"""Data stores, pools and synthetic faces of the port."""
