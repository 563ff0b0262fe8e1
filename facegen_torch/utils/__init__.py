"""Checkpoints, inference and image grids of the port."""
