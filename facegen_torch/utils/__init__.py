"""Checkpoints, inference, image grids, profiling and the dashboard of the port."""
