"""Layers and weight initialisation of the port."""
