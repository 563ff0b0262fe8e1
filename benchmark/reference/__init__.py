"""Plain PyTorch references of the configurations."""
