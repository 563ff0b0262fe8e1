"""Generator and discriminator factories of the port."""
