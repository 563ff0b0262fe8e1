"""Device time of the batch norm + PReLU kernels (``bn_prelu``) in the
traced training slice, ms a step. None without them. Moves
train_images_per_s."""

from benchmark.lib.norm import device_ms_per


def read(outcome):
    return device_ms_per(outcome, "steps")
