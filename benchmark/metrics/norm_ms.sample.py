"""Device time of the batch norm + PReLU kernels (``bn_prelu``: G's two
eval applies a G call) in the traced sampler slice, ms a request. None
without them. Moves sample_faces_per_s."""

from benchmark.lib.norm import device_ms_per


def read(outcome):
    return device_ms_per(outcome, "requests")
