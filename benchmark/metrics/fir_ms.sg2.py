"""Device time of StyleGAN2's FIR resamples (the program's ``sg2.fir``
views: G's up-conv blurs and image upsampling, D's downsampling blurs)
in the traced sampler slice, ms a request. None without them. Moves
sample_faces_per_s."""

from benchmark.lib.readers import span_device_ms


def read(outcome):
    return span_device_ms(outcome, "sg2.fir", "requests")
