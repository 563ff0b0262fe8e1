"""Device kernels a training step, counted from the traced slice: the
kernels that start inside the device's view of the spans around the
trainer's ``run_steps`` (the captured step's replays), over the slice's
steps. The pools, the read-back and approxParzen lie outside those
spans. Moves train_images_per_s."""

from benchmark.lib.readers import kernels_per_step
from benchmark.lib.window import STEPS


def read(outcome):
    return kernels_per_step(outcome, STEPS)
