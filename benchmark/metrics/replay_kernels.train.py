"""Kernels a replay of the captured step runs, observed: the kernels that
start inside the device view of the program's ``step.replay`` spans, over
those spans. The draws' eager kernels lie outside. Moves
train_images_per_s."""

from benchmark.lib import trace as T
from benchmark.lib.spans import REPLAY, per_view


def read(outcome):
    return per_view(outcome, REPLAY, T.kernels_in)
