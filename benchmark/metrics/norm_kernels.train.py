"""Batch norm + PReLU kernels a replay of the captured GAN step, observed:
the ``bn_prelu`` kernels that start inside the device views of the
program's ``step.replay`` spans, over those spans (12: G's two pairs, a
statistics and an apply launch each in the D phase's no-grad forward and
in the G phase's forward, a reduction and a dx launch each in its
backward). None without them. Moves train_images_per_s."""

from benchmark.lib.norm import launches_per_replay


def read(outcome):
    return launches_per_replay(outcome)
