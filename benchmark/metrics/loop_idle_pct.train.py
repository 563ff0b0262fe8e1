"""The device's idle time before work the epoch loop launched (a ``loop.*``
or ``data.pool`` span the innermost at the launch: the pools, the
summaries, the read-back, the save), or while the device waited for the
host in such a span, in % of the traced slice (lib/spans.py). Moves
train_images_per_s."""

from benchmark.lib.spans import layer_share


def read(outcome):
    return layer_share(outcome, "loop")
