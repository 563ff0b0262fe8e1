"""The device's idle time outside the replays before work the program's
steps launched (a ``step.draw``, ``step.replay`` or ``step.eager`` span
the innermost at the launch), or while the device waited for the host in
such a span, in % of the traced slice (lib/spans.py). Moves
train_images_per_s."""

from benchmark.lib.spans import layer_share


def read(outcome):
    return layer_share(outcome, "step")
