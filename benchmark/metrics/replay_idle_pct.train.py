"""The device's idle time inside the replays of the captured step, in % of
the traced slice: the gaps between a graph's kernels, inside the device
view of the program's ``step.replay`` spans (lib/spans.py). Moves
train_images_per_s."""

from benchmark.lib.spans import replay_share as read  # noqa: F401
