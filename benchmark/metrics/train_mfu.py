"""Model FLOPs of the traced slice's steps and validation (lib/flops.py)
over the slice's wall time at the bf16 peak, in %. Moves
train_images_per_s."""

from benchmark.lib.readers import mfu_pct as read  # noqa: F401
