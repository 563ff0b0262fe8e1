"""Model FLOPs of the traced requests (one G pass and two D passes over the
request's faces, the search's product) over the slice's wall time at the
bf16 peak, in %. Moves sample_faces_per_s."""

from benchmark.lib.readers import mfu_pct as read  # noqa: F401
