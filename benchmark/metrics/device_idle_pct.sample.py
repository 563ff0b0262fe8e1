"""The device's idle share of the traced sampler requests, in %: 100
minus the union of its kernel, copy and fill intervals over the slice's
wall time. Moves sample_faces_per_s."""

from benchmark.lib.readers import idle_pct as read  # noqa: F401
