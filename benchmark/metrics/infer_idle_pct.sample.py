"""The device's idle time before work the program's inference launched (an
``infer.*`` span the innermost at the launch: G, D, the ranking's sort and
gather, the search and its read-back), or while the device waited for the
host in such a span, in % of the traced requests' slice (lib/spans.py).
Moves sample_faces_per_s."""

from benchmark.lib.spans import layer_share


def read(outcome):
    return layer_share(outcome, "infer")
