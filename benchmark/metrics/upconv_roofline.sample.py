"""The upsample-conv forward's share of its bound in the traced sampler
requests (two launches a G call at the request's batch), in %. Moves
sample_faces_per_s."""

from benchmark.lib.readers import is_upconv, roofline_pct


def read(outcome):
    return roofline_pct(outcome, "upconv_bound_s", is_upconv)
