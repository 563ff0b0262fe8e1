"""The update tail's share of its byte bound in the traced training
slice, in %: fused_prep and fused_update of both nets, every step, over
their traced time. Moves train_images_per_s."""

from benchmark.lib.readers import is_update, roofline_pct


def read(outcome):
    return roofline_pct(outcome, "update_bound_s", is_update)
