"""The upsample-conv kernels' share of their bound in the traced training
slice, in %: the bound times of every forward, dx and dW of its steps
(lib/flops.py) over the traced time of those kernels. Moves
train_images_per_s."""

from benchmark.lib.readers import is_upconv, roofline_pct


def read(outcome):
    return roofline_pct(outcome, "upconv_bound_s", is_upconv)
