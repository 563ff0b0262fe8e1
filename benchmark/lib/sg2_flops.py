"""Operations and bytes of StyleGAN2's forward passes, from the layer shapes
of a configuration's flags (``resolution``, ``channels``, ``z_dim``,
``w_dim``, ``mapping_layers``, ``channel_base``, ``channel_max``,
``mbstd_channels``), counted as lib/flops.py counts: a conv is 2 x taps x
Cin x Cout per output position, a linear layer 2 x in x out; elementwise
work (modulation, demodulation, noise, bias, activations, the FIR) is
not counted. G's up-convs (a transposed 3x3 conv of stride 2) are
counted at their input positions, the work of the product.

A layer here is lib/flops.py's (kind, cin, cout, taps, positions) with
the input and output positions its bytes need after it. Bounds
(``bound_s``) sum each layer's own: the larger of its operations at the
bf16 peak and its bytes at the memory rate, the input and output
activations in bf16 read and written once and its weight once.

At config F's 256x256 (90.1 GFLOP for G's 3x3 and up-convs a face, 92.9
for D's 3x3 and skip convs) G's forward is 90.24 GFLOP a face with the
ToRGBs, the styles and the mapping, D's 93.07.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from benchmark.lib import flops

# (kind, cin, cout, taps, positions counted, input positions, output positions)
Layer = Tuple[str, int, int, int, int, int, int]


def _width(flags: dict, res: int) -> int:
    return min(flags["channel_base"] // res, flags["channel_max"])


def _resolutions(flags: dict) -> List[int]:
    return [2 ** i for i in range(2, int(math.log2(flags["resolution"])) + 1)]


def g_layers(flags: dict) -> List[Layer]:
    """G's layers a face: the mapping, each layer's style (``affine``), the
    modulated 3x3 convs (``upconv``: at their input positions; the output
    of a transposed conv of stride 2 is (2H + 1)^2), the ToRGBs."""
    z, w = flags["z_dim"], flags["w_dim"]
    out: List[Layer] = [("linear", z if i == 0 else w, w, 1, 1, 1, 1)
                        for i in range(flags["mapping_layers"])]
    for res in _resolutions(flags):
        c, hw = _width(flags, res), res * res
        if res > 4:
            cin, h_in = _width(flags, res // 2), res // 2
            out += [("affine", w, cin, 1, 1, 1, 1),
                    ("upconv", cin, c, 9, h_in * h_in, h_in * h_in, (res + 1) ** 2)]
        out += [("affine", w, c, 1, 1, 1, 1), ("conv", c, c, 9, hw, hw, hw),
                ("affine", w, c, 1, 1, 1, 1), ("torgb", c, flags["channels"], 1, hw, hw, hw)]
    return out


def d_layers(flags: dict) -> List[Layer]:
    """D's layers a face: FromRGB, per block conv0, conv1 (its input the
    blurred (H + 1)^2 map, its output (H/2)^2) and the skip, the epilogue's
    conv and two linear layers."""
    out: List[Layer] = []
    top = flags["resolution"]
    for res in reversed(_resolutions(flags)[1:]):
        tmp, c, hw, half = _width(flags, res), _width(flags, res // 2), res * res, (res // 2) ** 2
        if res == top:
            out.append(("fromrgb", flags["channels"], tmp, 1, hw, hw, hw))
        out += [("conv", tmp, tmp, 9, hw, hw, hw), ("conv", tmp, c, 9, half, (res + 1) ** 2, half),
                ("skip", tmp, c, 1, half, half, half)]
    c = _width(flags, 4)
    return out + [("conv", c + flags["mbstd_channels"], c, 9, 16, 16, 16),
                  ("linear", 16 * c, c, 1, 1, 1, 1), ("linear", c, 1, 1, 1, 1, 1)]


def forward_flops(layers: List[Layer]) -> float:
    return flops.forward_flops(layer[:5] for layer in layers)


def bound_s(n: int, layers: List[Layer], elem: int = 2) -> float:
    """The sum of each layer's bound at batch ``n``."""
    total = 0.0
    for _, cin, cout, taps, positions, p_in, p_out in layers:
        nbytes = elem * (n * cin * p_in + cin * cout * taps + n * cout * p_out)
        total += flops.bound_s(2.0 * n * cin * cout * taps * positions, nbytes)
    return total


def synthesis_convs(flags: dict) -> List[Layer]:
    """The convs whose bound ``synthesis_roofline.sg2`` reads: the modulated
    3x3 convs, the up-convs and the ToRGBs."""
    return [layer for layer in g_layers(flags) if layer[0] in ("conv", "upconv", "torgb")]


def _views(outcome, name: str):
    """The device views (us) of the ``name`` spans inside the traced slice,
    where the slice holds StyleGAN2's spans; else None."""
    from benchmark.lib import spans

    if outcome.trace is None or outcome.window is None:
        return None
    lo, hi = outcome.window
    if not spans.device_views(outcome.trace, "sg2.synthesis", lo, hi):
        return None
    return spans.device_views(outcome.trace, name, lo, hi) or None


def view_share(outcome, bound_key: str, name: str):
    """``facts[bound_key]`` over the device time of the ``name`` views, in %."""
    views = _views(outcome, name)
    if views is None or not outcome.facts.get(bound_key):
        return None
    return 100.0 * outcome.facts[bound_key] / (sum(e - s for s, e in views) * 1e-6)


def view_kernels(outcome, name: str):
    """Kernels starting in the ``name`` views, a request."""
    from benchmark.lib import trace as T

    views = _views(outcome, name)
    if views is None or not outcome.facts.get("requests"):
        return None
    return T.kernels_in(outcome.trace, views) / outcome.facts["requests"]
