"""Operations and bytes of the work the cells do, from layer shapes.

The counts are of the work, whatever implements it: a conv is 2 x taps x
Cin x Cout per output position, a linear layer 2 x in x out; G32's
upsample-conv is counted as the phase-collapsed 3x3 conv to 4 x Cout at
the input resolution, which is 36 % of the naive upsample-then-5x5
count, so a kernel and a library call that compute it read the same
work. Elementwise work (batch norm, activations, the optimizer) is not
counted in FLOPs. A training step of one D and one G iteration is, in
forward passes (one backward = two forwards):

- D iteration: G(batch / 2) without gradients + 3 D(batch);
- G iteration: 3 G(batch) + 2 D(batch) (D's backward to its input only).

Bounds (``bound_s``): the larger of the operations at the card's bf16
tensor-core peak and the bytes at its memory rate, inputs read once and
outputs written once (NVIDIA H100 SXM data sheet, dense).
"""

from __future__ import annotations

from typing import Iterable, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

Layer = Tuple[str, int, int, int, int]  # (kind, cin, cout, taps, output positions)


def forward_flops(layers: Iterable[Layer]) -> float:
    """FLOPs of one image's forward pass through ``layers``."""
    return float(sum(2 * cin * cout * taps * positions for _, cin, cout, taps, positions in layers))


def steps_per_epoch(n_epoch: int, batch: int) -> int:
    """The reference's ``for t = 1, N_epoch, batchSize / 2``, skipping a
    tail of fewer than 4 rows (adversarial.lua:54-76)."""
    half = batch // 2
    return max(sum(1 for t in range(1, n_epoch + 1, half) if min(batch, n_epoch - t + 1) >= 4), 1)


def gan_step_flops(g_image: float, d_image: float, batch: int) -> float:
    return (g_image * batch / 2 + 3 * d_image * batch) + (3 * g_image * batch + 2 * d_image * batch)


def bound_s(flop: float, nbytes: float) -> float:
    return max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def upconv_launches(n: int, h: int, cin: int, cout: int, elem: int = 2):
    """(forward, dx, dW) bound seconds of one upsample-conv at batch ``n``,
    input ``h`` x ``h`` x ``cin``, ``cout`` outputs, ``elem``-byte
    activations; dW writes fp32."""
    flop = 2 * n * h * h * 4 * cout * 9 * cin
    x, wc, out = n * h * h * cin, 9 * cin * 4 * cout, n * 4 * h * h * cout
    fwd = bound_s(flop, elem * (x + wc + cout + out))
    dx = bound_s(flop, elem * (out + wc + x))
    dw = bound_s(flop, elem * (x + out) + 4 * wc)
    return fwd, dx, dw


def update_bytes(leaves, penalty: bool, clamp: float) -> int:
    """Bytes of one net's update tail with Adam over its fp32 ``leaves``
    ((name, shape, rule) tables): the prep, which runs where there is a
    penalty or a clamp, reads the gradient (and the parameter, for a
    penalty) and writes the gradient; the update reads parameter,
    gradient and both moments and writes parameter and moments."""
    n = numel(shape for _, shape, _ in leaves)
    prep = (12 if penalty else 8) if (penalty or clamp) else 0
    return n * (prep + 28)


def numel(shapes: Iterable[Tuple[int, ...]]) -> int:
    total = 0
    for shape in shapes:
        n = 1
        for s in shape:
            n *= s
        total += n
    return total
