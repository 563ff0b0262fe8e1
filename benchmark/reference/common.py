"""Plain PyTorch pieces that the configurations' references share.

Nothing here imports the program under test. Where the program derives
something from the benchmark's inputs (an epoch pool from the store, a
step's draws from a seeded generator), this module works it out again
from the same inputs by the same arithmetic, written out plainly:

- ``seeded_generator``: a generator seeded from a list of words through
  numpy's SeedSequence, as the trainers seed each epoch's streams;
- ``augment`` and ``resize``: the flip, brightness and affine warp of a
  store image and the antialiased bilinear resize (the reference's
  ImageAugmenter family: flip p = 0.5, brightness U(0.9, 1.1), scale
  U(0.82, 1.10), rotation +-8 degrees, translation +-5 px);
- ``epoch_pool``: N rows of the store drawn with replacement, sorted,
  augmented and resized, as uint8 (``hold=bf16``: the control's pool,
  every stage rounded to bf16);
- ``Precision``: the arithmetic a reference computes in. ``fp32`` is the
  reference itself (TF32 off on the card); ``fp8`` holds every conv's
  and linear layer's input, weight and output in float8 e4m3 and their
  gradients in e5m2, scaled per tensor, and is the control that the
  comparison must fail;
- ``adam_step``, ``bce``: optax's Adam (bias correction by the step
  count, eps outside the root) and the mean binary cross-entropy of
  logits.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def seeded_generator(device, *words: int) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(words)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


@contextlib.contextmanager
def full_fp32():
    """Convolutions and matrix products in full fp32 (no TF32) inside the block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the fp8 ``dtype`` after scaling its largest
    magnitude to ``top``, and scaled back."""
    scale = top / x.abs().max().clamp_min(1e-30)
    return (x * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """An operand held in fp8: e4m3 forward, and its gradient in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad.float(), torch.float8_e5m2, 57344.0)


class Precision:
    """``q(x)``: a tensor as this precision holds it, in fp32. fp32 is
    exact; fp8 rounds the tensor to float8 e4m3 and its gradient to float8
    e5m2, each scaled per tensor so that its largest magnitude is the
    format's largest. A conv's or linear layer's input, weight and output
    are held so, as a bf16 program holds them in bf16."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x if self.name == "fp32" else _Fp8.apply(x)

    def conv(self, x, w, b, stride=1, padding=0):
        """NCHW conv of the operands as held."""
        return self.q(F.conv2d(self.q(x), self.q(w), b.float(), stride, padding))

    def linear(self, x, w, b):
        return self.q(F.linear(self.q(x), self.q(w), b.float()))


FP32 = Precision("fp32")


def prelu(x, slope):
    return torch.where(x >= 0, x, slope * x)


def bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logits, targets = logits.float().reshape(-1), targets.float().reshape(-1)
    per = logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return per.mean()


def adam_step(params: List[torch.Tensor], grads: List[torch.Tensor], state: dict,
              lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam update of ``params`` in place; ``state`` holds ``mu``, ``nu``
    and ``count`` (fresh: ``{}``)."""
    if not state:
        state.update(mu=[torch.zeros_like(p) for p in params],
                     nu=[torch.zeros_like(p) for p in params], count=0)
    state["count"] += 1
    c = state["count"]
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
    for i, (p, g) in enumerate(zip(params, grads)):
        state["mu"][i] = (1 - b1) * g + b1 * state["mu"][i]
        state["nu"][i] = (1 - b2) * g * g + b2 * state["nu"][i]
        p.sub_(lr * (state["mu"][i] / bc1) / (torch.sqrt(state["nu"][i] / bc2) + eps))


def penalised_grads(params, grads, sign_coef: float, l2: float, clamp: float):
    """grads + sign_coef * sign(p) + l2 * p, clamped to [-clamp, clamp]."""
    out = []
    for p, g in zip(params, grads):
        g = g + sign_coef * torch.sign(p) + l2 * p
        out.append(g.clamp(-clamp, clamp) if clamp else g)
    return out


def penalty(params, l1: float, l2: float) -> torch.Tensor:
    total = torch.zeros((), device=params[0].device)
    for p in params:
        total = total + l1 * p.abs().sum() + l2 * (p * p).sum() / 2.0
    return total


def uniform(generator: torch.Generator, n, lo: float, hi: float) -> torch.Tensor:
    shape = (n,) if isinstance(n, int) else tuple(n)
    return torch.rand(shape, generator=generator, device=generator.device) * (hi - lo) + lo


def affine_draws(generator: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
    """The per-image draws of the augmentation, in the order they are drawn."""
    flip = torch.rand(n, generator=generator, device=generator.device) < 0.5
    scale = uniform(generator, n, 0.82, 1.10)
    rot = uniform(generator, n, -8.0, 8.0) * (math.pi / 180.0)
    tx = uniform(generator, n, -5.0, 5.0)
    ty = uniform(generator, n, -5.0, 5.0)
    bright = uniform(generator, n, 0.9, 1.1)
    return {"flip": flip, "scale": scale, "rot": rot, "tx": tx, "ty": ty, "bright": bright}


def augment(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(N, H, W, C) floats in [0, 1]: flip, brightness and clip, then the
    affine warp about (W // 2, H // 2), bilinear with zeros outside."""
    n, h, w, _ = x.shape
    dev = x.device
    x = torch.where(p["flip"][:, None, None, None], x.flip(2), x)
    x = (x * p["bright"][:, None, None, None]).clamp(0.0, 1.0)
    s, r = p["scale"], p["rot"]
    a, b, c, d = s * torch.cos(r), -s * torch.sin(r), s * torch.sin(r), s * torch.cos(r)
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    cx, cy = float(w // 2), float(h // 2)
    ox, oy = -cx - p["tx"], -cy - p["ty"]
    m = torch.stack([torch.stack([ia, ib, ia * ox + ib * oy + cx], -1),
                     torch.stack([ic, id_, ic * ox + id_ * oy + cy], -1)], 1)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    src = torch.einsum("nij,hwj->nhwi", m, torch.stack([gx, gy, torch.ones_like(gx)], -1))
    sx, sy = src[..., 0], src[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    rows = torch.arange(n, device=dev)[:, None, None]

    def at(yi, xi):
        inside = ((yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1))[..., None]
        v = x[rows, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return torch.where(inside, v, 0.0)

    top = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx
    bottom = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bottom * fy


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC floats, antialiased bilinear resize to (size, size)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x * 255.0 + 0.5, 0, 255).to(torch.uint8)


def same(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` as bf16 holds it, in fp32."""
    return x.to(torch.bfloat16).float()


def epoch_pool(store: torch.Tensor, generator: torch.Generator, n: int, scale: int,
               holdout: int = 0, hold=same) -> torch.Tensor:
    """n rows of ``store`` (N, 64, 64, 3) uint8 from [holdout, N), drawn
    with replacement and sorted, augmented and resized to ``scale``;
    ``hold`` rounds the draws and every stage (``same``: fp32)."""
    idx = torch.randint(holdout, store.shape[0], (n,), generator=generator,
                        device=generator.device)
    raw = store[torch.sort(idx).values.to(store.device)]
    draws = {k: (v if v.dtype == torch.bool else hold(v)).to(store.device)
             for k, v in affine_draws(generator, n).items()}
    x = hold(augment(hold(raw.float() / 255.0), draws))
    return to_u8(hold(resize(x, scale)))


def range_pool(store: torch.Tensor, n: int, scale: int, hold=same) -> torch.Tensor:
    """The first n rows of ``store`` resized to ``scale``, as uint8."""
    return to_u8(hold(resize(hold(store[:n].float() / 255.0), scale)))


def dropout_masks(generator: torch.Generator, specs: Sequence) -> List[torch.Tensor]:
    """Keep-masks of (shape, rate) specs, drawn in order."""
    return [torch.rand(shape, generator=generator, device=generator.device) < 1.0 - rate
            for shape, rate in specs]


def apply_dropout(x: torch.Tensor, keep_mask: torch.Tensor, rate: float) -> torch.Tensor:
    keep = 1.0 - rate
    return torch.where(keep_mask, x / keep, 0.0)


def noise(generator: torch.Generator, shape) -> torch.Tensor:
    """U(-1, 1)."""
    return torch.rand(tuple(shape), generator=generator, device=generator.device) * 2.0 - 1.0
