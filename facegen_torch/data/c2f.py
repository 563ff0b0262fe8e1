"""Coarse/fine/diff triples for the refinement GAN (counterpart of
facegen/data/c2f.py).

For each fine image, coarse = a bilinear downscale to coarse_size and an
upscale back to the fine size (dataset_c2f.lua:52-56), diff = fine -
coarse (:58-61). The pool keeps fine and coarse as uint8 on the device;
a batch's diff is rebuilt as fine - coarse when it is gathered. Both
resizes are antialiased like jax.image.resize's "linear" method: the
downscale widens its triangle kernel by the factor, and the upscale
renormalises its weights at the border, which is the same as clamping.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class C2FPool(NamedTuple):
    fine: torch.Tensor    # (N, H, W, C) uint8
    coarse: torch.Tensor  # (N, H, W, C) uint8

    @property
    def size(self) -> int:
        return int(self.fine.shape[0])


def _resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC bilinear resize to (size, size), antialiased."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def make_triples(fine_u8: torch.Tensor, coarse_size: int) -> C2FPool:
    """(N, fine, fine, C) uint8 -> C2FPool with the blurred coarse, on the
    input's device."""
    x = fine_u8.float() / 255.0
    up = _resize(_resize(x, coarse_size), x.shape[1])
    coarse = torch.clamp(up * 255.0 + 0.5, 0, 255).to(torch.uint8)
    return C2FPool(fine=fine_u8, coarse=coarse.contiguous())


def gather_triple(pool: C2FPool, idx: torch.Tensor, dtype=torch.float32):
    """A batch of rows -> (fine, coarse, diff): fine and coarse in [0, 1],
    diff in [-1, 1], computed in ``dtype`` as facegen computes them, over a
    0-d tensor filled on the device (a CUDA graph can capture a fill, not
    a copy from the host)."""
    scale = torch.full((), 255.0, dtype=dtype, device=pool.fine.device)
    fine = pool.fine[idx].to(dtype) / scale
    coarse = pool.coarse[idx].to(dtype) / scale
    return fine, coarse, fine - coarse
