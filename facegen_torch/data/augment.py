"""Batched affine augmentation on the device (counterpart of
facegen/data/augment.py:68-172,292-322).

The reference's offline augmenter (generate_dataset.py:43-48,
ImageAugmenter.py) applied per image: a horizontal flip with p = 0.5,
a brightness factor U(0.9, 1.1) with a clip to [0, 1], and an affine
warp about the centre (scale U(0.82, 1.10) on both axes, rotation
+-8 degrees, translation +-5 px on both axes), bilinear, zero outside.
facegen draws the same family fresh every epoch on the device, and so
does the port, with those values fixed.

The draws are a dict of tensors (``sample_affine_params``), which
``augment_batch`` takes injected: the tests hand both packages facegen's
draws. Affine matrices use skimage's convention, (x, y) = (column, row);
the warp samples the input at the inverse-mapped place of each output
pixel.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# generate_dataset.py:43-48
SCALE_RANGE = (0.82, 1.10)
ROTATION_DEG = 8.0
TRANSLATION_PX = 5.0
BRIGHTNESS = 0.10


def sample_affine_params(generator: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
    """Per-image draws from ``generator`` on its device: flip (bool),
    scale, rot (radians), trans (n, 2) as (x, y), bright."""
    dev = generator.device

    def uniform(lo, hi):
        return torch.rand(n, generator=generator, device=dev) * (hi - lo) + lo

    return {
        "flip": torch.rand(n, generator=generator, device=dev) < 0.5,
        "scale": uniform(*SCALE_RANGE),
        "rot": uniform(-ROTATION_DEG, ROTATION_DEG) * (math.pi / 180.0),
        "trans": torch.stack([uniform(-TRANSLATION_PX, TRANSLATION_PX),
                              uniform(-TRANSLATION_PX, TRANSLATION_PX)], dim=-1),
        "bright": uniform(1.0 - BRIGHTNESS, 1.0 + BRIGHTNESS),
    }


def inverse_affine_matrices(params: Dict[str, torch.Tensor], height: int,
                            width: int) -> torch.Tensor:
    """(N, 2, 3) matrices taking an output pixel (x, y, 1) to the input
    point it samples: the centre int(w/2), int(h/2) moved to the origin,
    scaled and rotated, translated, moved back (ImageAugmenter.py:185-197),
    inverted."""
    s, r = params["scale"], params["rot"]
    tx, ty = params["trans"][:, 0], params["trans"][:, 1]
    a, b = s * torch.cos(r), -s * torch.sin(r)
    c, d = s * torch.sin(r), s * torch.cos(r)
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    cx, cy = float(width // 2), float(height // 2)
    ox, oy = -cx - tx, -cy - ty
    m02 = ia * ox + ib * oy + cx
    m12 = ic * ox + id_ * oy + cy
    return torch.stack([torch.stack([ia, ib, m02], -1), torch.stack([ic, id_, m12], -1)], 1)


def warp_bilinear(images: torch.Tensor, matrices: torch.Tensor) -> torch.Tensor:
    """Inverse-map bilinear warp of (N, H, W, C) float images with (N, 2, 3)
    matrices; corners outside the image read 0. The four corners are
    gathered and blended as facegen's warp_bilinear does, so the two
    agree to fp32 rounding."""
    n, h, w, c = images.shape
    dev = images.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (H, W, 3) = (x, y, 1)
    src = torch.einsum("nij,hwj->nhwi", matrices.float(), coords)
    sx, sy = src[..., 0], src[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    batch = torch.arange(n, device=dev)[:, None, None]

    def gather(yi, xi):
        inside = ((yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1))[..., None]
        vals = images[batch, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return torch.where(inside, vals, 0.0)

    top = gather(y0, x0) * (1 - fx) + gather(y0, x0 + 1) * fx
    bot = gather(y0 + 1, x0) * (1 - fx) + gather(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def augment_batch(images: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Flip, then brightness and clip, then the affine warp. ``images``:
    (N, H, W, C) uint8 or floats in [0, 1]; ``params`` as
    ``sample_affine_params`` returns. Returns fp32 in [0, 1]."""
    n, h, w, _ = images.shape
    x = images.float() / 255.0 if images.dtype == torch.uint8 else images.float()
    x = torch.where(params["flip"][:, None, None, None], x.flip(2), x)
    x = (x * params["bright"][:, None, None, None]).clamp(0.0, 1.0)
    return warp_bilinear(x, inverse_affine_matrices(params, h, w))
