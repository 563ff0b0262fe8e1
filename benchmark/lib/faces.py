"""The face store the cells train on and search, made on the device from the seed.

LFW (13,233 images) is not in the repository and cannot be fetched, so
the store holds as many procedural faces, (64, 64, 3) uint8 as the
packed LFW store is: an elliptical skin-tone head on a background
gradient, two eye blobs, a mouth bar and a darker hair cap, with
per-image jitter and pixel noise (the drawing of the program's
synthetic faces, copied so that the benchmark makes its own inputs).
"""

from __future__ import annotations

import torch

LFW_IMAGES = 13_233
SIZE = 64
# (low, high) of the per-image uniform draws: centre y, centre x, radius
# y, x/y aspect, skin tone, background top, background bottom
RANGES = ((0.45, 0.55), (0.45, 0.55), (0.28, 0.36), (0.72, 0.82),
          (0.6, 0.85), (0.05, 0.35), (0.05, 0.35))


def _gauss2d(gy, gx, cy, cx, sy, sx):
    return torch.exp(-(((gy - cy) / sy) ** 2 + ((gx - cx) / sx) ** 2))


def _faces(uniforms: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    dev, size = uniforms.device, noise.shape[1]
    lo = torch.tensor([r[0] for r in RANGES], device=dev)
    hi = torch.tensor([r[1] for r in RANGES], device=dev)
    u = (uniforms * (hi - lo) + lo)[:, :, None, None]
    cy, cx, ry, aspect, tone, bg_a, bg_b = u.unbind(1)
    rx = ry * aspect
    lin = torch.linspace(0.0, 1.0, size, device=dev)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    head = torch.sigmoid((1.0 - (((gy - cy) / ry) ** 2 + ((gx - cx) / rx) ** 2)) * 12.0)
    skin = torch.stack([tone, tone * 0.78, tone * 0.62], dim=-1)
    eye_y, eye_dx = cy - 0.08, rx * 0.45
    eyes = (_gauss2d(gy, gx, eye_y, cx - eye_dx, 0.03, 0.045)
            + _gauss2d(gy, gx, eye_y, cx + eye_dx, 0.03, 0.045))
    mouth = _gauss2d(gy, gx, cy + ry * 0.55, cx, 0.025, 0.10)
    hair = torch.sigmoid(((cy - ry * 0.45) - gy) * 18.0) * head
    bg = bg_a + (bg_b - bg_a) * gy
    img = bg[..., None] * torch.ones(3, device=dev)
    img = img * (1 - head[..., None]) + head[..., None] * skin
    img = img * (1 - 0.8 * hair[..., None])
    img = img * (1 - 0.85 * eyes[..., None])
    img = img * (1 - 0.6 * mouth[..., None] * torch.tensor([0.2, 0.8, 0.8], device=dev))
    img = torch.clamp(img + 0.02 * noise, 0.0, 1.0)
    return (img * 255.0 + 0.5).to(torch.uint8)


def make_store(generator: torch.Generator, n: int = LFW_IMAGES) -> torch.Tensor:
    """(n, 64, 64, 3) uint8 faces on the generator's device, 2048 at a time."""
    dev = generator.device
    out = torch.empty((n, SIZE, SIZE, 3), dtype=torch.uint8, device=dev)
    for start in range(0, n, 2048):
        m = min(2048, n - start)
        uniforms = torch.rand(m, len(RANGES), generator=generator, device=dev)
        noise = torch.randn(m, SIZE, SIZE, 3, generator=generator, device=dev)
        out[start:start + m] = _faces(uniforms, noise)
    return out
