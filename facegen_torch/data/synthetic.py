"""Procedural face-like images (counterpart of facegen/data/synthetic.py).

An elliptical skin-tone head on a background gradient, two eye blobs,
a mouth bar and a darker hair cap, with per-image jitter. The random
draws are arguments of ``synthetic_faces``, so the same draws give the
same faces in both packages; ``draw_synthetic_faces`` draws them from a
``torch.Generator``.
"""

from __future__ import annotations

import torch

# (low, high) of the per-image uniform draws, in facegen's order:
# centre y, centre x, radius y, x/y aspect, skin tone, background top,
# background bottom (facegen/data/synthetic.py:39-62)
UNIFORM_RANGES = (
    (0.45, 0.55), (0.45, 0.55), (0.28, 0.36), (0.72, 0.82),
    (0.6, 0.85), (0.05, 0.35), (0.05, 0.35),
)


def _gauss2d(gy, gx, cy, cx, sy, sx):
    return torch.exp(-(((gy - cy) / sy) ** 2 + ((gx - cx) / sx) ** 2))


def synthetic_faces(uniforms: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """uniforms: (n, 7) U(0, 1) draws, one column per UNIFORM_RANGES
    entry; noise: (n, size, size, 3) N(0, 1). Returns (n, size, size, 3)
    uint8 images on the draws' device."""
    dev, size = uniforms.device, noise.shape[1]
    lo = torch.tensor([r[0] for r in UNIFORM_RANGES], device=dev)
    hi = torch.tensor([r[1] for r in UNIFORM_RANGES], device=dev)
    u = (uniforms.float() * (hi - lo) + lo)[:, :, None, None]  # (n, 7, 1, 1)
    cy, cx, ry, aspect, tone, bg_a, bg_b = u.unbind(1)
    rx = ry * aspect
    lin = torch.linspace(0.0, 1.0, size, device=dev)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")

    d = ((gy - cy) / ry) ** 2 + ((gx - cx) / rx) ** 2
    head = torch.sigmoid((1.0 - d) * 12.0)
    skin = torch.stack([tone, tone * 0.78, tone * 0.62], dim=-1)  # (n, 1, 1, 3)
    eye_dy, eye_dx = cy - 0.08, rx * 0.45
    eyes = (_gauss2d(gy, gx, eye_dy, cx - eye_dx, 0.03, 0.045)
            + _gauss2d(gy, gx, eye_dy, cx + eye_dx, 0.03, 0.045))
    mouth = _gauss2d(gy, gx, cy + ry * 0.55, cx, 0.025, 0.10)
    hair = torch.sigmoid(((cy - ry * 0.45) - gy) * 18.0) * head
    bg = bg_a + (bg_b - bg_a) * gy

    img = bg[..., None] * torch.ones(3, device=dev)
    img = img * (1 - head[..., None]) + head[..., None] * skin
    img = img * (1 - 0.8 * hair[..., None])
    img = img * (1 - 0.85 * eyes[..., None])
    img = img * (1 - 0.6 * mouth[..., None] * torch.tensor([0.2, 0.8, 0.8], device=dev))
    img = torch.clamp(img + 0.02 * noise.float(), 0.0, 1.0)
    return (img * 255.0 + 0.5).to(torch.uint8)


def draw_synthetic_faces(generator: torch.Generator, n: int) -> torch.Tensor:
    """(n, 64, 64, 3) uint8 faces (the packed store's size) from draws of
    ``generator``, on its device, made 1024 images at a time to bound
    memory."""
    size = 64
    out = []
    for start in range(0, n, 1024):
        m = min(1024, n - start)
        uniforms = torch.rand(m, len(UNIFORM_RANGES), generator=generator,
                              device=generator.device)
        noise = torch.randn(m, size, size, 3, generator=generator, device=generator.device)
        out.append(synthetic_faces(uniforms, noise))
    return torch.cat(out)
