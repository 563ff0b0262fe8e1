"""Store -> pool preparation (counterpart of facegen/data/pipeline.py:39-56),
the part the sampler needs: no augmentation yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# BT.601 luma, as torch's image.rgb2y for 1-channel loads (dataset.lua:90)
_LUMA = (0.299, 0.587, 0.114)


def prepare_pool(raw: torch.Tensor, scale: int, channels: int) -> torch.Tensor:
    """(N, 64, 64, 3) uint8 -> (N, scale, scale, channels) uint8, on raw's
    device: /255, luma for gray, bilinear resize to ``scale``. The resize
    is antialiased like jax.image.resize's "linear" method, which widens
    its triangle kernel by the downscale factor."""
    x = raw.float() / 255.0
    if channels == 1:
        x = (x @ torch.tensor(_LUMA, device=x.device))[..., None]
    if scale != x.shape[1]:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(scale, scale), mode="bilinear",
                          align_corners=False, antialias=True).permute(0, 2, 3, 1)
    return torch.clamp(x * 255.0 + 0.5, 0, 255).to(torch.uint8)
