"""Inference helpers: generation, D scoring, ranking and the
nearest-neighbour search (counterpart of facegen/utils/infer.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


class GanInference:
    """Eval-mode G/D execution (dropout off, batch norm from running
    statistics, nn_utils.lua:207-222). Noise and activations are in
    ``compute_dtype`` (bf16 by default); parameters stay fp32 and are
    cast at use; D's sigmoid runs on fp32 logits."""

    def __init__(self, g: nn.Module, d: nn.Module, noise_dim: int,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.g = g.eval()
        self.d = d.eval()
        self.noise_dim = noise_dim
        self.dtype = compute_dtype
        self.device = next(g.parameters()).device

    def noise(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """U(-1, 1) noise (nn_utils.lua:35-39), drawn on the generator's device."""
        u = torch.rand(n, self.noise_dim, generator=generator, device=generator.device)
        return u * 2.0 - 1.0

    @torch.no_grad()
    def generate(self, noise: torch.Tensor) -> torch.Tensor:
        """(n, noise_dim) -> (n, H, W, C) fp32 images in [0, 1]."""
        return self.g(noise.to(self.device, self.dtype)).float()

    def generate_n(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return self.generate(self.noise(generator, n))

    @torch.no_grad()
    def score(self, images: torch.Tensor) -> torch.Tensor:
        """(n, H, W, C) images -> (n,) D probabilities."""
        logits = self.d(images.to(self.device, self.dtype))
        return torch.sigmoid(logits.float()).reshape(-1)

    def rank(self, images: torch.Tensor, ascending: bool = False,
             max_out: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(images sorted by D score, scores); ascending=True puts the
        most fake-looking first (nn_utils.lua:90-118). Stable, like
        jnp.argsort, so ties keep facegen's order."""
        scores = self.score(images)
        order = torch.argsort(scores if ascending else -scores, stable=True)
        if max_out is not None:
            order = order[:max_out]
        return images[order], scores[order]


def sanity_image(scale: int, channels: int, generator: torch.Generator) -> torch.Tensor:
    """The diagonal "non-face" probe D should reject (nn_utils.lua:157-169),
    (scale, scale, channels) fp32 on the generator's device: U(0, 0.5)
    background; on the first channel 1.0 on the main diagonal and 0.5 at
    every off-diagonal crossing of rows and columns 3, 7, 11, ... (the
    reference's 1-based multiples of 4)."""
    dev = generator.device
    img = torch.rand(scale, scale, channels, generator=generator, device=dev) * 0.5
    ii = torch.arange(scale, device=dev)
    lattice = ((ii[:, None] % 4 == 3) & (ii[None, :] % 4 == 3)
               & (ii[:, None] != ii[None, :]))
    img[..., 0] = torch.where(lattice, 0.5, img[..., 0])
    img[ii, ii, 0] = 1.0
    return img


def prepare_nn_dataset(dataset, device) -> torch.Tensor:
    """(N, H, W, C) images -> (N, H*W*C) fp32 on ``device``, uint8
    scaled to [0, 1]; done once for repeated queries."""
    t = torch.as_tensor(np.asarray(dataset)) if not torch.is_tensor(dataset) else dataset
    flat = t.reshape(t.shape[0], -1).to(device)
    if flat.dtype == torch.uint8:
        return flat.float() / 255.0
    return flat.float()


def nearest_neighbours(queries: torch.Tensor, dataset, k: int = 1,
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """For each query image the k nearest dataset images by L2 distance,
    as (indices, distances). One |q|^2 - 2 q d^T + |d|^2 product and a
    top-k on the device replace sample.lua:133-151's per-pair loop.
    ``dataset`` is a 2-D tensor from ``prepare_nn_dataset`` or images to
    prepare on the queries' device."""
    q = queries if torch.is_tensor(queries) else torch.as_tensor(np.asarray(queries))
    if q.dtype == torch.uint8:
        q = q.float() / 255.0
    q = q.reshape(q.shape[0], -1).float()
    if torch.is_tensor(dataset) and dataset.dim() == 2:
        df = dataset.to(q.device)
    else:
        df = prepare_nn_dataset(dataset, q.device)
    d2 = (q * q).sum(1, keepdim=True) - 2.0 * (q @ df.T) + (df * df).sum(1)[None, :]
    neg_top, idx = torch.topk(-d2.clamp_min(0.0), k, dim=1)
    return idx.cpu().numpy(), torch.sqrt(-neg_top).cpu().numpy()
