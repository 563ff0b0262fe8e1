"""Store -> epoch pool (counterpart of facegen/data/pipeline.py).

Each epoch draws a fresh pool: N_epoch rows of the packed uint8 store
sampled with replacement (sorted), augmented (data/augment.py), turned
gray for 1-channel runs, resized to the training scale and kept as uint8
on the device; the train step gathers its batches from it there. The
whole store lives on the GPU (the 13k-image LFW store is ~160 MB), so
no host work or prefetch thread is needed; synthetic runs draw fresh
faces each epoch instead (data/synthetic.py). Under data parallelism
every rank draws the same pool from the epoch's pool generator and
keeps its own rows (parallel/mesh.py:shard_pool, train/loop.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from facegen_torch.data.augment import augment_batch, sample_affine_params

# BT.601 luma, as torch's image.rgb2y for 1-channel loads (dataset.lua:90)
_LUMA = (0.299, 0.587, 0.114)


def prepare_pool(raw: torch.Tensor, scale: int, channels: int,
                 augment: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """(N, 64, 64, 3) uint8 -> (N, scale, scale, channels) uint8, on raw's
    device: /255, the augmentation when ``augment`` holds its draws
    (data/augment.py:sample_affine_params), luma for gray, bilinear resize
    to ``scale``. The resize is antialiased like jax.image.resize's
    "linear" method, which widens its triangle kernel by the downscale
    factor."""
    x = raw.float() / 255.0
    if augment is not None:
        x = augment_batch(x, augment)
    if channels == 1:
        x = (x @ torch.tensor(_LUMA, device=x.device))[..., None]
    if scale != x.shape[1]:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(scale, scale), mode="bilinear",
                          align_corners=False, antialias=True).permute(0, 2, 3, 1)
    return torch.clamp(x * 255.0 + 0.5, 0, 255).to(torch.uint8)


@dataclasses.dataclass
class DataSource:
    """Packed store or synthetic faces, on ``device``. ``epoch_pool``
    returns an (n, scale, scale, channels) uint8 pool on the device, the
    reference's TRAIN_DATA = loadRandomImages(N) (train.lua:201)."""

    scale: int
    channels: int
    device: torch.device
    store: Optional[torch.Tensor] = None  # (N, 64, 64, 3) uint8 on the device; None = synthetic
    holdout: int = 0  # the store's first rows, reserved for validation (c2f)

    @property
    def size(self) -> int:
        # synthetic data is unbounded; facegen reports the same finite size
        if self.store is None:
            return 16_384
        return int(self.store.shape[0]) - self.holdout

    def raw_batch(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """(n, 64, 64, 3) uint8 on the device, before augmentation; store
        rows are drawn from [holdout, N)."""
        if self.store is None:
            from facegen_torch.data.synthetic import draw_synthetic_faces

            return draw_synthetic_faces(generator, n).to(self.device)
        idx = torch.randint(self.holdout, self.store.shape[0], (n,), generator=generator,
                            device=generator.device)
        return self.store[torch.sort(idx).values.to(self.device)]

    def epoch_pool(self, generator: torch.Generator, n: int) -> torch.Tensor:
        raw = self.raw_batch(generator, n)
        aug = {k: v.to(self.device) for k, v in sample_affine_params(generator, n).items()}
        return prepare_pool(raw, self.scale, self.channels, aug)

    def range_pool(self, start: int, count: int) -> torch.Tensor:
        """Rows [start, start + count) resized without augmentation, the
        reference's loadImages(startAt, count) (dataset.lua:46-74) for
        validation sets; for synthetic data, ``count`` faces drawn from a
        generator seeded with ``start`` (facegen/data/pipeline.py:215-226)."""
        if self.store is None:
            from facegen_torch.data.synthetic import draw_synthetic_faces

            raw = draw_synthetic_faces(torch.Generator().manual_seed(start), count)
            raw = raw.to(self.device)
        else:
            raw = self.store[start : start + count]
        return prepare_pool(raw, self.scale, self.channels)


def make_source(cfg, device, holdout: int = 0) -> DataSource:
    """The DataSource a TrainConfig describes (store path selection as
    train.lua:166-173); a packed store is copied to the device once.
    ``holdout``: the store's first rows, which training pools skip."""
    from facegen_torch.data import lfw

    device = torch.device(device)
    if cfg.synthetic_data:
        return DataSource(cfg.scale, cfg.channels, device, holdout=holdout)
    path = lfw.default_store_path(cfg.aws, cfg.dataset_dir)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"packed dataset {path!r} not found; build it with "
            "`python -m facegen_torch.data.lfw --path=/path/to/lfw` or pass --syntheticData"
        )
    store = torch.from_numpy(np.array(lfw.load_store(path))).to(device)
    return DataSource(cfg.scale, cfg.channels, device, store=store, holdout=holdout)
