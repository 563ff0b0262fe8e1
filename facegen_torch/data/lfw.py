"""The packed uint8 face store: copied from facegen/data/lfw.py:125-136.
Packing an LFW tree into a store stays with facegen's
``python -m facegen.data.lfw``; its output is a plain .npy file."""

from __future__ import annotations

from typing import Optional

import numpy as np


def load_store(path: str) -> np.ndarray:
    """Memory-map a packed dataset; shape (N, 64, 64, 3) uint8."""
    return np.load(path, mmap_mode="r")


def default_store_path(aws: bool = False, dataset_dir: Optional[str] = None) -> str:
    """Mirrors train.lua:166-170 / sample.lua:61-65 directory selection."""
    if dataset_dir:
        return dataset_dir
    if aws:
        return "/mnt/datasets/lfw64.npy"
    return "dataset/lfw64.npy"
