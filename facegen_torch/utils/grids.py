"""Image grids and PNG output.

``to_grid`` and ``save_grid`` are copied from facegen/utils/grids.py:18-53.
``save_png`` writes the PNG itself (zlib + struct: 8-bit gray or RGB,
one IDAT chunk) instead of through PIL, which the port does not need.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Optional

import numpy as np


def to_grid(
    images: np.ndarray,
    nrow: Optional[int] = None,
    padding: int = 1,
    pad_value: float = 1.0,
) -> np.ndarray:
    """(N, H, W, C) floats in [0,1] -> one (GH, GW, C) grid array."""
    images = np.asarray(images, np.float32)
    n, h, w, c = images.shape
    nrow = nrow or int(math.ceil(math.sqrt(n)))
    ncol = int(math.ceil(n / nrow))
    gh = ncol * (h + padding) + padding
    gw = nrow * (w + padding) + padding
    grid = np.full((gh, gw, c), pad_value, np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y : y + h, x : x + w] = images[i]
    return grid


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(path: str, image: np.ndarray) -> str:
    """Write a [0,1] float (H, W, C) array, C in {1, 3}, as an 8-bit PNG."""
    arr = np.clip(np.asarray(image, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        color_type = 0  # gray
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        color_type = 2  # RGB
    else:
        raise ValueError(f"save_png: want (H, W), (H, W, 1) or (H, W, 3), got {arr.shape}")
    h, w = arr.shape[:2]
    # each scanline starts with its filter type, 0 = none
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)
    return path


def save_grid(path: str, images, nrow: Optional[int] = None) -> str:
    return save_png(path, to_grid(np.asarray(images), nrow=nrow))
