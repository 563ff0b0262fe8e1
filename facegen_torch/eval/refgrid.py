"""Slice published sample-grid images into individual sample tiles
(counterpart of facegen/eval/refgrid.py; NumPy and PIL only).

The reference repo distributes its trained model's outputs as tiled
grid images (README.md:11-23: `images/color_random1024.jpg` is 1024
random generations laid out 32x32 with 32px tiles, `color_best.jpg`
the 64 best by D score at 8x8). Those grids are the only reference
sample population available without retraining the Lua stack, so this
module turns them back into an (N, H, W, C) array the quality-parity
harness (facegen_torch/eval/parity.py) can score against our generator —
a direct cross-framework comparison on the reference's own artifacts.

Tiles are assumed borderless and square; non-square grids (e.g. the
512x64 neighbour strips) slice row-major just the same.
"""

from __future__ import annotations

import numpy as np


def slice_grid(image: np.ndarray, tile: int = 32) -> np.ndarray:
    """(GH*tile, GW*tile, C) grid image -> (GH*GW, tile, tile, C),
    row-major tile order, float32 in [0, 1]."""
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    if h % tile or w % tile:
        raise ValueError(f"grid {h}x{w} not divisible by tile {tile}")
    gh, gw = h // tile, w // tile
    tiles = arr.reshape(gh, tile, gw, tile, c).transpose(0, 2, 1, 3, 4)
    tiles = tiles.reshape(gh * gw, tile, tile, c).astype(np.float32)
    if tiles.max() > 1.5:
        tiles /= 255.0
    return tiles


def load_grid(path: str, tile: int = 32, grayscale: bool = False) -> np.ndarray:
    """Load a grid image file and slice it into sample tiles."""
    from PIL import Image

    im = Image.open(path)
    im = im.convert("L" if grayscale else "RGB")
    return slice_grid(np.asarray(im), tile)


def build_store_from_grid(
    grid_path: str, out_path: str, tile: int = 32, out_size: int = 64
) -> str:
    """Slice a published sample grid into a packed training store
    (``python -m facegen_torch.eval.refgrid --grid G --out S``).

    Turns e.g. the reference's `images/color_random1024.jpg` (1024
    random samples of its trained model, README.md:11-23) into the
    (N, 64, 64, 3) uint8 .npy store the data pipeline trains from
    (data/lfw.py:build_dataset format) — the route to an
    apples-to-apples quality comparison: train on the
    reference's own face distribution, then score both sample
    populations against that shared training set (eval/parity.py).

    Tiles are upsampled tile->out_size with PIL bilinear, matching the
    dataset.lua:90 image.load+scale route every stored image later
    takes back down to the training scale.
    """
    import os

    from PIL import Image

    tiles = load_grid(grid_path, tile)  # (N, tile, tile, C) float [0,1]
    n = tiles.shape[0]
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    for i in range(n):
        im = Image.fromarray(
            np.clip(tiles[i] * 255.0 + 0.5, 0, 255).astype(np.uint8)
        ).convert("RGB")
        out[i] = np.asarray(
            im.resize((out_size, out_size), Image.BILINEAR)
        )
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.save(out_path, out)
    return out_path


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="slice a published sample grid into a packed "
                    "(N, 64, 64, 3) uint8 training store")
    p.add_argument("--grid", required=True, help="grid image path")
    p.add_argument("--out", default="dataset/refgrid64.npy")
    p.add_argument("--tile", type=int, default=32)
    args = p.parse_args(argv)
    out = build_store_from_grid(args.grid, args.out, args.tile)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
