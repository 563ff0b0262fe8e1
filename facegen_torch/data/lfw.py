"""The packed LFW face store and its builder (counterpart of
facegen/data/lfw.py).

``python -m facegen_torch.data.lfw --path=/path/to/lfw`` walks an LFW
tree (person directories of JPEGs), cuts the fixed lfwcrop face box
x 83..166 / y 92..175 out of every 250x250 original, resizes to 64x64
and packs everything into one (N, 64, 64, 3) uint8 ``.npy``, the store
``--datasetDir`` reads (default ``dataset/lfw64.npy``).

Images are decoded with PIL, imported only inside the functions that
decode, on a thread pool. facegen also has a native libjpeg route for
all-JPEG trees (facegen/native/io.cc); it is not carried: it needs
libjpeg's headers at build time, and the machines the port runs on may
not have them. PIL's route is facegen's own for every other tree, so the
two stores agree byte for byte there, and within the two decoders'
rounding on JPEGs.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

# the fixed crop box of the lfwcrop spec (generate_dataset.py:20-23)
CROP_X0, CROP_Y0 = 83, 92
CROP_X1, CROP_Y1 = 166, 175  # inclusive
SCALE = 64
EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".pgm")


def scan_image_paths(dirs: Sequence[str], exts: Tuple[str, ...] = EXTS) -> List[str]:
    """Every image under ``dirs`` whose lower-cased name ends in one of
    ``exts``, sorted (generate_dataset.py:155-170 walks person
    directories)."""
    out: List[str] = []
    for d in dirs:
        for root, _, files in os.walk(d):
            for f in sorted(files):
                if f.lower().endswith(exts):
                    out.append(os.path.join(root, f))
    out.sort()
    return out


def load_and_crop(path: str, crop: bool = True) -> np.ndarray:
    """Decode one image to RGB; an image large enough for the lfwcrop box
    (a 250x250 LFW original) is cut to it, and anything not 64x64 is then
    resized bilinearly. Returns (64, 64, 3) uint8."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    arr = np.asarray(img, np.uint8)
    if crop and arr.shape[0] >= CROP_Y1 + 1 and arr.shape[1] >= CROP_X1 + 1:
        arr = arr[CROP_Y0: CROP_Y1 + 1, CROP_X0: CROP_X1 + 1]
    if arr.shape[:2] != (SCALE, SCALE):
        img = Image.fromarray(arr).resize((SCALE, SCALE), Image.BILINEAR)
        arr = np.asarray(img, np.uint8)
    return arr


def build_dataset(lfw_dir, out_path: str, limit: Optional[int] = None, workers: int = 8,
                  crop: bool = True, exts: Optional[Sequence[str]] = None) -> str:
    """Write the packed store, (N, 64, 64, 3) uint8, at ``out_path``.

    ``lfw_dir`` is one directory or a list of them (dataset.lua:18-22);
    ``exts`` restricts the extensions scanned, with or without the dot,
    in any case (dataset.lua:28-30); ``limit`` keeps the first paths in
    sorted order. Raises FileNotFoundError when no image is found."""
    from concurrent.futures import ThreadPoolExecutor

    dirs = [lfw_dir] if isinstance(lfw_dir, (str, os.PathLike)) else list(lfw_dir)
    if exts:
        exts = tuple((e if e.startswith(".") else "." + e).lower() for e in exts)
    paths = scan_image_paths(dirs, exts or EXTS)
    if limit:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no images under {lfw_dir!r}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    arr = np.lib.format.open_memmap(out_path, mode="w+", dtype=np.uint8,
                                    shape=(len(paths), SCALE, SCALE, 3))

    def work(i):
        arr[i] = load_and_crop(paths[i], crop=crop)

    # PIL releases the interpreter lock while it decodes and resizes
    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(work, range(len(paths))))
    arr.flush()
    return out_path


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


def main(argv=None) -> str:
    """``python -m facegen_torch.data.lfw``: facegen's flags."""
    import argparse

    p = argparse.ArgumentParser(description="Pack an LFW tree into the uint8 .npy store "
                                            "that --datasetDir reads")
    p.add_argument("--path", required=True, action="append",
                   help="image root directory; repeatable (dataset.lua:18-22)")
    p.add_argument("--out", default="dataset/lfw64.npy")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--no-crop", action="store_true")
    p.add_argument("--ext", action="append", default=None,
                   help="file extension(s) to scan, e.g. --ext jpg (dataset.lua:28-30); "
                        "default: jpg/jpeg/png/ppm/pgm")
    args = p.parse_args(argv)
    out = build_dataset(args.path, args.out, args.limit, args.workers, not args.no_crop,
                        exts=args.ext)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
