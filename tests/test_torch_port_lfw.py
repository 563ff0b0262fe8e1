"""facegen_torch's LFW store builder against facegen's.

Every tree is written here with PIL from numpy content made from a
seed. On a tree that is not all JPEG, facegen decodes with PIL as the
port does, so the stores are byte-equal. On a JPEG tree facegen may take
its native libjpeg route, whose decoder and resize round differently
from PIL's: there the stores agree within 2 per uint8 value and 0.5 on
average (max 1, mean 0.17 measured on 12 such images), and each of the
port's rows is byte-equal to facegen's PIL route (``load_and_crop``).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from facegen.data import lfw as jax_lfw
from facegen_torch.data import lfw

ROOT = Path(__file__).resolve().parents[1]


def _image(rs, h, w):
    """Smooth colour content plus a little noise, like a photo."""
    coarse = rs.rand(h // 10 + 2, w // 10 + 2, 3)
    ys = np.linspace(0, coarse.shape[0] - 1.001, h).astype(int)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w).astype(int)
    img = coarse[ys][:, xs] * 200 + rs.rand(h, w, 3) * 55
    return img.astype(np.uint8)


def _write(path, arr, fmt):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))


def _jpeg_tree(root, seed=0):
    """250x250 originals in nested person directories, a few 64x64 and a
    few small images of other sizes, and upper-case .JPG names."""
    rs = np.random.RandomState(seed)
    for person in ["Ann_A", "Bob_B", "Cid_C"]:
        for k in range(3):
            _write(os.path.join(root, "lfw", person, f"{person}_{k:04d}.jpg"),
                   _image(rs, 250, 250), "JPEG")
    _write(os.path.join(root, "lfw", "Dee_D", "x", "deep_0001.jpeg"), _image(rs, 250, 250), "JPEG")
    for k in range(2):
        _write(os.path.join(root, "small", f"s64_{k}.jpg"), _image(rs, 64, 64), "JPEG")
    _write(os.path.join(root, "small", "s40x50.jpg"), _image(rs, 40, 50), "JPEG")
    _write(os.path.join(root, "small", "s90.jpg"), _image(rs, 90, 90), "JPEG")
    for k in range(2):
        _write(os.path.join(root, "upper", f"U_{k}.JPG"), _image(rs, 250, 250), "JPEG")
    return root


def _png_ppm_tree(root, seed=1):
    rs = np.random.RandomState(seed)
    for person in ["Eve_E", "Fay_F"]:
        for k in range(2):
            _write(os.path.join(root, person, f"{person}_{k}.png"), _image(rs, 250, 250), "PNG")
        _write(os.path.join(root, person, f"{person}_p.ppm"), _image(rs, 250, 250), "PPM")
    _write(os.path.join(root, "misc", "m64.png"), _image(rs, 64, 64), "PNG")
    _write(os.path.join(root, "misc", "m30x44.ppm"), _image(rs, 30, 44), "PPM")
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    return {"jpeg": _jpeg_tree(str(base / "jpeg")), "png": _png_ppm_tree(str(base / "png"))}


def _both(tmp_path, dirs, **kw):
    ours = np.load(lfw.build_dataset(dirs, str(tmp_path / "ours.npy"), workers=3, **kw))
    theirs = np.load(jax_lfw.build_dataset(dirs, str(tmp_path / "theirs.npy"), workers=3, **kw))
    return ours, theirs


@pytest.mark.parametrize("kw", [{}, {"crop": False}, {"limit": 3}, {"exts": ["PPM"]},
                                {"exts": ["png", ".ppm"], "limit": 5}],
                         ids=["default", "no_crop", "limit", "ext_ppm", "ext_both_limit"])
def test_png_ppm_store_is_byte_equal_to_facegen(tmp_path, trees, kw):
    ours, theirs = _both(tmp_path, trees["png"], **kw)
    assert ours.dtype == np.uint8 and ours.shape[1:] == (64, 64, 3)
    assert ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


def test_repeated_paths_stack_like_facegen(tmp_path, trees):
    dirs = [os.path.join(trees["png"], "misc"), os.path.join(trees["png"], "Eve_E")]
    ours, theirs = _both(tmp_path, dirs)
    assert ours.shape[0] == 5
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("crop", [True, False])
def test_jpeg_rows_are_byte_equal_to_facegens_pil_route(tmp_path, trees, crop):
    out = lfw.build_dataset(trees["jpeg"], str(tmp_path / "s.npy"), workers=4, crop=crop)
    store = lfw.load_store(out)
    paths = jax_lfw.scan_image_paths([trees["jpeg"]])
    assert paths == lfw.scan_image_paths([trees["jpeg"]])
    assert store.shape == (len(paths), 64, 64, 3) == (16, 64, 64, 3)
    for row, path in zip(store, paths):
        np.testing.assert_array_equal(row, jax_lfw.load_and_crop(path, crop=crop))


@pytest.mark.parametrize("kw", [{}, {"exts": ["jpg"]}, {"crop": False, "limit": 7}],
                         ids=["default", "ext_jpg", "no_crop_limit"])
def test_jpeg_store_is_close_to_facegens(tmp_path, trees, kw):
    """facegen's store of an all-JPEG tree, through its native decoder
    where that builds, else through PIL."""
    ours, theirs = _both(tmp_path, trees["jpeg"], **kw)
    assert ours.shape == theirs.shape
    diff = np.abs(ours.astype(np.int16) - theirs.astype(np.int16))
    assert diff.max() <= 2 and diff.mean() <= 0.5, (diff.max(), diff.mean())


def test_ext_matches_upper_case_names_like_facegen(tmp_path, trees):
    ours = lfw.build_dataset(trees["jpeg"], str(tmp_path / "a.npy"), exts=["jpg"])
    assert lfw.load_store(ours).shape[0] == 15  # all but the .jpeg, the two .JPG included
    for exts in ([".JPG"], ["jpeg"], ["png"]):
        norm = tuple((e if e.startswith(".") else "." + e).lower() for e in exts)
        assert lfw.scan_image_paths([trees["jpeg"]], norm) == jax_lfw.scan_image_paths(
            [trees["jpeg"]], norm)


def test_empty_tree_raises_like_facegen(tmp_path, trees):
    empty = tmp_path / "empty"
    (empty / "person").mkdir(parents=True)
    for build, name in ((lfw.build_dataset, "a"), (jax_lfw.build_dataset, "b")):
        with pytest.raises(FileNotFoundError, match="no images"):
            build(str(empty), str(tmp_path / f"{name}.npy"))
    with pytest.raises(FileNotFoundError, match="no images"):
        lfw.build_dataset(trees["png"], str(tmp_path / "c.npy"), exts=["gif"])


def test_cli_packs_a_tree_as_facegens_main(tmp_path, trees):
    """``python -m facegen_torch.data.lfw`` with repeated --path, --no-crop
    and --limit writes what facegen's main writes."""
    out = tmp_path / "cli.npy"
    argv = ["--path", os.path.join(trees["png"], "Fay_F"), "--path",
            os.path.join(trees["png"], "misc"), "--no-crop", "--limit", "4", "--workers", "2"]
    run = subprocess.run([sys.executable, "-m", "facegen_torch.data.lfw", *argv,
                          "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    assert f"wrote {out}" in run.stdout
    jax_lfw.main(argv + ["--out", str(tmp_path / "ref.npy")])
    np.testing.assert_array_equal(np.load(out), np.load(tmp_path / "ref.npy"))


def test_missing_store_names_the_ports_builder(tmp_path):
    from facegen_torch.config import TrainConfig
    from facegen_torch.data.pipeline import make_source

    cfg = TrainConfig(dataset_dir=str(tmp_path / "none.npy"))
    with pytest.raises(FileNotFoundError, match=r"python -m facegen_torch\.data\.lfw --path="):
        make_source(cfg, "cpu")


def test_store_trains_one_epoch_on_the_cpu(tmp_path, trees):
    from facegen_torch import train

    store = lfw.build_dataset(trees["jpeg"], str(tmp_path / "lfw64.npy"))
    trainer = train.main(["--datasetDir", store, "--save", str(tmp_path / "logs"), "--scale",
                          "16", "--grayscale", "--batchSize", "4", "--N_epoch", "8",
                          "--noiseDim", "8", "--noplot", "--epochs", "1"], device="cpu")
    assert trainer.source.size == 16 and trainer.state.epoch == 2
