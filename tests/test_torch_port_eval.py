"""The port's quality-parity report and reference-grid tools against
facegen's (facegen/eval/parity.py, facegen/eval/refgrid.py), on the CPU.

Every draw of the port is injected from facegen's own jax.random draws:
each G's noise, the real images' permutation and the calibration's.

Tolerances, each with its reason:
- the statistics (ranks, Spearman, KS, Fréchet on both paths): bit-equal,
  the same NumPy code on the same float64 inputs;
- D's penultimate features, fp32: 2e-4 (rtol and atol), the sampler's
  tolerance for the two frameworks' fp32 convs (tests/test_torch_port_sampler.py);
- NN distances and the calibration: 1e-4 relative, one fp32 product
  |q|^2 - 2 q.d + |d|^2 summed in another order;
- the reports, fp32 (``parity.report_diffs``, which the card's checks
  share): means, spreads, percentiles and Fréchet distances within 1e-3
  relative (features within 2e-4 move a Fréchet distance of
  a 16-sample population by about that much); the KS statistic within
  1/n, one sample crossing another; Spearman's rho within 1e-2, a few
  adjacent ranks swapping where two scores agree to the features'
  tolerance; the KS p-value only where the statistics agree;
- the CLI's 32 -> 16 downscale against jax.image.resize: 1e-5, fp32
  sums of the same four to eight weights.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen.data.pipeline import prepare_pool as jax_prepare_pool
from facegen.data.synthetic import synthetic_faces as jax_synthetic_faces
from facegen.eval import parity as jp
from facegen.eval import refgrid as jrefgrid
from facegen.models import gan as jax_gan
from facegen.utils import checkpoint as jax_ckpt
from facegen_torch.eval import parity
from facegen_torch.eval import refgrid
from facegen_torch.models import gan

N, N_TRAIN = 16, 32
CONFIG = {"scale": 32, "grayscale": False, "noise_dim": 100}


def _checkpoint(tmp_path, seed, scale=32):
    """A facegen G + D checkpoint with weights away from init's flat
    output (G's kernels x6, D's x3, G's statistics moved), restored by both
    packages: (facegen's g, d, bundle), (the port's g, d)."""
    _, _, bundle = jax_gan.init_gan(jax.random.key(seed), scale, 3, 100, reference_init=False)
    for net, factor in (("params_g", 6.0), ("params_d", 3.0)):
        bundle[net] = jax.tree_util.tree_map_with_path(
            lambda p, a, f=factor: a * f if str(p[-1].key) == "w" else a, bundle[net])
    bundle["state_g"] = jax.tree.map(lambda a: a * 2.0 + 0.05, bundle["state_g"])
    name = f"gan{seed}_{scale}"
    jax_ckpt.save(str(tmp_path), name, bundle, meta={"config": dict(CONFIG, scale=scale)})
    jg, jd, jbundle, _, _ = jax_gan.restore_gan(name, default_dir=str(tmp_path))
    g, d, _ = gan.restore_gan(name, default_dir=str(tmp_path), device="cpu")
    return (jg, jd, jbundle), (g, d), os.path.join(str(tmp_path), name)


def _faces(seed, n, scale=32):
    """facegen's synthetic faces at ``scale``, uint8."""
    raw = jax_synthetic_faces(jax.random.key(seed), n)
    return np.asarray(jax_prepare_pool(raw, jax.random.key(0), scale, 3, augment=False))


def _uniform(key, n):
    return np.asarray(jax.random.uniform(key, (n, 100), jnp.float32, -1.0, 1.0))


# ---------------------------------------------------------------------------
# statistics: bit-equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_statistics_bit_equal_facegen(seed):
    rs = np.random.RandomState(seed)
    a = rs.normal(size=60)
    b = 0.5 * a + rs.normal(size=60)
    ties = np.round(a * 2) / 2  # ranks with ties
    assert np.array_equal(parity._rankdata(ties), jp._rankdata(ties))
    assert parity.spearman(a, b) == jp.spearman(a, b)
    assert parity.spearman(ties, b) == jp.spearman(ties, b)
    assert parity.ks_2samp(a, b + 0.3) == jp.ks_2samp(a, b + 0.3)
    # the dense path (n >= dim) and the Gram path (n < dim)
    fa, fb = rs.normal(size=(80, 12)), 0.8 * rs.normal(size=(90, 12)) + 0.2
    assert parity.frechet_distance(fa, fb) == jp.frechet_distance(fa, fb)
    ga, gb = rs.normal(size=(20, 50)), 0.7 * rs.normal(size=(30, 50)) + 0.1
    assert parity.frechet_distance(ga, gb) == jp.frechet_distance(ga, gb)
    assert parity.frechet_distance(gb, ga) == jp.frechet_distance(gb, ga)


# ---------------------------------------------------------------------------
# device primitives
# ---------------------------------------------------------------------------


def test_penultimate_features_match_facegen_across_the_padded_batch(tmp_path):
    (_, jd, jbundle), (_, d), _ = _checkpoint(tmp_path, 0)
    images = _faces(3, 20).astype(np.float32) / 255.0
    theirs = jp.d_penultimate_features(jd, jbundle, images, batch=8, compute_dtype="float32")
    ours = parity.d_penultimate_features(d, images, batch=8, compute_dtype=torch.float32)
    assert ours.shape == theirs.shape == (20, 512) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)
    # the zero-padded last batch changes no row
    alone = parity.d_penultimate_features(d, images[16:], batch=8, compute_dtype=torch.float32)
    np.testing.assert_array_equal(alone, ours[16:])


def test_nn_distances_and_calibration_match_facegen():
    train = _faces(4, N_TRAIN)
    queries = np.clip(train[:12] / 255.0 + np.random.RandomState(5).normal(
        0, 0.05, (12, 32, 32, 3)), 0, 1).astype(np.float32)
    theirs = jp.min_nn_distances(queries, train, batch=5)
    ours = parity.min_nn_distances(queries, train, batch=5)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    key = jax.random.key(7)
    perm = np.asarray(jax.random.permutation(key, N_TRAIN))
    j_cal = jp.train_set_nn_calibration(train, key)
    cal = parity.train_set_nn_calibration(train, perm=perm)
    assert cal.keys() == j_cal.keys()
    for view in cal:
        for stat in ("mean", "p10", "p90"):
            assert cal[view][stat] == pytest.approx(j_cal[view][stat], rel=1e-4)
    # the default permutation draws from its own seed, whatever the report's
    assert parity.train_set_nn_calibration(train) == parity.train_set_nn_calibration(train)


# ---------------------------------------------------------------------------
# the reports
# ---------------------------------------------------------------------------


def test_report_diffs_holds_reports_to_the_stated_tolerances():
    ref = {"labels": ["a", "b"], "n_samples": 16, "flag": True,
           "nn_distance": {"mean_a": 2.0, "ks_stat": 0.5, "ks_pvalue": 0.25},
           "rank_correlation": {"spearman_rho": 0.9}, "moments": [1.0, 2.0]}

    def edit(**kw):
        out = json.loads(json.dumps(ref))
        for path, value in kw.items():
            *keys, leaf = path.split("__")
            node = out
            for k in keys:
                node = node[k]
            node[leaf] = value
        return out

    assert parity.report_diffs(ref, ref, 16) == []
    within = edit(nn_distance__mean_a=2.0019, nn_distance__ks_stat=0.5625,
                  nn_distance__ks_pvalue=0.9, rank_correlation__spearman_rho=0.891,
                  moments=[1.0009, 2.0])
    assert parity.report_diffs(within, ref, 16) == []
    for bad, where in ((edit(nn_distance__mean_a=2.003), "/nn_distance/mean_a"),
                       (edit(nn_distance__ks_stat=0.57), "/nn_distance/ks_stat"),
                       (edit(nn_distance__ks_pvalue=0.26), "/nn_distance/ks_pvalue"),
                       (edit(rank_correlation__spearman_rho=0.88),
                        "/rank_correlation/spearman_rho"),
                       (edit(moments=[1.0, float("nan")]), "/moments"),
                       (edit(flag=False), "/flag"), (edit(n_samples=15), "/n_samples")):
        assert [d[0] for d in parity.report_diffs(bad, ref, 16)] == [where]
    missing = edit()
    del missing["nn_distance"]["ks_pvalue"]
    assert [d[0] for d in parity.report_diffs(missing, ref, 16)] == ["/nn_distance"]


def test_parity_report_matches_facegen(tmp_path):
    (jg_a, jd_a, jb_a), (g_a, d_a), _ = _checkpoint(tmp_path, 0)
    (jg_b, jd_b, jb_b), (g_b, d_b), _ = _checkpoint(tmp_path, 1)
    train = _faces(6, N_TRAIN)
    key = jax.random.key(11)
    theirs = jp.parity_report(jg_a, jd_a, jb_a, jg_b, jd_b, jb_b, train, n_samples=N,
                              key=key, compute_dtype="float32")
    k_a, k_b, k_mix = jax.random.split(key, 3)
    ours = parity.parity_report(
        g_a, d_a, g_b, d_b, train, n_samples=N, compute_dtype=torch.float32,
        noise_a=_uniform(k_a, N), noise_b=_uniform(k_b, N),
        real_perm=np.asarray(jax.random.permutation(k_mix, N_TRAIN)))
    assert not parity.report_diffs(ours, theirs, N)
    assert ours["frechet_d_features"]["a_vs_b"] > 0


def test_sample_report_matches_facegen(tmp_path):
    (jg, jd, jb), (g, d), _ = _checkpoint(tmp_path, 2)
    train = _faces(6, N_TRAIN)
    samples_b = _faces(8, 20).astype(np.float32) / 255.0
    key = jax.random.key(12)
    theirs = jp.sample_report(jg, jd, jb, samples_b, train, n_samples=N, key=key,
                              compute_dtype="float32")
    ours = parity.sample_report(
        g, d, samples_b, train, n_samples=N, compute_dtype=torch.float32,
        noise=_uniform(key, N),
        calib_perm=np.asarray(jax.random.permutation(jax.random.key(0), N_TRAIN)))
    assert not parity.report_diffs(ours, theirs, N)
    # without a training set, the report's first four sections alone
    bare = parity.sample_report(g, d, samples_b, n_samples=N, compute_dtype=torch.float32,
                                noise=_uniform(key, N))
    assert set(bare) == {"n_samples", "labels", "d_score", "frechet_d_features",
                         "frechet_pixels", "pixel_moments"}
    assert bare["d_score"] == ours["d_score"]


def test_self_report_matches_facegen(tmp_path):
    (jg, jd, jb), (g, d), _ = _checkpoint(tmp_path, 3)
    train = _faces(6, N_TRAIN)
    key = jax.random.key(13)
    theirs = jp.self_report(jg, jd, jb, train, n_samples=N, key=key, compute_dtype="float32")
    ours = parity.self_report(g, d, train, n_samples=N, compute_dtype=torch.float32,
                              noise=_uniform(key, N))
    assert not parity.report_diffs(ours, theirs, N)


def test_reports_draw_from_the_generator(tmp_path):
    _, (g, d), _ = _checkpoint(tmp_path, 0)
    train = _faces(6, N_TRAIN)

    def run(seed):
        return parity.self_report(g, d, train, n_samples=8, compute_dtype=torch.float32,
                                  generator=torch.Generator().manual_seed(seed))

    assert run(1) == run(1)
    assert run(1) != run(2)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cross_scale_downscale_matches_jax_resize():
    x = np.random.RandomState(9).rand(5, 32, 32, 3).astype(np.float32)
    theirs = np.asarray(jax.image.resize(jnp.asarray(x), (5, 16, 16, 3), method="linear"))
    ours = parity.to_scale(x, 16)
    assert ours.shape == (5, 16, 16, 3)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def _write_grid(path, tiles):
    """Tiles (n, t, t, 3) uint8 laid out row-major on a square grid."""
    n, t = tiles.shape[0], tiles.shape[1]
    side = int(round(n ** 0.5))
    grid = tiles.reshape(side, side, t, t, 3).transpose(0, 2, 1, 3, 4).reshape(
        side * t, side * t, 3)
    Image.fromarray(grid).save(path)


@pytest.mark.parametrize("mode", ["network_b", "samples_b", "self"])
def test_cli_runs_each_mode_with_facegens_keys(tmp_path, mode, capsys):
    from facegen.eval.parity import main as jax_main

    _, _, net_a = _checkpoint(tmp_path, 0, scale=16 if mode == "samples_b" else 32)
    _, _, net_b = _checkpoint(tmp_path, 1)
    store = str(tmp_path / "store.npy")
    np.save(store, np.asarray(jax_synthetic_faces(jax.random.key(20), 24)))
    argv = ["--network_a", net_a, "--n", "8", "--n_train", "24", "--data", store]
    if mode == "network_b":
        argv += ["--network_b", net_b]
    elif mode == "samples_b":  # a 32px grid against a 16px checkpoint
        grid = str(tmp_path / "grid.png")
        _write_grid(grid, _faces(21, 16))
        argv += ["--samples_b", grid]
    out = str(tmp_path / "ours.json")
    report = parity.main(argv + ["--out", out], device="cpu")
    with open(out) as f:
        assert json.load(f) == report
    assert json.loads(capsys.readouterr().out) == report
    jax_main(argv + ["--out", str(tmp_path / "theirs.json")])
    with open(tmp_path / "theirs.json") as f:
        theirs = json.load(f)

    def shape(r):
        return {k: shape(v) if isinstance(v, dict) else type(v).__name__ for k, v in r.items()}

    assert shape(report) == shape(theirs)

    def numbers(r):
        for v in r.values():
            if isinstance(v, dict):
                yield from numbers(v)
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                yield v
            elif isinstance(v, list) and v and not isinstance(v[0], str):
                yield from v

    assert all(np.isfinite(v) for v in numbers(report))
    if mode == "samples_b":
        assert report["n_samples"] == {"ours": 8, "reference": 16}


def test_cli_checks_b_against_a_and_needs_a_gpu(tmp_path, monkeypatch):
    _, _, net_a = _checkpoint(tmp_path, 0, scale=16)
    _, _, net_b = _checkpoint(tmp_path, 1)
    with pytest.raises(ValueError, match="scale=32"):
        parity.main(["--network_a", net_a, "--network_b", net_b, "--synthetic", "--n", "4",
                     "--n_train", "8"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        parity.main(["--network_a", net_a])
    assert "no CUDA GPU" in str(e.value.code)


# ---------------------------------------------------------------------------
# refgrid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile,grayscale", [(32, False), (16, False), (16, True)])
def test_refgrid_byte_equal_facegen(tmp_path, tile, grayscale):
    rs = np.random.RandomState(tile)
    image = rs.randint(0, 256, (3 * tile, 2 * tile, 3)).astype(np.uint8)
    assert refgrid.slice_grid(image, tile).tobytes() == jrefgrid.slice_grid(image, tile).tobytes()
    path = str(tmp_path / "grid.png")
    Image.fromarray(image).save(path)
    ours = refgrid.load_grid(path, tile, grayscale=grayscale)
    assert ours.tobytes() == jrefgrid.load_grid(path, tile, grayscale=grayscale).tobytes()
    assert ours.shape == (6, tile, tile, 1 if grayscale else 3)
    if grayscale:
        return
    refgrid.build_store_from_grid(path, str(tmp_path / "ours.npy"), tile)
    jrefgrid.build_store_from_grid(path, str(tmp_path / "theirs.npy"), tile)
    with open(tmp_path / "ours.npy", "rb") as a, open(tmp_path / "theirs.npy", "rb") as b:
        assert a.read() == b.read()


def test_refgrid_cli_writes_a_store(tmp_path, capsys):
    path = str(tmp_path / "grid.png")
    Image.fromarray(np.random.RandomState(1).randint(0, 256, (64, 64, 3)).astype(
        np.uint8)).save(path)
    refgrid.main(["--grid", path, "--out", str(tmp_path / "s" / "store.npy")])
    store = np.load(tmp_path / "s" / "store.npy")
    assert store.shape == (4, 64, 64, 3) and store.dtype == np.uint8
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(ValueError, match="not divisible"):
        refgrid.slice_grid(np.zeros((40, 32, 3), np.uint8), 32)
