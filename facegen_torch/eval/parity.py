"""Quality-parity report (counterpart of facegen/eval/parity.py).

The reference's quality evidence is behavioural: sample.lua:80-98 ranks
1024 generated images by D's score, and sample.lua:133-151 pairs the best
with their nearest training images by L2 distance. This module turns
those behaviours into numbers for one or two checkpoints, as facegen's
report does, key for key:

(a) **D-score rank correlation**: Spearman's rho between two
    discriminators' scores on a shared pool of real and generated images;
(b) **NN-distance distribution parity**: each generated image's least L2
    distance to the training set (one product and a top-k on the device,
    utils/infer.py), two populations compared by a two-sample KS test;
(c) **Fréchet distance** between populations in D's penultimate features
    (and, for a raw sample population, in pixel space).

Every draw can be injected: the noise of each G, the real images'
permutation and the calibration's permutation. Otherwise they come from
``generator`` (a CPU ``torch.Generator``; the CLI seeds it with
``--seed``), in the order noise A, noise B, permutation. torch's Philox
is not JAX's threefry, so a report of the port does not equal facegen's
for the same seed; the tests inject facegen's draws to compare them.

CLI (cuda:0; ``main(argv, device="cpu")`` for the CPU):
    python -m facegen_torch.eval.parity --network_a logs_a/adversarial \\
        --network_b logs_b/adversarial --n 1024 --out parity.json
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facegen_torch.utils.infer import GanInference, nearest_neighbours, prepare_nn_dataset

# ---------------------------------------------------------------------------
# statistics (host-side, numpy; facegen/eval/parity.py:52-149, bit-equal)
# ---------------------------------------------------------------------------


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties averaged), 1-based — matches scipy.rankdata."""
    x = np.asarray(x, np.float64)
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), np.float64)
    sx = x[order]
    i = 0
    while i < len(x):
        j = i
        while j + 1 < len(x) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation (Pearson on average ranks)."""
    ra, rb = _rankdata(a), _rankdata(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else 0.0


def ks_2samp(a: np.ndarray, b: np.ndarray) -> Tuple[float, float]:
    """Two-sample KS statistic + asymptotic p-value (scipy-compatible on
    the statistic; p-value via the Kolmogorov asymptotic series)."""
    a = np.sort(np.asarray(a, np.float64))
    b = np.sort(np.asarray(b, np.float64))
    na, nb = len(a), len(b)
    both = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, both, side="right") / na
    cdf_b = np.searchsorted(b, both, side="right") / nb
    d = float(np.abs(cdf_a - cdf_b).max())
    en = np.sqrt(na * nb / (na + nb))
    t = (en + 0.12 + 0.11 / en) * d
    # Kolmogorov survival series
    p = 2.0 * sum((-1.0) ** (k - 1) * np.exp(-2.0 * (k * t) ** 2)
                  for k in range(1, 101))
    return d, float(min(max(p, 0.0), 1.0))


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray,
                     eps: float = 1e-6) -> float:
    """Gaussian Fréchet distance between two feature populations:
    ||mu_a - mu_b||^2 + tr(Ca + Cb - 2 (Ca Cb)^(1/2)), the square root's
    trace from an eigendecomposition of a symmetric product."""
    a = np.asarray(feats_a, np.float64)
    b = np.asarray(feats_b, np.float64)
    mu_a, mu_b = a.mean(0), b.mean(0)
    diff = mu_a - mu_b
    dim = a.shape[1]
    if min(a.shape[0], b.shape[0]) < dim:
        # n < dim (pixel Fréchet): the nonzero eigenvalues of Ca Cb are
        # those of (Xa Xb^T)(Xb Xa^T) for the centred, scaled samples, so
        # tr sqrt(Ca Cb) comes from one eigvalsh of the smaller side's
        # Gram; no inverse is taken, so the eps ridge is not needed
        xa = (a - mu_a) / np.sqrt(max(a.shape[0] - 1, 1))
        xb = (b - mu_b) / np.sqrt(max(b.shape[0] - 1, 1))
        if xb.shape[0] < xa.shape[0]:
            xa, xb = xb, xa
        m = xa @ xb.T                      # (n_small, n_large)
        w = np.clip(np.linalg.eigvalsh(m @ m.T), 0.0, None)
        tr_sqrt = float(np.sqrt(w).sum())
        tr_ca = float(np.sum(xa * xa))
        tr_cb = float(np.sum(xb * xb))
        return float(diff @ diff + tr_ca + tr_cb - 2.0 * tr_sqrt)
    ca = np.cov(a, rowvar=False) + eps * np.eye(a.shape[1])
    cb = np.cov(b, rowvar=False) + eps * np.eye(b.shape[1])
    # sqrtm(ca @ cb) has the trace of sqrtm(sa @ cb @ sa), sa = sqrtm(ca),
    # which is symmetric PSD, so eigh is stable
    wa, va = np.linalg.eigh(ca)
    wa = np.clip(wa, 0.0, None)
    sa = (va * np.sqrt(wa)) @ va.T
    m = sa @ cb @ sa
    wm = np.clip(np.linalg.eigvalsh(m), 0.0, None)
    tr_sqrt = float(np.sqrt(wm).sum())
    return float(diff @ diff + np.trace(ca) + np.trace(cb) - 2.0 * tr_sqrt)


# ---------------------------------------------------------------------------
# device-side measurement primitives
# ---------------------------------------------------------------------------


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _unit_images(images) -> np.ndarray:
    """fp32 images in [0, 1] on the host (uint8 scaled, as facegen does)."""
    arr = np.asarray(images, np.float32)
    return arr / 255.0 if arr.max() > 1.5 else arr


@torch.no_grad()
def d_penultimate_features(d: nn.Module, images, batch: int = 256,
                           compute_dtype: torch.dtype = torch.bfloat16) -> np.ndarray:
    """(n, H, W, C) images -> (n, F) fp32 features on the host: the input
    of D's last child (the 512-wide input of D32b's fc_out,
    models.lua:411-413), D in eval mode, in fixed batches of ``batch``
    with the last one zero-padded, as facegen runs them."""
    children = list(d.children())
    if len(children) < 2:
        raise ValueError("the discriminator must be a sequential")
    d.eval()
    device = next(d.parameters()).device
    imgs = _tensor(images).float()
    out = []
    for s in range(0, imgs.shape[0], batch):
        chunk = imgs[s : s + batch]
        pad = batch - chunk.shape[0]
        if pad:
            chunk = torch.cat([chunk, chunk.new_zeros((pad,) + tuple(chunk.shape[1:]))])
        h = chunk.to(device, compute_dtype)
        for m in children[:-1]:
            h = m(h)
        feats = h.float().cpu().numpy()
        out.append(feats[: batch - pad] if pad else feats)
    return np.concatenate(out)


def min_nn_distances(images, train_set, batch: int = 1024) -> np.ndarray:
    """Least L2 distance from each image to the training set
    (sample.lua:140-146, approxParzen's adversarial_c2f.lua:316-327), one
    product and top-k per batch. ``train_set``: a 2-D tensor from
    ``prepare_nn_dataset`` (held on its device), or images, prepared on
    the images' device."""
    imgs = _tensor(images)
    df = (train_set if torch.is_tensor(train_set) and train_set.dim() == 2
          else prepare_nn_dataset(train_set, imgs.device))
    dists = []
    for s in range(0, imgs.shape[0], batch):
        _, dist = nearest_neighbours(imgs[s : s + batch], df, k=1)
        dists.append(dist[:, 0])
    return np.concatenate(dists)


def train_set_nn_calibration(train_images, perm=None, device="cpu") -> Dict:
    """The training set's own nearest-neighbour spacing, the yardstick for
    generated samples' NN distances (~0 is memorisation, far above p90 is
    off-distribution): **half-vs-half**, each image of one random half
    against the other half, and **leave-one-out**, a k=2 self-search whose
    first neighbour is the image itself. ``perm``: the halves'
    permutation; by default drawn from a generator seeded 0, as facegen
    draws it from key 0 whatever the report's seed."""
    train_np = _unit_images(train_images)
    flat = torch.as_tensor(train_np.reshape(len(train_np), -1)).to(device)

    _, d2 = nearest_neighbours(flat, flat, k=2)
    loo = d2[:, 1]

    if perm is None:
        perm = torch.randperm(len(flat), generator=torch.Generator().manual_seed(0))
    perm = _tensor(perm).to(device=flat.device, dtype=torch.long)
    h = len(flat) // 2
    _, dab = nearest_neighbours(flat[perm[:h]], flat[perm[h : 2 * h]], k=1)
    hvh = dab[:, 0]

    def _stats(x: np.ndarray) -> Dict:
        return {"mean": float(x.mean()),
                "p10": float(np.percentile(x, 10)),
                "p90": float(np.percentile(x, 90))}

    return {"nn_half_vs_half": _stats(hvh), "nn_leave_one_out": _stats(loo)}


# ---------------------------------------------------------------------------
# the reports
# ---------------------------------------------------------------------------


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def parity_report(
    g_a: nn.Module, d_a: nn.Module, g_b: nn.Module, d_b: nn.Module,
    train_images,
    n_samples: int = 1024,
    noise_dim_a: int = 100,
    noise_dim_b: int = 100,
    generator: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    label_a: str = "a",
    label_b: str = "b",
    noise_a=None,
    noise_b=None,
    real_perm=None,
) -> Dict:
    """The three parity statistics between two GANs, each G called once
    on ``n_samples`` noise vectors. ``train_images``: (N, H, W, C) in
    [0, 1] or uint8, the training distribution both are measured against.
    ``noise_a``, ``noise_b`` and ``real_perm`` (a permutation of the N
    training images) are drawn from ``generator`` when not given."""
    gen = _generator(generator)
    inf_a = GanInference(g_a, d_a, noise_dim_a, compute_dtype)
    inf_b = GanInference(g_b, d_b, noise_dim_b, compute_dtype)
    dev = inf_a.device
    if noise_a is None:
        noise_a = inf_a.noise(gen, n_samples)
    if noise_b is None:
        noise_b = inf_b.noise(gen, n_samples)
    samples_a = inf_a.generate(_tensor(noise_a))
    samples_b = inf_b.generate(_tensor(noise_b)).to(dev)

    train_np = _unit_images(train_images)
    # (a) rank correlation on a shared pool: half real, a quarter from
    # each G, the population sample.lua:84-89 ranks
    n_real = min(n_samples, train_np.shape[0])
    if real_perm is None:
        real_perm = torch.randperm(train_np.shape[0], generator=gen)
    real = torch.as_tensor(train_np[np.asarray(real_perm)[:n_real]]).to(dev)
    quarter = max(n_samples // 4, 1)
    shared = torch.cat([real[: n_samples // 2], samples_a[:quarter], samples_b[:quarter]])
    scores_a = inf_a.score(shared).cpu().numpy()
    scores_b = inf_b.score(shared).cpu().numpy()
    rho = spearman(scores_a, scores_b)

    # (b) NN-distance distributions
    df = prepare_nn_dataset(train_np, dev)
    nn_a = min_nn_distances(samples_a, df)
    nn_b = min_nn_distances(samples_b, df)
    ks_stat, ks_p = ks_2samp(nn_a, nn_b)

    # (c) Fréchet distance in one embedding, D_a's penultimate features
    feats_real = d_penultimate_features(d_a, real, compute_dtype=compute_dtype)
    feats_a = d_penultimate_features(d_a, samples_a, compute_dtype=compute_dtype)
    feats_b = d_penultimate_features(d_a, samples_b, compute_dtype=compute_dtype)
    fd_a_real = frechet_distance(feats_a, feats_real)
    fd_b_real = frechet_distance(feats_b, feats_real)
    fd_a_b = frechet_distance(feats_a, feats_b)

    return {
        "n_samples": int(n_samples),
        "labels": [label_a, label_b],
        "rank_correlation": {
            "spearman_rho": rho,
            "pool": "50% real + 25% from each G",
            "pool_size": int(shared.shape[0]),
        },
        "nn_distance": {
            f"mean_{label_a}": float(nn_a.mean()),
            f"mean_{label_b}": float(nn_b.mean()),
            f"std_{label_a}": float(nn_a.std()),
            f"std_{label_b}": float(nn_b.std()),
            "ks_stat": ks_stat,
            "ks_pvalue": ks_p,
        },
        "frechet_d_features": {
            f"{label_a}_vs_real": fd_a_real,
            f"{label_b}_vs_real": fd_b_real,
            f"{label_a}_vs_{label_b}": fd_a_b,
        },
        "parity": {
            # rank order agreement: rho >= 0.7 is "same ranking behaviour"
            "rank_parity": bool(rho >= 0.7),
            # the same NN-distance distribution at the 1 % level, or close
            # enough in KS distance
            "nn_parity": bool(ks_p >= 0.01 or ks_stat <= 0.15),
        },
    }


def sample_report(
    g_a: nn.Module, d_a: nn.Module,
    samples_b,
    train_images=None,
    n_samples: Optional[int] = None,
    noise_dim: int = 100,
    generator: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    label_a: str = "ours",
    label_b: str = "reference",
    noise=None,
    calib_perm=None,
) -> Dict:
    """G_a against a raw sample population (no second checkpoint), e.g.
    the reference's published grid sliced by eval/refgrid.py: D_a's score
    distributions (KS), Fréchet distances in D_a's penultimate features
    and in pixel space (independent of the measuring checkpoint, whose D
    goes blunt at its 0.5 equilibrium), pixel moments; with
    ``train_images`` also the NN-distance KS, the training set's own
    spacing (``calib_perm``: the calibration's permutation) and each
    population's distances to real images. ``noise`` is drawn from
    ``generator`` when not given."""
    sb = _unit_images(samples_b)
    n = int(n_samples or sb.shape[0])
    inf_a = GanInference(g_a, d_a, noise_dim, compute_dtype)
    dev = inf_a.device
    if noise is None:
        noise = inf_a.noise(_generator(generator), n)
    sa_t = inf_a.generate(_tensor(noise))
    sb_t = torch.as_tensor(sb).to(dev)
    sa = sa_t.cpu().numpy()

    scores_a = inf_a.score(sa_t).cpu().numpy()
    scores_b = inf_a.score(sb_t).cpu().numpy()
    ks_score, ks_score_p = ks_2samp(scores_a, scores_b)

    feats_a = d_penultimate_features(d_a, sa_t, compute_dtype=compute_dtype)
    feats_b = d_penultimate_features(d_a, sb_t, compute_dtype=compute_dtype)
    px_a = sa.reshape(len(sa), -1)
    px_b = sb.reshape(len(sb), -1)
    report: Dict = {
        "n_samples": {label_a: int(sa.shape[0]), label_b: int(sb.shape[0])},
        "labels": [label_a, label_b],
        "d_score": {
            f"mean_{label_a}": float(scores_a.mean()),
            f"mean_{label_b}": float(scores_b.mean()),
            "ks_stat": ks_score,
            "ks_pvalue": ks_score_p,
        },
        "frechet_d_features": {f"{label_a}_vs_{label_b}":
                               frechet_distance(feats_a, feats_b)},
        "frechet_pixels": {f"{label_a}_vs_{label_b}":
                           frechet_distance(px_a, px_b)},
        "pixel_moments": {
            f"mean_{label_a}": [float(v) for v in sa.mean(axis=(0, 1, 2))],
            f"mean_{label_b}": [float(v) for v in sb.mean(axis=(0, 1, 2))],
            f"std_{label_a}": [float(v) for v in sa.std(axis=(0, 1, 2))],
            f"std_{label_b}": [float(v) for v in sb.std(axis=(0, 1, 2))],
        },
    }
    if train_images is not None:
        train_np = _unit_images(train_images)
        df = prepare_nn_dataset(train_np, dev)
        nn_a = min_nn_distances(sa_t, df)
        nn_b = min_nn_distances(sb_t, df)
        ks_stat, ks_p = ks_2samp(nn_a, nn_b)
        report["nn_distance"] = {
            f"mean_{label_a}": float(nn_a.mean()),
            f"mean_{label_b}": float(nn_b.mean()),
            "ks_stat": ks_stat,
            "ks_pvalue": ks_p,
        }
        report["calibration"] = {
            "note": "the train set's own nearest-neighbour spacings — "
                    "the yardstick for mean NN distances above (~0 = "
                    "memorizing; far above p90 = off-distribution)",
            **train_set_nn_calibration(train_np, perm=calib_perm, device=dev),
        }
        n_real = min(n, train_np.shape[0])
        feats_real = d_penultimate_features(d_a, train_np[:n_real],
                                            compute_dtype=compute_dtype)
        report["frechet_d_features"][f"{label_a}_vs_real"] = (
            frechet_distance(feats_a, feats_real))
        report["frechet_d_features"][f"{label_b}_vs_real"] = (
            frechet_distance(feats_b, feats_real))
        px_real = train_np[:n_real].reshape(n_real, -1)
        report["frechet_pixels"][f"{label_a}_vs_real"] = (
            frechet_distance(px_a, px_real))
        report["frechet_pixels"][f"{label_b}_vs_real"] = (
            frechet_distance(px_b, px_real))
    return report


def self_report(
    g: nn.Module, d: nn.Module, train_images,
    n_samples: int = 1024, noise_dim: int = 100,
    generator: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    noise=None,
) -> Dict:
    """One checkpoint's report: NN-distance statistics of its samples
    against the training set (approxParzen's scalar,
    adversarial_c2f.lua:329-331) and its Fréchet distance to real images.
    ``noise`` is drawn from ``generator`` when not given."""
    inf = GanInference(g, d, noise_dim, compute_dtype)
    if noise is None:
        noise = inf.noise(_generator(generator), n_samples)
    samples = inf.generate(_tensor(noise))
    train_np = _unit_images(train_images)
    nn_d = min_nn_distances(samples, prepare_nn_dataset(train_np, inf.device))
    n_real = min(n_samples, train_np.shape[0])
    feats_real = d_penultimate_features(d, train_np[:n_real], compute_dtype=compute_dtype)
    feats = d_penultimate_features(d, samples, compute_dtype=compute_dtype)
    return {
        "n_samples": int(n_samples),
        "nn_distance": {"mean": float(nn_d.mean()), "std": float(nn_d.std()),
                        "min": float(nn_d.min()), "max": float(nn_d.max())},
        "frechet_vs_real": frechet_distance(feats, feats_real),
    }


def report_diffs(ours: Dict, ref: Dict, n: int, path: str = "") -> list:
    """Where report ``ours`` departs from ``ref`` (the same report from
    another device or package on the same draws) by more than fp32
    rounding of the features and distances can move it: every float 1e-3
    relative (means, spreads, percentiles, Fréchet distances), the KS
    statistic 1/n (one of n samples crossing another), Spearman's rho
    1e-2 (adjacent ranks swapping where two scores nearly tie), the KS
    p-value only where the statistics agree; keys and everything else
    equal. Returns (path, ours, ref) triples; empty when they agree."""
    if not isinstance(ours, dict) or ours.keys() != ref.keys():
        return [(path, sorted(ours) if isinstance(ours, dict) else ours, sorted(ref))]
    out = []
    for k, r in ref.items():
        o, where = ours[k], f"{path}/{k}"
        if isinstance(r, dict):
            out += report_diffs(o, r, n, where)
        elif k == "ks_stat":
            out += [(where, o, r)] if abs(o - r) > 1.0 / n + 1e-12 else []
        elif k == "ks_pvalue":
            same = abs(ours["ks_stat"] - ref["ks_stat"]) <= 1e-12
            out += [(where, o, r)] if same and abs(o - r) > 1e-6 * abs(r) + 1e-12 else []
        elif k == "spearman_rho":
            out += [(where, o, r)] if abs(o - r) > 1e-2 else []
        elif isinstance(r, float) or (isinstance(r, list) and r and isinstance(r[0], float)):
            pairs = zip(o, r) if isinstance(r, list) else [(o, r)]
            bad = (isinstance(r, list) and len(o) != len(r)) or any(
                not np.isfinite(a) or abs(a - b) > 1e-3 * abs(b) for a, b in pairs)
            out += [(where, o, r)] if bad else []
        elif o != r:
            out.append((where, o, r))
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def to_scale(samples: np.ndarray, scale: int) -> np.ndarray:
    """(n, s, s, C) -> (n, scale, scale, C): the load-time bilinear resize
    every training image takes (dataset.lua:90-95). facegen's
    jax.image.resize(method="linear") widens its triangle kernel by the
    factor on a downscale; torch's bilinear with antialias=True does the
    same."""
    x = torch.from_numpy(np.ascontiguousarray(samples, np.float32)).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(scale, scale), mode="bilinear", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1).contiguous().numpy()


def _load_train_images(args, device) -> np.ndarray:
    """``--n_train`` training images at the checkpoint's scale and
    channels, uint8 on the host: synthetic faces from a generator seeded 0
    (facegen's key 0), or the packed store's first rows; resized on
    ``device``, without augmentation."""
    from facegen_torch.data.pipeline import prepare_pool

    if args.synthetic:
        from facegen_torch.data.synthetic import draw_synthetic_faces

        raw = draw_synthetic_faces(torch.Generator().manual_seed(0), args.n_train)
    else:
        from facegen_torch.data.lfw import default_store_path, load_store

        store = load_store(args.data or default_store_path(False))
        raw = torch.from_numpy(np.array(store[: args.n_train]))
    channels = 1 if args.grayscale else 3
    return prepare_pool(raw.to(device), args.scale, channels).cpu().numpy()


def main(argv=None, device=None) -> Dict:
    """``python -m facegen_torch.eval.parity``: facegen's flags; runs on
    cuda:0 and exits without a CUDA GPU. ``device`` lets the tests run it
    on the CPU. Prints the JSON report (and writes it to ``--out``);
    returns it."""
    import argparse

    from facegen_torch.models.gan import restore_gan

    p = argparse.ArgumentParser(
        description="facegen quality-parity report "
                    "(sample.lua:80-98 + adversarial_c2f.lua:305-344 "
                    "statistics, comparable across frameworks)")
    p.add_argument("--network_a", required=True,
                   help="checkpoint A as dir/name (e.g. logs/adversarial)")
    p.add_argument("--network_b", default=None,
                   help="checkpoint B; omit for a single-checkpoint report")
    p.add_argument("--samples_b", default=None,
                   help="grid image of raw samples to compare against "
                        "(e.g. the reference repo's images/"
                        "color_random1024.jpg), sliced at --tile px")
    p.add_argument("--tile", type=int, default=32,
                   help="tile size when slicing --samples_b")
    p.add_argument("--no_train_set", action="store_true",
                   help="with --samples_b: skip train-set statistics "
                        "(use when the raw samples came from a different "
                        "training distribution)")
    # None = take the value from checkpoint A's own meta.json config;
    # explicit flags are checked overrides (models/gan.py:restore_gan)
    p.add_argument("--scale", type=int, default=None)
    p.add_argument("--grayscale", action="store_true", default=None)
    p.add_argument("--noiseDim", type=int, default=None, dest="noise_dim")
    p.add_argument("--n", type=int, default=1024, help="samples per side")
    p.add_argument("--n_train", type=int, default=4096,
                   help="training images to measure against")
    p.add_argument("--synthetic", action="store_true",
                   help="use the procedural face dataset")
    p.add_argument("--data", type=str, default=None,
                   help="packed LFW store path (defaults to the standard one)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", type=str, default=None,
                   help="write the JSON report here as well as stdout")
    args = p.parse_args(argv)
    if device is None:
        from facegen_torch.config import cli_device

        device = cli_device(0, "parity")

    # checkpoint A's stored config resolves any flag left at None
    g_a, d_a, res = restore_gan(args.network_a, "logs", args.scale, args.grayscale,
                                args.noise_dim, device=device)
    args.scale, args.grayscale, args.noise_dim = res["scale"], res["grayscale"], res["noise_dim"]
    train_images = None if (args.samples_b and args.no_train_set) else (
        _load_train_images(args, device))
    gen = torch.Generator().manual_seed(args.seed)
    if args.samples_b:
        from facegen_torch.eval.refgrid import load_grid

        samples_b = load_grid(args.samples_b, args.tile, grayscale=args.grayscale)
        if samples_b.shape[1] != args.scale:
            # published grids are 32px; a 16px checkpoint compares
            # against the same population at its own scale
            samples_b = to_scale(samples_b, args.scale)
        report = sample_report(g_a, d_a, samples_b, train_images, n_samples=args.n,
                               noise_dim=args.noise_dim, generator=gen)
    elif args.network_b:
        # B must agree with A's shapes; A's resolved values as checked
        # overrides make a mismatch an error that names both
        g_b, d_b, _ = restore_gan(args.network_b, "logs", args.scale, args.grayscale,
                                  args.noise_dim, device=device)
        report = parity_report(g_a, d_a, g_b, d_b, train_images, n_samples=args.n,
                               noise_dim_a=args.noise_dim, noise_dim_b=args.noise_dim,
                               generator=gen, label_a="a", label_b="b")
    else:
        report = self_report(g_a, d_a, train_images, n_samples=args.n,
                             noise_dim=args.noise_dim, generator=gen)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return report


if __name__ == "__main__":
    main()
