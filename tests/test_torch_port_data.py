"""facegen_torch's augmentation and epoch pools against facegen's.

facegen's own draws (sample_affine_params on its key) are injected into
the port, so both packages warp with the same parameters. The inverse
affine matrices and the bilinear warp agree to 1e-5 (fp32 rounding of
the same formulas; the warp gathers the same four corners); a pool with
augmentation, which ends in a resize and a rounding to uint8, agrees
within one uint8 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facegen.data import augment as jax_aug
from facegen.data.pipeline import prepare_pool as jax_prepare_pool
from facegen.data.synthetic import synthetic_faces as jax_synthetic_faces
from facegen_torch.data import augment as aug
from facegen_torch.data.pipeline import DataSource, prepare_pool

TOL = 1e-5


def _jax_params(key, n, cfg=jax_aug.AugmentConfig()):
    params = jax_aug.sample_affine_params(key, n, cfg)
    return params, {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


@pytest.mark.parametrize("h,w", [(64, 48), (33, 20)])
def test_inverse_affine_matrices_match_jax(h, w):
    params, ours = _jax_params(jax.random.key(0), 16)
    np.testing.assert_allclose(aug.inverse_affine_matrices(ours, h, w).numpy(),
                               np.asarray(jax_aug.inverse_affine_matrices(params, h, w)),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("h,w,c", [(64, 64, 3), (20, 28, 1)])
def test_warp_bilinear_matches_jax(h, w, c):
    images = np.random.RandomState(1).rand(6, h, w, c).astype(np.float32)
    params, _ = _jax_params(jax.random.key(2), 6, jax_aug.AugmentConfig(rotation_deg=30.0))
    mats = np.array(jax_aug.inverse_affine_matrices(params, h, w))
    ours = aug.warp_bilinear(torch.from_numpy(images), torch.from_numpy(mats)).numpy()
    theirs = np.asarray(jax_aug.warp_bilinear(jnp.asarray(images), jnp.asarray(mats)))
    assert (theirs == 0).any()  # some corners fall outside: the zero border is exercised
    np.testing.assert_allclose(ours, theirs, rtol=TOL, atol=TOL)


def test_augment_batch_with_injected_params_matches_jax():
    faces = np.array(jax_synthetic_faces(jax.random.key(3), 8))
    key = jax.random.key(4)
    theirs = np.asarray(jax_aug.augment_batch(key, jnp.asarray(faces)))
    # augment_batch draws its params from the first half of its key
    _, params = _jax_params(jax.random.split(key)[0], 8)
    ours = aug.augment_batch(torch.from_numpy(faces), params).numpy()
    assert ours.dtype == np.float32 and ours.shape == faces.shape
    np.testing.assert_allclose(ours, theirs, rtol=TOL, atol=TOL)


def test_sampled_params_have_facegens_ranges():
    p = aug.sample_affine_params(torch.Generator().manual_seed(0), 4096)
    assert p["flip"].dtype == torch.bool and 0.45 < p["flip"].float().mean() < 0.55
    assert 0.82 <= float(p["scale"].min()) and float(p["scale"].max()) <= 1.10
    assert float(p["rot"].abs().max()) <= 8.0 * np.pi / 180
    assert float(p["trans"].abs().max()) <= 5.0 and p["trans"].shape == (4096, 2)
    assert float(p["trans"][:, 1].abs().max()) > 4.9  # y drawn over the x range
    assert 0.9 <= float(p["bright"].min()) and float(p["bright"].max()) <= 1.1


@pytest.mark.parametrize("scale,channels", [(32, 3), (16, 1)])
def test_augmented_pool_within_one_step_of_jax(scale, channels):
    faces = np.array(jax_synthetic_faces(jax.random.key(5), 8))
    key = jax.random.key(6)
    theirs = np.asarray(jax_prepare_pool(jnp.asarray(faces), key, scale, channels, True))
    _, params = _jax_params(jax.random.split(key)[0], 8)
    ours = prepare_pool(torch.from_numpy(faces), scale, channels, params).numpy()
    assert ours.dtype == np.uint8 and ours.shape == theirs.shape
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1


def test_store_pool_draws_rows_with_replacement_and_augments():
    store = torch.from_numpy(np.array(jax_synthetic_faces(jax.random.key(7), 16)))
    src = DataSource(32, 3, torch.device("cpu"), store=store)
    pool = src.epoch_pool(torch.Generator().manual_seed(0), 40)
    assert pool.dtype == torch.uint8 and pool.shape == (40, 32, 32, 3)
    # the pool is the epoch's rows augmented with the draws that follow them
    gen = torch.Generator().manual_seed(0)
    raw = src.raw_batch(gen, 40)
    assert torch.equal(pool, prepare_pool(raw, 32, 3, aug.sample_affine_params(gen, 40)))
    # without augmentation every drawn row is a resized store row
    rows = prepare_pool(store, 32, 3)
    plain = prepare_pool(raw, 32, 3)
    assert all(any(torch.equal(img, r) for r in rows) for img in plain)
    assert not torch.equal(pool, plain)
    synthetic = DataSource(16, 1, torch.device("cpu")).epoch_pool(
        torch.Generator().manual_seed(1), 5)
    assert synthetic.shape == (5, 16, 16, 1)
