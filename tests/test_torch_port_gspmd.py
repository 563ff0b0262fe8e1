"""The port's 2-D data x model mesh (facegen_torch/parallel/gspmd.py)
against facegen's GSPMD mode (facegen/parallel/gspmd.py), on the CPU.

The ranks are four processes of a gloo group with one thread each,
started once by the module fixture on the programs of
tests/torch_port_gspmd_ranks.py, which import neither JAX nor facegen;
facegen's side is computed here while they run. facegen's Trainer is
not run on a mesh here: its step and epoch factories are.

- The sharding rule: ``leaf_spec`` and ``torch_shard_dim`` against
  facegen's ``_leaf_spec`` on every leaf of G32, D32b, G16, D16_d, the
  c2f nets, the autoencoder and the denoiser's decoder at mp = 2 and 4;
  each rank's shards of the parameters and of Adam's moments against the
  shards of facegen's ``shard_state`` on ``make_mesh2d``.
- The GAN step: G32 + D32b colour at batch 8 and G16 + D16_d gray at
  batch 16, fp32, 3 steps (gate open, closed, open) at (2, 2), (2, 1) and
  (1, 2), and the first at (3, 1), against facegen's single-device
  ``make_train_step`` on its own draws (tests/test_torch_port_train_step.py's recipe at the global
  batch), and at (2, 2) against ``make_gspmd_step`` on
  ``make_mesh2d(2, 2)``. Tolerances as in tests/test_torch_port_parallel.py:
  losses rtol 1e-4; the parameters' change and Adam's moments 1e-3
  relative l2; batch-norm statistics 1e-5 absolute; the ring, the
  counters and the confusion matrix exactly; the ranks' gathered states
  bit-equal, and the (2, 1) and (1, 2) meshes on ranks 2-3 bit-equal to
  those on ranks 0-1. G16 + D16_d on these single-device draws lands on
  the PReLU kinks of ROADMAP's note: unmoved, the port's own
  single-device step reads 4.3e-2 on D's change and 5.3e-3 on a loss
  against facegen, and near it facegen's own three steps move their
  third G loss by up to 1.5e-4 when D's weights move by one ulp, more
  than the losses' tolerance. So D's weights are moved up by
  ``G16_ULPS`` ulps on both sides, a point where facegen's losses move
  by less than 1e-5 for one ulp either way
  (``test_the_g16_case_is_well_conditioned`` holds that), and its
  changes and moments are held to 5e-3, the margin
  tests/test_torch_port_parallel.py gives this net, and its batch-norm
  statistics to 5e-5.
- Uneven data rows: at (3, 1) a data row holds ceil(B / 3) rows of a
  batch and the last one what is left (``row_block``), as GSPMD pads, so
  G32 + D32b at batch 8 gives the D phase's halves 2, 2 and 0 rows a rank
  and the G phase 3, 3 and 2. G32 + D32b at batch 4 leaves rank 2 with no
  rows in either phase: its 3 steps match facegen's single-device step
  with the same tolerances, and nothing in them is NaN. facegen's own
  GSPMD programs run at (3, 1): make_gspmd_c2f_epoch and the AE and
  denoiser epochs on 8 virtual CPU devices gave the single-device losses
  and a worst leaf 6.1e-6 from them (checked once; no test here runs them),
  and its GAN step's only condition is an even batch of at least 4, which
  the port's 2-D step keeps (the 1-D mesh of local batches keeps
  facegen's shard_map condition; tests/torch_port_gspmd_ranks.py).
- The c2f, autoencoder and denoiser steps: 3 steps at (2, 1), (1, 2) and
  (3, 1) against ``make_epoch_fn``, ``make_ae_epoch`` and
  ``make_denoiser_epoch`` on their draws, with their files' tolerances
  (tests/test_torch_port_c2f.py, tests/test_torch_port_ae.py); at (3, 1)
  the denoiser's validation loss on a 256-row pool against
  ``make_denoiser_val`` within 1e-4 relative.
- The trainer on (2, 2): --epochsPerCompile's message, --weightsVisFreq's
  directories, and its checkpoint resumed on one device, on '2' and by
  facegen. --meshShape 2,1 (G32 + D32b colour, batch 32) on a 61-row
  pool (4 steps; the pool is not a multiple of the data rows) trains
  what one device trains, which '2' does not: the parameters' change and
  the momentum traces within 1e-3 relative l2 of one device's (2.0e-4
  read), the counters equal. The run uses SGD with momentum: with
  Adam, G's batch-norm-fed biases (exact gradient 0) move by lr x the
  sign of their rounding noise, and under --G_L2 the reference's sign
  term flips as those biases cross 0, so two Adam runs drift 2.2e-3 apart
  in 4 steps whatever the mesh.
- Serving 'DP,MP': GanInference over ["cpu"] * 4 in groups of 2 against
  one device within 1e-5, against facegen's GanInference on
  ``make_mesh2d(2, 2)`` within 2e-4, and ``run_sampling`` writing one
  device's grids.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_port_ae as tae
import test_torch_port_c2f as tc2f
import test_torch_port_parallel as tpp
import torch_port_gspmd_ranks as ranks
import torch_port_parallel_ranks as tpr
import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen.config import TrainConfig as JaxTrainConfig
from facegen.models import ae as jax_ae
from facegen.models import c2f as jax_c2f
from facegen.models import gan as jax_gan
from facegen.nn import init as jax_init
from facegen.parallel import make_mesh2d, shard_pool_2d, shard_state
from facegen.parallel.gspmd import _leaf_spec, make_gspmd_step
from facegen.parallel.multihost import hybrid_mesh as jax_hybrid_mesh
from facegen.train import ae_loop as jax_ae_loop
from facegen.train import c2f as jax_train_c2f
from facegen.train.step import init_state as jax_init_state
from facegen.train.step import make_train_step
from facegen.utils import checkpoint as jax_ckpt
from facegen.utils.infer import GanInference as JaxInference
from facegen_torch import sample
from facegen_torch.config import SampleConfig, TrainConfig
from facegen_torch.models import ae, c2f, gan
from facegen_torch.nn import dropout
from facegen_torch.parallel import gspmd
from facegen_torch.train import main as train_main
from facegen_torch.train.ae_loop import AEStep, DenoiserStep
from facegen_torch.train.c2f import C2FStep
from facegen_torch.train.loop import Trainer
from facegen_torch.utils import checkpoint as ckpt
from facegen_torch.utils.infer import GanInference
from torch_port_parallel_ranks import digest

NOISE_DIM, POOL = tpp.NOISE_DIM, tpp.POOL
MESH_NAMES = ("2x2", "2x1a", "1x2a", "3x1")
# the GAN cases and the meshes each runs on: tests/test_torch_port_parallel.py's
# two on the (2, 2), (2, 1) and (1, 2) meshes, G32 + D32b at batch 8 on (3, 1)
# too, and at batch 4, where rank 2 of (3, 1) holds no rows
EVEN = ("2x2", "2x1a", "2x1b", "1x2a", "1x2b")
GAN_CASES = {"g32": (tpp.CASES["g32"], EVEN + ("3x1",)), "g16": (tpp.CASES["g16"], EVEN),
             "g32b4": ((32, 3, 4, {}), ("3x1",))}
# G32 + D32b on g32's inputs with --boundaryPad 8 on (2, 2), where D's first
# conv is sharded over the model axis and gathered before the step pads it
PADDED = {"g32p8": ("g32", dict(boundary_pad=8), ("2x2",))}
SERVE_TOL, JAX_TOL = 1e-5, 2e-4


# ------------------------------------------------------------- the inputs
def _global_draws(rng, bs, specs):
    """facegen's single-device draws of the step keyed ``rng``
    (facegen/train/step.py:269-273, 342-345) under the ranks' .npz names."""
    half = bs // 2
    k_idx, k_noise, _, k_drop = jax.random.split(jax.random.fold_in(rng, 0), 4)
    out = {"d_idx": np.array(jax.random.randint(k_idx, (half,), 0, POOL), np.int64),
           "d_noise": np.array(jax.random.uniform(k_noise, (half, NOISE_DIM), jnp.float32,
                                                  -1.0, 1.0))}
    out.update({f"d_mask/{k}": m for k, m in tpp._masks(k_drop, specs).items()})
    k_noise, _, k_drop = jax.random.split(jax.random.fold_in(rng, 1000), 3)
    out["g_noise"] = np.array(jax.random.uniform(k_noise, (bs, NOISE_DIM), jnp.float32,
                                                 -1.0, 1.0))
    out.update({f"g_mask/{k}": m for k, m in tpp._masks(k_drop, specs).items()})
    return out


# G16 + D16_d's D weights are moved up by this many ulps, off the PReLU
# kinks (module docstring): of the counts 1 to 23, the first at which
# facegen's three steps move their losses by less than 1e-5 for one ulp
# either way and the port's single-device step meets this file's
# tolerances against facegen's
G16_ULPS = 21


def _nudge(tree, ulps):
    """Every leaf of ``tree`` moved by ``ulps`` ulps (down when negative)."""
    towards = np.float32(np.inf if ulps > 0 else -np.inf)

    def move(a):
        a = np.asarray(a)
        for _ in range(abs(ulps)):
            a = np.nextafter(a, towards)
        return jnp.asarray(a)

    return jax.tree.map(move, tree)


def _gan_inputs(work, name, scale, channels, bs, wider):
    jg, jd, bundle, pool = tpp._jax_case(scale, channels, bs, wider)
    if name == "g16":  # off the PReLU kinks (module docstring)
        bundle["params_d"] = _nudge(bundle["params_d"], G16_ULPS)
    sds = ckpt.jax_to_torch(jax_ckpt.flatten_tree(bundle))
    _, d = gan.init_gan(torch.Generator().manual_seed(0), scale, channels, NOISE_DIM,
                        reference_init=False)
    specs = dropout.dropout_mask_specs(d, bs, (scale, scale, channels))
    arrays = {f"{net}/{k}": t.numpy() for net in ("g", "d") for k, t in sds[net].items()}
    arrays["pool"] = pool
    for i in range(3):
        for k, v in _global_draws(jax.random.fold_in(jax.random.key(5), i), bs, specs).items():
            arrays[f"s{i}/{k}"] = v
    np.savez(os.path.join(work, f"{name}.npz"), **arrays)
    return jg, jd, bundle, pool


def _jax_gan_steps(jg, jd, bundle, pool, kw, mesh=None):
    """3 steps of make_train_step, or of make_gspmd_step on ``mesh``: (start,
    end leaves under checkpoint paths, per-step metrics)."""
    jcfg = JaxTrainConfig(**kw).validate()
    state = jax_init_state(jcfg, bundle)
    start = jax_ckpt.flatten_tree(state)
    jpool = jnp.asarray(pool)
    if mesh is None:
        step = jax.jit(make_train_step(jg, jd, jcfg))
    else:
        state, jpool = shard_state(state, mesh), shard_pool_2d(jpool, mesh)
        step = make_gspmd_step(jg, jd, jcfg, mesh, draw_n=POOL)
    k, rows = jcfg.accs_interval, []
    for i in range(3):
        if i > 0:  # a full ring of 1s closes the gate, an empty one opens it
            state = state._replace(accs=jnp.full((k,), 1.0 if i == 1 else 0.0, jnp.float32),
                                   accs_n=jnp.int32(k))
        state, m = step(state, jax.random.fold_in(jax.random.key(5), i), jpool)
        rows.append([float(v) for v in m])
    return start, jax_ckpt.flatten_tree(jax.device_get(state)), rows


def _t2n(sd):
    return {k: t.detach().numpy() for k, t in sd.items()}


def _c2f_inputs(work):
    (jg, jd, jcfg, bundle, jpool), (tcfg, g, d, pool) = tc2f._setup(3, "adam")
    step = C2FStep(tcfg, g, d)
    rng = jax.random.key(5)
    arrays = {**{f"g/{k}": v for k, v in _t2n(g.state_dict()).items()},
              **{f"d/{k}": v for k, v in _t2n(d.state_dict()).items()},
              "fine": pool.fine.numpy(), "coarse": pool.coarse.numpy()}
    for i in range(3):
        (dd,), (gd,) = tc2f._draws(jax.random.fold_in(rng, i), tcfg, pool.size, step)
        for k, v in (("d_real", dd.idx_real), ("d_fake", dd.idx_fake), ("d_noise", dd.noise),
                     ("g_idx", gd.idx), ("g_noise", gd.noise)):
            arrays[f"s{i}/{k}"] = v.numpy()
        for k, v in dd.masks.items():
            arrays[f"s{i}/d_mask/{k}"] = v.numpy()
        for k, v in gd.masks.items():
            arrays[f"s{i}/g_mask/{k}"] = v.numpy()
    np.savez(os.path.join(work, "c2f.npz"), **arrays)
    kw = {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(tcfg).items()}
    return (jg, jd, jcfg, bundle, jpool), kw


def _jax_c2f(jg, jd, jcfg, bundle, jpool):
    jstate = jax_train_c2f.init_c2f_state(jcfg, bundle)
    start = jax_ckpt.flatten_tree(jstate)
    epoch = jax.jit(jax_train_c2f.make_epoch_fn(jg, jd, jcfg, pool_size=jpool.fine.shape[0]))
    jstate, jm = epoch(jstate, jax.random.key(5), jpool)
    rows = [[float(jm.loss_d[i]), float(jm.loss_g[i]), float(jm.acc_d[i])] for i in range(3)]
    return start, jax_ckpt.flatten_tree(jstate), rows


AE_KW = dict(batch_size=tae.BATCH, scale=8, grayscale=True, noise_dim=32)
DEN_KW = dict(batch_size=tae.BATCH, scale=8, grayscale=False)


def _ae_inputs(work):
    """Write the ranks' autoencoder inputs; returns the function that runs
    facegen's epoch on them (start, end leaves, losses)."""
    s, c = 8, 1
    jcfg, tcfg = JaxTrainConfig(**AE_KW), TrainConfig(**AE_KW).validate()
    model = jax_ae.create_autoencoder(s, c, 32)
    params, state, _ = model.init(jax.random.key(9), (s, s, c))
    params = jax_init.gaussian_overwrite(params, jax.random.key(10))
    opt = optax.adam(1e-3).init(params)
    pool, rng = tae._pool(s, c), jax.random.key(11)
    port = tae._carry(ae.create_autoencoder(s, c, 32, generator=tae._gen()), params, state)
    specs = AEStep(tcfg, port).mask_specs
    arrays = {**{f"g/{k}": v for k, v in _t2n(port.state_dict()).items()}, "pool": pool}
    for i, idx in enumerate(tae._perm_batches(rng)):
        arrays[f"s{i}/idx"] = idx.numpy()
        for k, v in tae._masks(jax.random.fold_in(rng, 1 + i), specs).items():
            arrays[f"s{i}/mask/{k}"] = v.numpy()
    np.savez(os.path.join(work, "ae.npz"), **arrays)

    def facegen():
        start = jax_ckpt.flatten_tree({"params": params, "state": state, "opt": opt})
        p1, s1, o1, jl = jax_ae_loop.make_ae_epoch(model, jcfg)(params, state, opt, rng,
                                                                jnp.asarray(pool))
        return start, jax_ckpt.flatten_tree({"params": p1, "state": s1, "opt": o1}), np.asarray(jl)

    return facegen


def _denoiser_inputs(work):
    """Write the ranks' denoiser inputs; returns the function that runs
    facegen's epoch on them (start, end leaves, losses, and the validation
    loss after it on a 256-row pool)."""
    s, c = 8, 3
    jcfg, tcfg = JaxTrainConfig(**DEN_KW), TrainConfig(**DEN_KW).validate()
    enc, dec1, dec2, bundle = tae._jax_denoiser(s, c)
    tx = optax.adam(1e-3)
    opt1, opt2 = tx.init(bundle["AE1_DECODER"]["params"]), tx.init(bundle["AE2_DECODER"]["params"])
    pool, rng = tae._pool(s, c), jax.random.key(13)
    _, tdec1, tdec2 = tae._port_denoiser(bundle, s, c)
    specs = DenoiserStep(tcfg, tdec1).mask_specs
    arrays = {**{f"g/{k}": v for k, v in _t2n(tdec1.state_dict()).items()},
              **{f"d/{k}": v for k, v in _t2n(tdec2.state_dict()).items()}, "pool": pool}
    for i, idx in enumerate(tae._perm_batches(rng)):
        arrays[f"s{i}/idx"] = idx.numpy()
        noise, m1, noise2, m1b, m2 = tae._denoiser_draws(rng, i, s, c, specs)
        arrays[f"s{i}/noise"], arrays[f"s{i}/noise2"] = noise.numpy(), noise2.numpy()
        for tag, masks in (("m1", m1), ("m1b", m1b), ("m2", m2)):
            for k, v in masks.items():
                arrays[f"s{i}/{tag}/{k}"] = v.numpy()
    arrays["val"] = val = np.random.RandomState(17).randint(0, 256, (256, s, s, c)).astype(np.uint8)
    np.savez(os.path.join(work, "denoiser.npz"), **arrays)

    def facegen():
        start = jax_ckpt.flatten_tree(bundle)
        jb, jo1, jo2, jl = jax_ae_loop.make_denoiser_epoch(enc, dec1, dec2, jcfg)(
            bundle, opt1, opt2, rng, jnp.asarray(pool))
        theirs = jax_ckpt.flatten_tree(jb)
        for key, jo in (("AE1_DECODER", jo1), ("AE2_DECODER", jo2)):
            theirs.update({f"{key}/{k}": v for k, v in jax_ckpt.flatten_tree({"opt": jo}).items()})
        jval = float(jax_ae_loop.make_denoiser_val(dec1, jcfg)(jb, jnp.asarray(val)))
        return start, theirs, np.asarray(jl), jval

    return facegen


def _ranks_and_facegen(work):
    """The ranks' programs in one spawn of four processes, started first:
    they wait for each program's inputs as the parent writes them
    (``torch_port_parallel_ranks.wait_for``); facegen's steps and epochs
    computed meanwhile. Returns facegen's side."""
    ctx = ranks.spawn(work, join=False)
    try:
        gan_in, kwargs = {}, {}
        for name, (case, _) in GAN_CASES.items():
            kwargs[name] = tpp._step_kwargs(*case)
            gan_in[name] = _gan_inputs(work, name, *case)
        steps = {name: (kwargs[name], meshes, name) for name, (_, meshes) in GAN_CASES.items()}
        steps.update({name: ({**kwargs[base], **kw}, meshes, base)
                      for name, (base, kw, meshes) in PADDED.items()})
        tpr.publish(work, "gan_steps.json", steps)
        c2f_in, c2f_kw = _c2f_inputs(work)
        ae, denoiser = _ae_inputs(work), _denoiser_inputs(work)
        tpr.publish(work, "family.json", {"c2f": c2f_kw, "ae": AE_KW, "denoiser": DEN_KW})
        side = {"ae": ae(), "denoiser": denoiser()}
        side.update({name: _jax_gan_steps(*gan_in[name], kwargs[name]) for name in GAN_CASES})
        jg, jd, bundle, pool = gan_in["g16"]
        side["g16_neighbours"] = [
            _jax_gan_steps(jg, jd, {**bundle, "params_d": _nudge(bundle["params_d"], ulps)},
                           pool, kwargs["g16"])[2] for ulps in (-1, 1)]
        side["g32_gspmd"] = _jax_gan_steps(*gan_in["g32"], kwargs["g32"], mesh=make_mesh2d(2, 2))
        side["c2f"] = _jax_c2f(*c2f_in)
    except BaseException:
        tpr.abandon(work)
        raise
    finally:
        while not ctx.join(timeout=600):
            pass
    return tpp._numpy(side)


@pytest.fixture(scope="session")
def ranks_run(tmp_path_factory):
    """(the ranks' work directory, facegen's side), built once per test
    session: under pytest-xdist the first worker to need it runs the four
    ranks and facegen's side, the others read its files, and the last
    worker to finish removes them (``torch_port_parallel_ranks.run_once``)."""
    with tpr.run_once(tmp_path_factory, "gspmd_ranks", _ranks_and_facegen) as run:
        yield run


def _reports(work, name, mesh_name):
    """The reports of ``name`` from every rank of the mesh (and of its twin
    on ranks 2-3), their digests equal; returns the first."""
    twins = {"2x2": [("2x2", range(4))], "2x1a": [("2x1a", (0, 1)), ("2x1b", (2, 3))],
             "1x2a": [("1x2a", (0, 1)), ("1x2b", (2, 3))], "3x1": [("3x1", (0, 1, 2))]}[mesh_name]
    reports = []
    for mesh, rs in twins:
        for r in rs:
            with open(os.path.join(work, f"{name}_{mesh}_rank{r}.json")) as f:
                reports.append(json.load(f))
    assert all(rep["digest"] == reports[0]["digest"] for rep in reports), name
    return reports[0]


def _ranks_equal(work, name, world=4):
    reports = []
    for r in range(world):
        with open(os.path.join(work, f"{name}_rank{r}.json")) as f:
            reports.append(json.load(f))
    assert all(rep["digest"] == reports[0]["digest"] for rep in reports), name
    return reports[0]


def _check_updates(ours, theirs, start, keys_of, tol, wider=None):
    """The parameters' change and the optimizer moments, relative l2."""
    wider = wider or {}
    for prefix in keys_of["params"]:
        keys = [k for k in theirs if k.startswith(prefix)]
        assert keys, prefix
        err = tpp._rel_l2([ours[k] - start[k] for k in keys],
                          [np.asarray(theirs[k]) - start[k] for k in keys])
        assert err <= wider.get(prefix, tol), (prefix, err)
    for prefix in keys_of["moments"]:
        keys = [k for k in theirs if k.startswith(prefix)]
        assert keys, prefix
        err = tpp._rel_l2([ours[k] for k in keys], [np.asarray(theirs[k]) for k in keys])
        assert err <= wider.get(prefix, tol), (prefix, err)


GAN_KEYS = {"params": ("params_g/", "params_d/"),
            "moments": ("opt_g/0/mu/", "opt_g/0/nu/", "opt_d/0/mu/", "opt_d/0/nu/")}
G16_TOL = 5e-3  # G16 + D16_d's changes and moments (module docstring)
G16_STAT_TOL = 5e-5  # and its batch-norm statistics


def _check_gan(work, side_key, name, mesh_name, side):
    start, theirs, jrows = side[side_key]
    wider = {k: G16_TOL for keys in GAN_KEYS.values() for k in keys} if name == "g16" else {}
    rows = _reports(work, name, mesh_name)["metrics"]
    ours, _ = ckpt.load(work, f"{name}_{mesh_name}_arrays")
    assert digest(ours) == _reports(work, name, mesh_name)["digest"]
    assert [r[3] for r in rows] == [r[3] for r in jrows] == [1.0, 0.0, 1.0]
    for r, jr in zip(rows, jrows):  # loss_d, loss_g, acc_d
        np.testing.assert_allclose(r[:3], jr[:3], rtol=1e-4)
    assert set(ours) == set(theirs)
    for k in [k for k in theirs if "/" not in k or k.endswith("/count")]:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)
    batch = GAN_CASES[PADDED[name][0] if name in PADDED else name][0][2]
    assert int(ours["confusion"].sum()) == 3 * batch  # the global batch per step
    _check_updates(ours, theirs, start, GAN_KEYS, tpp.TOL, wider)
    stat_tol = G16_STAT_TOL if name == "g16" else tpp.STAT_TOL
    for k in theirs:
        if k.startswith(("state_g/", "state_d/")):
            np.testing.assert_allclose(ours[k], np.asarray(theirs[k]), rtol=0, atol=stat_tol,
                                       err_msg=k)
        if k.startswith("state_g/"):
            assert not np.array_equal(ours[k], start[k]), k  # the statistics moved


@pytest.mark.parametrize("name,mesh_name", [(name, mesh) for mesh in MESH_NAMES
                                             for name in tpp.CASES
                                             if mesh in GAN_CASES[name][1]])
def test_three_steps_match_the_single_device_step(ranks_run, name, mesh_name):
    work, side = ranks_run
    _check_gan(work, name, name, mesh_name, side)


def test_the_g16_case_is_well_conditioned(ranks_run):
    """facegen's own three G16 + D16_d steps on this file's draws move
    each loss by less than 1e-5 (relative) when D's weights move by one
    more or one less ulp: the case sits off the PReLU kinks, so the
    losses' 1e-4 measures the mesh and not a kink."""
    _, side = ranks_run
    rows = np.array([r[:3] for r in side["g16"][2]])
    for neighbour in side["g16_neighbours"]:
        np.testing.assert_allclose(np.array([r[:3] for r in neighbour]), rows, rtol=1e-5)


def test_three_steps_on_2x2_match_make_gspmd_step(ranks_run):
    work, side = ranks_run
    _check_gan(work, "g32_gspmd", "g32", "2x2", side)


def test_a_padded_step_on_2x2_trains_the_single_device_step(ranks_run):
    """--boundaryPad 8 on (2, 2): D's first conv is a sharded leaf, gathered
    into the rank's weight before the step pads its input channels; the 3
    steps match facegen's unpadded single-device step with the same
    tolerances (the pad is exact)."""
    work, side = ranks_run
    _check_gan(work, "g32", "g32p8", "2x2", side)


def test_a_data_row_with_no_rows_adds_nothing(ranks_run):
    """G32 + D32b at batch 4 on (3, 1): rank 2 holds none of a D half's 2
    rows and none of G's 4, and adds zeros to every sum (no mean of an
    empty batch); the 3 steps match facegen's single-device step, and
    every leaf of the state is finite."""
    work, side = ranks_run
    _check_gan(work, "g32b4", "g32b4", "3x1", side)
    ours, _ = ckpt.load(work, "g32b4_3x1_arrays")
    assert all(np.isfinite(v).all() for v in ours.values() if v.dtype.kind == "f")


@pytest.mark.parametrize("n", [4, 6, 32])
def test_row_blocks_are_contiguous_disjoint_and_cover_the_batch(n):
    """``row_block(n, dp, i)`` at dp = 1..8: blocks of ceil(n / dp) rows in
    the order of the data rows, the last ones short or empty, together
    exactly the batch; ``Mesh2D.rows``, ``pair_rows`` and ``row_count``
    take those blocks (a Mesh2D needs no process group for them)."""
    x = torch.arange(n)
    for dp in range(1, 9):
        blocks = [gspmd.row_block(n, dp, i) for i in range(dp)]
        c = -(-n // dp)
        assert blocks[0][0] == 0 and blocks[-1][1] == n
        for (a, b), (a2, _) in zip(blocks, blocks[1:]):
            assert b == a2  # contiguous and disjoint
        assert all(b - a == min(c, max(n - a, 0)) for a, b in blocks)
        assert sum(b - a for a, b in blocks) == n
        meshes = [gspmd.Mesh2D(dp, 1, i, tuple(range(dp)), torch.device("cpu"), None, None)
                  for i in range(dp)]
        assert torch.equal(torch.cat([m.rows(x) for m in meshes]), x)
        assert [m.row_count(n) for m in meshes] == [b - a for a, b in blocks]
        pair = torch.cat([x, x + n])
        h = n // 2
        assert torch.equal(torch.cat([m.pair_rows(pair)[:m.row_count(n)] for m in meshes]), x)
        assert [m.pair_rows(x).shape[0] for m in meshes] == [2 * m.row_count(h) for m in meshes]


# ------------------------------------------------------------- the leaf rule
def _facegen_axis(spec):
    return next((i for i, a in enumerate(spec) if a == "model"), None)


# the port's dim -> facegen's axis (gspmd._TORCH_DIM's inverse)
_AXIS = {(4, 0): 3, (2, 0): 1, (2, 1): 0}


@pytest.fixture(scope="module")
def leaf_nets():
    """(name, facegen's parameter leaves by path, the port's module), built
    once for both mp cases, which only read them."""
    g32, d32, jb = jax_gan.init_gan(jax.random.key(0), 32, 3, 100)
    g16, d16, jb16 = jax_gan.init_gan(jax.random.key(0), 16, 1, 100)
    pg32, pd32 = gan.init_gan(torch.Generator().manual_seed(0), 32, 3, 100)
    pg16, pd16 = gan.init_gan(torch.Generator().manual_seed(0), 16, 1, 100)
    cg, cd, cb = jax_c2f.init_c2f(jax.random.key(0), 32, 3)
    pcg, pcd = c2f.init_c2f(torch.Generator().manual_seed(0), 32, 3)
    am = jax_ae.create_autoencoder(32, 1, 256)
    ap, _, _ = am.init(jax.random.key(0), (32, 32, 1))
    _, _, _, db = jax_ae.init_denoiser(jax.random.key(0), 16, 3)
    _, pdec1, _ = ae.init_denoiser(torch.Generator().manual_seed(0), 16, 3)
    return [("G32", jb["params_g"], pg32), ("D32b", jb["params_d"], pd32),
            ("G16", jb16["params_g"], pg16), ("D16_d", jb16["params_d"], pd16),
            ("c2f G", cb["params_g"], pcg), ("c2f D", cb["params_d"], pcd),
            ("autoencoder", ap, ae.create_autoencoder(32, 1, 256,
                                                      generator=torch.Generator())),
            ("denoiser decoder", db["AE1_DECODER"]["params"], pdec1)]


@pytest.mark.parametrize("mp", [2, 4])
def test_the_leaf_rule_is_facegens(leaf_nets, mp):
    """Every parameter leaf of every net: the axis facegen's _leaf_spec
    shards, from the port's leaf_spec on facegen's shape and from
    torch_shard_dim on the port's; at both mp, G32 + D32b shard 5,318,848
    of the 5,334,413 numbers of their parameters and batch-norm
    statistics."""
    sharded, nets = {}, leaf_nets
    for name, jparams, module in nets:
        theirs = {k: np.asarray(v).shape for k, v in jax_ckpt.flatten_tree(jparams).items()}
        bn = ckpt._bn_prefixes(module.state_dict())
        ours = {}
        for pname, p in module.named_parameters():
            _, path, a = ckpt._jax_leaf(pname, p, bn)
            ours[path] = (a.shape, gspmd.torch_shard_dim(p.shape, mp), p.dim())
        assert set(ours) == set(theirs), name
        for path, shape in theirs.items():
            axis = _facegen_axis(_leaf_spec(np.empty(shape, np.float32), mp))
            fshape, dim, ndim = ours[path]
            assert fshape == shape and gspmd.leaf_spec(shape, mp) == axis, (name, path)
            assert (None if dim is None else _AXIS[(ndim, dim)]) == axis, (name, path)
            if axis is not None:
                sharded[name] = sharded.get(name, 0) + int(np.prod(shape))
        assert name in sharded, name  # every net has leaves the rule shards
    total = sum(t.numel() for _, _, m in nets[:2] for t in m.state_dict().values())
    assert (sharded["G32"] + sharded["D32b"], total) == (5_318_848, 5_334_413)


@pytest.mark.parametrize("mesh_name", ["2x2", "1x2a"])
def test_shards_have_the_shapes_of_facegens_shard_state(ranks_run, mesh_name):
    """Each rank's masters and Adam moments against the shard on the
    device at the rank's place in facegen's make_mesh2d."""
    work, _ = ranks_run
    jg, jd, bundle, _ = tpp._jax_case(32, 3, 8, {})
    dp, mp = (2, 2) if mesh_name == "2x2" else (1, 2)
    mesh = make_mesh2d(dp, mp)
    state = shard_state(jax_init_state(JaxTrainConfig(**tpp._step_kwargs(32, 3, 8, {})),
                                       bundle), mesh)
    leaves = {jax_ckpt._path_str(path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}
    n_sharded = 0
    for rank in range(dp * mp):  # both meshes are ranks 0 .. dp*mp-1
        index = rank
        with open(os.path.join(work, f"g32_{mesh_name}_rank{rank}.json")) as f:
            shapes = json.load(f)["shapes"]
        device = mesh.devices[index // mp, index % mp]
        for path, shape in shapes.items():
            (shard,) = [s for s in leaves[path].addressable_shards if s.device == device]
            assert tuple(shape) == shard.data.shape, (rank, path)
            n_sharded += tuple(shape) != leaves[path].shape
    assert n_sharded > 0


# --------------------------------------------------------- c2f, AE, denoiser
@pytest.mark.parametrize("mesh_name", ["2x1a", "1x2a", "3x1"])
def test_c2f_steps_match_make_epoch_fn(ranks_run, mesh_name):
    work, side = ranks_run
    start, theirs, jrows = side["c2f"]
    rows = _reports(work, "c2f", mesh_name)["metrics"]
    for r, jr in zip(rows, jrows):
        np.testing.assert_allclose(r[:2], jr[:2], rtol=1e-4)
        assert r[2] == jr[2]
    ours, _ = ckpt.load(work, f"c2f_{mesh_name}_arrays")
    assert set(ours) == set(theirs)
    for k in [k for k in theirs if "/" not in k or k.endswith("/count")]:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)
    assert int(ours["epoch"]) == 2 and int(ours["confusion"].sum()) == 3 * tc2f.BS
    _check_updates(ours, theirs, start, GAN_KEYS, tc2f.UPDATE_TOL)


@pytest.mark.parametrize("mesh_name", ["2x1a", "1x2a", "3x1"])
def test_autoencoder_steps_match_make_ae_epoch(ranks_run, mesh_name):
    work, side = ranks_run
    start, theirs, jlosses = side["ae"]
    np.testing.assert_allclose(_reports(work, "ae", mesh_name)["losses"], jlosses, rtol=1e-4)
    ours, _ = ckpt.load(work, f"ae_{mesh_name}_arrays")
    assert set(ours) == set(theirs) and int(ours["opt/0/count"]) == 3
    _check_updates(ours, theirs, start, {"params": ("params/",),
                                         "moments": ("opt/0/mu/", "opt/0/nu/")}, tae.UPDATE_TOL)


@pytest.mark.parametrize("mesh_name", ["2x1a", "1x2a", "3x1"])
def test_denoiser_steps_match_make_denoiser_epoch(ranks_run, mesh_name):
    work, side = ranks_run
    start, theirs, jlosses, jval = side["denoiser"]
    report = _reports(work, "denoiser", mesh_name)
    np.testing.assert_allclose(report["losses"], jlosses, rtol=1e-4)
    np.testing.assert_allclose(report["val"], jval, rtol=1e-4)  # every rank's, on 256 rows
    ours, _ = ckpt.load(work, f"denoiser_{mesh_name}_arrays")
    for net in ("AE1_DECODER", "AE2_DECODER"):
        keys = {"params": (f"{net}/params/",), "moments": (f"{net}/opt/0/mu/", f"{net}/opt/0/nu/")}
        _check_updates(ours, theirs, start, keys, tae.UPDATE_TOL)
        state = [k for k in theirs if k.startswith(f"{net}/state/")]
        assert len(state) == 6  # three batch norms' means and variances
        assert tpp._rel_l2([ours[k] for k in state], [theirs[k] for k in state]) <= tae.UPDATE_TOL
        assert int(ours[f"{net}/opt/0/count"]) == 3


# ------------------------------------------------------------------ trainers
def test_epochs_per_compile_runs_per_epoch_on_the_2d_mesh(ranks_run):
    work, _ = ranks_run
    rep = _ranks_equal(work, "t22")
    assert (rep["epochs_per_compile"], rep["readbacks"]) == (1, 2)
    assert ("<trainer> epochsPerCompile > 1 not supported on the 2-D GSPMD mesh; running "
            "per-epoch") in rep["log"]
    assert [os.path.exists(os.path.join(work, "t22", f"rank{r}")) for r in range(4)] == [
        True, False, False, False]


def test_weights_vis_freq_dumps_on_the_2d_mesh(ranks_run):
    """--weightsVisFreq 1 trains what whole epochs train, and rank 0 dumps
    after each of the 2 steps of each epoch."""
    work, _ = ranks_run
    assert _ranks_equal(work, "vis22")["digest"] == _ranks_equal(work, "t22")["digest"]
    dumps = sorted(os.listdir(os.path.join(work, "vis22", "rank0", "viz", "netvis")))
    assert dumps == [f"e{e:04d}_s{s:05d}" for e in (1, 2) for s in (1, 2)]
    assert not os.path.exists(os.path.join(work, "vis22", "rank1"))


def test_a_2x2_checkpoint_resumes_anywhere_and_loads_in_facegen(ranks_run, tmp_path):
    """Full tensors in facegen's layout: resumed on one device and at '2'
    with the state the four ranks held, and loaded strictly by facegen."""
    work, _ = ranks_run
    held = _ranks_equal(work, "t22")["digest"]
    saved, meta = ckpt.load(os.path.join(work, "t22", "rank0"), "adversarial")
    assert digest(saved) == held and meta["epoch"] == 3
    assert _ranks_equal(work, "resumed2_start", world=2)["digest"] == held
    cfg = TrainConfig(**ranks.TINY, save=str(tmp_path),
                      network=os.path.join(work, "t22", "rank0", "adversarial"))
    one = Trainer(cfg, device="cpu", verbose=False)
    assert digest(ckpt.train_state_arrays(one.state)) == held
    assert np.isfinite(one.train_epoch(2)["loss_d_mean"]) and one.state.epoch == 4
    jcfg = JaxTrainConfig(**{**ranks.TINY, "save": str(tmp_path)}).validate()
    _, _, bundle = jax_gan.init_gan(jax.random.key(0), 16, 1, ranks.TINY["noise_dim"],
                                    reference_init=False)
    restored, _ = jax_ckpt.load(os.path.join(work, "t22", "rank0"), "adversarial",
                                jax_init_state(jcfg, bundle))
    theirs = jax_ckpt.flatten_tree(restored)
    assert set(theirs) == set(saved)
    for k, v in theirs.items():
        np.testing.assert_array_equal(np.asarray(v), saved[k], err_msg=k)


def test_mesh_shape_2_1_trains_what_one_device_trains(ranks_run, tmp_path):
    """facegen sends any 'DP,MP' to its GSPMD mesh (facegen/train/loop.py:
    507-519): two ranks at 2,1 train one device's run on a 61-row pool,
    which two ranks at '2' (local batches) do not."""
    work, _ = ranks_run
    one = train_main(ranks.CLI + ["--meshShape", "1", "--save", str(tmp_path)], device="cpu")
    theirs = ckpt.train_state_arrays(one.state)
    start = ckpt.train_state_arrays(Trainer(dataclasses.replace(one.cfg, save=str(tmp_path / "s")),
                                            device="cpu", verbose=False).state)
    for name, close in (("cli21", True), ("cli2", False)):
        _ranks_equal(work, name, world=2)
        ours, _ = ckpt.load(os.path.join(work, name, "rank0"), "adversarial")
        keys = [k for k in theirs if k.startswith("params_")]
        err = tpp._rel_l2([ours[k] - start[k] for k in keys],
                          [theirs[k] - start[k] for k in keys])
        if close:
            _check_updates(ours, theirs, start, {"params": GAN_KEYS["params"], "moments": (
                "opt_g/0/trace/", "opt_d/0/trace/")}, tpp.TOL)
            for k in ("accs_n", "confusion", "trained_d", "not_trained_d", "epoch"):
                np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        else:
            assert err > 0.1, err


# ------------------------------------------------------------------- serving
def _serving_nets(scale=16, channels=1, seed=3):
    return gan.init_gan(torch.Generator().manual_seed(seed), scale, channels, NOISE_DIM,
                        reference_init=False)


@pytest.mark.parametrize("n", [64, 301])
def test_dp_mp_serving_matches_one_device(n):
    g, d = _serving_nets()
    one = GanInference(g, d, NOISE_DIM, torch.float32)
    grid = GanInference(g, d, NOISE_DIM, torch.float32, devices=["cpu"] * 4, mp=2)
    assert len(grid.g_replicas) == 2
    held = [[tuple(s.shape) for s in shards] for _, _, shards in grid.g_replicas[0].leaves]
    assert held and all(len(s) == 2 for s in held)  # each sharded leaf as 2 shards
    assert all(p.numel() == 0 for p, _, _ in grid.g_replicas[0].leaves)  # released
    noise = one.noise(torch.Generator().manual_seed(n), n)
    imgs, imgs2 = one.generate(noise), grid.generate(noise)
    assert imgs2.shape == imgs.shape == (n, 16, 16, 1)
    np.testing.assert_allclose(imgs2.numpy(), imgs.numpy(), rtol=SERVE_TOL, atol=SERVE_TOL)
    np.testing.assert_allclose(grid.score(imgs).numpy(), one.score(imgs).numpy(),
                               rtol=SERVE_TOL, atol=SERVE_TOL)


def test_dp_mp_serving_matches_facegens_2x2_mesh(tmp_path):
    _, _, bundle = jax_gan.init_gan(jax.random.key(0), 16, 1, NOISE_DIM, reference_init=False)
    bundle["state_g"] = jax.tree.map(lambda a: a * 2.0 + 0.05, bundle["state_g"])
    jax_ckpt.save(str(tmp_path), "adversarial", bundle,
                  meta={"config": {"scale": 16, "grayscale": True, "noise_dim": NOISE_DIM}})
    jg, jd, jbundle, _, _ = jax_gan.restore_gan("adversarial", default_dir=str(tmp_path))
    g, d, _ = gan.restore_gan("adversarial", default_dir=str(tmp_path), device="cpu")
    noise = np.random.RandomState(1).uniform(-1, 1, (301, NOISE_DIM)).astype(np.float32)
    jinf = JaxInference(jg, jd, NOISE_DIM, compute_dtype="float32", mesh=make_mesh2d(2, 2))
    j_imgs = jinf.generate(jbundle, jnp.asarray(noise))
    inf = GanInference(g, d, NOISE_DIM, torch.float32, devices=["cpu"] * 4, mp=2)
    imgs = inf.generate(torch.from_numpy(noise))
    np.testing.assert_allclose(imgs.numpy(), np.asarray(j_imgs), rtol=JAX_TOL, atol=JAX_TOL)
    np.testing.assert_allclose(inf.score(imgs).numpy(), np.asarray(jinf.score(jbundle, j_imgs)),
                               rtol=JAX_TOL, atol=JAX_TOL)


def test_run_sampling_on_a_2x2_mesh_writes_the_single_device_grids(tmp_path):
    g, d = _serving_nets()
    ckpt.save_gan(str(tmp_path), "adversarial", g, d,
                  {"scale": 16, "grayscale": True, "noise_dim": NOISE_DIM, "noise_view": "nhwc"})
    data = np.random.RandomState(5).randint(0, 256, (41, 16, 16, 1)).astype(np.uint8)
    outs = {}
    for label, shape, devices in (("one", (), None), ("grid", (2, 2), ["cpu"] * 4)):
        cfg = SampleConfig(save=str(tmp_path), neighbours=True, writeto=str(tmp_path / label),
                           mesh_shape=shape)
        outs[label] = sample.run_sampling(cfg, dataset=data, device="cpu", devices=devices,
                                          verbose=False)
    from PIL import Image

    assert [os.path.basename(p) for p in outs["one"]] == [os.path.basename(p)
                                                          for p in outs["grid"]]
    for a, b in zip(outs["one"], outs["grid"]):
        x, y = (np.asarray(Image.open(p), np.int16) for p in (a, b))
        assert x.shape == y.shape and np.abs(x - y).max() <= 1, a


def _tensor_bytes(*roots) -> int:
    """Bytes of the distinct storages of every tensor reachable from
    ``roots`` through objects' attributes, lists, tuples and dicts."""
    seen, total, stack = set(), 0, list(roots)
    while stack:
        obj = stack.pop()
        if isinstance(obj, torch.Tensor):
            storage = obj.untyped_storage()
            if storage.data_ptr() not in seen:
                seen.add(storage.data_ptr())
                total += storage.nbytes()
        elif isinstance(obj, dict):
            stack.extend(obj.values())
        elif isinstance(obj, (list, tuple)):
            stack.extend(obj)
        elif isinstance(obj, gspmd.ShardedParams):
            stack.extend(vars(obj).values())
    return total


@pytest.mark.parametrize("mp", [2, 4])
def test_the_model_axis_divides_the_masters_and_moments(mp):
    """G32 + D32b's parameters under Adam: one device holds them and two
    moments, 3P floats. A rank of a model group of mp holds the full work
    weights (P), and of each leaf the rule shards (S of the P) only its
    master and moments, with no staging buffer: P + 3S/mp + 2(P - S)
    floats, counted over every tensor the ShardedParams and the optimizer
    state hold."""
    from facegen_torch.train.optim import adam

    def nets():
        return gan.init_gan(torch.Generator().manual_seed(0), 32, 3, 100)

    def moments(opt):  # Adam's step count aside
        return [v for v in opt.values() if isinstance(v, list)]

    g, d = nets()
    params = [*g.parameters(), *d.parameters()]
    one = _tensor_bytes(params, moments(adam(1e-3).init(params)))
    g, d = nets()
    params = [*g.parameters(), *d.parameters()]
    column = dataclasses.make_dataclass("Column", ["mp", "j"])(mp, mp - 1)
    shards = gspmd.ShardedParams(params, column)
    ours = _tensor_bytes(params, shards, moments(adam(1e-3).init(shards.masters)))
    total = sum(p.numel() for p in params)
    sharded = sum(p.numel() for p, dim in zip(params, shards.dims) if dim is not None)
    assert sharded > 0.99 * total
    assert one == 4 * 3 * total
    assert ours == 4 * (total + 3 * sharded // mp + 2 * (total - sharded))
    assert ours < one


def test_synchronised_batch_norm_is_batch_norm_of_the_global_batch():
    """Over two data rows that hold the same local batch (an all-reduce
    that doubles), the synchronised batch norm of the local rows equals
    the plain batch norm of the doubled batch: the output's rows, the
    running statistics (unbiased with the global count), the input's
    gradient, and half of the scale's and the bias's (the step's
    all-reduce sums the rows' halves)."""
    import types

    from facegen_torch.nn.layers import BatchNorm

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(5, 4, 4, 8, generator=gen) * 2.0 + 0.5
    dy = torch.randn(5, 4, 4, 8, generator=gen)
    outs = []
    for mesh, xin, dyin in ((types.SimpleNamespace(dp=2, all_reduce_sum_=lambda t: t.mul_(2.0)),
                             x, dy), (None, torch.cat([x, x]), torch.cat([dy, dy]))):
        bn = BatchNorm(8)
        with torch.no_grad():
            bn.weight.copy_(torch.rand(8, generator=torch.Generator().manual_seed(4)) + 0.5)
        bn.mesh = mesh
        xs = xin.clone().requires_grad_()
        y = bn.train()(xs)
        y.backward(dyin)
        outs.append((y.detach()[:5], bn.running_mean, bn.running_var, xs.grad[:5],
                     bn.weight.grad, bn.bias.grad))
    (y, rm, rv, dx, dw, db), (y2, rm2, rv2, dx2, dw2, db2) = outs
    for ours, ref in ((y, y2), (rm, rm2), (rv, rv2), (dx, dx2), (2 * dw, dw2), (2 * db, db2)):
        torch.testing.assert_close(ours, ref, rtol=1e-5, atol=1e-6)


def test_synchronised_batch_norm_keeps_its_precision_at_a_large_mean():
    """Inputs whose mean (100) is 10^4 times their spread (0.01): the
    synchronised batch norm over two data rows holding the same batch,
    and the plain one of the doubled batch, both in fp32, against the
    exact batch norm of the doubled batch in fp64 (F.batch_norm). The
    variance is taken in two passes as the plain ``var`` does, so its
    error on every output stays within 8 times the plain batch norm's
    (a one-pass SS / n - mean^2 misses by 10^2 to 10^4 times). No fp32
    batch norm gets near 1e-5 here: the inputs' own rounding is 8e-6, a
    tenth of a percent of their spread."""
    import types

    import torch.nn.functional as F

    from facegen_torch.nn.layers import BatchNorm

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(5, 4, 4, 8, generator=gen) * 0.01 + 100.0
    dy = torch.randn(5, 4, 4, 8, generator=gen)
    weight = torch.rand(8, generator=torch.Generator().manual_seed(4)) + 0.5

    def fp32(mesh, xin, dyin):
        bn = BatchNorm(8)
        with torch.no_grad():
            bn.weight.copy_(weight)
        bn.mesh = mesh
        xs = xin.clone().requires_grad_()
        y = bn.train()(xs)
        y.backward(dyin)
        k = 2 if mesh is not None else 1  # the step's all-reduce sums the rows' halves
        return [y.detach()[:5], bn.running_mean, bn.running_var, xs.grad[:5],
                k * bn.weight.grad, k * bn.bias.grad]

    x64 = torch.cat([x, x]).double().reshape(-1, 8).requires_grad_()
    w64 = weight.double().requires_grad_()
    b64 = torch.zeros(8, dtype=torch.float64, requires_grad=True)
    rm, rv = torch.zeros(8, dtype=torch.float64), torch.ones(8, dtype=torch.float64)
    y64 = F.batch_norm(x64, rm, rv, w64, b64, training=True, momentum=0.1, eps=1e-5)
    y64.backward(torch.cat([dy, dy]).double().reshape(-1, 8))
    exact = [y64.detach().reshape(10, 4, 4, 8)[:5], rm, rv, x64.grad.reshape(10, 4, 4, 8)[:5],
             w64.grad, b64.grad]
    two_rows = types.SimpleNamespace(dp=2, all_reduce_sum_=lambda t: t.mul_(2.0))
    ours = fp32(two_rows, x, dy)
    plain = fp32(None, torch.cat([x, x]), torch.cat([dy, dy]))
    for name, o, p, e in zip(("y", "running_mean", "running_var", "dx", "dscale", "dbias"),
                             ours, plain, exact):
        err, plain_err = ((t.double() - e).abs().max().item() for t in (o, p))
        assert err <= 8 * plain_err + 1e-6, (name, err, plain_err)


def test_the_mesh_constructors_refuse_bad_shapes():
    """Without a process group (the ranks check the group's errors and
    layouts, tests/torch_port_gspmd_ranks.py:mesh_constructors); hybrid_mesh's
    shape against facegen's fallback reshape."""
    with pytest.raises(ValueError, match="mesh axes must be positive"):
        gspmd.make_mesh2d(0, 16)
    with pytest.raises(ValueError, match="mesh axes must be positive"):
        gspmd.make_mesh2d(4, -1)
    with pytest.raises(ValueError, match="no process group is up"):
        gspmd.make_mesh2d(16, 4)
    with pytest.raises(ValueError, match="launch 8 processes"):
        gspmd.resolve_axes((4, 2), None)
    assert gspmd.resolve_axes((1, 1), None) == gspmd.resolve_axes((-1,), None) == (1, 1)
    assert gspmd.mesh2d_from_shape((1,)) is None
    # one host of the conftest's 8 virtual devices: rank r at divmod(r, mp)
    for ici_dp, ici_mp in ((-1, 2), (2, 4), (-1, 1), (2, 2)):
        theirs = np.vectorize(lambda dev: dev.id)(jax_hybrid_mesh(ici_dp, ici_mp).devices)
        dp, mp = gspmd.hybrid_axes(8, 8, ici_dp, ici_mp)
        np.testing.assert_array_equal(theirs, np.arange(dp * mp).reshape(dp, mp))
    assert gspmd.hybrid_axes(16, 4, 2, 1) == (8, 1)  # 4 hosts stacked on the data axis
    with pytest.raises(ValueError, match="not hosts of 3"):
        gspmd.hybrid_axes(8, 3)


def test_the_ranks_module_imports_neither_jax_nor_facegen():
    import subprocess
    import sys

    code = ("import sys, torch_port_gspmd_ranks; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'facegen.'))"
            " or m == 'facegen']; assert not bad, bad")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([here, os.path.dirname(here)]))
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
