"""facegen's training options that no earlier slice of the port carried,
against facegen on the CPU in fp32: --boundaryPad (the GAN and the c2f
steps), ``guard_nonfinite`` and ``g_train_in_d_phase``.

- --boundaryPad 8 on G32 + D32b colour at batch 4 (the padder widens G's
  output conv, the real images and D's first conv to 8 channels inside
  the step): 3 steps (gate open, closed, open) against facegen's
  make_train_step with boundary_pad=8 on its own draws, with
  tests/test_torch_port_train_step.py's recipe and tolerances (losses
  rtol 1e-4; the parameters' change and Adam's moments 1e-3 relative l2;
  batch-norm statistics 1e-5; counters exact); and against the port's
  unpadded step on the same draws: losses rtol 1e-6, the parameters'
  change 1e-6 relative l2, batch-norm statistics 1e-6, counters exact,
  Adam's moments 1e-5 relative l2 (the padded convs sum their products
  in another order, and a gradient entry made of many cancelling terms,
  such as G's output conv's, carries that rounding into the moments:
  2.9e-6 on G's second moment in this case). The
  checkpoint of the padded run loads strictly into facegen's state.
- --boundaryPad 8 on the c2f (G_d's output conv, the real diffs, D's
  coarse conditions and D_c's first conv): 3 steps against facegen's
  make_epoch_fn with boundary_pad=8 (tests/test_torch_port_c2f.py's
  recipe and tolerances) and against the port's unpadded step, as the
  GAN's.
- The identity cases, as facegen's gate decides them on the same nets:
  D16_d (its dense branch takes the flattened image), the flat G (no
  output conv), P = 1 and P = 3 on colour images (P <= C): no padding,
  and a step bit-equal to P = 0's.
- guard_nonfinite with facegen's poisoned-D case (tests/test_aux.py:17):
  every D parameter NaN; one step on facegen's draws skips D's update
  (not_trained_d 1) and G's (its gradients come through the NaN D), and
  leaves the parameters and the optimizer states as they were, as
  facegen's does; G's batch-norm statistics, which still move, within
  1e-5 of facegen's.
- g_train_in_d_phase=False: 3 steps of G32 + D32b at batch 4 against
  facegen's, with the recipe's tolerances; G's batch-norm statistics
  move in the G phase only, and equal facegen's within 1e-5.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_c2f as tc2f
import test_torch_port_train_step as tts
import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen.models import gan as jax_gan
from facegen.nn import init as jax_winit
from facegen.train import c2f as jax_train_c2f
from facegen.train.step import init_state as jax_init_state
from facegen.train.step import make_boundary_padder as jax_make_boundary_padder
from facegen.train.step import make_train_step
from facegen.utils import checkpoint as jax_ckpt
from facegen_torch.config import TrainConfig
from facegen_torch.models import gan
from facegen_torch.train.c2f import C2FStep, init_c2f_state
from facegen_torch.train.step import TrainStep, draw_step, init_state, make_boundary_padder
from facegen_torch.utils import checkpoint as ckpt

PAD_TOL = 1e-6         # padded against unpadded, the same draws: losses, changes, statistics
PAD_MOMENT_TOL = 1e-5  # and Adam's moments (module docstring)
STAT_TOL = 1e-5


def _gan_steps(case, facegen=True, **kw):
    """3 steps of the port's TrainStep, and with ``facegen`` of facegen's
    make_train_step, from the same state on facegen's draws, both with the
    config fields ``kw`` (the ring filled with 1s before the second step
    and emptied before the third): (start, facegen's leaves, the port's,
    facegen's metrics, the port's, the port's state)."""
    (jg, jd, jcfg, jstate), (tcfg, tstate, _), pool = tts._setup(*case)
    jcfg, tcfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw).validate()
    jstate = jax_init_state(jcfg, _bundle(jstate))
    tstep = TrainStep(tcfg, tstate.g, tstate.d)
    start = _arrays(tstate)
    jstep = jax.jit(make_train_step(jg, jd, jcfg))
    jms, tms = [], []
    for i in range(3):
        if i > 0:
            jstate = tts._set_ring(jstate, tstate, 1.0 if i == 1 else 0.0)
        rng = jax.random.fold_in(jax.random.key(5), i)
        if facegen:
            jstate, jm = jstep(jstate, rng, jnp.asarray(pool))
            jms.append([float(v) for v in jm])
        tm = tstep(tstate, torch.from_numpy(pool), tts._draws(rng, tcfg, pool.shape[0], tstep))
        tms.append([float(v) for v in tm])
    theirs = jax_ckpt.flatten_tree(jstate) if facegen else None
    return start, theirs, _arrays(tstate), jms, tms, tstate


def _arrays(state):
    """Copies of the state's leaves under facegen's checkpoint paths (some
    arrays of ``train_state_arrays`` share the tensors' memory)."""
    return {k: np.array(v, copy=True) for k, v in ckpt.train_state_arrays(state).items()}


def _bundle(jstate):
    return {"params_g": jstate.params_g, "state_g": jstate.state_g,
            "params_d": jstate.params_d, "state_d": jstate.state_d}


def _check_against(ours, theirs, start, moments, tol, stat_tol, moment_tol=None):
    """Counters exactly; per network the parameters' change and the
    optimizer moments in relative l2; the batch-norm statistics."""
    assert set(ours) == set(theirs)
    for k in [k for k in theirs if "/" not in k or k.endswith("/count")]:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)
    for prefix in ("params_g/", "params_d/"):
        keys = [k for k in theirs if k.startswith(prefix)]
        err = tts._rel_l2([ours[k] - start[k] for k in keys],
                          [np.asarray(theirs[k]) - start[k] for k in keys])
        assert err <= tol, (prefix, err)
    for prefix in moments:
        keys = [k for k in theirs if k.startswith(prefix)]
        assert keys, prefix
        err = tts._rel_l2([ours[k] for k in keys], [np.asarray(theirs[k]) for k in keys])
        assert err <= (moment_tol or tol), (prefix, err)
    for k in theirs:
        if k.startswith(("state_g/", "state_d/")):
            np.testing.assert_allclose(ours[k], np.asarray(theirs[k]), rtol=0, atol=stat_tol,
                                       err_msg=k)


GAN_MOMENTS = ("opt_g/0/mu/", "opt_g/0/nu/", "opt_d/0/mu/", "opt_d/0/nu/")
PADDED_CASE = (32, 3, 4)  # G32 + D32b colour at batch 4


@pytest.fixture(scope="module")
def padded_gan():
    """facegen's and the port's padded runs, and the port's unpadded run,
    on the same draws."""
    start, theirs, ours, jms, tms, tstate = _gan_steps(PADDED_CASE, boundary_pad=8)
    _, _, plain, _, plain_ms, _ = _gan_steps(PADDED_CASE, facegen=False)
    return start, theirs, ours, jms, tms, tstate, plain, plain_ms


def test_boundary_pad_gan_steps_match_facegens_padded_steps(padded_gan):
    start, theirs, ours, jms, tms, tstate, _, _ = padded_gan
    pad = make_boundary_padder(dataclasses.replace(tts._configs(*PADDED_CASE)[1], boundary_pad=8),
                               tstate.g, tstate.d)
    assert (pad.pad, pad.g_convs, pad.d_convs) == (5, ("09_conv_out",), ("00_conv64",))
    assert [m[3] for m in tms] == [m[3] for m in jms] == [1.0, 0.0, 1.0]
    for tm, jm in zip(tms, jms):
        np.testing.assert_allclose(tm[:3], jm[:3], rtol=1e-4)
    _check_against(ours, theirs, start, GAN_MOMENTS, tts.UPDATE_TOL, tts.STAT_TOL)


def test_boundary_pad_gan_steps_train_what_unpadded_steps_train(padded_gan):
    start, _, ours, _, tms, _, plain, plain_ms = padded_gan
    np.testing.assert_allclose(np.array(tms), np.array(plain_ms), rtol=PAD_TOL)
    _check_against(ours, plain, start, GAN_MOMENTS, PAD_TOL, PAD_TOL, PAD_MOMENT_TOL)


def test_a_padded_runs_checkpoint_loads_in_facegen(padded_gan, tmp_path):
    """Stored parameters, statistics and moments keep their unpadded
    shapes: facegen's strict load of the padded run's checkpoint gives
    its leaves back."""
    tstate = padded_gan[5]
    ckpt.save_train_state(str(tmp_path), "adversarial", tstate,
                          {"config": {"scale": 32, "grayscale": False, "boundary_pad": 8},
                           "epoch": 1})
    ours = ckpt.train_state_arrays(tstate)
    (_, _, jcfg, jstate), _, _ = tts._setup(*PADDED_CASE)
    restored, _ = jax_ckpt.load(str(tmp_path), "adversarial", jstate)
    theirs = jax_ckpt.flatten_tree(restored)
    assert set(theirs) == set(ours)
    for k, v in theirs.items():
        np.testing.assert_array_equal(np.asarray(v), ours[k], err_msg=k)


def _c2f_steps(facegen=True, **kw):
    """3 c2f steps of the port's C2FStep, and with ``facegen`` of facegen's
    make_epoch_fn, on facegen's draws (tests/test_torch_port_c2f.py's
    recipe)."""
    (jg, jd, jcfg, bundle, jpool), (tcfg, g, d, pool) = tc2f._setup(3, "adam", **kw)
    theirs, jrows = None, []
    if facegen:
        jstate = jax_train_c2f.init_c2f_state(jcfg, bundle)
        jstate, jm = jax.jit(jax_train_c2f.make_epoch_fn(jg, jd, jcfg, pool_size=pool.size))(
            jstate, jax.random.key(5), jpool)
        theirs = jax_ckpt.flatten_tree(jstate)
        jrows = [[float(jm.loss_d[i]), float(jm.loss_g[i]), float(jm.acc_d[i])] for i in range(3)]
    tstate, tstep = init_c2f_state(tcfg, g, d), C2FStep(tcfg, g, d)
    start = _arrays(tstate)
    rows = [[float(v) for v in tstep(tstate, pool, tc2f._draws(
        jax.random.fold_in(jax.random.key(5), i), tcfg, pool.size, tstep))] for i in range(3)]
    tstate.epoch += 1  # facegen's epoch function counts the epoch
    return start, theirs, _arrays(tstate), jrows, rows, (tstep, bundle)


def test_boundary_pad_c2f_steps_match_facegen_and_the_unpadded_steps():
    start, theirs, ours, jrows, rows, (tstep, bundle) = _c2f_steps(boundary_pad=8)
    assert (tstep.pad.pad, tstep.pad.g_convs, tstep.pad.d_convs) == (
        5, ("body.08_conv5",), ("body.00_conv1",))
    padder = jax_make_boundary_padder(tstep.cfg)
    assert padder[0](bundle["params_g"])[1] == 1 and padder[1](bundle["params_d"])[1] == 1
    for r, jr in zip(rows, jrows):
        np.testing.assert_allclose(r[:2], jr[:2], rtol=1e-4)
        assert r[2] == jr[2]
    moments = ("opt_g/0/mu/", "opt_g/0/nu/", "opt_d/0/mu/", "opt_d/0/nu/")
    _check_against(ours, theirs, start, moments, tc2f.UPDATE_TOL, tts.STAT_TOL)
    _, _, plain, _, plain_rows, _ = _c2f_steps(facegen=False)
    np.testing.assert_allclose(np.array(rows), np.array(plain_rows), rtol=PAD_TOL)
    _check_against(ours, plain, start, moments, PAD_TOL, PAD_TOL, PAD_MOMENT_TOL)


def _identity_nets(case):
    """(config kwargs, the port's G and D, facegen's params of the same nets)."""
    gen = torch.Generator().manual_seed(0)
    if case == "d16_d":
        scale, channels, bp = 16, 1, 8
    elif case == "flat_g":
        scale, channels, bp = 32, 3, 8
    else:  # P <= C on colour images
        scale, channels, bp = 32, 3, {"p1": 1, "p3": 3}[case]
    g, d = gan.init_gan(gen, scale, channels, tts.NOISE_DIM, reference_init=False)
    jg, jd, bundle = jax_gan.init_gan(jax.random.key(0), scale, channels, tts.NOISE_DIM,
                                      reference_init=False)
    params_g = bundle["params_g"]
    if case == "flat_g":
        g = gan.create_g_flat(scale, channels, tts.NOISE_DIM, generator=gen)
        flat = jax_gan.create_g_flat(scale, channels, tts.NOISE_DIM)
        params_g, _, _ = flat.init(jax.random.key(1), (tts.NOISE_DIM,))
        params_g = jax_winit.zero_biases(params_g)
    kw = dict(batch_size=4, scale=scale, grayscale=channels == 1, noise_dim=tts.NOISE_DIM,
              compute_dtype="float32", reference_init=False, boundary_pad=bp)
    return kw, g, d, params_g, bundle["params_d"]


@pytest.mark.parametrize("case", ["d16_d", "flat_g", "p1", "p3"])
def test_the_identity_cases_train_what_no_pad_trains(case):
    """facegen's gate (a G conv with C outputs, a D conv with C inputs, no
    D leaf that flattens the image) refuses these nets or this P, and so
    does the port's: a step trains what --boundaryPad 0 trains, bit for bit."""
    kw, g, d, jparams_g, jparams_d = _identity_nets(case)
    cfg = TrainConfig(**kw).validate()
    padder = jax_make_boundary_padder(cfg)
    if padder is not None:  # the P > C cases: facegen's gate refuses the nets
        ng, nd = padder[0](jparams_g)[1], padder[1](jparams_d)[1]
        assert not (ng == 1 and nd >= 1 and not padder[3](jparams_d)), case
    assert not make_boundary_padder(cfg, g, d).active
    pool = torch.from_numpy(np.random.RandomState(7).randint(
        0, 256, (32,) + cfg.img_shape, np.uint8))
    states = []
    for bp in (cfg.boundary_pad, 0):
        c = dataclasses.replace(cfg, boundary_pad=bp)
        state = init_state(c, copy.deepcopy(g), copy.deepcopy(d))
        step = TrainStep(c, state.g, state.d)
        step(state, pool, draw_step(torch.Generator().manual_seed(3), c, 32, step.mask_specs))
        states.append(_arrays(state))
    for k in states[1]:
        np.testing.assert_array_equal(states[0][k], states[1][k], err_msg=k)


def test_guard_nonfinite_skips_the_poisoned_update_as_facegen_does():
    """facegen's tests/test_aux.py case: batch 8, G16 + D16_d gray, noise
    16, every D parameter NaN."""
    kw = dict(batch_size=8, scale=16, grayscale=True, noise_dim=16, n_epoch=16,
              compute_dtype="float32", reference_init=False, guard_nonfinite=True)
    (jg, jd, jcfg, jstate), (tcfg, tstate, _), pool = tts._setup(16, 1, 8)
    jcfg, tcfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw).validate()
    bundle = _bundle(jstate)
    bundle["params_d"] = jax.tree.map(lambda x: jnp.full_like(x, jnp.nan), bundle["params_d"])
    with torch.no_grad():
        for p in tstate.d.parameters():
            p.fill_(float("nan"))
    jstate = jax_init_state(jcfg, bundle)
    tstate = init_state(tcfg, tstate.g, tstate.d)
    tstep = TrainStep(tcfg, tstate.g, tstate.d)
    start, jstart = _arrays(tstate), jax_ckpt.flatten_tree(jstate)
    rng = jax.random.key(2)
    jstate, _ = jax.jit(make_train_step(jg, jd, jcfg))(jstate, rng, jnp.asarray(pool))
    tstep(tstate, torch.from_numpy(pool), tts._draws(rng, tcfg, pool.shape[0], tstep))
    theirs, ours = jax_ckpt.flatten_tree(jstate), _arrays(tstate)
    assert int(ours["not_trained_d"]) == int(theirs["not_trained_d"]) == 1
    assert int(ours["trained_d"]) == int(theirs["trained_d"]) == 0
    for k in theirs:
        if k.startswith(("params_", "opt_")):  # no update landed, on either side
            np.testing.assert_array_equal(np.asarray(theirs[k]), np.asarray(jstart[k]), err_msg=k)
            np.testing.assert_array_equal(ours[k], start[k], err_msg=k)
        if k.startswith("state_g/"):  # G's statistics moved in both phases
            np.testing.assert_allclose(ours[k], np.asarray(theirs[k]), rtol=0, atol=STAT_TOL,
                                       err_msg=k)
            assert not np.array_equal(ours[k], start[k]), k


def test_g_train_in_d_phase_off_trains_what_facegen_trains():
    start, theirs, ours, jms, tms, _ = _gan_steps(PADDED_CASE, g_train_in_d_phase=False)
    assert [m[3] for m in tms] == [m[3] for m in jms] == [1.0, 0.0, 1.0]
    for tm, jm in zip(tms, jms):
        np.testing.assert_allclose(tm[:3], jm[:3], rtol=1e-4)
    _check_against(ours, theirs, start, GAN_MOMENTS, tts.UPDATE_TOL, tts.STAT_TOL)
    # the D phase moved none of G's statistics: one momentum update a step
    # (the G phase's) from the start, where a train-mode D phase adds another
    _, _, both, _, _, _ = _gan_steps(PADDED_CASE, facegen=False)
    for k in [k for k in ours if k.startswith("state_g/")]:
        assert not np.array_equal(ours[k], start[k]) and not np.allclose(ours[k], both[k]), k
