"""The trainers' capture core (facegen_torch/train/graph.py) on the CPU,
where every route runs its steps eagerly on the static buffers a CUDA
graph would read.

- The route is a pure function of the device type, the backend and
  ``capture`` (``step_route``), the same for the GAN, c2f, autoencoder
  and denoiser trainers, each of which logs it.
- c2f (fine 16, batch 8), the autoencoder and the denoiser (scale 8,
  batch 8), 3 steps each: the runner writes exactly what
  ``draw_c2f_step`` / ``ae_epoch_draws`` / ``denoiser_epoch_draws`` draw
  into its static draws, and its steps are bit-equal to the same steps
  called one by one on those draws (the trainers' ``run_steps`` before
  the core). ``tests/test_torch_port_loop_modes.py`` holds the GAN's.
- The slice against facegen: the c2f runner on facegen's draws against
  ``make_epoch_fn``, and ``AETrainer.run_steps`` / ``DenoiserTrainer.
  run_steps`` on facegen's draws against ``make_ae_epoch`` /
  ``make_denoiser_epoch``, with the tolerances of
  tests/test_torch_port_c2f.py and tests/test_torch_port_ae.py (losses
  1e-4 relative, the parameters' change and the moments 1e-3 relative
  l2).
- ``set_pool`` refuses a pool of another shape or dtype.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_port_ae as tae
import test_torch_port_c2f as tc2f
import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen.config import TrainConfig as JaxTrainConfig
from facegen.models import ae as jax_ae
from facegen.nn.init import gaussian_overwrite as jax_gaussian_overwrite
from facegen.train import ae_loop as jax_ae_loop
from facegen.train import c2f as jax_train_c2f
from facegen.utils import checkpoint as jax_ckpt
from facegen_torch.config import C2FConfig, TrainConfig
from facegen_torch.data.c2f import C2FPool, make_triples
from facegen_torch.parallel.gspmd import Mesh2D
from facegen_torch.train.ae_loop import (
    AEDraws,
    AETrainer,
    DenoiserDraws,
    DenoiserTrainer,
    ae_epoch_draws,
    denoiser_epoch_draws,
)
from facegen_torch.train.c2f import C2FTrainer, draw_c2f_step
from facegen_torch.train.graph import copy_into, step_route
from facegen_torch.train.loop import Trainer
from facegen_torch.utils import checkpoint as ckpt

C2F_KW = dict(batch_size=8, n_epoch=16, fine_size=16, coarse_size=8, grayscale=True,
              compute_dtype="float32", synthetic_data=True, val_size=16, parzen_samples=8,
              g_l2=1e-3, seed=3)
AE_KW = dict(synthetic_data=True, scale=8, grayscale=True, noise_dim=32, batch_size=8,
             n_epoch=24, seed=3)
DEN_KW = dict(synthetic_data=True, scale=8, batch_size=8, n_epoch=24, seed=3)
GAN_KW = dict(synthetic_data=True, scale=16, grayscale=True, batch_size=8, noise_dim=8,
              n_epoch=16)


def _build(kind, save, **kw):
    """A trainer of ``kind`` on the CPU at this file's small sizes."""
    if kind == "gan":
        return Trainer(TrainConfig(**GAN_KW, save=save), device="cpu", **kw)
    if kind == "c2f":
        return C2FTrainer(C2FConfig(**C2F_KW, save=save), device="cpu", **kw)
    if kind == "autoencoder":
        return AETrainer(TrainConfig(**AE_KW, save=save), device="cpu", **kw)
    return DenoiserTrainer(TrainConfig(**DEN_KW, save=save), device="cpu", **kw)


KINDS = ("gan", "c2f", "autoencoder", "denoiser")


@pytest.fixture(scope="module")
def logged(tmp_path_factory):
    """Each trainer built once with its log on: (trainer, its log)."""
    out = {}
    for kind in KINDS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            trainer = _build(kind, str(tmp_path_factory.mktemp(kind)), verbose=True)
        out[kind] = (trainer, buf.getvalue())
    return out


# ------------------------------------------------------------------ routes
def _mesh(dp, mp):
    return Mesh2D(dp, mp, 0, tuple(range(dp * mp)), torch.device("cpu"), None, None)


ROUTE_CASES = {  # name -> (device type, backend, capture, mesh, captures, the route)
    "cpu": ("cpu", None, True, None, False, "eager steps on the CPU"),
    "cpu_gloo": ("cpu", "gloo", True, _mesh(2, 1), False,
                 "eager steps on the CPU, gloo over 2 ranks"),
    "cuda": ("cuda", None, True, None, True, "one CUDA graph replay a step"),
    "nccl": ("cuda", "nccl", True, _mesh(1, 1), True,
             "one CUDA graph replay a step, NCCL's all-reduces and all-gathers over the 1x1 "
             "mesh inside it"),
    "gloo": ("cuda", "gloo", True, _mesh(2, 2), False,
             "eager steps: a gloo all-reduce of a CUDA tensor waits on the host and cannot be "
             "captured (4 ranks)"),
    "no_capture": ("cuda", None, False, None, False, "eager steps: {reason}"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
@pytest.mark.parametrize("kind", KINDS)
def test_the_route_is_a_function_of_device_backend_and_capture(logged, kind, case):
    """Each trainer's runner takes its route from ``step_route`` alone,
    logs it, and on the CPU runs eagerly; under NCCL the graph holds the
    collectives, under gloo nothing is captured, and ``capture=False``
    says why it runs eagerly (the GAN trainer: debug_nans)."""
    trainer, log = logged[kind]
    runner = trainer.graphed
    assert (runner.captures, runner.route) == step_route("cpu", None, True)
    assert f"<trainer> step route: {runner.route}\n" in log
    device_type, backend, capture, mesh, captures, route = ROUTE_CASES[case]
    want = route.format(reason=runner.eager_reason)
    assert step_route(device_type, backend, capture, mesh, runner.eager_reason) == (captures,
                                                                                      want)
    assert ("debug_nans" in runner.eager_reason) == (kind == "gan")


@pytest.mark.parametrize("kind", ["gan", "c2f"])
def test_set_pool_refuses_a_pool_of_another_shape(logged, kind):
    trainer, _ = logged[kind]
    runner = trainer.graphed
    pool = trainer.source.epoch_pool(torch.Generator().manual_seed(1), 16)
    if kind == "c2f":
        pool = make_triples(pool, 8)
    runner.set_pool(pool)
    runner.set_pool(pool)  # the same shapes again: copied in place
    smaller = pool[:8] if kind == "gan" else C2FPool(pool.fine[:8], pool.coarse[:8])
    with pytest.raises(ValueError, match="into the static"):
        runner.set_pool(smaller)
    wider = pool.float() if kind == "gan" else C2FPool(pool.fine, pool.coarse.float())
    with pytest.raises(ValueError, match="into the static"):
        runner.set_pool(wider)


# ------------------------------------------- the eager route is today's steps
def _assert_trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)


def _assert_arrays_equal(ours, theirs):
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_c2f_runner_draws_and_trains_what_the_steps_do(tmp_path):
    """3 steps through the runner against 3 calls of the step on
    ``draw_c2f_step``'s draws from the same generator: the static draws
    hold the last step's draws, and the metrics and the state are
    bit-equal."""
    runner, plain = (_build("c2f", str(tmp_path / n), verbose=False) for n in ("a", "b"))
    pool = make_triples(runner.source.epoch_pool(torch.Generator().manual_seed(1), 16), 8)
    ms = runner.run_steps(pool, torch.Generator().manual_seed(2), 3)
    gen = torch.Generator().manual_seed(2)
    want = []
    for _ in range(3):
        draws = draw_c2f_step(gen, plain.cfg, pool.size, plain.step.mask_specs)
        want.append(torch.stack(plain.step(plain.state, pool, draws)))
    _assert_trees_equal(runner.draws, draws)
    assert torch.equal(torch.stack(ms, 1), torch.stack(want))
    _assert_arrays_equal(ckpt.train_state_arrays(runner.state),
                         ckpt.train_state_arrays(plain.state))
    assert runner.graphed.graph is None and int(runner.state.opt_g["count"]) == 3


@pytest.mark.parametrize("kind", ["autoencoder", "denoiser"])
def test_ae_family_runner_draws_and_trains_what_the_steps_do(tmp_path, kind):
    """3 steps of ``run_steps`` on an epoch's draws against 3 calls of the
    step on them: the runner's static draws hold the last step's, and the
    losses and the state are bit-equal."""
    runner, plain = (_build(kind, str(tmp_path / n), verbose=False) for n in ("a", "b"))
    cfg, specs = runner.cfg, runner.step.mask_specs
    gen = torch.Generator().manual_seed(4)
    if kind == "autoencoder":
        draws = ae_epoch_draws(gen, cfg.batch_size, runner.n_pool, specs)[:3]
        want = [plain.step(plain.model, plain.opt, plain.pool, d) for d in draws]
    else:
        draws = denoiser_epoch_draws(gen, cfg.batch_size, cfg.img_shape, runner.n_pool,
                                     specs)[:3]
        want = [plain.step(plain.state, plain.pool, d) for d in draws]
    assert torch.equal(runner.epoch_draws(torch.Generator().manual_seed(4))[2].idx, draws[2].idx)
    losses = runner.run_steps(draws)
    _assert_trees_equal(runner.draws, draws[-1])
    assert torch.equal(losses, torch.stack(want))
    _assert_arrays_equal(*(_family_arrays(t) for t in (runner, plain)))
    assert runner.graphed.graph is None


def _family_arrays(trainer):
    """An autoencoder's or a denoiser's parameters, statistics and Adam
    states under facegen's paths."""
    if isinstance(trainer, AETrainer):
        return ckpt.autoencoder_arrays(trainer.model, trainer.opt)
    st = trainer.state
    return {k: v for key, dec, opt in (("AE1_DECODER", st.dec1, st.opt1),
                                       ("AE2_DECODER", st.dec2, st.opt2))
            for k, v in ckpt.module_arrays(dec, f"{key}/params", f"{key}/state", opt,
                                           f"{key}/opt").items()}


def test_copy_into_matches_dicts_by_key_and_refuses_another_shape():
    dst = AEDraws(torch.zeros(4, dtype=torch.int64), {"a": torch.zeros(2), "b": torch.zeros(3)})
    src = AEDraws(torch.arange(4), {"b": torch.ones(3), "a": torch.full((2,), 2.0)})
    copy_into(dst, src)
    _assert_trees_equal(dst, src)
    with pytest.raises(ValueError, match="into the static"):
        copy_into(dst, AEDraws(torch.arange(5), src.masks))
    with pytest.raises(KeyError):
        copy_into(dst, AEDraws(torch.arange(4), {"a": torch.zeros(2)}))


# ------------------------------------------------------- against facegen
def _check_updates(ours, theirs, start, prefixes, moments):
    for prefix in prefixes:
        keys = [k for k in theirs if k.startswith(prefix)]
        assert keys, prefix
        assert tc2f._rel_l2([ours[k] - start[k] for k in keys],
                            [np.asarray(theirs[k]) - start[k] for k in keys]) <= 1e-3, prefix
    for prefix in moments:
        keys = [k for k in theirs if k.startswith(prefix)]
        assert keys, prefix
        assert tc2f._rel_l2([ours[k] for k in keys],
                            [np.asarray(theirs[k]) for k in keys]) <= 1e-3, prefix


def test_c2f_runner_on_facegens_draws_matches_make_epoch_fn(tmp_path):
    """The c2f trainer's runner (static pool and draws, the eager route)
    on facegen's weights, pool and draws: 3 steps against make_epoch_fn."""
    (jg, jd, jcfg, bundle, jpool), (tcfg, g, d, pool) = tc2f._setup(1, "adam")
    jstate = jax_train_c2f.init_c2f_state(jcfg, bundle)
    start = jax_ckpt.flatten_tree(jstate)
    rng = jax.random.key(5)
    jstate, jm = jax.jit(jax_train_c2f.make_epoch_fn(jg, jd, jcfg, pool_size=pool.size))(
        jstate, rng, jpool)
    kw = {**C2F_KW, "fine_size": tc2f.FS, "coarse_size": tc2f.CS}
    trainer = C2FTrainer(C2FConfig(**kw, save=str(tmp_path)), device="cpu", verbose=False)
    trainer.state.g.load_state_dict(g.state_dict())
    trainer.state.d.load_state_dict(d.state_dict())
    trainer.graphed.set_pool(pool)
    draws = [tc2f._draws(jax.random.fold_in(rng, i), tcfg, pool.size, trainer.step)
             for i in range(3)]
    rows = trainer.graphed.run_steps(lambda i: copy_into(trainer.draws, draws[i]), 3)
    np.testing.assert_allclose(rows[:, 0].numpy(), np.asarray(jm.loss_d), rtol=1e-4)
    np.testing.assert_allclose(rows[:, 1].numpy(), np.asarray(jm.loss_g), rtol=1e-4)
    np.testing.assert_array_equal(rows[:, 2].numpy(), np.asarray(jm.acc_d))
    trainer.state.epoch += 1  # facegen's epoch function counts the epoch
    ours, theirs = ckpt.train_state_arrays(trainer.state), jax_ckpt.flatten_tree(jstate)
    assert set(ours) == set(theirs)
    for k in [k for k in theirs if "/" not in k or k.endswith("/count")]:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)
    _check_updates(ours, theirs, start, ("params_g/", "params_d/"),
                   [f"opt_{n}/0/{k}/" for n in "gd" for k in ("mu", "nu")])


def test_autoencoder_run_steps_on_facegens_draws_matches_make_ae_epoch(tmp_path):
    s, c = 8, 1
    kw = dict(batch_size=tae.BATCH, scale=s, grayscale=True, noise_dim=32)
    model = jax_ae.create_autoencoder(s, c, 32)
    params, state, _ = model.init(jax.random.key(9), (s, s, c))
    params = jax_gaussian_overwrite(params, jax.random.key(10))
    opt = optax.adam(1e-3).init(params)
    pool, rng = tae._pool(s, c), jax.random.key(11)
    start = jax_ckpt.flatten_tree({"params": params, "state": state, "opt": opt})
    p1, s1, o1, jlosses = jax_ae_loop.make_ae_epoch(model, JaxTrainConfig(**kw))(
        params, state, opt, rng, jnp.asarray(pool))
    trainer = AETrainer(TrainConfig(**kw, synthetic_data=True, n_epoch=tae.POOL,
                                    save=str(tmp_path)), device="cpu", verbose=False)
    tae._carry(trainer.model, params, state)
    trainer.pool = torch.from_numpy(pool)  # read in place by the step, on the CPU route
    draws = [AEDraws(idx, tae._masks(jax.random.fold_in(rng, 1 + i), trainer.step.mask_specs))
             for i, idx in enumerate(tae._perm_batches(rng))]
    np.testing.assert_allclose(trainer.run_steps(draws).numpy(), np.asarray(jlosses), rtol=1e-4)
    ours = ckpt.autoencoder_arrays(trainer.model, trainer.opt)
    theirs = jax_ckpt.flatten_tree({"params": p1, "state": s1, "opt": o1})
    assert set(ours) == set(theirs) and int(ours["opt/0/count"]) == 3
    _check_updates(ours, theirs, start, ("params/",), ("opt/0/mu/", "opt/0/nu/"))


def test_denoiser_run_steps_on_facegens_draws_matches_make_denoiser_epoch(tmp_path):
    s, c = 8, 3
    kw = dict(batch_size=tae.BATCH, scale=s, grayscale=False)
    enc, dec1, dec2, bundle = tae._jax_denoiser(s, c)
    tx = optax.adam(1e-3)
    opt1, opt2 = tx.init(bundle["AE1_DECODER"]["params"]), tx.init(bundle["AE2_DECODER"]["params"])
    pool, rng = tae._pool(s, c), jax.random.key(13)
    start = jax_ckpt.flatten_tree(bundle)
    jb, jo1, jo2, jlosses = jax_ae_loop.make_denoiser_epoch(enc, dec1, dec2, JaxTrainConfig(**kw))(
        bundle, opt1, opt2, rng, jnp.asarray(pool))
    trainer = DenoiserTrainer(TrainConfig(**kw, synthetic_data=True, n_epoch=tae.POOL,
                                          save=str(tmp_path)), device="cpu", verbose=False)
    for key, dec in (("AE1_DECODER", trainer.state.dec1), ("AE2_DECODER", trainer.state.dec2)):
        tae._carry(dec, bundle[key]["params"], bundle[key]["state"])
    trainer.pool = torch.from_numpy(pool)
    specs = trainer.step.mask_specs
    draws = [DenoiserDraws(idx, *tae._denoiser_draws(rng, i, s, c, specs))
             for i, idx in enumerate(tae._perm_batches(rng))]
    np.testing.assert_allclose(trainer.run_steps(draws).numpy(), np.asarray(jlosses), rtol=1e-4)
    ours, theirs = _family_arrays(trainer), jax_ckpt.flatten_tree(jb)
    for key, jo in (("AE1_DECODER", jo1), ("AE2_DECODER", jo2)):
        theirs.update({f"{key}/{k}": v for k, v in jax_ckpt.flatten_tree({"opt": jo}).items()})
    assert set(ours) == set(theirs)
    nets = ("AE1_DECODER", "AE2_DECODER")
    assert all(int(ours[f"{net}/opt/0/count"]) == 3 for net in nets)
    _check_updates(ours, theirs, start, [f"{net}/params/" for net in nets],
                   [f"{net}/opt/0/{k}/" for net in nets for k in ("mu", "nu")])
    for net in nets:  # three batch norms' means and variances each
        keys = [k for k in theirs if k.startswith(f"{net}/state/")]
        assert len(keys) == 6
        assert tc2f._rel_l2([ours[k] for k in keys], [np.asarray(theirs[k]) for k in keys]) <= 1e-3
