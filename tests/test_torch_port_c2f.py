"""The port's coarse-to-fine (c2f) slice against facegen's, on the CPU.

facegen's modules are initialised and their parameters carried into the
port with ``jax_to_torch`` (the checkpoint converter); both packages run
the same numpy inputs in fp32. Tolerances, each with its reason:

- layers, the c2f nets, approxParzen and the refinement: 2e-4 (rtol and
  atol; parzen 1e-4 relative), the fp32 reassociation drift of the convs
  (~1e-5) with margin; a layout error is O(1e-2) or more;
- make_triples: within one uint8 step, since both round x*255+0.5 after
  resizes whose fp32 sums differ in the last bits; gather_triple on the
  same uint8 pool: equal;
- 3 train steps against facegen's make_epoch_fn on facegen's own draws,
  rebuilt from its keys: counters, the epoch and Adam's counts equal;
  relative l2 errors of the parameters' change and of the optimizer
  moments within 1e-3 per network (Adam's first steps move an entry by
  about lr x the sign of its gradient, so an entry whose gradient is as
  small as its rounding noise can move either way; see
  tests/test_torch_port_train_step.py);
- optimizers against optax: 1e-6 relative, 1e-9 absolute (the same
  elementwise formulas).
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen.config import C2FConfig as JaxC2FConfig
from facegen.data.c2f import gather_triple as jax_gather_triple
from facegen.data.c2f import make_triples as jax_make_triples
from facegen.data.pipeline import DataSource as JaxDataSource
from facegen.data.synthetic import synthetic_faces as jax_synthetic_faces
from facegen.models import c2f as jax_c2f
from facegen.nn import Ctx, layers as JL, sequential as jax_sequential
from facegen.nn.core import param_count
from facegen.sample import refine_c2f as jax_refine_c2f
from facegen.train import c2f as jax_train_c2f
from facegen.utils import checkpoint as jax_ckpt
from facegen_torch import sample, train_c2f
from facegen_torch.config import C2FConfig, SampleConfig, c2f_config_from_args
from facegen_torch.data.c2f import C2FPool, gather_triple, make_triples
from facegen_torch.data.pipeline import DataSource, prepare_pool
from facegen_torch.models import c2f, gan
from facegen_torch.nn import dropout
from facegen_torch.nn import layers as L
from facegen_torch.ops import fused_update
from facegen_torch.train import optim
from facegen_torch.train.c2f import (
    C2FDDraws,
    C2FGDraws,
    C2FStep,
    C2FStepDraws,
    C2FTrainer,
    ckpt_name,
    draw_c2f_step,
    init_c2f_state,
    parzen_distances,
)
from facegen_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
UPDATE_TOL = 1e-3


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _scale_weights(params, factor=3.0):
    """Larger weights than the init's, so outputs differ per input."""
    return jax.tree_util.tree_map_with_path(
        lambda p, a: a * factor if str(p[-1].key) == "w" else a, params)


def _carry(bundle):
    """facegen's bundle -> the port's {"g": state_dict, "d": state_dict}."""
    return ckpt.jax_to_torch(jax_ckpt.flatten_tree(bundle))


# (name, facegen layer, port layer, per-example input shape)
LAYER_CASES = [
    ("max_pool", JL.max_pool(2), lambda: L.MaxPool(), (7, 7, 8)),
    ("subpixel_f1", JL.subpixel_conv(16, 3, 1, name="conv"),
     lambda: L.SubpixelConv(8, 16, 3, 1, generator=_gen()), (6, 6, 8)),
    ("subpixel_f2", JL.subpixel_conv(6, 5, 2, name="conv"),
     lambda: L.SubpixelConv(8, 6, 5, 2, generator=_gen()), (5, 4, 8)),
]


@pytest.mark.parametrize("name,jax_layer,make,in_shape", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_jax(name, jax_layer, make, in_shape):
    jm = jax_sequential(jax_layer)
    params, state, out_shape = jm.init(jax.random.key(0), in_shape)
    port = L.sequential((jax_layer.name, make())).eval()
    port.load_state_dict(_carry({"params_g": params, "state_g": state})["g"], strict=True)
    x = np.random.RandomState(1).randn(3, *in_shape).astype(np.float32)
    theirs, _ = jm.apply(params, state, jnp.asarray(x), Ctx(None, False))
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    assert ours.shape == (3,) + tuple(out_shape)
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=TOL, atol=TOL)


# (name, facegen factory, port factory, fine size, channels, G or D)
NET_CASES = [
    ("g_d", jax_c2f.create_g, c2f.create_g, 8, 3, "g"),
    ("d_c", jax_c2f.create_d, c2f.create_d, 8, 3, "d"),
    ("g_a", jax_c2f.create_g_a, c2f.create_g_a, 8, 1, "g"),
    ("g_b", jax_c2f.create_g_b, c2f.create_g_b, 8, 3, "g"),
    ("g_c", jax_c2f.create_g_c, c2f.create_g_c, 8, 1, "g"),
    ("d_a", jax_c2f.create_d_a, c2f.create_d_a, 8, 1, "d"),
    ("d_b", jax_c2f.create_d_b, c2f.create_d_b, 16, 3, "d"),
]


@pytest.mark.parametrize("name,jax_create,create,fs,c,kind", NET_CASES,
                         ids=[n[0] for n in NET_CASES])
def test_c2f_net_matches_jax(name, jax_create, create, fs, c, kind):
    first = (fs, fs, 1) if kind == "g" else (fs, fs, c)
    jm = jax_create(fs, c)
    params, state, _ = jm.init(jax.random.key(3), (first, (fs, fs, c)))
    params = _scale_weights(params)
    port = create(fs, c, generator=_gen())
    port.load_state_dict(_carry({"params_g": params, "state_g": state})["g"], strict=True)
    rs = np.random.RandomState(4)
    a = rs.uniform(-1, 1, (4,) + first).astype(np.float32)
    b = rs.uniform(0, 1, (4, fs, fs, c)).astype(np.float32)
    theirs, _ = jm.apply(params, state, (jnp.asarray(a), jnp.asarray(b)), Ctx(None, False))
    with torch.no_grad():
        ours = port((torch.from_numpy(a), torch.from_numpy(b))).numpy()
    assert ours.shape == ((4, fs, fs, c) if kind == "g" else (4, 1))
    assert np.asarray(theirs).std() > 1e-3
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=TOL, atol=TOL)
    assert sum(p.numel() for p in port.parameters()) == param_count(params)


def test_d_c_dropout_masks_are_named_by_facegens_key_path():
    d = c2f.create_d(8, 3, generator=_gen())
    assert sorted(dropout.dropout_layers(d)) == ["01_body.10_dropout", "01_body.14_dropout"]
    shapes = dropout.dropout_mask_shapes(d, 6, ((8, 8, 3), (8, 8, 3)))
    assert shapes == {"01_body.10_dropout": (6, 2, 2, 256), "01_body.14_dropout": (6, 512)}


@pytest.mark.parametrize("fs,cs,c", [(16, 8, 3), (8, 4, 1)])
def test_make_triples_and_gather_match_jax(fs, cs, c):
    fine = np.random.RandomState(5).randint(0, 256, (6, fs, fs, c)).astype(np.uint8)
    faces = np.asarray(jax_synthetic_faces(jax.random.key(0), 4))[:, ::64 // fs, ::64 // fs, :c]
    fine = np.concatenate([fine, faces])
    theirs = jax_make_triples(jnp.asarray(fine), cs)
    ours = make_triples(torch.from_numpy(fine), cs)
    assert ours.coarse.dtype == torch.uint8 and ours.coarse.shape == fine.shape
    assert np.array_equal(ours.fine.numpy(), fine)
    assert np.abs(ours.coarse.numpy().astype(int) - np.asarray(theirs.coarse).astype(int)).max() <= 1
    same = C2FPool(torch.from_numpy(fine), torch.from_numpy(np.array(theirs.coarse)))
    idx = np.array([3, 0, 3, 9])
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        for o, t in zip(gather_triple(same, torch.from_numpy(idx), tdt),
                        jax_gather_triple(theirs, jnp.asarray(idx), jdt)):
            assert o.dtype == tdt
            np.testing.assert_array_equal(o.float().numpy(), np.asarray(t.astype(jnp.float32)))


def test_holdout_draws_and_range_pool_match_jax():
    store = np.array(jax_synthetic_faces(jax.random.key(1), 12))
    ours = DataSource(16, 3, torch.device("cpu"), store=torch.from_numpy(store), holdout=5)
    theirs = JaxDataSource(16, 3, store=store, holdout=5)
    assert ours.size == theirs.size == 7
    val = ours.range_pool(0, 5)
    assert torch.equal(val, prepare_pool(torch.from_numpy(store[:5]), 16, 3))
    j_val = np.asarray(theirs.range_pool(0, 5, jax.random.key(2))).astype(int)
    assert np.abs(val.numpy().astype(int) - j_val).max() <= 1
    # training draws skip the held-out rows
    raw = ours.raw_batch(_gen(3), 200)
    rows = [int(np.argmax([np.array_equal(r, s) for s in store])) for r in raw.numpy()]
    assert min(rows) == 5 and max(rows) == 11
    synthetic = DataSource(8, 1, torch.device("cpu"), holdout=5)
    assert torch.equal(synthetic.range_pool(0, 3), synthetic.range_pool(0, 3))
    assert synthetic.range_pool(0, 3).shape == (3, 8, 8, 1)


def _jax_cli_config(argv, monkeypatch):
    """facegen's train_c2f.py CLI config for ``argv`` (its trainer stubbed)."""
    spec = importlib.util.spec_from_file_location("jax_train_c2f_cli",
                                                  os.path.join(REPO, "train_c2f.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    seen = {}

    class Stop(Exception):
        pass

    def trainer(cfg, mesh=None):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(cli, "C2FTrainer", trainer)
    with pytest.raises(Stop):
        cli.main(argv)
    return seen["cfg"]


@pytest.mark.parametrize("argv", [
    [], ["--batchSize", "8", "--D_L1", "0", "--G_L2", "1e-3", "--noplot", "--grayscale",
         "--fineSize", "16", "--coarseSize", "8", "--D_optmethod", "adagrad",
         "--G_optmethod", "sgd", "--G_sgd_momentum", "0.5", "--syntheticData", "--epochs", "3",
         "--N_epoch", "-1", "--datasetDir", "x.npy", "--saveFreq", "2", "--seed", "7"],
])
def test_c2f_cli_parses_like_jax(argv, monkeypatch):
    ours, theirs = c2f_config_from_args(argv), _jax_cli_config(argv, monkeypatch)
    shared = {f.name for f in dataclasses.fields(C2FConfig)} & {
        f.name for f in dataclasses.fields(JaxC2FConfig)}
    assert len(shared) >= 35
    for name in shared - {"mesh_shape"}:
        assert getattr(ours, name) == getattr(theirs, name), name
    assert C2FConfig().mesh_shape == (1,) and ours.mesh_shape == (-1,)


@pytest.mark.parametrize("argv,message", [
    # the 2-D mesh is ported (tests/test_torch_port_gspmd.py): without a
    # process group the CLI says how to launch its ranks
    (["--meshShape", "2"], "launch 2 processes"),
    # --boundaryPad is ported (tests/test_torch_port_train_options.py): at
    # P = 1 <= C the padder is the identity, and the run trains what
    # --boundaryPad 0 trains, bit for bit
    (["--boundaryPad", "1"], None),
], ids=["argv0-not ported yet", "argv1-not ported"])  # the ids from when both were refused
def test_c2f_cli_refuses_what_is_not_ported(argv, message, capsys, tmp_path):
    if message is None:
        tiny = ["--syntheticData", "--fineSize", "8", "--coarseSize", "4", "--batchSize", "4",
                "--N_epoch", "8", "--epochs", "1", "--noplot", "--grayscale"]
        runs = {}
        for label, extra in (("padded", argv), ("plain", ["--boundaryPad", "0"])):
            save = str(tmp_path / label)
            trainer = train_c2f.main(tiny + extra + ["--save", save], device="cpu")
            assert not trainer.step.pad.active
            runs[label], _ = ckpt.load(save, ckpt_name(trainer.cfg))
        assert set(runs["padded"]) == set(runs["plain"])
        for k, v in runs["plain"].items():
            np.testing.assert_array_equal(runs["padded"][k], v, err_msg=k)
        return
    with pytest.raises(SystemExit) as e:
        train_c2f.main(argv, device="cpu")
    assert e.value.code != 0 and message in capsys.readouterr().err


def test_c2f_cli_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        train_c2f.main(["--syntheticData"])
    assert "no CUDA GPU" in str(e.value.code)


@pytest.mark.parametrize("method,which,flags", [
    ("adam", "D", {}), ("adagrad", "D", {}), ("adagrad", "G", {}),
    ("sgd", "G", {"g_sgd_momentum": 0.9, "g_sgd_lr": 0.05}),
])
def test_c2f_optimizers_match_optax(method, which, flags):
    import optax

    rs = np.random.RandomState(6)
    params = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    tx = jax_train_c2f._make_tx(method, JaxC2FConfig(**flags), which)
    ours_tx = optim.make_c2f_optimizer(method, C2FConfig(**flags), which)
    jp, js = params, tx.init(params)
    tp = [torch.from_numpy(a.copy()) for a in params]
    ts = ours_tx.init(tp)
    for _ in range(3):
        grads = [rs.randn(*a.shape).astype(np.float32) for a in params]
        updates, js = tx.update(grads, js, jp)
        jp = optax.apply_updates(jp, updates)
        fused_update.gated_update(ours_tx, [torch.from_numpy(g) for g in grads], ts, tp, True)
    for o, t in zip(tp, jp):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=1e-6, atol=1e-9)
    theirs = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
    mine = ([ts["count"]] + ts["mu"] + ts["nu"] if method == "adam"
            else fused_update._state_tensors(ts))
    assert len(mine) == len(theirs)
    for o, t in zip(mine, theirs):
        np.testing.assert_allclose(o.numpy(), t, rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------- train step
FS, CS, BS = 8, 4, 8


def _configs(c, method, **kw):
    kw = {**dict(batch_size=BS, n_epoch=12, fine_size=FS, coarse_size=CS, grayscale=c == 1,
                 compute_dtype="float32", d_optmethod=method, g_optmethod=method, g_l2=1e-3,
                 seed=3, val_size=16, parzen_samples=8), **kw}
    return JaxC2FConfig(**kw).validate(), C2FConfig(**kw).validate()


def _setup(c, method, **kw):
    jcfg, tcfg = _configs(c, method, **kw)
    jg, jd, bundle = jax_c2f.init_c2f(jax.random.key(11), FS, c)
    g, d = c2f.init_c2f(_gen(1), FS, c)
    sds = _carry(bundle)
    g.load_state_dict(sds["g"], strict=True)
    d.load_state_dict(sds["d"], strict=True)
    fine = np.random.RandomState(12).randint(0, 256, (32, FS, FS, c)).astype(np.uint8)
    jpool = jax_make_triples(jnp.asarray(fine), CS)
    pool = C2FPool(torch.from_numpy(fine), torch.from_numpy(np.array(jpool.coarse)))
    return (jg, jd, jcfg, bundle, jpool), (tcfg, g, d, pool)


def _masks(key, step: C2FStep):
    out = {}
    for name, (shape, rate) in step.mask_specs.items():
        k = key
        for part in name.split("."):  # e.g. 01_body.10_dropout: fold 1, then 10
            k = jax.random.fold_in(k, int(part[:2]))
        out[name] = torch.from_numpy(np.array(jax.random.bernoulli(k, 1.0 - rate, shape)))
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _draws(rng, cfg, pool_n, step):
    """facegen's draws for the step keyed ``rng`` (facegen/train/c2f.py:133-139,
    171-174), as the port's C2FStepDraws."""
    half, fs = cfg.batch_size // 2, cfg.fine_size
    k_real, k_fake, k_noise, _, k_drop = jax.random.split(jax.random.fold_in(rng, 0), 5)
    d = C2FDDraws(_t(jax.random.randint(k_real, (half,), 0, pool_n)).long(),
                  _t(jax.random.randint(k_fake, (half,), 0, pool_n)).long(),
                  _t(jax.random.uniform(k_noise, (half, fs, fs, 1), jnp.float32, -1.0, 1.0)),
                  _masks(k_drop, step))
    k_cond, k_noise, _, k_drop = jax.random.split(jax.random.fold_in(rng, 1000), 4)
    g = C2FGDraws(_t(jax.random.randint(k_cond, (cfg.batch_size,), 0, pool_n)).long(),
                  _t(jax.random.uniform(k_noise, (cfg.batch_size, fs, fs, 1), jnp.float32,
                                        -1.0, 1.0)),
                  _masks(k_drop, step))
    return C2FStepDraws((d,), (g,))


def _rel_l2(ours, theirs):
    num = sum(float(np.sum((o - t) ** 2)) for o, t in zip(ours, theirs))
    return (num / max(sum(float(np.sum(t ** 2)) for t in theirs), 1e-300)) ** 0.5


@pytest.mark.parametrize("c,method", [(3, "adam"), (1, "adagrad")])
def test_three_steps_match_make_epoch_fn(c, method):
    (jg, jd, jcfg, bundle, jpool), (tcfg, g, d, pool) = _setup(c, method)
    jstate = jax_train_c2f.init_c2f_state(jcfg, bundle)
    start = jax_ckpt.flatten_tree(jstate)
    epoch = jax.jit(jax_train_c2f.make_epoch_fn(jg, jd, jcfg, pool_size=pool.size))
    rng = jax.random.key(5)
    jstate, jm = epoch(jstate, rng, jpool)
    assert len(jm.loss_d) == 3
    tstate, tstep = init_c2f_state(tcfg, g, d), C2FStep(tcfg, g, d)
    for i in range(3):
        tm = tstep(tstate, pool, _draws(jax.random.fold_in(rng, i), tcfg, pool.size, tstep))
        np.testing.assert_allclose(float(tm.loss_d), float(jm.loss_d[i]), rtol=1e-4)
        np.testing.assert_allclose(float(tm.loss_g), float(jm.loss_g[i]), rtol=1e-4)
        assert float(tm.acc_d) == float(jm.acc_d[i])
    tstate.epoch += 1  # facegen's epoch function counts the epoch

    theirs = jax_ckpt.flatten_tree(jstate)
    ours = ckpt.train_state_arrays(tstate)
    assert set(ours) == set(theirs)
    for k in [k for k in theirs if "/" not in k or k.endswith("/count")]:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)
    assert int(ours["epoch"]) == 2 and int(ours["confusion"].sum()) == 3 * BS
    for prefix in ("params_g/", "params_d/"):
        keys = [k for k in theirs if k.startswith(prefix)]
        err = _rel_l2([ours[k] - start[k] for k in keys],
                      [np.asarray(theirs[k]) - start[k] for k in keys])
        assert err <= UPDATE_TOL, (prefix, err)
    kinds = ("mu", "nu") if method == "adam" else ("sum_of_squares",)
    for prefix in [f"opt_{n}/0/{k}/" for n in "gd" for k in kinds]:
        keys = [k for k in theirs if k.startswith(prefix)]
        assert keys
        err = _rel_l2([ours[k] for k in keys], [np.asarray(theirs[k]) for k in keys])
        assert err <= UPDATE_TOL, (prefix, err)


def test_parzen_matches_make_parzen_fn():
    (jg, _, jcfg, bundle, jpool), (tcfg, g, _, pool) = _setup(3, "adam")
    bundle["params_g"] = _scale_weights(bundle["params_g"], 2.0)
    g.load_state_dict(_carry(bundle)["g"], strict=True)
    rng, nn_ = jax.random.key(8), 4
    theirs = jax_train_c2f.make_parzen_fn(jg, jcfg, nn_)(bundle["params_g"], bundle["state_g"],
                                                         rng, jpool)
    k_pick, k_noise = jax.random.split(rng)
    idx = jax.random.randint(k_pick, (jcfg.parzen_samples,), 0, pool.size)
    z = jax.random.uniform(k_noise, (jcfg.parzen_samples, nn_, FS, FS, 1), jnp.float32, -1, 1)
    ours = parzen_distances(g, tcfg, pool, _t(idx).long(), _t(z))
    assert ours.shape == (jcfg.parzen_samples,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-4, atol=1e-6)


def test_refine_c2f_matches_jax():
    jcfg, _ = _configs(3, "adam")
    _, _, bundle = jax_c2f.init_c2f(jax.random.key(13), FS, 3)
    bundle = dict(bundle, params_g=_scale_weights(bundle["params_g"]),
                  params_d=_scale_weights(bundle["params_d"]))
    g, d = c2f.init_c2f(_gen(2), FS, 3)
    sds = _carry(bundle)
    g.load_state_dict(sds["g"], strict=True)
    d.load_state_dict(sds["d"], strict=True)
    n, tries = 12, 5
    imgs = np.random.RandomState(9).uniform(0, 1, (n, CS, CS, 3)).astype(np.float32)
    key = jax.random.key(10)
    theirs = np.asarray(jax_refine_c2f(jcfg, bundle, jnp.asarray(imgs), key, tries=tries))
    z = jax.random.uniform(key, (n, tries, FS, FS, 1), jnp.float32, -1.0, 1.0)
    ours, scores = sample.refine_c2f(g, d, FS, torch.from_numpy(imgs), _t(z))
    # facegen's scores, from the same nets on the same upscaled images and noise
    up = jax.image.resize(jnp.asarray(imgs), (n, FS, FS, 3), "linear")
    cond = jnp.broadcast_to(up[:, None], (n, tries, FS, FS, 3)).reshape(-1, FS, FS, 3)
    jg, jd = jax_c2f.create_g(FS, 3), jax_c2f.create_d(FS, 3)
    diff, _ = jg.apply(bundle["params_g"], bundle["state_g"], (z.reshape(-1, FS, FS, 1), cond),
                       Ctx(None, False))
    logits, _ = jd.apply(bundle["params_d"], bundle["state_d"], (diff, cond), Ctx(None, False))
    j_scores = np.asarray(logits).reshape(n, tries)
    np.testing.assert_allclose(scores.numpy(), j_scores, rtol=TOL, atol=TOL)
    # the choice is defined only where the top two scores are farther apart
    # than the tolerance; compare the chosen candidate and its image there
    top2 = np.sort(j_scores, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * TOL
    assert clear.sum() >= n // 2
    np.testing.assert_array_equal(scores.numpy().argmax(1)[clear], j_scores.argmax(1)[clear])
    np.testing.assert_allclose(ours.numpy()[clear], theirs[clear], rtol=TOL, atol=TOL)
    assert ours.shape == (n, FS, FS, 3) and 0 <= float(ours.min()) and float(ours.max()) <= 1


def test_refine_c2f_runs_without_tf32_and_restores_the_setting():
    """The refinement is fp32 whatever the caller's TF32 setting: off
    inside G's and D's forwards, the caller's own afterwards."""
    g, d = c2f.init_c2f(_gen(3), FS, 1)
    seen = []
    for m in (g, d):
        m.register_forward_pre_hook(lambda *_: seen.append(
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        sample.refine_c2f(g, d, FS, torch.rand(2, CS, CS, 1), torch.rand(2, 3, FS, FS, 1))
        assert seen == [(False, False), (False, False)]
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# -------------------------------------------------------------- checkpoints
def _jax_state(c=1):
    """A facegen C2FState with every leaf set (moments, confusion, epoch 4)."""
    (_, _, jcfg, bundle, _), _ = _setup(c, "adam")
    jstate = jax_train_c2f.init_c2f_state(jcfg, bundle)
    fill = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jax.random.uniform(jax.random.key(a.size), a.shape, a.dtype), t)
    opt = lambda o: (o[0]._replace(count=jnp.int32(7), mu=fill(o[0].mu), nu=fill(o[0].nu)),  # noqa: E731
                     o[1])
    return jcfg, jstate._replace(opt_g=opt(jstate.opt_g), opt_d=opt(jstate.opt_d),
                                 confusion=jnp.array([[3, 1], [2, 2]], jnp.int32),
                                 epoch=jnp.int32(4))


def test_facegen_c2f_checkpoint_resumes_in_the_port(tmp_path):
    jcfg, jstate = _jax_state()
    save = str(tmp_path)
    jcfg = dataclasses.replace(jcfg, save=save, synthetic_data=True)
    jax_ckpt.save(save, jax_train_c2f.ckpt_name(jcfg), jstate,
                  meta={**jax_ckpt.config_meta(jcfg), "epoch": 4})
    jax_ckpt.save(save, jax_train_c2f.ckpt_name(jcfg, best=True), jstate,
                  meta={**jax_ckpt.config_meta(jcfg), "epoch": 3, "parzen": 1.25})
    _, tcfg = _configs(1, "adam", save=save, synthetic_data=True,
                       network=jax_train_c2f.ckpt_name(jcfg))
    trainer = C2FTrainer(tcfg, device="cpu", verbose=False)
    assert trainer.state.epoch == 4 and trainer.best_dist == 1.25
    theirs = jax_ckpt.flatten_tree(jstate)
    ours = ckpt.train_state_arrays(trainer.state)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():  # transposes and renames of the same values
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)
    assert int(ours["opt_d/0/count"]) == 7


def test_port_c2f_checkpoint_loads_in_facegen(tmp_path):
    (_, _, jcfg, bundle, _), (tcfg, g, d, pool) = _setup(3, "adagrad")
    tstate, tstep = init_c2f_state(tcfg, g, d), C2FStep(tcfg, g, d)
    tstep(tstate, pool, draw_c2f_step(_gen(4), tcfg, pool.size, tstep.mask_specs))
    tstate.epoch = 2
    save = str(tmp_path)
    ckpt.save_train_state(save, ckpt_name(tcfg), tstate,
                          {**ckpt.config_meta(tcfg), "epoch": 2})
    template = jax_train_c2f.init_c2f_state(jcfg, bundle)
    restored, meta = jax_ckpt.load(save, ckpt_name(tcfg), template)  # strict
    ours = ckpt.train_state_arrays(tstate)
    theirs = jax_ckpt.flatten_tree(restored)
    assert set(ours) == set(theirs) and int(restored.epoch) == 2 and meta["epoch"] == 2
    for k, v in theirs.items():
        np.testing.assert_array_equal(np.asarray(v), ours[k], err_msg=k)
    # facegen's sampler-side restore rebuilds the geometry from meta.json
    *_, res = jax_c2f.restore_c2f(ckpt_name(tcfg), default_dir=save)
    assert (res["fine_size"], res["coarse_size"], res["channels"]) == (FS, CS, 3)


def test_resume_checks_every_c2f_leaf(tmp_path):
    _, (tcfg, g, d, _) = _setup(1, "adam")
    tstate = init_c2f_state(tcfg, g, d)
    ckpt.save_train_state(str(tmp_path), "net", tstate)
    arrays, meta = ckpt.load(str(tmp_path), "net")
    del arrays["opt_g/0/nu/body/08_conv5/w"]
    ckpt.save(str(tmp_path), "net", arrays, meta)
    with pytest.raises(KeyError, match="opt_g/0/nu/body/08_conv5/w"):
        ckpt.load_train_state(str(tmp_path), "net", tstate)


def test_trainer_trains_saves_and_resumes_on_the_cpu(tmp_path):
    """Two epochs with the grid and a checkpoint each, then a resume for
    a third: the checkpoint, its .old, the _best checkpoint and its
    parzen, metrics_c2f.jsonl."""
    save = str(tmp_path / "logs")
    _, cfg = _configs(1, "adam", save=save, synthetic_data=True, save_freq=1, n_epoch=16)
    trainer = C2FTrainer(cfg, device="cpu", verbose=False)
    first = list(trainer.run(2))
    assert trainer.state.epoch == 3
    name = ckpt_name(cfg)
    for n in (name, name + ".old", name + "_best"):
        assert os.path.exists(os.path.join(save, n, "arrays.npz")), n
    assert os.path.getsize(os.path.join(save, "viz", "c2f_samples.png")) > 0
    best = json.load(open(os.path.join(save, name + "_best", "meta.json")))
    assert best["parzen"] == min(s["parzen"] for s in first)
    for s in first:
        assert np.isfinite(s["loss_d_mean"]) and np.isfinite(s["loss_g_mean"]) and s["parzen"] > 0
    resumed = C2FTrainer(dataclasses.replace(cfg, network=name, noplot=True), device="cpu",
                         verbose=False)
    assert resumed.state.epoch == 3 and resumed.best_dist == best["parzen"]
    (third,) = list(resumed.run(1))
    assert third["epoch"] == 3 and resumed.state.epoch == 4
    meta = json.load(open(os.path.join(save, name, "meta.json")))
    assert meta["epoch"] == 4 and meta["config"]["fine_size"] == FS
    rows = [json.loads(line) for line in open(os.path.join(save, "metrics_c2f.jsonl"))]
    assert [r["epoch"] for r in rows] == [1, 2, 3]


# ------------------------------------------------------------------ sampler
def _c2f_checkpoint(save, name, fine, coarse, gray, seed):
    g, d = c2f.init_c2f(_gen(seed), fine, 1 if gray else 3)
    ckpt.save_gan(save, name, g, d, {"fine_size": fine, "coarse_size": coarse,
                                     "grayscale": gray})
    return g, d


def _base_checkpoint(save):
    g, d = gan.init_gan(_gen(8), 16, 1, 16, reference_init=False)
    ckpt.save_gan(save, "adversarial", g, d,
                  {"scale": 16, "grayscale": True, "noise_dim": 16, "noise_view": "nhwc"})


def test_run_sampling_with_c2f_writes_the_refined_grids(tmp_path):
    from PIL import Image

    save = str(tmp_path / "logs")
    _base_checkpoint(save)
    g, d = _c2f_checkpoint(save, "adversarial_c2f_16_to_32", FS, CS, True, 5)
    cfg = SampleConfig(save=save, writeto=str(tmp_path / "samples"), runs=2, c2f=True,
                       c2f_tries=2, seed=2)
    rs = np.random.RandomState(7)
    noise = rs.uniform(-1, 1, (2, 1024, 16)).astype(np.float32)
    c2f_noise = rs.uniform(-1, 1, (2, 3, 64, 2, FS, FS, 1)).astype(np.float32)
    outputs = sample.run_sampling(cfg, device="cpu", noise=noise, c2f_noise=c2f_noise,
                                  verbose=False)
    names = {os.path.basename(o) for o in outputs}
    for run in (1, 2):
        for label in ("best", "worst", "random"):
            assert f"{label}_{run:04d}_c2f_{FS}.png" in names
            assert f"{label}_{run:04d}_base.png" in names
    assert len(names) == 16
    # run 1's best grid is the refinement of its best 64 on the injected noise
    base_g, base_d, _ = sample.load_models(cfg, "cpu")
    inf = sample.GanInference(base_g, base_d, 16)
    best, _ = inf.rank(inf.generate(torch.from_numpy(noise[0])), max_out=64)
    refined, _ = sample.refine_c2f(g, d, FS, best, torch.from_numpy(c2f_noise[0, 0]))
    grid = np.asarray(Image.open(tmp_path / "samples" / "best_0001_c2f_8.png"))
    assert grid.shape == (8 * (FS + 1) + 1,) * 2
    expected = np.clip(refined[0, :, :, 0].numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(grid[1:1 + FS, 1:1 + FS], expected)


def test_c2f_checkpoints_of_another_geometry_are_refused(tmp_path):
    save = str(tmp_path)
    _base_checkpoint(save)
    _c2f_checkpoint(save, "adversarial_c2f_16_to_32", FS, CS, True, 5)
    _c2f_checkpoint(save, "d_other", 16, 8, True, 6)
    _c2f_checkpoint(save, "colour", FS, CS, False, 7)
    cfg = SampleConfig(save=save, c2f=True, d_c2f_network="d_other")
    with pytest.raises(ValueError, match="fine_size=16"):
        sample.load_c2f(cfg, "cpu")
    cfg = SampleConfig(save=save, c2f=True, c2f_network="colour",
                       writeto=str(tmp_path / "out"))
    with pytest.raises(ValueError, match="3 channels"):
        sample.run_sampling(cfg, device="cpu", verbose=False)
    # a D of the same geometry from another checkpoint is taken
    _, d_same = _c2f_checkpoint(save, "d_same", FS, CS, True, 9)
    _, d, res = sample.load_c2f(SampleConfig(save=save, d_c2f_network="d_same"), "cpu")
    assert res["fine_size"] == FS
    for k, t in d_same.state_dict().items():
        assert torch.equal(d.state_dict()[k], t), k
