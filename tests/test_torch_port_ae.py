"""The port's autoencoder and denoiser against facegen's, on the CPU.

facegen's modules are initialised and their leaves carried into the port
with the checkpoint converter; both packages run the same numpy inputs in
fp32, and the port takes facegen's random draws (the permutation, the
white noise and the dropout masks, rebuilt from facegen's keys as
facegen/train/ae_loop.py:75-81 and :212-220 fold and split them).
Tolerances, each with its reason:

- layers, train and eval mode, and the validation BCE: 1e-5, the same
  fp32 ops (a conv or a 64-term sum in another order, ~1e-7);
- the nets, and ``load_denoiser_fn``'s output: 2e-4 and 1e-5, dense
  layers of up to 2048 inputs summed in other orders;
- 3 steps of each trainer against facegen's epoch functions: losses 1e-4
  relative; the parameters' change, the batch-norm statistics and Adam's
  moments 1e-3 relative l2 per network. Normwise, because ``conv1``,
  ``conv2`` and ``fc1`` each have a bias in front of a batch norm: its
  exact gradient is 0, so what each side computes is rounding noise,
  which Adam can turn into a step of either sign (see
  tests/test_torch_port_train_step.py);
- checkpoints: the same leaves, shapes and values, exactly.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen.config import TrainConfig as JaxTrainConfig
from facegen.models import ae as jax_ae
from facegen.nn import Ctx, layers as JL, sequential as jax_sequential
from facegen.nn.core import param_count
from facegen.nn.init import gaussian_overwrite as jax_gaussian_overwrite
from facegen.train import ae_loop as jax_ae_loop
from facegen.utils import checkpoint as jax_ckpt
from facegen_torch import train, train_autoencoder, train_denoiser
from facegen_torch.config import TrainConfig, train_config_from_args
from facegen_torch.models import ae
from facegen_torch.nn import dropout
from facegen_torch.nn import layers as L
from facegen_torch.train import optim
from facegen_torch.train.ae_loop import (
    AEDraws,
    AEStep,
    DenoiserDraws,
    DenoiserState,
    DenoiserStep,
    DenoiserTrainer,
    denoiser_val_loss,
)
from facegen_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYER_TOL = 1e-5
NET_TOL = 2e-4
UPDATE_TOL = 1e-3


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _randomize(tree, seed):
    """Every leaf U(0.5, 1.5): batch-norm statistics (variances positive),
    scales and biases away from their init values."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(rs.uniform(0.5, 1.5, np.shape(x)).astype(np.float32))
                  for x in leaves])


def _carry(module, params, state):
    """facegen's params and state of a sequential -> the port's module."""
    ckpt.load_module_arrays(jax_ckpt.flatten_tree({"params": params, "state": state}), module,
                            "params", "state")
    return module


def _rel_l2(ours, theirs):
    num = sum(float(np.sum((np.asarray(o) - np.asarray(t)) ** 2)) for o, t in zip(ours, theirs))
    return (num / max(sum(float(np.sum(np.asarray(t) ** 2)) for t in theirs), 1e-300)) ** 0.5


# (name, facegen layer, port layer, per-example input shape)
LAYER_CASES = [
    ("conv_valid", JL.conv2d(8, 3, padding="VALID", name="conv"),
     lambda: L.Conv2d(3, 8, 3, padding="VALID", generator=_gen()), (7, 6, 3)),
    ("leaky_relu", JL.leaky_relu(1.0 / 3.0), lambda: L.LeakyReLU(1.0 / 3.0), (5, 5, 4)),
    ("relu", JL.relu(), lambda: L.ReLU(), (12,)),
    ("tanh", JL.tanh(), lambda: L.Tanh(), (12,)),
    ("white_noise", JL.white_noise(0.0, 0.1), lambda: L.WhiteNoise(0.0, 0.1), (6, 6, 3)),
    # the decoder's batch norm over (N, 2048) after fc1, at a narrower width
    ("batch_norm_nf", JL.batch_norm(), lambda: L.BatchNorm(64), (64,)),
    ("batch_norm_nhwc", JL.batch_norm(), lambda: L.BatchNorm(8), (4, 4, 8)),
]


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,jax_layer,make,in_shape", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_jax(name, jax_layer, make, in_shape, train_mode):
    jm = jax_sequential(jax_layer)
    params, state, out_shape = jm.init(jax.random.key(0), in_shape)
    if name.startswith("batch_norm"):
        params, state = _randomize(params, 1), _randomize(state, 2)
    port = L.sequential((jax_layer.name, make()))
    _carry(port, params, state)
    port.train(train_mode)
    x = np.random.RandomState(3).randn(10, *in_shape).astype(np.float32)
    key = jax.random.key(4)
    theirs, new_state = jm.apply(params, state, jnp.asarray(x), Ctx(key, train_mode))
    if name == "white_noise":
        # facegen's sequential folds the layer's index into the key
        port[0].draw = _t(jax.random.normal(jax.random.fold_in(key, 0), x.shape, jnp.float32))
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    assert ours.shape == (10,) + tuple(out_shape)
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=LAYER_TOL, atol=LAYER_TOL)
    if name == "white_noise":
        assert (np.abs(ours - x).max() > 0.1) == train_mode
    # the running statistics: moved in train mode, untouched in eval mode
    for key_, arr in jax_ckpt.flatten_tree({"state": new_state}).items():
        got = ckpt.module_arrays(port, "params", "state")[key_]
        np.testing.assert_allclose(got, arr, rtol=LAYER_TOL, atol=LAYER_TOL, err_msg=key_)


def test_white_noise_rejects_a_draw_of_another_shape():
    layer = L.WhiteNoise().train()
    layer.draw = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="draw"):
        layer(torch.zeros(2, 4))
    assert torch.equal(L.WhiteNoise().eval()(torch.ones(2, 4)), torch.ones(2, 4))


# (name, facegen factory, port factory, scale, channels)
NET_CASES = [
    ("autoencoder", lambda s, c: jax_ae.create_autoencoder(s, c, 32),
     lambda s, c: ae.create_autoencoder(s, c, 32, generator=_gen()), 8, 1),
    ("decoder_rgb", lambda s, c: jax_ae.create_denoiser_decoder(s, c),
     lambda s, c: ae.create_denoiser_decoder(s, c, generator=_gen()), 8, 3),
    ("decoder_gray16", lambda s, c: jax_ae.create_denoiser_decoder(s, c),
     lambda s, c: ae.create_denoiser_decoder(s, c, generator=_gen()), 16, 1),
]


def _masks(key, specs):
    """facegen's dropout masks under ``key`` for the port's ``specs``
    (each layer's key folds its index into the net's)."""
    return {name: _t(jax.random.bernoulli(jax.random.fold_in(key, int(name[:2])), 1.0 - rate,
                                          shape))
            for name, (shape, rate) in specs.items()}


@pytest.mark.parametrize("name,jax_create,create,s,c", NET_CASES, ids=[n[0] for n in NET_CASES])
def test_net_matches_jax(name, jax_create, create, s, c):
    """Eval mode, and train mode on facegen's dropout masks (the batch
    norms on batch statistics); the parameter counts equal."""
    jm = jax_create(s, c)
    params, state, _ = jm.init(jax.random.key(5), (s, s, c))
    state = jax.tree_util.tree_map(
        lambda a: a + 0.5 * jax.random.uniform(jax.random.key(a.size), a.shape), state)
    port = _carry(create(s, c), params, state)
    assert sum(p.numel() for p in port.parameters()) == param_count(params)
    x = np.random.RandomState(6).uniform(0, 1, (6, s, s, c)).astype(np.float32)
    key = jax.random.key(7)
    specs = dropout.dropout_mask_specs(port, 6, (s, s, c))
    assert sorted(specs) == (["05_dropout"] if name == "autoencoder"
                             else ["06_dropout", "11_dropout"])
    for train_mode in (False, True):
        theirs, _ = jm.apply(params, state, jnp.asarray(x), Ctx(key, train_mode))
        port.train(train_mode)
        if train_mode:
            dropout.set_dropout_masks(port, _masks(key, specs))
        with torch.no_grad():
            ours = port(torch.from_numpy(x)).numpy()
        assert ours.shape == (6, s, s, c) and np.asarray(theirs).std() > 1e-3
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=NET_TOL, atol=NET_TOL)


# ------------------------------------------------------------- train steps
POOL, BATCH = 64, 20  # 3 batches a permutation, the last 4 rows dropped


def _pool(s, c, seed=8):
    return np.random.RandomState(seed).randint(0, 256, (POOL, s, s, c)).astype(np.uint8)


def _perm_batches(rng):
    perm = np.asarray(jax.random.permutation(jax.random.fold_in(rng, 0), POOL))
    return _t(perm[: 3 * BATCH].reshape(3, BATCH)).long()


FLAG_CASES = [{}, {"coef_l1": 1e-4, "coef_l2": 1e-3, "ae_clamp": 0.0}]


@pytest.mark.parametrize("flags", FLAG_CASES, ids=["defaults", "penalty_no_clamp"])
def test_three_ae_steps_match_make_ae_epoch(flags):
    s, c = 8, 1
    kw = dict(batch_size=BATCH, scale=s, grayscale=True, noise_dim=32, **flags)
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw).validate()
    model = jax_ae.create_autoencoder(s, c, 32)
    params, state, _ = model.init(jax.random.key(9), (s, s, c))
    params = jax_gaussian_overwrite(params, jax.random.key(10))
    opt = optax.adam(1e-3).init(params)
    pool = _pool(s, c)
    rng = jax.random.key(11)
    tree = {"params": params, "state": state, "opt": opt}
    start = jax_ckpt.flatten_tree(tree)
    p1, s1, o1, jlosses = jax_ae_loop.make_ae_epoch(model, jcfg)(params, state, opt, rng,
                                                                 jnp.asarray(pool))
    assert len(jlosses) == 3

    port = _carry(ae.create_autoencoder(s, c, 32, generator=_gen()), params, state)
    topt = optim.adam(1e-3).init(list(port.parameters()))
    step = AEStep(tcfg, port)
    for i, idx in enumerate(_perm_batches(rng)):
        masks = _masks(jax.random.fold_in(rng, 1 + i), step.mask_specs)
        loss = step(port, topt, torch.from_numpy(pool), AEDraws(idx, masks))
        np.testing.assert_allclose(float(loss), float(jlosses[i]), rtol=1e-4)

    theirs = jax_ckpt.flatten_tree({"params": p1, "state": s1, "opt": o1})
    ours = ckpt.autoencoder_arrays(port, topt)
    assert set(ours) == set(theirs) and int(ours["opt/0/count"]) == 3
    keys = [k for k in theirs if k.startswith("params/")]
    assert _rel_l2([ours[k] - start[k] for k in keys],
                   [np.asarray(theirs[k]) - start[k] for k in keys]) <= UPDATE_TOL
    for kind in ("mu", "nu"):
        keys = [k for k in theirs if k.startswith(f"opt/0/{kind}/")]
        assert _rel_l2([ours[k] for k in keys], [theirs[k] for k in keys]) <= UPDATE_TOL, kind


def _denoiser_draws(rng, i, s, c, specs):
    """facegen's draws of step ``i`` (facegen/train/ae_loop.py:219-220)."""
    k_enc, k_d1, k_enc2, k_d1b, k_d2 = jax.random.split(jax.random.fold_in(rng, 1 + i), 5)

    def noise(k):  # the encoder's white noise is its layer 0
        return _t(jax.random.normal(jax.random.fold_in(k, 0), (BATCH, s, s, c), jnp.float32))

    return (noise(k_enc), _masks(k_d1, specs), noise(k_enc2), _masks(k_d1b, specs),
            _masks(k_d2, specs))


def _jax_denoiser(s, c, seed=12):
    enc, dec1, dec2, bundle = jax_ae.init_denoiser(jax.random.key(seed), s, c)
    return enc, dec1, dec2, bundle


def _port_denoiser(bundle, s, c):
    enc, dec1, dec2 = ae.init_denoiser(_gen(1), s, c)
    for key, dec in (("AE1_DECODER", dec1), ("AE2_DECODER", dec2)):
        _carry(dec, bundle[key]["params"], bundle[key]["state"])
    return enc, dec1, dec2


@pytest.mark.parametrize("s,c,flags", [(8, 3, FLAG_CASES[0]), (16, 1, FLAG_CASES[1])],
                         ids=["rgb8_defaults", "gray16_penalty_no_clamp"])
def test_three_denoiser_steps_match_make_denoiser_epoch(s, c, flags):
    kw = dict(batch_size=BATCH, scale=s, grayscale=c == 1, **flags)
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw).validate()
    enc, dec1, dec2, bundle = _jax_denoiser(s, c)
    tx = optax.adam(1e-3)
    opt1, opt2 = tx.init(bundle["AE1_DECODER"]["params"]), tx.init(bundle["AE2_DECODER"]["params"])
    pool = _pool(s, c)
    rng = jax.random.key(13)
    start = jax_ckpt.flatten_tree(bundle)
    epoch = jax_ae_loop.make_denoiser_epoch(enc, dec1, dec2, jcfg)
    jb, jo1, jo2, jlosses = epoch(bundle, opt1, opt2, rng, jnp.asarray(pool))
    assert jlosses.shape == (3, 2)

    tenc, tdec1, tdec2 = _port_denoiser(bundle, s, c)
    tx_t = optim.adam(1e-3)
    st = DenoiserState(tenc, tdec1, tdec2, tx_t.init(list(tdec1.parameters())),
                       tx_t.init(list(tdec2.parameters())))
    step = DenoiserStep(tcfg, tdec1)
    for i, idx in enumerate(_perm_batches(rng)):
        draws = DenoiserDraws(idx, *_denoiser_draws(rng, i, s, c, step.mask_specs))
        pair = step(st, torch.from_numpy(pool), draws)
        np.testing.assert_allclose(pair.numpy(), np.asarray(jlosses[i]), rtol=1e-4)

    theirs = jax_ckpt.flatten_tree(jb)
    ours = ckpt.denoiser_arrays(tdec1, tdec2)
    assert set(ours) == set(theirs)
    for net, topt, jopt in (("AE1_DECODER", st.opt1, jo1), ("AE2_DECODER", st.opt2, jo2)):
        keys = [k for k in theirs if k.startswith(f"{net}/params/")]
        assert _rel_l2([ours[k] - start[k] for k in keys],
                       [np.asarray(theirs[k]) - start[k] for k in keys]) <= UPDATE_TOL, net
        keys = [k for k in theirs if k.startswith(f"{net}/state/")]
        assert len(keys) == 6  # three batch norms' means and variances
        assert _rel_l2([ours[k] for k in keys], [theirs[k] for k in keys]) <= UPDATE_TOL, net
        ours_opt = ckpt.module_arrays(tdec1 if net == "AE1_DECODER" else tdec2, "p", "s",
                                      topt, "opt")
        theirs_opt = jax_ckpt.flatten_tree({"opt": jopt})
        assert int(ours_opt["opt/0/count"]) == int(theirs_opt["opt/0/count"]) == 3
        for kind in ("mu", "nu"):
            keys = [k for k in theirs_opt if k.startswith(f"opt/0/{kind}/")]
            assert _rel_l2([ours_opt[k] for k in keys],
                           [theirs_opt[k] for k in keys]) <= UPDATE_TOL, (net, kind)


def test_denoiser_val_loss_matches_make_denoiser_val():
    s, c = 8, 3
    _, dec1, _, bundle = _jax_denoiser(s, c)
    p, st, _ = dec1.init(jax.random.key(14), (s, s, c))  # torch's reset: outputs not flat
    bundle["AE1_DECODER"] = {"params": p, "state": _randomize(st, 15)}
    pool = _pool(s, c, seed=16)
    theirs = jax_ae_loop.make_denoiser_val(dec1, JaxTrainConfig(scale=s))(bundle,
                                                                          jnp.asarray(pool))
    _, tdec1, _ = _port_denoiser(bundle, s, c)
    ours = denoiser_val_loss(tdec1, torch.from_numpy(pool))
    np.testing.assert_allclose(float(ours), float(theirs), rtol=LAYER_TOL)


def test_bce_is_facegens_clipped_form():
    from facegen_torch.train.ae_loop import bce

    y = np.array([0.0, 1e-9, 0.3, 1.0, 1.0 - 1e-9], np.float32)
    t = np.array([1.0, 0.0, 0.6, 0.0, 1.0], np.float32)
    np.testing.assert_allclose(float(bce(torch.from_numpy(y), torch.from_numpy(t))),
                               float(jax_ae_loop._bce(jnp.asarray(y), jnp.asarray(t))),
                               rtol=1e-6)


# -------------------------------------------------------------- checkpoints
def _jax_ae_tree(s=8, noise_dim=32):
    model = jax_ae.create_autoencoder(s, 1, noise_dim)
    params, state, _ = model.init(jax.random.key(17), (s, s, 1))
    opt = optax.adam(1e-3).init(params)
    fill = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jax.random.uniform(jax.random.key(a.size), a.shape, a.dtype), t)
    opt = (opt[0]._replace(count=jnp.int32(7), mu=fill(opt[0].mu), nu=fill(opt[0].nu)), opt[1])
    return {"params": params, "state": state, "opt": opt}


def _port_pair(kind, s=8):
    if kind == "autoencoder":
        model = ae.create_autoencoder(s, 1, 32, generator=_gen(2))
        opt = optim.adam(1e-3).init(list(model.parameters()))
        return model, opt
    _, dec1, dec2 = ae.init_denoiser(_gen(3), s, 3)
    return dec1, dec2


@pytest.mark.parametrize("kind", ["autoencoder", "denoiser"])
def test_facegen_checkpoint_loads_in_the_port(kind, tmp_path):
    save = str(tmp_path)
    if kind == "autoencoder":
        tree, name = _jax_ae_tree(), jax_ae.AE_CKPT_NAME
    else:
        *_, tree = _jax_denoiser(8, 3)
        tree["AE1_DECODER"]["state"] = _randomize(tree["AE1_DECODER"]["state"], 18)
        name = jax_ae.denoiser_ckpt_name(8, 3)
    jax_ckpt.save(save, name, tree, meta={"epoch": 4})
    a, b = _port_pair(kind)
    if kind == "autoencoder":
        meta = ckpt.load_autoencoder(save, name, a, b)
        ours = ckpt.autoencoder_arrays(a, b)
    else:
        meta = ckpt.load_denoiser(save, name, a, b)
        ours = ckpt.denoiser_arrays(a, b)
    theirs = jax_ckpt.flatten_tree(tree)
    assert meta["epoch"] == 4 and set(ours) == set(theirs)
    for k, v in theirs.items():  # transposes and renames of the same values
        assert ours[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("kind", ["autoencoder", "denoiser"])
def test_port_checkpoint_loads_in_facegen(kind, tmp_path):
    save = str(tmp_path)
    a, b = _port_pair(kind)
    if kind == "autoencoder":
        with torch.no_grad():
            b["count"].fill_(5)
            for m in b["mu"] + b["nu"]:
                m.uniform_(0, 1, generator=_gen(4))
        name = jax_ae.AE_CKPT_NAME
        ckpt.save_autoencoder(save, name, a, b, meta={"epoch": 3})
        template, ours = _jax_ae_tree(), ckpt.autoencoder_arrays(a, b)
    else:
        with torch.no_grad():
            for buf in a.buffers():
                buf.uniform_(0.5, 1.5, generator=_gen(5))
        name = ae.denoiser_ckpt_name(8, 3)
        ckpt.save_denoiser(save, name, a, b, meta={"epoch": 3})
        *_, template = _jax_denoiser(8, 3)
        ours = ckpt.denoiser_arrays(a, b)
    restored, meta = jax_ckpt.load(save, name, template)  # strict
    theirs = jax_ckpt.flatten_tree(restored)
    assert meta["epoch"] == 3 and set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(np.asarray(v), ours[k], err_msg=k)
    assert os.path.exists(os.path.join(save, name, "meta.json"))


def test_load_denoiser_fn_matches_jax(tmp_path):
    s, c = 8, 3
    save = str(tmp_path)
    _, dec1, _, bundle = _jax_denoiser(s, c)
    p, st, _ = dec1.init(jax.random.key(19), (s, s, c))
    bundle["AE1_DECODER"] = {"params": p, "state": _randomize(st, 20)}
    jax_ckpt.save(save, jax_ae.denoiser_ckpt_name(s, c), bundle)
    images = np.random.RandomState(21).uniform(0, 1, (5, s, s, c)).astype(np.float32)
    theirs = jax_ae.load_denoiser_fn(JaxTrainConfig(save=save, scale=s))(jnp.asarray(images))
    ours = ae.load_denoiser_fn(TrainConfig(save=save, scale=s), "cpu")(torch.from_numpy(images))
    assert ours.dtype == torch.float32 and np.asarray(theirs).std() > 1e-3
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=LAYER_TOL, atol=LAYER_TOL)
    with pytest.raises(FileNotFoundError, match="denoiser_1x8x8"):
        ae.load_denoiser_fn(TrainConfig(save=save, scale=s, grayscale=True), "cpu")


# ------------------------------------------------------------------ trainers
def _cli(name):
    return {"autoencoder": train_autoencoder, "denoiser": train_denoiser}[name]


@pytest.mark.parametrize("name", ["autoencoder", "denoiser"])
def test_a_pool_smaller_than_the_batch_is_refused(name, tmp_path):
    with pytest.raises(ValueError, match="smaller than batchSize 16"):
        _cli(name).main(["--syntheticData", "--save", str(tmp_path), "--N_epoch", "12",
                         "--batchSize", "16", "--scale", "8"], device="cpu")


def test_autoencoder_cli_trains_and_saves_on_the_cpu(tmp_path):
    save = str(tmp_path / "logs")
    trainer = train_autoencoder.main(["--syntheticData", "--save", save, "--N_epoch", "40",
                                      "--batchSize", "8", "--scale", "8", "--epochs", "2"],
                                     device="cpu")
    assert trainer.cfg.grayscale and trainer.cfg.noise_dim == 256 and trainer.epoch == 2
    assert trainer.pool.shape == (40, 8, 8, 1)
    meta = json.load(open(os.path.join(save, "autoencoder", "meta.json")))
    assert meta["epoch"] == 2 and meta["config"]["noise_dim"] == 256
    assert not os.path.exists(os.path.join(save, "autoencoder.old"))  # saved once, at the end
    assert os.path.getsize(os.path.join(save, "viz", "ae_recon.png")) > 0
    arrays, _ = ckpt.load(save, "autoencoder")
    assert int(arrays["opt/0/count"]) == 2 * 5 and arrays["params/03_enc2/w"].shape == (512, 256)


def test_denoiser_resume_restores_the_epoch_and_starts_adam_fresh(tmp_path):
    save = str(tmp_path / "logs")
    argv = ["--syntheticData", "--save", save, "--N_epoch", "24", "--batchSize", "8",
            "--scale", "8"]
    first = train_denoiser.main(argv + ["--epochs", "2"], device="cpu")
    assert first.epoch == 2 and int(first.state.opt1["count"]) == 2 * 3
    name = ae.denoiser_ckpt_name(8, 3)
    assert os.path.getsize(os.path.join(save, "viz", "denoiser_recon.png")) > 0
    cfg = dataclasses.replace(first.cfg, network="1", noplot=True)  # a bare sentinel
    resumed = DenoiserTrainer(cfg, device="cpu", verbose=False)
    assert resumed.epoch == 2 and int(resumed.state.opt1["count"]) == 0
    assert not any(m.any() for m in resumed.state.opt2["mu"])
    for a, b in zip(resumed.state.dec2.state_dict().values(), first.state.dec2.state_dict().values()):
        assert torch.equal(a, b)
    (third,) = list(resumed.run(1))
    assert third["epoch"] == 3 and np.isfinite([third["loss_ae1"], third["loss_ae2"],
                                                third["val_loss"]]).all()
    assert json.load(open(os.path.join(save, name, "meta.json")))["epoch"] == 3
    assert resumed.val_pool.shape == (256, 8, 8, 3)


def _jax_cli_config(name, argv, monkeypatch):
    """facegen's root train_autoencoder.py / train_denoiser.py config for
    ``argv`` (its trainer stubbed)."""
    script = f"train_{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}_cli", os.path.join(REPO, script))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    seen = {}

    class Stop(Exception):
        pass

    def trainer(cfg, **kw):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(cli, f"train_{name}", trainer)
    with pytest.raises(Stop):
        cli.main(argv)
    return seen["cfg"]


@pytest.mark.parametrize("name,argv", [
    ("autoencoder", []), ("denoiser", []),
    ("autoencoder", ["--scale", "24", "--noiseDim", "64", "--coefL1", "1e-4", "--epochs", "3"]),
    ("denoiser", ["--scale", "12", "--grayscale", "--AE_clamp", "0", "--coefL2", "1e-3"]),
])
def test_cli_configs_parse_like_jax(name, argv, monkeypatch):
    theirs = _jax_cli_config(name, argv, monkeypatch)
    seen = {}

    class Trainer:  # stands in for the CLI's trainer: records its config
        def __init__(self, cfg, device, mesh=None):
            seen["cfg"] = cfg

        def run(self):
            return iter(())

    cls = {"autoencoder": "AETrainer", "denoiser": "DenoiserTrainer"}[name]
    monkeypatch.setattr(f"facegen_torch.train_{name}.{cls}", Trainer)
    _cli(name).main(argv, device="cpu")
    ours = seen["cfg"]
    for f in dataclasses.fields(TrainConfig):
        if hasattr(theirs, f.name) and f.name != "mesh_shape":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


@pytest.mark.parametrize("name", ["autoencoder", "denoiser"])
def test_cli_refuses_several_devices_and_needs_a_gpu(name, monkeypatch, capsys):
    # several devices run on the 2-D mesh (tests/test_torch_port_gspmd.py):
    # without a process group the CLI says how to launch them
    with pytest.raises(SystemExit) as e:
        _cli(name).main(["--meshShape", "2"], device="cpu")
    assert e.value.code != 0 and "launch 2 processes" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        _cli(name).main(["--syntheticData"])
    assert "no CUDA GPU" in str(e.value.code)


def test_gan_cli_keeps_its_scale_limit(tmp_path):
    """The GAN trainer holds --scale to its nets' 16 or 32; the config
    the AE and denoiser CLIs share with it does not."""
    argv = ["--syntheticData", "--save", str(tmp_path), "--scale", "24"]
    assert train_config_from_args(argv).scale == 24
    with pytest.raises(ValueError, match="G16/G32"):
        train.main(argv, device="cpu")


# ------------------------------------------------------------- --denoise
def _gan_argv(save):
    return ["--syntheticData", "--save", save, "--scale", "16", "--grayscale", "--batchSize",
            "4", "--N_epoch", "8", "--noiseDim", "8", "--denoise", "--epochs", "1"]


def test_trainer_with_denoise_writes_samples_denoised(tmp_path):
    from PIL import Image

    save = str(tmp_path / "logs")
    _, dec1, dec2 = ae.init_denoiser(_gen(6), 16, 1)
    ckpt.save_denoiser(save, ae.denoiser_ckpt_name(16, 1), dec1, dec2)
    trainer = train.main(_gan_argv(save), device="cpu")
    assert trainer.denoiser is not None
    viz = os.path.join(save, "viz")
    denoised = np.asarray(Image.open(os.path.join(viz, "samples_denoised.png")))
    fixed = np.asarray(Image.open(os.path.join(viz, "samples_fixed.png")))
    assert denoised.shape == fixed.shape == (10 * 17 + 1,) * 2
    assert not np.array_equal(denoised, fixed)
    # the grid is AE1's decoder on G's fixed samples
    images = torch.rand(3, 16, 16, 1, generator=_gen(7))
    with torch.no_grad():
        np.testing.assert_allclose(trainer.denoiser(images).numpy(), dec1.eval()(images).numpy(),
                                   rtol=0, atol=0)


def test_trainer_with_denoise_fails_without_the_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="denoiser_1x16x16"):
        train.main(_gan_argv(str(tmp_path / "logs")), device="cpu")
