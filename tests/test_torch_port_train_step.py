"""The port's train step against facegen's make_train_step, and training
checkpoints across the two packages.

Both packages start from the same weights (facegen's init carried over
with the checkpoint converter) and take 3 steps on the same uint8 pool;
the port gets facegen's own draws, rebuilt from its keys: per step
``rng``, the D iteration splits fold_in(rng, 0) into (idx, noise, G,
dropout) keys and the G iteration splits fold_in(rng, 1000) into (noise,
G, dropout) (facegen/train/step.py:269-273,342-345); a dropout layer's
mask is bernoulli(keep) on the dropout key folded with each index along
the layer's qualified name (facegen/nn/core.py:49-53,101-105). Before
the second step both gate rings are filled with accuracy 1, which
closes the gate (D_maxAcc 0.97); before the third they are emptied
again. fp32 on the CPU.

Compared after the 3 steps, leaf by leaf under facegen's checkpoint
paths (utils/checkpoint.py:train_state_arrays): the counters (accs_n,
confusion, trained_d, not_trained_d, Adam's counts) and the ring of
accuracies exactly; per network and per kind, relative l2 errors of the
parameters' change from their start and of Adam's moments within 1e-3,
and batch-norm statistics within 1e-5 absolute. Both sides compute the
same sums in other orders (~1e-6 relative); Adam's step moves every
entry by about lr x the sign of its gradient, so an entry whose
gradient is as small as its rounding noise can move either way, which
the l2 error bounds and an elementwise check would not. G's upsample-
conv biases feed batch norms (exact gradient 0): G gets nonzero biases
and an L2 penalty (G_L2 1e-3, with the reference's sign-term bug), so
those gradients are the penalty's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen.config import TrainConfig as JaxTrainConfig
from facegen.models import gan as jax_gan
from facegen.train.step import init_state as jax_init_state
from facegen.train.step import make_train_step
from facegen.utils import checkpoint as jax_ckpt
from facegen_torch.config import TrainConfig
from facegen_torch.models import gan
from facegen_torch.train.step import (
    DDraws,
    GDraws,
    StepDraws,
    TrainStep,
    draw_step,
    init_state,
)
from facegen_torch.utils import checkpoint as ckpt

CASES = [(32, 3, 4), (16, 1, 8)]  # (scale, channels, batch): G32 + D32b, G16 + D16_d gray
NOISE_DIM = 16
UPDATE_TOL = 1e-3
STAT_TOL = 1e-5


def _configs(scale, channels, bs):
    kw = dict(batch_size=bs, scale=scale, grayscale=channels == 1, noise_dim=NOISE_DIM,
              compute_dtype="float32", reference_init=False, g_l2=1e-3, d_max_acc=0.97)
    return JaxTrainConfig(**kw).validate(), TrainConfig(**kw).validate()


def _setup(scale, channels, bs):
    jcfg, tcfg = _configs(scale, channels, bs)
    jg, jd, bundle = jax_gan.init_gan(jax.random.key(scale), scale, channels, NOISE_DIM,
                                      reference_init=False)
    bundle["params_g"] = jax.tree_util.tree_map_with_path(
        lambda p, a: jax.random.uniform(jax.random.key(a.size), a.shape, minval=-0.1,
                                        maxval=0.1) if p[-1].key == "b" else a,
        bundle["params_g"])
    g, d = gan.init_gan(torch.Generator().manual_seed(0), scale, channels, NOISE_DIM,
                        reference_init=False)
    sds = ckpt.jax_to_torch(jax_ckpt.flatten_tree(bundle))
    g.load_state_dict(sds["g"], strict=True)
    d.load_state_dict(sds["d"], strict=True)
    pool = np.random.RandomState(7).randint(0, 256, (32, scale, scale, channels), np.uint8)
    return (jg, jd, jcfg, jax_init_state(jcfg, bundle)), (tcfg, init_state(tcfg, g, d),
                                                           TrainStep(tcfg, g, d)), pool


def _masks(key, step: TrainStep):
    out = {}
    for name, (shape, rate) in step.mask_specs.items():
        k = key
        for part in name.split("."):
            k = jax.random.fold_in(k, int(part[:2]))
        out[name] = torch.from_numpy(np.array(jax.random.bernoulli(k, 1.0 - rate, shape)))
    return out


def _draws(rng, cfg, pool_n, step):
    """facegen's draws for the step keyed ``rng``, as the port's StepDraws."""
    half = cfg.batch_size // 2
    k_idx, k_noise, _, k_drop = jax.random.split(jax.random.fold_in(rng, 0), 4)
    idx = jax.random.randint(k_idx, (half,), 0, pool_n)
    noise_d = jax.random.uniform(k_noise, (half, cfg.noise_dim), jnp.float32, -1.0, 1.0)
    d = DDraws(torch.from_numpy(np.array(idx)).long(), torch.from_numpy(np.array(noise_d)),
               _masks(k_drop, step))
    k_noise, _, k_drop = jax.random.split(jax.random.fold_in(rng, 1000), 3)
    noise_g = jax.random.uniform(k_noise, (cfg.batch_size, cfg.noise_dim), jnp.float32,
                                 -1.0, 1.0)
    g = GDraws(torch.from_numpy(np.array(noise_g)), _masks(k_drop, step))
    return StepDraws((d,), (g,))


def _set_ring(jstate, tstate, value):
    k = tstate.accs.shape[0]
    tstate.accs.fill_(value)
    tstate.accs_n.fill_(k)
    return jstate._replace(accs=jnp.full((k,), value, jnp.float32), accs_n=jnp.int32(k))


def _rel_l2(ours, theirs):
    num = sum(float(np.sum((o - t) ** 2)) for o, t in zip(ours, theirs))
    return (num / max(sum(float(np.sum(t ** 2)) for t in theirs), 1e-300)) ** 0.5


@pytest.mark.parametrize("scale,channels,bs", CASES)
def test_three_steps_match_make_train_step(scale, channels, bs):
    (jg, jd, jcfg, jstate), (tcfg, tstate, tstep), pool = _setup(scale, channels, bs)
    start = jax_ckpt.flatten_tree(jstate)
    jstep = jax.jit(make_train_step(jg, jd, jcfg))
    gates = []
    for i in range(3):
        if i > 0:  # a full ring of 1s closes the gate, an empty one opens it
            jstate = _set_ring(jstate, tstate, 1.0 if i == 1 else 0.0)
        rng = jax.random.fold_in(jax.random.key(5), i)
        jstate, jm = jstep(jstate, rng, jnp.asarray(pool))
        tm = tstep(tstate, torch.from_numpy(pool), _draws(rng, tcfg, pool.shape[0], tstep))
        gates.append(float(jm.gate_open))
        assert float(tm.gate_open) == float(jm.gate_open)
        np.testing.assert_allclose(float(tm.loss_d), float(jm.loss_d), rtol=1e-4)
        np.testing.assert_allclose(float(tm.loss_g), float(jm.loss_g), rtol=1e-4)
    assert gates == [1.0, 0.0, 1.0]

    theirs = jax_ckpt.flatten_tree(jstate)
    ours = ckpt.train_state_arrays(tstate)
    assert set(ours) == set(theirs)
    exact = [k for k in theirs if "/" not in k or k.endswith("/count")]
    for k in exact:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)
    assert int(ours["opt_d/0/count"]) == 2 and int(ours["opt_g/0/count"]) == 3
    for prefix in ("params_g/", "params_d/"):
        keys = [k for k in theirs if k.startswith(prefix)]
        err = _rel_l2([ours[k] - start[k] for k in keys],
                      [np.asarray(theirs[k]) - start[k] for k in keys])
        assert err <= UPDATE_TOL, (prefix, err)
    for prefix in ("opt_g/0/mu/", "opt_g/0/nu/", "opt_d/0/mu/", "opt_d/0/nu/"):
        keys = [k for k in theirs if k.startswith(prefix)]
        err = _rel_l2([ours[k] for k in keys], [np.asarray(theirs[k]) for k in keys])
        assert err <= UPDATE_TOL, (prefix, err)
    for k in theirs:
        if k.startswith("state_g/"):
            np.testing.assert_allclose(ours[k], np.asarray(theirs[k]), rtol=0, atol=STAT_TOL,
                                       err_msg=k)
            assert not np.array_equal(ours[k], start[k]), k  # the statistics moved


def _jax_trained_state(tmp_path):
    """A facegen GanState after one step, saved as facegen's trainer does."""
    (jg, jd, jcfg, jstate), _, pool = _setup(16, 1, 8)
    jstate, _ = jax.jit(make_train_step(jg, jd, jcfg))(jstate, jax.random.key(1),
                                                       jnp.asarray(pool))
    jstate = jstate._replace(epoch=jnp.int32(4))
    jax_ckpt.save(str(tmp_path), "adversarial", jstate,
                  meta={**jax_ckpt.config_meta(jcfg), "epoch": 4})
    return jcfg, jstate


def test_jax_training_checkpoint_resumes_in_the_port(tmp_path):
    jcfg, jstate = _jax_trained_state(tmp_path)
    _, tcfg = _configs(16, 1, 8)
    g, d = gan.init_gan(torch.Generator().manual_seed(3), 16, 1, NOISE_DIM)
    tstate = init_state(tcfg, g, d)
    meta = ckpt.load_train_state(str(tmp_path), "adversarial", tstate)
    assert meta["epoch"] == 4 and tstate.epoch == 4
    theirs = jax_ckpt.flatten_tree(jstate)
    ours = ckpt.train_state_arrays(tstate)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():  # transposes and renames of the same values
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)
    assert int(ours["opt_d/0/count"]) == 1 and ours["opt_g/0/mu/00_fc/w"].any()


def test_port_training_checkpoint_resumes_in_jax(tmp_path):
    (jg, jd, jcfg, jstate), (tcfg, tstate, tstep), pool = _setup(32, 3, 4)
    draws = draw_step(torch.Generator().manual_seed(0), tcfg, pool.shape[0], tstep.mask_specs)
    tstep(tstate, torch.from_numpy(pool), draws)
    tstate.epoch = 2
    ckpt.save_train_state(str(tmp_path), "adversarial", tstate,
                          {"config": {"scale": 32, "grayscale": False, "noise_dim": NOISE_DIM,
                                      "noise_view": "nhwc"}, "epoch": 2})
    restored, meta = jax_ckpt.load(str(tmp_path), "adversarial", jstate)  # strict
    ours = ckpt.train_state_arrays(tstate)
    theirs = jax_ckpt.flatten_tree(restored)
    assert set(ours) == set(theirs) and int(restored.epoch) == 2
    for k, v in theirs.items():
        np.testing.assert_array_equal(np.asarray(v), ours[k], err_msg=k)
    # and facegen's sampler-side restore reads the same checkpoint's G and D
    _, _, bundle, _, res = jax_gan.restore_gan("adversarial", default_dir=str(tmp_path))
    assert res["scale"] == 32 and res["noise_dim"] == NOISE_DIM


def test_resume_checks_every_leaf(tmp_path):
    _, (tcfg, tstate, _), _ = _setup(16, 1, 8)
    ckpt.save_train_state(str(tmp_path), "net", tstate)
    arrays, meta = ckpt.load(str(tmp_path), "net")
    del arrays["opt_d/0/nu/01_fc_out/b"]
    ckpt.save(str(tmp_path), "net", arrays, meta)
    with pytest.raises(KeyError, match="opt_d/0/nu/01_fc_out/b"):
        ckpt.load_train_state(str(tmp_path), "net", tstate)
