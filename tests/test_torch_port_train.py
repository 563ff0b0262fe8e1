"""facegen_torch's losses, metrics, optimizers, config and trainer
against facegen's.

Same numpy inputs into both packages, fp32 on the CPU. Losses and
penalties: 1e-6 relative (the same few fp32 operations). Optimizers: 3
updates against optax with 1e-6 relative and 1e-9 absolute (the same
elementwise formulas; a wrong constant or order of bias correction is
off by far more). Confusion matrices and counters: exact.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen.config import TrainConfig as JaxTrainConfig
from facegen.config import train_config_from_args as jax_config_from_args
from facegen.train import losses as jax_losses
from facegen.train import metrics as jax_metrics
from facegen.train.optim import gated_update as jax_gated_update
from facegen.train.optim import make_optimizer as jax_make_optimizer
from facegen.train.step import steps_per_epoch as jax_steps_per_epoch
from facegen_torch import train
from facegen_torch.config import TrainConfig, train_config_from_args
from facegen_torch.ops import fused_update
from facegen_torch.train import losses, metrics, optim
from facegen_torch.train.step import steps_per_epoch

RTOL = 1e-6


def _arrays(seed, shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


SHAPES = [(3, 4), (5,), (2, 3, 3, 2)]


def test_bce_and_accuracy_match_jax():
    logits = np.random.RandomState(0).randn(16).astype(np.float32) * 4
    targets = (np.arange(16) % 2).astype(np.float32)
    lt, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    np.testing.assert_allclose(float(losses.bce_with_logits(lt, tt)),
                               float(jax_losses.bce_with_logits(logits, targets)), rtol=RTOL)
    assert float(losses.batch_accuracy(lt, tt)) == float(jax_losses.batch_accuracy(logits, targets))


@pytest.mark.parametrize("sign_coef,linear_coef,clamp", [(0.0, 1e-4, 1.0), (1e-3, 1e-3, 0.05)])
def test_penalties_and_clamp_match_jax(sign_coef, linear_coef, clamp):
    params, grads = _arrays(1, SHAPES), _arrays(2, SHAPES)
    tp, tg = [torch.from_numpy(a) for a in params], [torch.from_numpy(a) for a in grads]
    np.testing.assert_allclose(float(losses.penalty_loss(tp, sign_coef, linear_coef)),
                               float(jax_losses.penalty_loss(params, sign_coef, linear_coef)),
                               rtol=RTOL)
    ours = fused_update.clamp_grads(
        fused_update.add_penalty_grads(tg, tp, sign_coef, linear_coef), clamp)
    theirs = jax_losses.clamp_grads(
        jax_losses.add_penalty_grads(grads, params, sign_coef, linear_coef), clamp)
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=RTOL, atol=1e-9)


def test_confusion_matches_jax_and_formats_alike():
    logits = np.random.RandomState(3).randn(32).astype(np.float32)
    targets = (np.random.RandomState(4).rand(32) > 0.5).astype(np.float32)
    ours = metrics.update_confusion(metrics.empty_confusion(), torch.from_numpy(logits),
                                    torch.from_numpy(targets))
    theirs = jax_metrics.update_confusion(jax_metrics.empty_confusion(), logits, targets)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert metrics.total_valid(ours) == pytest.approx(float(jax_metrics.total_valid(theirs)))
    assert metrics.format_confusion(ours) == jax_metrics.format_confusion(theirs)


OPTIMIZERS = [("adam", {}), ("adagrad", {}), ("sgd", {}), ("sgd", {"d_sgd_momentum": 0.9}),
              ("adam", {"d_adam_lr": 3e-4})]


@pytest.mark.parametrize("method,flags", OPTIMIZERS,
                         ids=["adam", "adagrad", "sgd", "sgd_momentum", "adam_lr"])
def test_gated_optimizers_match_optax(method, flags):
    """Three steps, the second with the gate closed: params, moments and
    Adam's count stay where they were on the closed step."""
    cfg = JaxTrainConfig(**flags)
    params = _arrays(5, SHAPES)
    tx = jax_make_optimizer(method, cfg, "D")
    ours_tx = optim.make_optimizer(method, TrainConfig(**flags), "D")
    jp, js = params, tx.init(params)
    tp = [torch.from_numpy(a.copy()) for a in params]
    ts = ours_tx.init(tp)
    for step, gate in enumerate([True, False, True]):
        grads = _arrays(10 + step, SHAPES)
        jp, js = jax_gated_update(tx, grads, js, jp, jnp.bool_(gate))
        fused_update.gated_update(ours_tx, [torch.from_numpy(g) for g in grads], ts, tp,
                                  torch.tensor(gate))
    for o, t in zip(tp, jp):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=RTOL, atol=1e-9)
    theirs = jax.tree_util.tree_leaves(js)
    mine = fused_update._state_tensors(ts)
    if method == "adam":  # optax's leaf order: count, mu..., nu...
        mine = [ts["count"]] + ts["mu"] + ts["nu"]
        assert int(ts["count"]) == int(theirs[0]) == 2
    assert len(mine) == len(theirs)
    for o, t in zip(mine, theirs):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=RTOL, atol=1e-9)


def test_closed_gate_leaves_everything_untouched():
    tx = optim.adam(1e-3)
    params = [torch.ones(3)]
    state = tx.init(params)
    fused_update.gated_update(tx, [torch.ones(3)], state, params, torch.tensor(False))
    assert torch.equal(params[0], torch.ones(3)) and int(state["count"]) == 0
    assert not state["mu"][0].any() and not state["nu"][0].any()


def test_defaults_and_derived_values_match_jax():
    ours, theirs = TrainConfig(), JaxTrainConfig()
    shared = {f.name for f in dataclasses.fields(TrainConfig)} & {
        f.name for f in dataclasses.fields(JaxTrainConfig)}
    assert len(shared) >= 45
    for name in shared - {"mesh_shape"}:
        assert getattr(ours, name) == getattr(theirs, name), name
    for bs in (4, 8, 32, 64):
        assert (TrainConfig(batch_size=bs).accs_interval
                == JaxTrainConfig(batch_size=bs).accs_interval)
    assert ours.d_adam_lr_effective == theirs.d_adam_lr_effective == 1e-3


@pytest.mark.parametrize("argv", [
    [], ["--batchSize", "16", "--D_L2", "0", "--G_L2", "1e-3", "--noplot", "--grayscale",
         "--scale", "16", "--D_optmethod", "adagrad", "--computeDtype", "float32",
         "--modernInit", "--syntheticData", "--epochs", "3", "--N_epoch", "-1",
         "--D_maxAcc", "0.9", "--datasetDir", "x.npy", "--epochsPerCompile", "4"],
    ["--boundaryPad", "8", "--weightsVisFreq", "4"],
])
def test_cli_parses_like_jax(argv):
    ours, theirs = train_config_from_args(argv), jax_config_from_args(argv)
    for f in dataclasses.fields(TrainConfig):
        if hasattr(theirs, f.name) and f.name not in ("mesh_shape",):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


@pytest.mark.parametrize("argv,message", [
    # several devices are ported (tests/test_torch_port_parallel.py,
    # tests/test_torch_port_gspmd.py): without a process group the CLI
    # says how to launch them, the 2-D mesh and --denoise included
    (["--meshShape", "4"], "launch 4 processes"), (["--meshShape", "2,2"], "launch 4 processes"),
    (["--denoise", "--meshShape", "2"], "launch 2 processes"),
    # --boundaryPad is ported (tests/test_torch_port_train_options.py): the
    # flag parses, and only the mesh is refused
    (["--boundaryPad", "8", "--meshShape", "3"], "launch 3 processes"),
    (["--batchSize", "5"], "multiple of 2"),
], ids=[  # the ids the cases had when the first four asserted a refusal
    "argv0-not ported yet", "argv1-not ported yet", "argv2-not ported yet", "argv3-not ported",
    "argv4-multiple of 2"])
def test_cli_rejects_what_is_not_ported(argv, message, capsys):
    with pytest.raises(SystemExit):
        train.main(argv, device="cpu")
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("bs,n_epoch,pool", [(32, 1000, None), (8, 10, None), (8, -1, 32),
                                             (6, 101, None)])
def test_steps_per_epoch_matches_jax(bs, n_epoch, pool):
    assert (steps_per_epoch(TrainConfig(batch_size=bs, n_epoch=n_epoch), pool)
            == jax_steps_per_epoch(JaxTrainConfig(batch_size=bs, n_epoch=n_epoch), pool))


def test_trainer_cli_trains_saves_and_resumes_on_the_cpu(tmp_path):
    """Two epochs with grids and a checkpoint per epoch, then a resume for
    a third: the epoch counter, metrics.jsonl, .old rotation and the
    printed parameter counts."""
    save = str(tmp_path / "logs")
    argv = ["--syntheticData", "--save", save, "--scale", "16", "--grayscale",
            "--batchSize", "8", "--N_epoch", "24", "--saveFreq", "1", "--noiseDim", "16"]
    trainer = train.main(argv + ["--epochs", "2"], device="cpu")
    assert trainer.state.epoch == 3
    for name in ("samples_fixed", "best50", "worst50", "real100"):
        assert os.path.getsize(os.path.join(save, "viz", f"{name}.png")) > 0
    assert os.path.exists(os.path.join(save, "adversarial.old", "arrays.npz"))
    trainer = train.main(argv + ["--epochs", "1", "--network", "adversarial", "--noplot"],
                         device="cpu")
    assert trainer.state.epoch == 4
    with open(os.path.join(save, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [1, 2, 3]
    for r in rows:
        assert np.isfinite(r["loss_d_mean"]) and np.isfinite(r["loss_g_mean"])
        assert r["trained_d"] + r["not_trained_d"] == 6  # t = 1, 5, ..., 21 of 24, batch 8
    meta = json.load(open(os.path.join(save, "adversarial", "meta.json")))
    assert meta["epoch"] == 4 and meta["config"]["scale"] == 16


def test_resume_refuses_another_noise_view(tmp_path):
    save = str(tmp_path)
    argv = ["--syntheticData", "--save", save, "--scale", "16", "--grayscale", "--noplot",
            "--batchSize", "4", "--N_epoch", "4", "--noiseDim", "8", "--epochs", "1"]
    trainer = train.main(argv, device="cpu")
    cfg = dataclasses.replace(trainer.cfg, noise_view="nchw", network="adversarial")
    from facegen_torch.train.loop import Trainer

    with pytest.raises(ValueError, match="noise_view"):
        Trainer(cfg, device="cpu", verbose=False)
