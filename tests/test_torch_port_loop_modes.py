"""facegen_torch's --epochsPerCompile chunks and --weightsVisFreq dumps
against facegen's, on the CPU.

On the CPU the captured step (train/graph.py) runs the eager step on its
static buffers, so a chunk of epochs must reproduce single epochs
exactly: parameters, optimizer state, metrics.jsonl rows (but for the
clock) and checkpoints are compared for equality. The activation grids
hold against facegen's visualize_network on the same weights (carried
over by the checkpoint converter) and probe: the same layers and files,
and PNG pixels within 1/255 (fp32 drift of the two frameworks' convs,
far below a uint8 step but for values at a rounding edge).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from facegen.config import TrainConfig as JaxTrainConfig
from facegen.models import gan as jax_gan
from facegen.utils.checkpoint import flatten_tree
from facegen.utils.netvis import visualize_network as jax_visualize_network
from facegen_torch import train
from facegen_torch.config import TrainConfig, train_config_from_args
from facegen_torch.models import gan
from facegen_torch.train.loop import Trainer, resolve_epochs_per_compile
from facegen_torch.train.step import draw_step
from facegen_torch.utils.checkpoint import jax_to_torch, load
from facegen_torch.utils.netvis import visualize_network

TINY = ["--syntheticData", "--scale", "16", "--grayscale", "--batchSize", "8",
        "--noiseDim", "8", "--N_epoch", "16"]


@pytest.mark.parametrize("epc,noplot,wvf", [(0, False, 0), (0, True, 0), (0, True, 3),
                                            (0, False, 3), (5, False, 0), (5, True, 2),
                                            (1, True, 0), (-1, True, 0), (2, False, 0)])
def test_epochs_per_compile_resolves_like_facegen(tmp_path, epc, noplot, wvf):
    from facegen.train.loop import Trainer as JaxTrainer

    kw = dict(epochs_per_compile=epc, noplot=noplot, weights_vis_freq=wvf, scale=16,
              grayscale=True, noise_dim=8, batch_size=8, n_epoch=8, synthetic_data=True,
              save=str(tmp_path))
    logs = []
    ours = resolve_epochs_per_compile(TrainConfig(**kw), logs.append)
    theirs = JaxTrainer(JaxTrainConfig(**kw), verbose=False).epochs_per_compile
    assert ours == theirs
    assert bool(logs) == (epc > 1 and wvf > 0)


def _rows(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        for k in ("time", "seconds", "images_per_sec"):
            r.pop(k)
    return rows


def test_a_chunk_of_epochs_reproduces_single_epochs(tmp_path):
    runs = {}
    for epc in (1, 3):
        save = str(tmp_path / f"epc{epc}")
        runs[epc] = (train.main(TINY + ["--save", save, "--epochs", "3", "--noplot",
                                        "--epochsPerCompile", str(epc)], device="cpu"), save)
    (one, save1), (three, save3) = runs[1], runs[3]
    assert one.epochs_per_compile == 1 and three.epochs_per_compile == 3
    assert one.readbacks == 3 and three.readbacks == 1
    assert one.state.epoch == three.state.epoch == 4
    for net in ("g", "d"):
        for a, b in zip(getattr(one.state, net).state_dict().values(),
                        getattr(three.state, net).state_dict().values()):
            assert torch.equal(a, b)
        for a, b in zip(getattr(one.state, f"opt_{net}")["mu"],
                        getattr(three.state, f"opt_{net}")["mu"]):
            assert torch.equal(a, b)
    for key in ("accs", "accs_n", "confusion", "trained_d", "not_trained_d"):
        assert torch.equal(getattr(one.state, key), getattr(three.state, key))
    rows = _rows(save1)
    assert rows == _rows(save3) and [r["epoch"] for r in rows] == [1, 2, 3]
    assert all(r["trained_d"] + r["not_trained_d"] == 4 for r in rows)
    (a1, m1), (a3, m3) = load(save1, "adversarial"), load(save3, "adversarial")
    assert sorted(a1) == sorted(a3)
    for k in a1:
        np.testing.assert_array_equal(a1[k], a3[k])
    assert m1["epoch"] == m3["epoch"] == 4
    assert m1["config"]["epochs_per_compile"] == 1 and m3["config"]["epochs_per_compile"] == 3


@pytest.mark.parametrize("save_freq,start,saves", [(2, 0, 1), (5, 0, 0), (3, 0, 1), (1, 1, 1)])
def test_a_chunk_saves_once_if_it_crosses_a_save_boundary(tmp_path, monkeypatch, save_freq,
                                                          start, saves):
    cfg = train_config_from_args(TINY + ["--save", str(tmp_path), "--noplot", "--saveFreq",
                                         str(save_freq)])
    trainer = Trainer(cfg, device="cpu", verbose=False)
    trainer.state.epoch = start + 1
    calls = []
    monkeypatch.setattr(trainer, "save", lambda: calls.append(trainer.state.epoch))
    stats = trainer.train_epochs_chunk(start, 3)
    assert [s["epoch"] for s in stats] == [start + 1, start + 2, start + 3]
    assert calls == [start + 4] * saves and trainer.readbacks == 1


def test_graphed_step_on_the_cpu_draws_what_draw_step_draws(tmp_path):
    """The CPU route of GraphedStep writes draw_step's draws into its static
    buffers and runs the eager step on them."""
    trainer = Trainer(train_config_from_args(TINY + ["--save", str(tmp_path)]), device="cpu",
                      verbose=False)
    pool = trainer.source.epoch_pool(torch.Generator().manual_seed(1), trainer.pool_n)
    ms = trainer.run_steps(pool, torch.Generator().manual_seed(2), 2)
    gen = torch.Generator().manual_seed(2)
    for _ in range(2):
        want = draw_step(gen, trainer.cfg, trainer.pool_n, trainer.step.mask_specs)
    got = trainer.graphed.draws
    for a, b in zip(want.d + want.g, got.d + got.g):
        for x, y in zip(a, b):
            if isinstance(x, dict):
                assert sorted(x) == sorted(y) and all(torch.equal(x[k], y[k]) for k in x)
            else:
                assert torch.equal(x, y)
    assert ms.loss_d.shape == (2,) and bool(torch.isfinite(ms.loss_g).all())
    assert trainer.graphed.graph is None  # no capture on the CPU


def _scale_weights(params, factor=3.0):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: a * factor if str(p[-1].key) == "w" else a, params)


def _perturb_bn(state):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.05 if str(p[-1].key) == "mean" else a * 1.7, state)


def _read_png(path):
    from PIL import Image

    return np.asarray(Image.open(path), np.int16)


NETS = [("g32", 32, 3, "g"), ("d32b", 32, 3, "d"), ("g16", 16, 1, "g"), ("d16_d", 16, 3, "d")]


@pytest.mark.parametrize("name,scale,channels,net", NETS, ids=[n[0] for n in NETS])
def test_visualize_network_matches_facegen(tmp_path, name, scale, channels, net):
    noise_dim = 16
    if net == "g":
        jax_m = jax_gan.create_g(scale, channels, noise_dim, noise_view="nhwc")
        in_shape = (noise_dim,)
        x = np.random.RandomState(0).uniform(-1, 1, (4, noise_dim)).astype(np.float32)
        ours_m = gan.create_g(scale, channels, noise_dim, generator=torch.Generator())
    else:
        jax_m = jax_gan.create_d(scale, channels)
        in_shape = (scale, scale, channels)
        x = np.random.RandomState(0).rand(4, *in_shape).astype(np.float32)
        ours_m = gan.create_d(scale, channels, generator=torch.Generator())
    params, state, _ = jax_m.init(jax.random.key(3), in_shape)
    params, state = _scale_weights(params, 1.5), _perturb_bn(state)
    sd = jax_to_torch(flatten_tree({f"params_{net}": params, f"state_{net}": state}))[net]
    ours_m.load_state_dict(sd, strict=True)
    ours_m.train()
    theirs = jax_visualize_network(jax_m, params, state, x, str(tmp_path / "jax"))
    ours = visualize_network(ours_m, torch.from_numpy(x), str(tmp_path / "torch"))
    assert ours_m.training  # the mode is restored
    assert sorted(ours) == sorted(theirs)
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    if name == "d16_d":  # no conv or linear at D16_d's top level, as in facegen
        assert not ours
    else:
        assert any("conv" in k for k in ours) and any("fc" in k for k in ours)
    for k in ours:
        a, b = _read_png(ours[k]), _read_png(theirs[k])
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= 1, (k, np.abs(a - b).max())


def test_weights_vis_freq_writes_facegens_directories(tmp_path):
    """--weightsVisFreq 4 over an epoch of 6 steps dumps after steps 4 and
    6, in the directories and files facegen's Trainer writes; the
    segmented epoch trains what a plain epoch trains."""
    from facegen.train.loop import Trainer as JaxTrainer

    kw = dict(scale=16, grayscale=True, noise_dim=8, batch_size=8, n_epoch=24,
              synthetic_data=True, noplot=True, weights_vis_freq=4, compute_dtype="float32",
              reference_init=False)
    JaxTrainer(JaxTrainConfig(save=str(tmp_path / "jax"), **kw), verbose=False).train_epoch(0)
    cfg = TrainConfig(save=str(tmp_path / "torch"), **kw)
    ours = Trainer(cfg, device="cpu", verbose=False)
    ours.train_epoch(0)

    def tree(root):
        base = os.path.join(root, "viz", "netvis")
        return sorted((os.path.relpath(d, base), sorted(f)) for d, _, f in os.walk(base))

    listing = tree(str(tmp_path / "torch"))
    assert listing == tree(str(tmp_path / "jax"))
    assert [d for d, _ in listing] == [".", "e0001_s00004", "e0001_s00004/g", "e0001_s00006",
                                       "e0001_s00006/g"]
    assert "03_upconv1.png" in dict(listing)["e0001_s00006/g"]
    plain = Trainer(dataclasses.replace(cfg, weights_vis_freq=0, save=str(tmp_path / "plain")),
                    device="cpu", verbose=False)
    plain.train_epoch(0)
    for a, b in zip(ours.state.g.state_dict().values(), plain.state.g.state_dict().values()):
        assert torch.equal(a, b)
    assert _rows(str(tmp_path / "torch")) == _rows(str(tmp_path / "plain"))
