"""The rank programs of tests/test_torch_port_gspmd.py.

Four processes of a gloo group on the CPU, started once with
``torch.multiprocessing`` by ``spawn``, run every 2-D mesh case: the
(2, 2) mesh over all four, the (2, 1) and (1, 2) meshes twice, over
ranks 0-1 and over ranks 2-3, and the (3, 1) mesh over ranks 0-2, whose
data rows hold unequal blocks of a batch (or none), while rank 3 waits
(every rank creates every mesh's groups, in one order). Ranks 0-1 and
ranks 2-3 then form two groups of two for the cases that need a whole
group of two: a (2, 2) checkpoint resumed at '2', and the trainer CLI at
--meshShape 2 (ranks 0-1) and 2,1 (ranks 2-3).

This module imports neither JAX nor facegen: the parent computes
facegen's side and hands the ranks their inputs as ``.npz`` files under
a work directory, each program's JSON written after its files, which the
ranks, started first, wait for (``wait_for``); each rank writes its
results there: a digest of its state's gathered leaves under facegen's
checkpoint paths (``report``), and where the parent compares values, the
leaves themselves, written by the mesh's first rank. A rank's own checks
are asserts, which reach the parent as the spawned process's exception.
"""

from __future__ import annotations

import contextlib
import io
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from facegen_torch.config import C2FConfig, TrainConfig
from facegen_torch.data.c2f import C2FPool
from facegen_torch.models import ae, c2f, gan
from facegen_torch.nn.layers import set_batch_norm_mesh
from facegen_torch.parallel import (
    Mesh2D,
    ensure_mesh2d,
    hybrid_mesh,
    make_mesh,
    make_mesh2d,
    mesh2d_from_shape,
    training_mesh,
)
from facegen_torch.parallel.gspmd import shard_params
from facegen_torch.train import main as train_main
from facegen_torch.train.ae_loop import (
    AEDraws,
    AEStep,
    DenoiserDraws,
    DenoiserState,
    DenoiserStep,
    denoiser_val_loss,
)
from facegen_torch.train.c2f import C2FDDraws, C2FGDraws, C2FStep, C2FStepDraws, init_c2f_state
from facegen_torch.train.loop import Trainer
from facegen_torch.train.optim import adam
from facegen_torch.train.step import DDraws, GDraws, StepDraws, TrainStep, init_state
from facegen_torch.utils import checkpoint as ckpt
from torch_port_parallel_ranks import digest, wait_for

WORLD = 4
# name -> (dp, mp, ranks): every rank creates every mesh, in this order
MESHES = {"2x2": (2, 2, None), "2x1a": (2, 1, (0, 1)), "2x1b": (2, 1, (2, 3)),
          "1x2a": (1, 2, (0, 1)), "1x2b": (1, 2, (2, 3)), "3x1": (3, 1, (0, 1, 2))}
# the trainer cases: 16x16 gray (G16 + D16_d), batch 8, 2 steps of
# 4 per epoch, G's penalty so that its batch-norm-fed biases move by it
TINY = dict(scale=16, grayscale=True, noise_dim=8, batch_size=8, n_epoch=8,
            synthetic_data=True, noplot=True, compute_dtype="float32", reference_init=False,
            g_l2=1e-3)
# the CLI cases: G32 + D32b colour, batch 32, 4 steps on a 61-row pool, SGD
# with momentum (tests/test_torch_port_gspmd.py says why)
CLI = ["--scale", "32", "--noiseDim", "8", "--batchSize", "32", "--N_epoch", "61",
       "--syntheticData", "--noplot", "--computeDtype", "float32", "--modernInit",
       "--G_optmethod", "sgd", "--D_optmethod", "sgd", "--G_SGD_momentum", "0.9",
       "--D_SGD_momentum", "0.9", "--epochs", "1"]


def report(work: str, name: str, arrays, **meta) -> None:
    with open(os.path.join(work, f"{name}.json"), "w") as f:
        json.dump({"digest": digest(arrays), **meta}, f)


def spawn(work: str, join: bool = True):
    return torch.multiprocessing.spawn(_rank_main, args=(work,), nprocs=WORLD, join=join)


def _rank_main(rank: int, work: str):
    # the ranks keep the test workers' priority: a rank's collectives wait
    # for its peers, and under the whole suite's load a rank at nice 10
    # (about a tenth of a nice-0 process's share of the CPU) stalls them
    torch.set_num_threads(2)
    store = dist.FileStore(os.path.join(work, "filestore"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD)
    try:
        meshes = {name: make_mesh2d(dp, mp, ranks=ranks, device="cpu")
                  for name, (dp, mp, ranks) in MESHES.items()}
        meshes = {name: m for name, m in meshes.items() if m is not None}
        mesh_constructors(rank, work)
        trainers(rank, work)  # needs no input: it runs while the parent writes them
        gan_steps(rank, work, meshes)
        family_steps(rank, work, meshes)
    finally:
        dist.destroy_process_group()
    # then two groups of two at once: ranks 0-1 and ranks 2-3
    pair = rank // 2
    store = dist.FileStore(os.path.join(work, f"filestore_pair{pair}"), 2)
    dist.init_process_group("gloo", store=store, rank=rank % 2, world_size=2)
    try:
        group_of_two(rank % 2, work, pair)
    finally:
        dist.destroy_process_group()


def _expect_error(fn, message: str):
    try:
        fn()
    except ValueError as e:
        assert message in str(e), (message, str(e))
    else:
        raise AssertionError(f"no error: {message}")


def mesh_constructors(rank: int, work: str):
    """The mesh constructors in a group of four: the layouts, facegen's
    fallback of hybrid_mesh, and their errors."""
    mesh = mesh2d_from_shape((2, 2), device="cpu")
    assert (mesh.dp, mesh.mp, mesh.i, mesh.j) == (2, 2, rank // 2, rank % 2)
    assert mesh2d_from_shape((-1, 2), device="cpu").dp == 2
    assert mesh2d_from_shape((-1,), device="cpu").mp == 1
    # --meshShape 2,2 is the 2-D mesh, and so is 4,1 (facegen/train/loop.py:507-519)
    assert isinstance(training_mesh((4, 1), device="cpu"), Mesh2D)
    assert not isinstance(training_mesh((4,), device="cpu"), Mesh2D)
    lifted = ensure_mesh2d(make_mesh((4,), device="cpu"))  # facegen's (N,) -> (N, 1)
    assert (lifted.dp, lifted.mp, lifted.i) == (4, 1, rank)
    for rph, ici_dp, ici_mp, want in ((2, -1, 2, (2, 2)), (2, -1, 1, (4, 1)),
                                      (4, 2, 2, (2, 2)), (4, -1, 4, (1, 4))):
        m = hybrid_mesh(ici_dp, ici_mp, ranks_per_host=rph, device="cpu")
        assert (m.dp, m.mp) == want and (m.i, m.j) == divmod(rank, m.mp), (rph, m)
    _expect_error(lambda: make_mesh2d(16, 4), "needs 64 ranks, have 4")
    _expect_error(lambda: mesh2d_from_shape((3, 2)), "asks for 6 ranks, but the process group")
    _expect_error(lambda: mesh2d_from_shape((-1, 3)), "a model axis of 3 does not divide")
    _expect_error(lambda: make_mesh((2, 2)), "a 2-D shape is a mesh of parallel/gspmd.py")
    # the 2-D mesh takes any batch facegen takes (even, >= 4), its data rows
    # holding unequal blocks; the 1-D mesh of local batches keeps facegen's
    # shard_map condition, half real and half fake images on every rank
    cfg = TrainConfig(**{**TINY, "batch_size": 6}).validate()
    g, d = gan.init_gan(torch.Generator().manual_seed(0), cfg.scale, cfg.channels,
                        cfg.noise_dim, reference_init=False)
    step = TrainStep(cfg, g, d, make_mesh2d(4, 1, device="cpu"))
    assert (step.draw_batch, step.batch) == (6, (2, 2, 2, 0)[rank])
    _expect_error(lambda: TrainStep(cfg, g, d, make_mesh((4,), device="cpu")),
                  "does not split into half real and half fake images on each of 4 ranks")


# ------------------------------------------------------------------ GAN steps
def _masks(npz, prefix: str):
    return {k[len(prefix):]: torch.from_numpy(npz[k]) for k in npz.files if k.startswith(prefix)}


def _gan_draws(npz, i: int) -> StepDraws:
    p = f"s{i}/"
    d = DDraws(torch.from_numpy(npz[p + "d_idx"]), torch.from_numpy(npz[p + "d_noise"]),
               _masks(npz, p + "d_mask/"))
    g = GDraws(torch.from_numpy(npz[p + "g_noise"]), _masks(npz, p + "g_mask/"))
    return StepDraws((d,), (g,))


def _load_nets(npz, *nets):
    for prefix, net in zip(("g/", "d/", "e/"), nets):
        net.load_state_dict({k[len(prefix):]: torch.from_numpy(npz[k]) for k in npz.files
                             if k.startswith(prefix)}, strict=True)


def shard_shapes(module, masters, root: str, opt_root: str) -> dict:
    """facegen's logical shape of this rank's master of each parameter and
    of its moments, under facegen's checkpoint paths."""
    bn = ckpt._bn_prefixes(module.state_dict())
    out = {}
    for (name, _), m in zip(module.named_parameters(), masters):
        _, path, a = ckpt._jax_leaf(name, m, bn)
        out[f"{root}/{path}"] = list(a.shape)
        for kind in ("mu", "nu"):
            out[f"{opt_root}/0/{kind}/{path}"] = list(a.shape)
    return out


def _finish(work: str, name: str, mesh, arrays, **meta):
    report(work, f"{name}_rank{mesh.rank}", arrays, **meta)
    if mesh.index == 0:  # the values facegen's side is compared with
        ckpt.save(work, f"{name}_arrays", arrays)


def gan_steps(rank: int, work: str, meshes):
    """3 steps of each case's TrainStep on every mesh this rank is in, on
    facegen's single-device draws; the gate ring filled with 1s before the
    second step (closed) and emptied before the third (open)."""
    with open(wait_for(work, "gan_steps.json")) as f:
        cases = json.load(f)
    for case, (kw, mesh_names, inputs) in cases.items():
        npz = np.load(os.path.join(work, f"{inputs}.npz"))
        cfg = TrainConfig(**kw).validate()
        for mname, mesh in meshes.items():
            if mname not in mesh_names:
                continue
            g, d = gan.init_gan(torch.Generator().manual_seed(0), cfg.scale, cfg.channels,
                                cfg.noise_dim, reference_init=False)
            _load_nets(npz, g, d)
            state = init_state(cfg, g, d, mesh)
            step = TrainStep(cfg, g, d, mesh)
            assert step.batch == mesh.row_count(cfg.batch_size)
            assert step.draw_batch == cfg.batch_size
            pool, rows = torch.from_numpy(npz["pool"]), []
            for i in range(3):
                if i > 0:
                    state.accs.fill_(1.0 if i == 1 else 0.0)
                    state.accs_n.fill_(state.accs.shape[0])
                rows.append([float(v) for v in step(state, pool, _gan_draws(npz, i))])
            shapes = {**shard_shapes(g, state.shards["g"].masters, "params_g", "opt_g"),
                      **shard_shapes(d, state.shards["d"].masters, "params_d", "opt_d")}
            for net in ("g", "d"):  # the moments have the masters' shapes
                for kind in ("mu", "nu"):
                    opt = state.opt_g if net == "g" else state.opt_d
                    assert [tuple(t.shape) for t in opt[kind]] == [
                        tuple(m.shape) for m in state.shards[net].masters]
            _finish(work, f"{case}_{mname}", mesh, ckpt.train_state_arrays(state),
                    metrics=rows, shapes=shapes)


# ------------------------------------------------------- c2f, AE, denoiser
def family_steps(rank: int, work: str, meshes):
    """3 steps of the c2f, autoencoder and denoiser steps at (2, 1), (1, 2)
    and (3, 1) on facegen's draws; then the denoiser's validation loss on
    its 256-row pool."""
    with open(wait_for(work, "family.json")) as f:
        kws = json.load(f)
    for mname, mesh in meshes.items():
        if mname == "2x2":
            continue
        tag = mname
        # c2f
        npz = np.load(os.path.join(work, "c2f.npz"))
        cfg = C2FConfig(**kws["c2f"]).validate()
        g, d = c2f.init_c2f(torch.Generator().manual_seed(1), cfg.fine_size, cfg.channels)
        _load_nets(npz, g, d)
        state, step = init_c2f_state(cfg, g, d, mesh), C2FStep(cfg, g, d, mesh)
        pool = C2FPool(torch.from_numpy(npz["fine"]), torch.from_numpy(npz["coarse"]))
        rows = []
        for i in range(3):
            p = f"s{i}/"
            draws = C2FStepDraws(
                (C2FDDraws(*(torch.from_numpy(npz[p + k]) for k in ("d_real", "d_fake", "d_noise")),
                           _masks(npz, p + "d_mask/")),),
                (C2FGDraws(torch.from_numpy(npz[p + "g_idx"]), torch.from_numpy(npz[p + "g_noise"]),
                           _masks(npz, p + "g_mask/")),))
            rows.append([float(v) for v in step(state, pool, draws)])
        state.epoch += 1  # facegen's epoch function counts the epoch
        _finish(work, f"c2f_{tag}", mesh, ckpt.train_state_arrays(state), metrics=rows)
        # autoencoder
        npz = np.load(os.path.join(work, "ae.npz"))
        cfg = TrainConfig(**kws["ae"]).validate()
        model = ae.create_autoencoder(cfg.scale, cfg.channels, cfg.noise_dim,
                                      generator=torch.Generator().manual_seed(0))
        _load_nets(npz, model)
        shards = shard_params({"m": model}, mesh)["m"]
        opt = adam(1e-3).init(shards.masters)
        step = AEStep(cfg, model, mesh, shards)
        pool = torch.from_numpy(npz["pool"])
        losses = [float(step(model, opt, pool, AEDraws(torch.from_numpy(npz[f"s{i}/idx"]),
                                                        _masks(npz, f"s{i}/mask/"))))
                  for i in range(3)]
        _finish(work, f"ae_{tag}", mesh,
                ckpt.autoencoder_arrays(model, shards.full_opt(opt)), losses=losses)
        # denoiser
        npz = np.load(os.path.join(work, "denoiser.npz"))
        cfg = TrainConfig(**kws["denoiser"]).validate()
        enc, dec1, dec2 = ae.init_denoiser(torch.Generator().manual_seed(1), cfg.scale,
                                           cfg.channels)
        _load_nets(npz, dec1, dec2)
        shards = shard_params({"dec1": dec1, "dec2": dec2}, mesh)
        tx = adam(1e-3)
        st = DenoiserState(enc, dec1, dec2, tx.init(shards["dec1"].masters),
                           tx.init(shards["dec2"].masters), shards)
        step = DenoiserStep(cfg, dec1, mesh)
        set_batch_norm_mesh(dec1, mesh)
        set_batch_norm_mesh(dec2, mesh)
        pool, losses = torch.from_numpy(npz["pool"]), []
        for i in range(3):
            p = f"s{i}/"
            draws = DenoiserDraws(torch.from_numpy(npz[p + "idx"]), torch.from_numpy(npz[p + "noise"]),
                                  _masks(npz, p + "m1/"), torch.from_numpy(npz[p + "noise2"]),
                                  _masks(npz, p + "m1b/"), _masks(npz, p + "m2/"))
            losses.append(step(st, pool, draws).tolist())
        arrays = ckpt.denoiser_arrays(dec1, dec2)
        for key, dec, o in (("AE1_DECODER", dec1, st.opt1), ("AE2_DECODER", dec2, st.opt2)):
            k = "dec1" if key == "AE1_DECODER" else "dec2"
            arrays.update(ckpt.module_arrays(dec, f"{key}/p", f"{key}/s", shards[k].full_opt(o),
                                             f"{key}/opt"))
        val = float(denoiser_val_loss(dec1, torch.from_numpy(npz["val"])))
        _finish(work, f"denoiser_{tag}", mesh, arrays, losses=losses, val=val)


# ------------------------------------------------------------------ trainers
def _trainer(rank: int, work: str, name: str, mesh, **kw) -> Trainer:
    cfg = TrainConfig(**{**TINY, **kw}, save=os.path.join(work, name, f"rank{rank}")).validate()
    return Trainer(cfg, mesh=mesh, verbose=True)


def trainers(rank: int, work: str):
    """On (2, 2): 2 epochs with --epochsPerCompile 4 (one epoch at a time,
    facegen's message) and a checkpoint each epoch, then the same 2
    epochs with --weightsVisFreq 1; rank 0 alone writes."""
    mesh = make_mesh2d(2, 2, device="cpu")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tr = _trainer(rank, work, "t22", mesh, epochs_per_compile=4, save_freq=1)
        list(tr.run(2))
    report(work, f"t22_rank{rank}", ckpt.train_state_arrays(tr.state), log=log.getvalue(),
           epochs_per_compile=tr.epochs_per_compile, readbacks=tr.readbacks)
    tr = _trainer(rank, work, "vis22", mesh, weights_vis_freq=1, save_freq=10)
    list(tr.run(2))
    report(work, f"vis22_rank{rank}", ckpt.train_state_arrays(tr.state))


def group_of_two(rank: int, work: str, pair: int):
    """In a group of two (``rank`` its rank in the group): on ranks 0-1 the
    (2, 2) run's checkpoint resumed at '2' for an epoch, then the trainer
    CLI at --meshShape 2 on a 61-row pool (4 steps an epoch); on ranks 2-3
    the CLI at --meshShape 2,1."""
    if pair == 0:
        tr = _trainer(rank, work, "resumed2", make_mesh((2,), device="cpu"),
                      network=os.path.join(work, "t22", "rank0", "adversarial"))
        report(work, f"resumed2_start_rank{rank}", ckpt.train_state_arrays(tr.state))
        stats = list(tr.run(1))
        assert np.isfinite(stats[0]["loss_d_mean"]) and tr.state.epoch == 4
    for shape in (("2",) if pair == 0 else ("2,1",)):
        save = os.path.join(work, f"cli{shape.replace(',', '')}", f"rank{rank}")
        tr = train_main(CLI + ["--meshShape", shape, "--save", save], device="cpu")
        assert isinstance(tr.mesh, Mesh2D) == (shape == "2,1")
        assert os.path.isdir(save) == (rank == 0)
        report(work, f"cli{shape.replace(',', '')}_rank{rank}", ckpt.train_state_arrays(tr.state))
