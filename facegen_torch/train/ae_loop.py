"""Autoencoder and denoiser trainers (counterpart of facegen/train/ae_loop.py).

- ``AETrainer`` (train_autoencoder.lua:148-239): the flat AE on one
  augmented pool per run, L1 loss (AbsCriterion), Adam 1e-3, the weight
  penalty with no clamp, a checkpoint every 50 epochs and at the end,
  the NaN guard.
- ``DenoiserTrainer`` (train_denoiser.lua:235-369): per batch, AE1 (the
  white-noise encoder and its decoder) takes a BCE step against the
  clean image; AE1 then runs again in train mode after its update, with
  fresh noise and dropout, so its batch-norm statistics move twice; AE2
  takes a BCE step on that output, detached. The penalty feeds the
  gradients only and the clamp is --AE_clamp. Each epoch ends with the
  BCE of AE1's decoder on 256 held-out rows; --network resumes both
  decoders and the epoch count, with Adam fresh.

Both nets run in fp32, as facegen's do. Every draw of a step is an
argument (``AEDraws``, ``DenoiserDraws``): the batch's pool rows, taken
from one permutation per epoch with the remainder dropped, the dropout
masks and the white noise. ``ae_epoch_draws`` and
``denoiser_epoch_draws`` make them on the device; the tests rebuild
facegen's. Epoch ``e`` draws from a generator seeded by (seed, 30000 + e)
for the AE and (seed, 40000 + e) for the denoiser, so a resumed run
draws fresh batches.

Both trainers' ``run_steps`` run the steps through train/graph.py's
capture core (facegen's jit of each epoch, ae_loop.py:97-106, 280-289):
on a card every step after the first replays one CUDA graph of the step,
which reads the run's pool in place and static draws into which each
step's draws are copied; the step points the dropout layers and the
denoiser's white noise (both of its forwards) at those buffers. The
denoiser's validation loss and both NaN guards run outside it, once per
epoch.

On a 2-D mesh (parallel/gspmd.py; facegen's ``gspmd_jit`` of the epochs,
ae_loop.py:102-105, 142-167, 285-288, 332-360) both trainers run the
single-device program on the global batch: every rank draws the epoch's
draws and computes its data row's block of each batch (the white noise
and the masks too; the last blocks short or empty, as GSPMD pads), a
rank's loss is the sum over its rows over the global batch's count, one
SUM all-reduce per update over the data group makes the gradients and
the loss global, the denoiser's batch norms take the global batch's
statistics, and the updates run on this rank's shards of the decoders'
masters and Adam's moments. The pool is rounded down to a multiple of
the data rows, as facegen's is. Rank 0 logs, plots and writes.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from facegen_torch.config import TrainConfig
from facegen_torch.data.pipeline import make_source
from facegen_torch.models import ae
from facegen_torch.nn import dropout
from facegen_torch.nn.init import gaussian_overwrite, seeded_generator
from facegen_torch.nn.layers import set_batch_norm_mesh
from facegen_torch.parallel.gspmd import ShardedParams, flat_all_reduce, global_rows, shard_params
from facegen_torch.parallel.mesh import placement, replicate
from facegen_torch.train import losses
from facegen_torch.train.graph import StepGraph, copy_into
from facegen_torch.train.optim import adam, penalised_update
from facegen_torch.utils import checkpoint as ckpt
from facegen_torch.utils.grids import save_grid

ADAM_LR = 1e-3
VAL_ROWS = 256  # VAL_DATA = images 10001-10256 (train_denoiser.lua:153-156)


def shuffled_batches(perm: torch.Tensor, batch: int) -> torch.Tensor:
    """A permutation of the pool -> (n_batches, batch) rows, the
    remainder dropped (facegen/train/ae_loop.py:39-42)."""
    n = perm.shape[0] // batch
    return perm[: n * batch].reshape(n, batch)


def bce(y: torch.Tensor, t: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """Mean BCE of probabilities in fp32, ``y`` clipped to [1e-7, 1 - 1e-7]
    (facegen/train/ae_loop.py:201-205; not F.binary_cross_entropy, which
    clamps its logs at -100 instead); with ``rows``, as
    ``losses.batch_mean``."""
    eps = 1e-7
    y = y.float().clamp(eps, 1 - eps)
    t = t.float()
    return losses.batch_mean(-(t * torch.log(y) + (1 - t) * torch.log1p(-y)), rows)


def pool_size(cfg: TrainConfig, mesh=None) -> int:
    """Rows of the run's pool: min(N_epoch, or 10000, 16384), on a 2-D mesh
    rounded down to a multiple of its data rows (facegen/train/ae_loop.py:
    151-154). A pool smaller than the batch would give no batch at all."""
    n_pool = min(cfg.n_epoch if cfg.n_epoch > 0 else 10000, 16384)
    if mesh is not None:
        n_pool -= n_pool % mesh.dp
    if n_pool < cfg.batch_size:
        raise ValueError(f"epoch pool of {n_pool} images is smaller than batchSize "
                         f"{cfg.batch_size}; raise --N_epoch or lower --batchSize")
    return n_pool


class AEDraws(NamedTuple):
    idx: torch.Tensor               # (batch,) int64 pool rows
    masks: Dict[str, torch.Tensor]  # the AE's dropout keep-masks by key path


class DenoiserDraws(NamedTuple):
    idx: torch.Tensor                     # (batch,) int64 pool rows
    noise: torch.Tensor                   # (batch, s, s, C) N(0, 1): AE1's white noise
    masks: Dict[str, torch.Tensor]        # AE1's decoder's masks in its step
    noise_again: torch.Tensor             # the same two for AE1's second forward
    masks_again: Dict[str, torch.Tensor]
    masks2: Dict[str, torch.Tensor]       # AE2's decoder's masks


def ae_epoch_draws(generator: torch.Generator, batch: int, n_pool: int,
                   mask_specs) -> List[AEDraws]:
    perm = torch.randperm(n_pool, generator=generator, device=generator.device)
    return [AEDraws(idx, dropout.draw_masks(generator, mask_specs))
            for idx in shuffled_batches(perm, batch)]


def denoiser_epoch_draws(generator: torch.Generator, batch: int, img_shape, n_pool: int,
                         mask_specs) -> List[DenoiserDraws]:
    def normal():
        return torch.randn((batch,) + tuple(img_shape), generator=generator,
                           device=generator.device)

    def masks():
        return dropout.draw_masks(generator, mask_specs)

    perm = torch.randperm(n_pool, generator=generator, device=generator.device)
    return [DenoiserDraws(idx, normal(), masks(), normal(), masks(), masks())
            for idx in shuffled_batches(perm, batch)]


class _MeshStep:
    """What the AE and denoiser steps share on a 2-D mesh: this data row's
    rows of a batch-shaped draw, the global batch's count that makes a sum
    over them its share of the global mean (``global_rows``), and the flat
    all-reduce of an update's gradients and loss."""

    def __init__(self, cfg: TrainConfig, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.global_rows = global_rows(mesh, cfg.batch_size)
        self._flat: Dict[str, torch.Tensor] = {}

    def _rows(self, t):
        if self.mesh is None:
            return t
        if isinstance(t, dict):
            return {k: self.mesh.rows(v) for k, v in t.items()}
        return self.mesh.rows(t)

    def _grads(self, key: str, loss: torch.Tensor, params) -> tuple:
        """(the global batch's gradients, in the parameters' layouts; its
        loss): the loss a local share."""
        grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        if self.mesh is not None:
            *grads, loss = flat_all_reduce(self.mesh, self._flat, key, [*grads, loss], params)
        return list(grads), loss


class AEStep(_MeshStep):
    """``step(model, opt, pool, draws) -> loss`` (with the penalty),
    updating the model and Adam's state in place
    (facegen/train/ae_loop.py:77-95); on a 2-D ``mesh`` the update runs on
    ``shards`` (parallel/gspmd.py:ShardedParams), which ``opt`` is made from."""

    def __init__(self, cfg: TrainConfig, model: nn.Module, mesh=None, shards=None):
        super().__init__(cfg, mesh)
        self.shards = shards
        self.tx = adam(ADAM_LR)
        self.mask_specs = dropout.dropout_mask_specs(model, cfg.batch_size, cfg.img_shape,
                                                     next(model.parameters()).device)

    def __call__(self, model: nn.Module, opt: dict, pool: torch.Tensor,
                 draws: AEDraws) -> torch.Tensor:
        x = pool[self._rows(draws.idx)].float() / 255.0
        model.train()
        dropout.set_dropout_masks(model, self._rows(draws.masks))
        params = list(model.parameters())
        grads, loss = self._grads("ae", losses.batch_mean((model(x) - x).abs(), self.global_rows),
                                  params)
        # the L1/L2 penalty on every parameter, biases included, in the loss
        # and the gradients, and no clamp (train_autoencoder.lua:196-204)
        cfg = self.cfg
        return loss + penalised_update(self.tx, grads, opt, params, cfg.coef_l1, cfg.coef_l1,
                                       cfg.coef_l2, 0.0, penalty=True, shards=self.shards)[0]


@dataclasses.dataclass
class DenoiserState:
    enc: nn.Module
    dec1: nn.Module
    dec2: nn.Module
    opt1: dict
    opt2: dict
    shards: Optional[dict] = None  # on a 2-D mesh: "dec1", "dec2" -> ShardedParams


class DenoiserStep(_MeshStep):
    """``step(state, pool, draws) -> (AE1's BCE, AE2's BCE)``, updating
    ``state`` in place (facegen/train/ae_loop.py:215-278)."""

    def __init__(self, cfg: TrainConfig, dec: nn.Module, mesh=None):
        super().__init__(cfg, mesh)
        self.tx = adam(ADAM_LR)
        self.mask_specs = dropout.dropout_mask_specs(dec, cfg.batch_size, cfg.img_shape,
                                                     next(dec.parameters()).device)

    def _train(self, st: DenoiserState, key: str, loss: torch.Tensor, dec: nn.Module,
               opt: dict) -> torch.Tensor:
        """One decoder's update on ``loss`` (this rank's share on a mesh);
        returns the global batch's loss."""
        params = list(dec.parameters())
        grads, loss = self._grads(key, loss, params)
        # the penalty feeds the gradient only: the reported loss stays the
        # bare BCE (train_denoiser.lua:272, 311); then the clamp (:289-291)
        cfg = self.cfg
        penalised_update(self.tx, grads, opt, params, cfg.coef_l1, cfg.coef_l1, cfg.coef_l2,
                         cfg.ae_clamp, penalty=False,
                         shards=None if st.shards is None else st.shards[key])
        return loss

    def __call__(self, st: DenoiserState, pool: torch.Tensor,
                 draws: DenoiserDraws) -> torch.Tensor:
        rows = self._rows
        x = pool[rows(draws.idx)].float() / 255.0
        for m in (st.enc, st.dec1, st.dec2):
            m.train()
        ae.set_white_noise(st.enc, rows(draws.noise))
        dropout.set_dropout_masks(st.dec1, rows(draws.masks))
        l1 = self._train(st, "dec1", bce(st.dec1(st.enc(x)), x, self.global_rows), st.dec1,
                         st.opt1)
        # AE1 again after its update (train_denoiser.lua:313-315, 335-336)
        with torch.no_grad():
            ae.set_white_noise(st.enc, rows(draws.noise_again))
            dropout.set_dropout_masks(st.dec1, rows(draws.masks_again))
            y1 = st.dec1(st.enc(x))
        dropout.set_dropout_masks(st.dec2, rows(draws.masks2))
        l2 = self._train(st, "dec2", bce(st.dec2(y1), x, self.global_rows), st.dec2, st.opt2)
        return torch.stack([l1, l2])


@torch.no_grad()
def denoiser_val_loss(dec1: nn.Module, val_pool: torch.Tensor) -> torch.Tensor:
    """BCE of AE1's decoder in eval mode on the held-out rows
    (facegen/train/ae_loop.py:292-300)."""
    x = val_pool.float() / 255.0
    return bce(dec1.eval()(x), x)


@torch.no_grad()
def dump_recon_grid(model: nn.Module, pool: torch.Tensor, path: str, n: int = 16) -> None:
    """Input | reconstruction pairs of the pool's first ``n`` rows, the
    model in eval mode (facegen/train/ae_loop.py:109-122)."""
    x = pool[:n].float() / 255.0
    rows = torch.stack([x, model.eval()(x).clamp(0, 1)], dim=1).reshape((2 * n,) + x.shape[1:])
    save_grid(path, rows.cpu().numpy(), nrow=8)


class _Trainer:
    """The epoch loop both trainers share: ``epoch`` counts the epochs
    done and ``history`` holds their stats; a checkpoint every 50 epochs
    and at the end of a run, then the reconstruction grid unless
    --noplot (rank 0's, on a mesh)."""

    def run(self, epochs: Optional[int] = None) -> Iterator[dict]:
        """Train ``epochs`` epochs (default --epochs, else 1), yielding
        each epoch's stats."""
        cfg = self.cfg
        n = epochs if epochs is not None else (cfg.epochs if cfg.epochs > 0 else 1)
        for i in range(n):
            stats = self.train_epoch()
            self.history.append(stats)
            if self.epoch % 50 == 0 or i + 1 == n:
                self.save()
            yield stats
        if not cfg.noplot and self.writes:
            self.plot()

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)


class AETrainer(_Trainer):
    """train_autoencoder.lua's loop (facegen/train/ae_loop.py:125-193)."""

    def __init__(self, cfg: TrainConfig, device=None, verbose: bool = True, mesh=None,
                 capture: bool = True):
        cfg = self.cfg = cfg.validate()
        self.device, self.writes = placement(mesh, device, cfg.gpu)
        self.mesh = mesh
        self.verbose = verbose and self.writes
        self.n_pool = pool_size(cfg, mesh)
        # weights drawn on the CPU: the same seed gives the same weights on every device
        gen = torch.Generator().manual_seed(cfg.seed)
        self.model = ae.create_autoencoder(cfg.scale, cfg.channels, cfg.noise_dim,
                                           generator=gen, device=self.device)
        gaussian_overwrite(self.model, gen)
        self.shards = None
        if mesh is not None:  # rank 0's weights, then this rank's shards
            replicate([*self.model.parameters(), *self.model.buffers()], mesh)
            self.shards = ShardedParams(list(self.model.parameters()), mesh)
        masters = list(self.model.parameters()) if mesh is None else self.shards.masters
        self.opt = adam(ADAM_LR).init(masters)
        self.step = AEStep(cfg, self.model, mesh, self.shards)
        source = make_source(cfg, self.device)
        self.pool = source.epoch_pool(seeded_generator(self.device, cfg.seed, 2), self.n_pool)
        self.epoch, self.history = 0, []
        self.draws = AEDraws(torch.empty(cfg.batch_size, dtype=torch.int64, device=self.device),
                             dropout.empty_masks(self.step.mask_specs, self.device))
        self.graphed = StepGraph(lambda: self.step(self.model, self.opt, self.pool, self.draws),
                                 (), self.device, mesh, log=self._log, capture=capture,
                                 name="autoencoder step")

    def epoch_draws(self, generator: torch.Generator) -> List[AEDraws]:
        return ae_epoch_draws(generator, self.cfg.batch_size, self.n_pool, self.step.mask_specs)

    def run_steps(self, draws: Sequence[AEDraws]) -> torch.Tensor:
        """One step per draws, each copied into the static draws the
        captured step reads; their losses stacked on the device."""
        return self.graphed.run_steps(lambda i: copy_into(self.draws, draws[i]), len(draws))

    def train_epoch(self) -> dict:
        cfg, e = self.cfg, self.epoch
        draws = self.epoch_draws(seeded_generator(self.device, cfg.seed, 30_000 + e))
        t0 = time.perf_counter()
        mean = float(self.run_steps(draws).mean())  # the epoch's one read-back
        dt = time.perf_counter() - t0
        if mean != mean:  # NaN guard (train_autoencoder.lua:241-247)
            raise FloatingPointError(f"NaN loss at epoch {e}")
        self.epoch += 1
        self._log(f"<AE> epoch {e + 1}: L1 loss {mean:.5f} ({dt:.2f}s)")
        return {"epoch": e + 1, "loss": mean, "seconds": dt,
                "images_per_sec": len(draws) * cfg.batch_size / dt}

    def save(self):
        opt = self.opt if self.shards is None else self.shards.full_opt(self.opt)  # collective
        if self.writes:
            ckpt.save_autoencoder(self.cfg.save, ae.AE_CKPT_NAME, self.model, opt,
                                  meta={"epoch": self.epoch, **ckpt.config_meta(self.cfg)})

    def plot(self):
        dump_recon_grid(self.model, self.pool, os.path.join(self.cfg.save, "viz", "ae_recon.png"))


class DenoiserTrainer(_Trainer):
    """train_denoiser.lua's loop (facegen/train/ae_loop.py:303-392)."""

    def __init__(self, cfg: TrainConfig, device=None, verbose: bool = True, mesh=None,
                 capture: bool = True):
        cfg = self.cfg = cfg.validate()
        self.device, self.writes = placement(mesh, device, cfg.gpu)
        self.mesh = mesh
        self.verbose = verbose and self.writes
        self.n_pool = pool_size(cfg, mesh)
        enc, dec1, dec2 = ae.init_denoiser(torch.Generator().manual_seed(cfg.seed), cfg.scale,
                                           cfg.channels, device=self.device)
        self.epoch, self.history = 0, []
        if cfg.network:  # every rank loads the whole file
            self.resume(cfg.network, dec1, dec2)
        elif mesh is not None:  # rank 0's weights, before they are sharded
            replicate([t for m in (dec1, dec2) for t in (*m.parameters(), *m.buffers())], mesh)
        shards = None
        if mesh is not None:
            shards = shard_params({"dec1": dec1, "dec2": dec2}, mesh)
            set_batch_norm_mesh(dec1, mesh)
            set_batch_norm_mesh(dec2, mesh)
        masters = {k: (shards[k].masters if shards else list(m.parameters()))
                   for k, m in (("dec1", dec1), ("dec2", dec2))}
        tx = adam(ADAM_LR)  # fresh after a resume, as the reference's OPTSTATE = {}
        self.state = DenoiserState(enc, dec1, dec2, tx.init(masters["dec1"]),
                                   tx.init(masters["dec2"]), shards)
        self.step = DenoiserStep(cfg, dec1, mesh)
        # the store's first 256 rows are the validation set, kept out of training
        source = make_source(cfg, self.device, holdout=VAL_ROWS)
        self.pool = source.epoch_pool(seeded_generator(self.device, cfg.seed, 2), self.n_pool)
        self.val_pool = source.range_pool(0, VAL_ROWS)
        noise = (cfg.batch_size,) + tuple(cfg.img_shape)
        specs = self.step.mask_specs
        self.draws = DenoiserDraws(
            torch.empty(cfg.batch_size, dtype=torch.int64, device=self.device),
            torch.empty(noise, device=self.device), dropout.empty_masks(specs, self.device),
            torch.empty(noise, device=self.device), dropout.empty_masks(specs, self.device),
            dropout.empty_masks(specs, self.device))
        self.graphed = StepGraph(lambda: self.step(self.state, self.pool, self.draws), (2,),
                                 self.device, mesh, log=self._log, capture=capture,
                                 name="denoiser step")

    def resume(self, network: str, dec1: nn.Module, dec2: nn.Module):
        """--network: a checkpoint name or dir/name; a value that names no
        checkpoint (the reference ignores the value) means the standard
        ``denoiser_{c}x{h}x{w}`` under --save."""
        cfg = self.cfg
        if not ckpt.exists(*ckpt.split_network_arg(network, cfg.save)):
            network = ae.denoiser_ckpt_name(cfg.scale, cfg.channels)
        directory, name = ckpt.split_network_arg(network, cfg.save)
        meta = ckpt.load_denoiser(directory, name, dec1, dec2)
        self.epoch = int(meta.get("epoch", 0))
        self._log(f"<trainer> reloaded denoiser from {os.path.join(directory, name)} "
                  f"(epoch {self.epoch})")

    def epoch_draws(self, generator: torch.Generator) -> List[DenoiserDraws]:
        cfg = self.cfg
        return denoiser_epoch_draws(generator, cfg.batch_size, cfg.img_shape, self.n_pool,
                                    self.step.mask_specs)

    def run_steps(self, draws: Sequence[DenoiserDraws]) -> torch.Tensor:
        """One step per draws, each copied into the static draws the
        captured step reads; (steps, 2) losses on the device."""
        return self.graphed.run_steps(lambda i: copy_into(self.draws, draws[i]), len(draws))

    def train_epoch(self) -> dict:
        cfg, e = self.cfg, self.epoch
        draws = self.epoch_draws(seeded_generator(self.device, cfg.seed, 40_000 + e))
        t0 = time.perf_counter()
        means = self.run_steps(draws).mean(0)
        val = denoiser_val_loss(self.state.dec1, self.val_pool)
        host = torch.cat([means, val.reshape(1)]).cpu().numpy()  # the epoch's one read-back
        dt = time.perf_counter() - t0
        if not np.isfinite(host[:2]).all():  # exitIfNaNs (train_denoiser.lua:371-379)
            raise FloatingPointError(f"NaN loss at epoch {e}")
        self.epoch += 1
        self._log(f"<denoiser> epoch {e + 1}: AE1 {host[0]:.5f} AE2 {host[1]:.5f} "
                  f"val {host[2]:.5f} ({dt:.2f}s)")
        return {"epoch": e + 1, "loss_ae1": float(host[0]), "loss_ae2": float(host[1]),
                "val_loss": float(host[2]), "seconds": dt,
                "images_per_sec": len(draws) * cfg.batch_size / dt}

    def save(self):
        cfg = self.cfg
        if not self.writes:  # the decoders' weights are whole on every rank
            return
        ckpt.save_denoiser(cfg.save, ae.denoiser_ckpt_name(cfg.scale, cfg.channels),
                           self.state.dec1, self.state.dec2,
                           meta={"epoch": self.epoch, **ckpt.config_meta(cfg)})

    def plot(self):
        dump_recon_grid(self.state.dec1, self.val_pool,
                        os.path.join(self.cfg.save, "viz", "denoiser_recon.png"))

