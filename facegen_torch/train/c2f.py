"""Coarse-to-fine refinement GAN training (counterpart of
facegen/train/c2f.py; adversarial_c2f.lua and train_c2f.lua).

Differences from the GAN step (train/step.py), as in the reference:

- D takes (diff, coarse) pairs and sums them back into the fine image
  (models/c2f.py AddPair); G takes (image-shaped noise, coarse) and
  returns a signed diff.
- The D batch's fake half is made on FRESH random coarse conditions, not
  the real half's (adversarial_c2f.lua:136-142).
- Stock optimizers, no accuracy gate (adversarial_c2f.lua:154-163).
- approxParzen (adversarial_c2f.lua:305-344): for each of
  ``parzen_samples`` validation images, ``batch_size`` refinements of its
  coarse, and the least L2 distance to the true fine; the mean picks the
  ``_best`` checkpoint. One batched G call over all refinements.

Every draw of a step is an argument (``C2FStepDraws``): per D iteration
the real rows, the fake conditions' rows, the noise and D's dropout
masks; per G iteration the conditions' rows, the noise and D's masks.
``draw_c2f_step`` makes them on the device; the tests rebuild facegen's.

``C2FTrainer.run_steps`` runs the steps through train/graph.py's capture
core (facegen's one ``lax.scan`` of the epoch under ``jax.jit``,
c2f.py:205-214, 294): on a card every step after the first replays one
CUDA graph of the step, which reads a static copy of the epoch's pool and
static draws that ``draw_c2f_step(out=)`` fills before each step;
approxParzen, the grid and the confusion matrix's reset run outside it,
and the epoch's metrics are read back once.

On a 2-D mesh (parallel/gspmd.py; facegen's ``make_gspmd_c2f_epoch``,
c2f.py:278-291) the trainer runs the single-device program on the global
batch, as the GAN's step does there (train/step.py): every rank draws
the global batch's draws and computes its data row's block of them
(short or empty on the last rows), a rank's losses and accuracy are the
sums over its rows over the global batch, one SUM all-reduce per
iteration over the data group makes the gradients, the loss, the
accuracy and the confusion counts global, and the update runs on this
rank's shards (``C2FState.shards``).

``--boundaryPad P`` widens the diff/coarse interface to P channels inside
the step (facegen/train/c2f.py:113-128; train/step.py:BoundaryPadder):
G_d's 7x7 output conv gains zero output channels (its pad diffs come out
exactly 0), the real diffs and D's coarse conditions gain zero channels,
and D_c's first conv zero input channels; G's own (noise, coarse) inputs
stay unpadded. Rank 0 writes the grids,
the metrics and the checkpoints; every rank computes approxParzen and
takes rank 0's mean, so all choose alike whether to save ``_best``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from facegen_torch.config import C2FConfig, TrainConfig
from facegen_torch.data.c2f import C2FPool, gather_triple, make_triples
from facegen_torch.data.pipeline import make_source
from facegen_torch.models import c2f as c2f_models
from facegen_torch.nn import dropout
from facegen_torch.nn.init import seeded_generator
from facegen_torch.parallel.gspmd import flat_all_reduce, global_rows, shard_params
from facegen_torch.parallel.mesh import placement, replicate
from facegen_torch.train import losses, metrics as M
from facegen_torch.train.graph import StepGraph
from facegen_torch.train.optim import make_c2f_optimizer, penalised_update
from facegen_torch.train.step import make_boundary_padder, steps_per_epoch
from facegen_torch.utils import checkpoint as ckpt
from facegen_torch.utils.grids import save_png, to_grid
from facegen_torch.utils.profiling import MetricsLogger


@dataclasses.dataclass
class C2FState:
    """What c2f training carries (facegen's C2FState): the two nets, their
    optimizer states, the epoch's confusion matrix, on the nets' device,
    and the 1-based epoch number."""

    g: nn.Module
    d: nn.Module
    opt_g: dict
    opt_d: dict
    confusion: torch.Tensor  # (2, 2) int32 [target, predicted], reset each epoch
    epoch: int = 1
    shards: Optional[dict] = None  # on a 2-D mesh (train/step.py:GanState.shards)


class C2FDDraws(NamedTuple):
    """One D iteration's draws (facegen/train/c2f.py:133-139)."""

    idx_real: torch.Tensor          # (half,) int64 pool rows of the real half
    idx_fake: torch.Tensor          # (half,) rows whose coarse conditions the fakes
    noise: torch.Tensor             # (half, fs, fs, 1) U(-1, 1)
    masks: Dict[str, torch.Tensor]  # D's keep-masks by key path (models/c2f.py)


class C2FGDraws(NamedTuple):
    """One G iteration's draws (facegen/train/c2f.py:171-174)."""

    idx: torch.Tensor               # (batch,) rows of the conditions
    noise: torch.Tensor             # (batch, fs, fs, 1) U(-1, 1)
    masks: Dict[str, torch.Tensor]


class C2FStepDraws(NamedTuple):
    d: Tuple[C2FDDraws, ...]        # one per D iteration
    g: Tuple[C2FGDraws, ...]        # one per G iteration


class C2FStepMetrics(NamedTuple):
    loss_d: torch.Tensor  # with D's penalty
    loss_g: torch.Tensor  # with G's penalty
    acc_d: torch.Tensor   # the batch's D accuracy


def init_c2f_state(cfg: C2FConfig, g: nn.Module, d: nn.Module, mesh=None) -> C2FState:
    device = next(g.parameters()).device
    shards = shard_params({"g": g, "d": d}, mesh) if mesh is not None else None
    masters = {k: (shards[k].masters if shards else list(m.parameters()))
               for k, m in (("g", g), ("d", d))}
    return C2FState(
        g=g, d=d,
        opt_g=make_c2f_optimizer(cfg.g_optmethod, cfg, "G").init(masters["g"]),
        opt_d=make_c2f_optimizer(cfg.d_optmethod, cfg, "D").init(masters["d"]),
        confusion=M.empty_confusion(device), epoch=1, shards=shards,
    )


def empty_c2f_draws(cfg: C2FConfig, mask_specs: Dict[str, Tuple[Tuple[int, ...], float]],
                    device) -> C2FStepDraws:
    """Uninitialised buffers of one step's draws, for ``draw_c2f_step(out=)``."""
    fs, half = cfg.fine_size, cfg.batch_size // 2

    def idx(n):
        return torch.empty(n, dtype=torch.int64, device=device)

    def noise(n):
        return torch.empty(n, fs, fs, 1, device=device)

    def masks():
        return dropout.empty_masks(mask_specs, device)

    return C2FStepDraws(
        tuple(C2FDDraws(idx(half), idx(half), noise(half), masks())
              for _ in range(cfg.d_iterations)),
        tuple(C2FGDraws(idx(cfg.batch_size), noise(cfg.batch_size), masks())
              for _ in range(cfg.g_iterations)))


def draw_c2f_step(generator: torch.Generator, cfg: C2FConfig, pool_n: int,
                  mask_specs: Dict[str, Tuple[Tuple[int, ...], float]],
                  out: Optional[C2FStepDraws] = None) -> C2FStepDraws:
    """One step's draws from ``generator``, on its device; ``mask_specs``
    as ``C2FStep.mask_specs``. With ``out`` (``empty_c2f_draws``, e.g. a
    CUDA graph's static buffers) they are written into its tensors: the
    same values, drawn in the same order."""
    dev = generator.device
    if out is None:
        out = empty_c2f_draws(cfg, mask_specs, dev)

    def idx(buf):
        torch.randint(0, pool_n, buf.shape, generator=generator, device=dev, out=buf)

    def noise(buf):  # U(-1, 1)
        torch.rand(buf.shape, generator=generator, device=dev, out=buf)
        buf.mul_(2.0).sub_(1.0)

    for dd in out.d:
        idx(dd.idx_real)
        idx(dd.idx_fake)
        noise(dd.noise)
        dropout.draw_masks(generator, mask_specs, out=dd.masks)
    for gd in out.g:
        idx(gd.idx)
        noise(gd.noise)
        dropout.draw_masks(generator, mask_specs, out=gd.masks)
    return out


class C2FStep:
    """``step(state, pool, draws) -> C2FStepMetrics``, updating ``state``
    in place; ``pool`` is the epoch's C2FPool on the nets' device (the
    whole pool on a 2-D ``mesh``)."""

    def __init__(self, cfg: C2FConfig, g: nn.Module, d: nn.Module, mesh=None):
        self.cfg, self.mesh = cfg, mesh
        self.global_rows = global_rows(mesh, cfg.batch_size)
        self.pad = make_boundary_padder(cfg, g, d)
        self.tx_d = make_c2f_optimizer(cfg.d_optmethod, cfg, "D")
        self.tx_g = make_c2f_optimizer(cfg.g_optmethod, cfg, "G")
        self.dtype = getattr(torch, cfg.compute_dtype)
        device = next(d.parameters()).device
        self.mask_specs = dropout.dropout_mask_specs(
            d, cfg.batch_size, (cfg.img_shape, cfg.img_shape), device)
        self._flat: Dict[str, torch.Tensor] = {}

    def d_iteration(self, state: C2FState, pool: C2FPool, draws: C2FDDraws):
        cfg, g, d, mesh, pad = self.cfg, state.g, state.d, self.mesh, self.pad
        params = list(d.parameters())
        idx_real, idx_fake, noise, masks = draws.idx_real, draws.idx_fake, draws.noise, draws.masks
        if mesh is not None:  # this data row's rows of the global batch
            idx_real, idx_fake, noise = mesh.rows(idx_real), mesh.rows(idx_fake), mesh.rows(noise)
            masks = {k: mesh.pair_rows(m) for k, m in masks.items()}
        half = idx_real.shape[0]
        _, cond_real, diff_real = gather_triple(pool, idx_real, self.dtype)
        _, cond_fake, _ = gather_triple(pool, idx_fake, self.dtype)
        g.train()
        with torch.no_grad():  # the fakes are detached
            diff_fake = pad.g(g, (noise.to(self.dtype), cond_fake))
        diffs = torch.cat([pad.images(diff_real), diff_fake])
        conds = pad.images(torch.cat([cond_real, cond_fake]))
        ones = torch.ones(half, device=diffs.device)
        targets = torch.cat([ones, torch.zeros_like(ones)])
        d.train()
        dropout.set_dropout_masks(d, masks)
        logits = pad.d(d, (diffs, conds))
        loss = losses.bce_with_logits(logits, targets, self.global_rows)
        grads = torch.autograd.grad(loss, params)
        logits = logits.detach()
        acc = losses.batch_accuracy(logits, targets, self.global_rows)
        counts = M.update_confusion(M.empty_confusion(logits.device), logits, targets)
        loss = loss.detach()
        if mesh is not None:
            *grads, loss, acc, counts = flat_all_reduce(mesh, self._flat, "d",
                                                        [*grads, loss, acc, counts], params)
            acc, counts = acc.clone(), counts.to(torch.int32)
        # penalties on the pre-update parameters, then the clamp and the update
        loss = loss + penalised_update(
            self.tx_d, grads, state.opt_d, params, cfg.d_l1, cfg.d_l1, cfg.d_l2, cfg.d_clamp,
            shards=None if state.shards is None else state.shards["d"])[0]
        state.confusion += counts
        return loss, acc

    def g_iteration(self, state: C2FState, pool: C2FPool, draws: C2FGDraws):
        cfg, g, d, mesh, pad = self.cfg, state.g, state.d, self.mesh, self.pad
        params = list(g.parameters())
        idx, noise, masks = draws.idx, draws.noise, draws.masks
        if mesh is not None:
            idx, noise = mesh.rows(idx), mesh.rows(noise)
            masks = {k: mesh.rows(m) for k, m in masks.items()}
        _, conds, _ = gather_triple(pool, idx, self.dtype)
        g.train()
        d.train()
        dropout.set_dropout_masks(d, masks)
        diff = pad.g(g, (noise.to(self.dtype), conds))
        logits = pad.d(d, (diff, pad.images(conds)))  # D's parameters as the D phase left them
        loss = losses.bce_with_logits(logits, torch.ones(logits.shape[0], device=logits.device),
                                      self.global_rows)
        grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        if mesh is not None:
            *grads, loss = flat_all_reduce(mesh, self._flat, "g", [*grads, loss], params)
        # the reference's bug (adversarial.lua:223): G_L2 scales the sign term too
        sign_coef = cfg.g_l2 if cfg.reference_g_penalty_bug else cfg.g_l1
        return loss + penalised_update(
            self.tx_g, grads, state.opt_g, params, sign_coef, cfg.g_l1, cfg.g_l2, cfg.g_clamp,
            shards=None if state.shards is None else state.shards["g"])[0]

    def __call__(self, state: C2FState, pool: C2FPool, draws: C2FStepDraws) -> C2FStepMetrics:
        zero = torch.zeros((), device=pool.fine.device)
        loss_d, acc = zero, zero
        for dd in draws.d:
            loss_d, acc = self.d_iteration(state, pool, dd)
        loss_g = zero
        for gd in draws.g:
            loss_g = self.g_iteration(state, pool, gd)
        return C2FStepMetrics(loss_d, loss_g, acc)


def parzen_draws(generator: torch.Generator, cfg: C2FConfig, nneighbors: int,
                 pool_n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """approxParzen's draws on the generator's device: the
    ``parzen_samples`` validation rows and (samples, nneighbors, fs, fs, 1)
    U(-1, 1) noise."""
    dev, fs = generator.device, cfg.fine_size
    idx = torch.randint(0, pool_n, (cfg.parzen_samples,), generator=generator, device=dev)
    noise = torch.rand(cfg.parzen_samples, nneighbors, fs, fs, 1, generator=generator,
                       device=dev) * 2.0 - 1.0
    return idx, noise


@torch.no_grad()
def parzen_distances(g: nn.Module, cfg: C2FConfig, pool: C2FPool, idx: torch.Tensor,
                     noise: torch.Tensor) -> torch.Tensor:
    """Per validation row ``idx[i]``, the least L2 distance between its
    fine image and G's refinements of its coarse on ``noise[i]``
    (facegen/train/c2f.py:218-242); G in eval mode and the compute dtype,
    the distances in fp32. Returns (samples,)."""
    ns, nn_, fs, c = noise.shape[0], noise.shape[1], cfg.fine_size, cfg.channels
    dtype = getattr(torch, cfg.compute_dtype)
    fine, coarse, _ = gather_triple(pool, idx, torch.float32)
    cond = coarse[:, None].to(dtype).expand(ns, nn_, fs, fs, c).reshape(ns * nn_, fs, fs, c)
    diff = g.eval()((noise.reshape(ns * nn_, fs, fs, 1).to(dtype), cond))
    refined = (diff.float() + cond.float()).reshape(ns, nn_, -1)
    dists = torch.sqrt(((refined - fine.reshape(ns, 1, -1)) ** 2).sum(-1))
    return dists.min(dim=1).values


def ckpt_name(cfg: C2FConfig, best: bool = False) -> str:
    """adversarial_c2f_{coarse}_to_{fine}[_best] (adversarial_c2f.lua:209,336)."""
    return f"adversarial_c2f_{cfg.coarse_size}_to_{cfg.fine_size}" + ("_best" if best else "")


class C2FTrainer:
    """train_c2f.lua's main loop (facegen/train/c2f.py:251-430): the epoch
    loop, approxParzen after each epoch with the ``_best`` checkpoint, the
    5-column sample grid, and saves every saveFreq epochs with ``.old``
    rotation. Random streams: epoch ``i`` draws from generators seeded by
    (seed, 20000 + i, k), so a resumed run draws fresh pools."""

    def __init__(self, cfg: C2FConfig, device=None, source=None, verbose: bool = True,
                 mesh=None, capture: bool = True):
        self.cfg = cfg.validate()
        self.device, self.writes = placement(mesh, device, cfg.gpu)
        self.mesh = mesh
        self.verbose = verbose and self.writes
        if source is None:
            # the fine-size source; its first val_size rows are the validation set
            tcfg = TrainConfig(scale=cfg.fine_size, grayscale=cfg.grayscale,
                               synthetic_data=cfg.synthetic_data, dataset_dir=cfg.dataset_dir,
                               aws=cfg.aws)
            source = make_source(tcfg, self.device, holdout=cfg.val_size)
        self.source = source
        # weights drawn on the CPU: the same seed gives the same weights on every device
        g, d = c2f_models.init_c2f(torch.Generator().manual_seed(cfg.seed), cfg.fine_size,
                                   cfg.channels, device=self.device)
        if mesh is not None and not cfg.network:  # rank 0's weights, before they are sharded
            replicate([*g.parameters(), *g.buffers(), *d.parameters(), *d.buffers()], mesh)
        self.state = init_c2f_state(cfg, g, d, mesh)
        self.step = C2FStep(cfg, g, d, mesh)
        # the step as a CUDA graph on a card (train/graph.py): it reads the
        # static pool and draws, which each epoch and step write
        self.draws = empty_c2f_draws(cfg, self.step.mask_specs, self.device)
        self.graphed = StepGraph(
            lambda: torch.stack(self.step(self.state, self.graphed.pool, self.draws)), (3,),
            self.device, mesh, log=self._log, capture=capture, name="c2f step")
        self.pool_n = cfg.n_epoch if cfg.n_epoch > 0 else source.size
        self.best_dist = math.inf
        # VAL_DATA = the first val_size images (train_c2f.lua:218)
        self.val_pool = make_triples(source.range_pool(0, cfg.val_size), cfg.coarse_size)
        self.metrics_log = MetricsLogger(cfg.save, "metrics_c2f.jsonl") if self.writes else None
        if cfg.network:
            self.resume(cfg.network)

    def save(self, best: bool = False, **meta):
        """Rank 0 writes; on a 2-D mesh every rank gathers the moments."""
        meta = {**ckpt.config_meta(self.cfg), "epoch": self.state.epoch, **meta}
        path = ckpt.save_train_state(self.cfg.save, ckpt_name(self.cfg, best), self.state, meta,
                                     write=self.writes)
        self._log(f"<trainer> saved {'best network' if best else 'checkpoint'} to {path}")

    def resume(self, network: str):
        """Parameters, optimizer states and the epoch (train_c2f.lua:109-116),
        and the best parzen so far from the ``_best`` checkpoint's meta, so a
        resumed run cannot overwrite a better one."""
        directory, name = ckpt.split_network_arg(network, self.cfg.save)
        ckpt.load_train_state(directory, name, self.state)
        best = ckpt.load_meta(directory, ckpt_name(self.cfg, best=True))
        self.best_dist = float(best.get("parzen", math.inf))
        self._log(f"<trainer> reloaded previously trained network: {network} "
                  f"(epoch {self.state.epoch})")

    @torch.no_grad()
    def get_samples_grid(self, generator: torch.Generator, n: int = 8) -> np.ndarray:
        """train_c2f.lua:187-216's plot: for n validation images a row of
        (coarse | ground truth | refined | true diff | G's diff), diffs
        shown around mid-gray; G in eval mode, fp32."""
        cfg = self.cfg
        idx = torch.randint(0, self.val_pool.size, (n,), generator=generator,
                            device=generator.device)
        z = torch.rand(n, cfg.fine_size, cfg.fine_size, 1, generator=generator,
                       device=generator.device) * 2.0 - 1.0
        fine, coarse, diff = gather_triple(self.val_pool, idx.to(self.device))
        g_diff = self.state.g.eval()((z.to(self.device), coarse))
        refined = torch.clamp(coarse + g_diff, 0.0, 1.0)
        tiles = torch.stack([coarse, fine, refined, torch.clamp(diff + 0.5, 0, 1),
                             torch.clamp(g_diff + 0.5, 0, 1)], dim=1)
        return to_grid(tiles.reshape((5 * n,) + tiles.shape[2:]).cpu().numpy(), nrow=5)

    def run_steps(self, pool: C2FPool, generator: torch.Generator,
                  n_steps: int) -> C2FStepMetrics:
        """``n_steps`` steps on ``pool`` through the captured step; their
        metrics stacked on the device."""
        self.graphed.set_pool(pool)
        cfg, specs = self.cfg, self.step.mask_specs
        rows = self.graphed.run_steps(
            lambda i: draw_c2f_step(generator, cfg, pool.size, specs, out=self.draws), n_steps)
        return C2FStepMetrics(*rows.unbind(1))

    def parzen(self, generator: torch.Generator) -> np.ndarray:
        """approxParzen over the validation pool, ``batch_size`` refinements
        per sample (train_c2f.lua:235)."""
        idx, noise = parzen_draws(generator, self.cfg, self.cfg.batch_size, self.val_pool.size)
        return parzen_distances(self.state.g, self.cfg, self.val_pool, idx, noise).cpu().numpy()

    def train_epoch(self, epoch_idx: int) -> dict:
        cfg, dev = self.cfg, self.device

        def gen(k):
            return seeded_generator(dev, cfg.seed, 20_000 + epoch_idx, k)

        self._log("Loading new training data...")
        pool = make_triples(self.source.epoch_pool(gen(0), self.pool_n), cfg.coarse_size)
        if not cfg.noplot and self.writes:
            save_png(os.path.join(cfg.save, "viz", "c2f_samples.png"),
                     self.get_samples_grid(gen(3), 20))

        t0 = time.perf_counter()
        ms = self.run_steps(pool, gen(1), steps_per_epoch(cfg, self.pool_n))
        # the epoch's one read-back, which also waits for the device
        host = {k: v.cpu().numpy() for k, v in ms._asdict().items()}
        conf = self.state.confusion.cpu().numpy()
        dt = time.perf_counter() - t0
        self.state.epoch += 1
        n_examples = cfg.n_epoch if cfg.n_epoch > 0 else self.pool_n
        self._log(f"<trainer> time required for this epoch = {dt:.3f} s")
        self._log(f"<trainer> time to learn 1 sample = {1000 * dt / n_examples:.4f} ms")
        self._log(M.format_confusion(conf))

        t1 = time.perf_counter()
        mean_dist = float(self.parzen(gen(2)).mean())
        if self.mesh is not None:  # rank 0's value: every rank saves _best or none does
            shared = torch.tensor([mean_dist], dtype=torch.float64, device=dev)
            torch.distributed.broadcast(shared, src=self.mesh.ranks[0])
            mean_dist = float(shared)
        parzen_s = time.perf_counter() - t1
        self._log(f"average || x_{cfg.fine_size} - G(x_{cfg.coarse_size}) || = {mean_dist:.5f}")
        if mean_dist < self.best_dist:
            self.best_dist = mean_dist
            self.save(best=True, parzen=mean_dist)
        stats = {
            "epoch": self.state.epoch - 1,
            "seconds": dt,
            "images_per_sec": n_examples / dt,
            "loss_d_mean": float(host["loss_d"].mean()),
            "loss_g_mean": float(host["loss_g"].mean()),
            "acc_d_mean": float(host["acc_d"].mean()),
            "total_valid": M.total_valid(conf),
            "parzen": mean_dist,
            "parzen_ms": 1e3 * parzen_s,
        }
        self.state.confusion.zero_()
        if self.writes:
            self.metrics_log.log(stats)
        if (self.state.epoch - 1) % cfg.save_freq == 0:
            self.save()
        return stats

    def run(self, epochs: Optional[int] = None) -> Iterator[dict]:
        """Train ``epochs`` epochs (default --epochs; -1 runs forever),
        yielding each epoch's stats; a bounded run saves once more at its
        end unless its last epoch just saved."""
        n = epochs if epochs is not None else (self.cfg.epochs if self.cfg.epochs > 0 else None)
        start = self.state.epoch - 1
        i = 0
        while n is None or i < n:
            yield self.train_epoch(start + i)
            i += 1
        if (self.state.epoch - 1) % self.cfg.save_freq != 0:
            self.save()

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)
