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
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from facegen_torch.config import TrainConfig
from facegen_torch.data.pipeline import make_source
from facegen_torch.models import ae
from facegen_torch.nn import dropout
from facegen_torch.nn.init import gaussian_overwrite, seeded_generator
from facegen_torch.train import losses
from facegen_torch.train.optim import adam, gated_update
from facegen_torch.utils import checkpoint as ckpt
from facegen_torch.utils.grids import save_grid

ADAM_LR = 1e-3
VAL_ROWS = 256  # VAL_DATA = images 10001-10256 (train_denoiser.lua:153-156)


def shuffled_batches(perm: torch.Tensor, batch: int) -> torch.Tensor:
    """A permutation of the pool -> (n_batches, batch) rows, the
    remainder dropped (facegen/train/ae_loop.py:39-42)."""
    n = perm.shape[0] // batch
    return perm[: n * batch].reshape(n, batch)


def bce(y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Mean BCE of probabilities in fp32, ``y`` clipped to [1e-7, 1 - 1e-7]
    (facegen/train/ae_loop.py:201-205; not F.binary_cross_entropy, which
    clamps its logs at -100 instead)."""
    eps = 1e-7
    y = y.float().clamp(eps, 1 - eps)
    t = t.float()
    return -(t * torch.log(y) + (1 - t) * torch.log1p(-y)).mean()


def pool_size(cfg: TrainConfig) -> int:
    """Rows of the run's pool: min(N_epoch, or 10000, 16384). A pool
    smaller than the batch would give no batch at all."""
    n_pool = min(cfg.n_epoch if cfg.n_epoch > 0 else 10000, 16384)
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


class AEStep:
    """``step(model, opt, pool, draws) -> loss`` (with the penalty),
    updating the model and Adam's state in place
    (facegen/train/ae_loop.py:77-95)."""

    def __init__(self, cfg: TrainConfig, model: nn.Module):
        self.cfg = cfg
        self.tx = adam(ADAM_LR)
        self.mask_specs = dropout.dropout_mask_specs(model, cfg.batch_size, cfg.img_shape,
                                                     next(model.parameters()).device)

    def __call__(self, model: nn.Module, opt: dict, pool: torch.Tensor,
                 draws: AEDraws) -> torch.Tensor:
        cfg = self.cfg
        x = pool[draws.idx].float() / 255.0
        model.train()
        dropout.set_dropout_masks(model, draws.masks)
        params = list(model.parameters())
        loss = (model(x) - x).abs().mean()
        grads = torch.autograd.grad(loss, params)
        # the L1/L2 penalty on every parameter, biases included, in the loss
        # and the gradients, and no clamp (train_autoencoder.lua:196-204)
        loss = loss.detach() + losses.penalty_loss(params, cfg.coef_l1, cfg.coef_l2)
        grads = losses.add_penalty_grads(grads, params, cfg.coef_l1, cfg.coef_l2)
        gated_update(self.tx, grads, opt, params, True)
        return loss


@dataclasses.dataclass
class DenoiserState:
    enc: nn.Module
    dec1: nn.Module
    dec2: nn.Module
    opt1: dict
    opt2: dict


class DenoiserStep:
    """``step(state, pool, draws) -> (AE1's BCE, AE2's BCE)``, updating
    ``state`` in place (facegen/train/ae_loop.py:215-278)."""

    def __init__(self, cfg: TrainConfig, dec: nn.Module):
        self.cfg = cfg
        self.tx = adam(ADAM_LR)
        self.mask_specs = dropout.dropout_mask_specs(dec, cfg.batch_size, cfg.img_shape,
                                                     next(dec.parameters()).device)

    def _update(self, loss: torch.Tensor, dec: nn.Module, opt: dict) -> None:
        cfg = self.cfg
        params = list(dec.parameters())
        grads = torch.autograd.grad(loss, params)
        # the penalty feeds the gradient only: the reported loss stays the
        # bare BCE (train_denoiser.lua:272, 311); then the clamp (:289-291)
        grads = losses.add_penalty_grads(grads, params, cfg.coef_l1, cfg.coef_l2)
        grads = losses.clamp_grads(grads, cfg.ae_clamp)
        gated_update(self.tx, grads, opt, params, True)

    def __call__(self, st: DenoiserState, pool: torch.Tensor,
                 draws: DenoiserDraws) -> torch.Tensor:
        x = pool[draws.idx].float() / 255.0
        for m in (st.enc, st.dec1, st.dec2):
            m.train()
        ae.set_white_noise(st.enc, draws.noise)
        dropout.set_dropout_masks(st.dec1, draws.masks)
        l1 = bce(st.dec1(st.enc(x)), x)
        self._update(l1, st.dec1, st.opt1)
        # AE1 again after its update (train_denoiser.lua:313-315, 335-336)
        with torch.no_grad():
            ae.set_white_noise(st.enc, draws.noise_again)
            dropout.set_dropout_masks(st.dec1, draws.masks_again)
            y1 = st.dec1(st.enc(x))
        dropout.set_dropout_masks(st.dec2, draws.masks2)
        l2 = bce(st.dec2(y1), x)
        self._update(l2, st.dec2, st.opt2)
        return torch.stack([l1.detach(), l2.detach()])


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
    --noplot."""

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
        if not cfg.noplot:
            self.plot()

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)


class AETrainer(_Trainer):
    """train_autoencoder.lua's loop (facegen/train/ae_loop.py:125-193)."""

    def __init__(self, cfg: TrainConfig, device=None, verbose: bool = True):
        self.cfg = cfg = cfg.validate()
        self.device = torch.device(device if device is not None else f"cuda:{cfg.gpu}")
        self.verbose = verbose
        self.n_pool = pool_size(cfg)
        # weights drawn on the CPU: the same seed gives the same weights on every device
        gen = torch.Generator().manual_seed(cfg.seed)
        self.model = ae.create_autoencoder(cfg.scale, cfg.channels, cfg.noise_dim,
                                           generator=gen, device=self.device)
        gaussian_overwrite(self.model, gen)
        self.opt = adam(ADAM_LR).init(list(self.model.parameters()))
        self.step = AEStep(cfg, self.model)
        source = make_source(cfg, self.device)
        self.pool = source.epoch_pool(seeded_generator(self.device, cfg.seed, 2), self.n_pool)
        self.epoch, self.history = 0, []

    def epoch_draws(self, generator: torch.Generator) -> List[AEDraws]:
        return ae_epoch_draws(generator, self.cfg.batch_size, self.n_pool, self.step.mask_specs)

    def run_steps(self, draws) -> torch.Tensor:
        """One step per draws; their losses stacked on the device."""
        return torch.stack([self.step(self.model, self.opt, self.pool, d) for d in draws])

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
        ckpt.save_autoencoder(self.cfg.save, ae.AE_CKPT_NAME, self.model, self.opt,
                              meta={"epoch": self.epoch, **ckpt.config_meta(self.cfg)})

    def plot(self):
        dump_recon_grid(self.model, self.pool, os.path.join(self.cfg.save, "viz", "ae_recon.png"))


class DenoiserTrainer(_Trainer):
    """train_denoiser.lua's loop (facegen/train/ae_loop.py:303-392)."""

    def __init__(self, cfg: TrainConfig, device=None, verbose: bool = True):
        self.cfg = cfg = cfg.validate()
        self.device = torch.device(device if device is not None else f"cuda:{cfg.gpu}")
        self.verbose = verbose
        self.n_pool = pool_size(cfg)
        enc, dec1, dec2 = ae.init_denoiser(torch.Generator().manual_seed(cfg.seed), cfg.scale,
                                           cfg.channels, device=self.device)
        self.epoch, self.history = 0, []
        if cfg.network:
            self.resume(cfg.network, dec1, dec2)
        tx = adam(ADAM_LR)  # fresh after a resume, as the reference's OPTSTATE = {}
        self.state = DenoiserState(enc, dec1, dec2, tx.init(list(dec1.parameters())),
                                   tx.init(list(dec2.parameters())))
        self.step = DenoiserStep(cfg, dec1)
        # the store's first 256 rows are the validation set, kept out of training
        source = make_source(cfg, self.device, holdout=VAL_ROWS)
        self.pool = source.epoch_pool(seeded_generator(self.device, cfg.seed, 2), self.n_pool)
        self.val_pool = source.range_pool(0, VAL_ROWS)

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

    def run_steps(self, draws) -> torch.Tensor:
        """One step per draws; (steps, 2) losses on the device."""
        return torch.stack([self.step(self.state, self.pool, d) for d in draws])

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
        ckpt.save_denoiser(cfg.save, ae.denoiser_ckpt_name(cfg.scale, cfg.channels),
                           self.state.dec1, self.state.dec2,
                           meta={"epoch": self.epoch, **ckpt.config_meta(cfg)})

    def plot(self):
        dump_recon_grid(self.state.dec1, self.val_pool,
                        os.path.join(self.cfg.save, "viz", "denoiser_recon.png"))

