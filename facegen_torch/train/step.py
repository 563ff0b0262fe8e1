"""The GAN train step (counterpart of facegen/train/step.py:204-393).

One step is ``d_iterations`` D iterations and then ``g_iterations`` G
iterations (adversarial.lua:240-288):

- D: half a batch of real images drawn with replacement from the epoch
  pool and half a batch of fakes from G, which runs in train mode under
  no_grad (its batch-norm statistics move; the fakes are detached);
  BCE on D's logits; D's L1/L2 penalty on the pre-update parameters,
  then the gradient clamp; the batch accuracy is pushed into the ring
  buffer and the ring's mean gates the update (D_maxAcc).
- G: a full batch of noise through G and the just-updated D, all
  targets "real"; G's penalty (with the reference's G_L2 bug) and clamp;
  an ungated update.

Every random draw of a step is an argument (``StepDraws``): per D
iteration the batch indices, the fakes' noise and D's dropout masks, per
G iteration the noise and D's masks.
``draw_step`` makes them on the device in a normal run; the tests
reproduce facegen's draws and inject them. Nothing is read back to the
host inside a step: the step's metrics stay on the device until the
epoch ends (train/loop.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from facegen_torch.config import TrainConfig
from facegen_torch.nn import dropout
from facegen_torch.train import losses, metrics
from facegen_torch.train.optim import gated_update, make_optimizer


@dataclasses.dataclass
class GanState:
    """What training carries across steps and epochs (facegen's GanState):
    the two networks (parameters and batch-norm statistics), the
    optimizer states, the gate's ring buffer, the epoch's confusion
    matrix and gate counters, all on the networks' device, and the
    1-based epoch number."""

    g: nn.Module
    d: nn.Module
    opt_g: dict
    opt_d: dict
    accs: torch.Tensor           # (accs_interval,) fp32 ring of D batch accuracies
    accs_n: torch.Tensor         # int32: accuracies pushed (ring head = accs_n % K)
    confusion: torch.Tensor      # (2, 2) int32 [target, predicted], reset each epoch
    trained_d: torch.Tensor      # int32: D updates taken this epoch
    not_trained_d: torch.Tensor  # int32: D updates skipped by the gate
    epoch: int = 1


class DDraws(NamedTuple):
    """One D iteration's draws (facegen/train/step.py:269-273)."""

    idx: torch.Tensor                # (half,) int64 pool rows of the real half
    noise: torch.Tensor              # (half, noise_dim) U(-1, 1) for the fakes
    masks: Dict[str, torch.Tensor]   # D's keep-masks by layer name


class GDraws(NamedTuple):
    """One G iteration's draws (facegen/train/step.py:342-345)."""

    noise: torch.Tensor              # (batch, noise_dim) U(-1, 1)
    masks: Dict[str, torch.Tensor]


class StepDraws(NamedTuple):
    d: Tuple[DDraws, ...]            # one per D iteration
    g: Tuple[GDraws, ...]            # one per G iteration


class StepMetrics(NamedTuple):
    loss_d: torch.Tensor     # with D's penalty
    loss_g: torch.Tensor     # with G's penalty
    acc_d: torch.Tensor      # the batch's D accuracy
    gate_open: torch.Tensor  # fp32 0/1: whether D trained


def init_state(cfg: TrainConfig, g: nn.Module, d: nn.Module) -> GanState:
    device = next(g.parameters()).device
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return GanState(
        g=g, d=d,
        opt_g=make_optimizer(cfg.g_optmethod, cfg, "G").init(list(g.parameters())),
        opt_d=make_optimizer(cfg.d_optmethod, cfg, "D").init(list(d.parameters())),
        accs=torch.zeros((cfg.accs_interval,), dtype=torch.float32, device=device),
        accs_n=zero.clone(), confusion=metrics.empty_confusion(device),
        trained_d=zero.clone(), not_trained_d=zero.clone(), epoch=1,
    )


def reset_epoch_stats(state: GanState) -> None:
    """Zero the confusion matrix and gate counters (adversarial.lua:316)."""
    state.confusion.zero_()
    state.trained_d.zero_()
    state.not_trained_d.zero_()


def steps_per_epoch(cfg: TrainConfig, pool_size: Optional[int] = None) -> int:
    """Optimizer steps per epoch: the reference's ``for t = 1, N_epoch,
    batchSize/2`` skipping tails smaller than 4 (adversarial.lua:54-76);
    N_epoch <= 0 means the whole pool."""
    n = cfg.n_epoch if cfg.n_epoch > 0 else (pool_size or 0)
    half = cfg.batch_size // 2
    count = sum(1 for t in range(1, n + 1, half) if min(cfg.batch_size, n - t + 1) >= 4)
    return max(count, 1)


def empty_draws(cfg: TrainConfig, mask_specs: Dict[str, Tuple[Tuple[int, ...], float]],
                device) -> StepDraws:
    """Uninitialised buffers of one step's draws, for ``draw_step(out=)``."""
    half = cfg.batch_size // 2

    def masks():
        return {name: torch.empty(shape, dtype=torch.bool, device=device)
                for name, (shape, _) in mask_specs.items()}

    def noise(n):
        return torch.empty(n, cfg.noise_dim, device=device)

    return StepDraws(
        tuple(DDraws(torch.empty(half, dtype=torch.int64, device=device), noise(half), masks())
              for _ in range(cfg.d_iterations)),
        tuple(GDraws(noise(cfg.batch_size), masks()) for _ in range(cfg.g_iterations)))


def draw_step(generator: torch.Generator, cfg: TrainConfig, pool_n: int,
              mask_specs: Dict[str, Tuple[Tuple[int, ...], float]],
              out: Optional[StepDraws] = None) -> StepDraws:
    """One step's draws from ``generator``, on its device. ``mask_specs``
    maps each of D's dropout layers to its mask shape at the full batch
    and its rate (``TrainStep.mask_specs``). With ``out`` (``empty_draws``,
    e.g. a CUDA graph's static buffers) they are written into its tensors:
    the same values, drawn in the same order."""
    dev = generator.device
    if out is None:
        out = empty_draws(cfg, mask_specs, dev)

    def noise(buf):  # U(-1, 1)
        torch.rand(buf.shape, generator=generator, device=dev, out=buf)
        buf.mul_(2.0).sub_(1.0)

    for dd in out.d:
        torch.randint(0, pool_n, dd.idx.shape, generator=generator, device=dev, out=dd.idx)
        noise(dd.noise)
        dropout.draw_masks(generator, mask_specs, out=dd.masks)
    for gd in out.g:
        noise(gd.noise)
        dropout.draw_masks(generator, mask_specs, out=gd.masks)
    return out


class EpochSummary(NamedTuple):
    """One epoch's results (facegen/train/step.py:465-473), made on the
    device before the epoch's counters are reset, so that a chunk of
    epochs is read back once (``summaries_to_host``)."""

    loss_d: torch.Tensor         # the epoch's means
    loss_g: torch.Tensor
    acc_d: torch.Tensor
    total_valid: torch.Tensor    # fp64: the confusion matrix's share of right predictions
    trained_d: torch.Tensor
    not_trained_d: torch.Tensor
    confusion: torch.Tensor      # (2, 2) int32


def epoch_summary(state: GanState, ms: StepMetrics) -> EpochSummary:
    """The summary of the epoch whose steps' metrics are ``ms`` and whose
    counters ``state`` holds."""
    c = state.confusion.clone()
    total_valid = (c[0, 0] + c[1, 1]).double() / c.sum().clamp(min=1).double()
    return EpochSummary(ms.loss_d.mean(), ms.loss_g.mean(), ms.acc_d.mean(), total_valid,
                        state.trained_d.clone(), state.not_trained_d.clone(), c)


def summaries_to_host(summaries) -> list:
    """EpochSummary tuples of Python numbers (the confusion a numpy (2, 2)
    int32 array), read back in one copy: every field goes into one fp64
    row (counts are exact there)."""
    rows = torch.stack([torch.cat([torch.stack([x.double() for x in s[:6]]),
                                   s.confusion.reshape(4).double()]) for s in summaries])
    out = []
    for r in rows.cpu().numpy():
        out.append(EpochSummary(*(float(v) for v in r[:4]), int(r[4]), int(r[5]),
                                r[6:].astype(np.int32).reshape(2, 2)))
    return out


class TrainStep:
    """``step(state, pool, draws) -> StepMetrics``, updating ``state`` in
    place. ``pool`` is the epoch's (P, H, W, C) uint8 images on the
    networks' device."""

    def __init__(self, cfg: TrainConfig, g: nn.Module, d: nn.Module):
        self.cfg = cfg
        self.tx_d = make_optimizer(cfg.d_optmethod, cfg, "D")
        self.tx_g = make_optimizer(cfg.g_optmethod, cfg, "G")
        self.dtype = getattr(torch, cfg.compute_dtype)
        device = next(d.parameters()).device
        self.mask_specs = dropout.dropout_mask_specs(d, cfg.batch_size, cfg.img_shape, device)

    def d_iteration(self, state: GanState, pool: torch.Tensor, draws: DDraws):
        cfg, g, d = self.cfg, state.g, state.d
        half = cfg.batch_size // 2
        params = list(d.parameters())
        real = pool[draws.idx].to(self.dtype) / 255.0
        g.train()
        with torch.no_grad():  # BN statistics move (adversarial.lua:252); fakes detached
            fake = g(draws.noise.to(self.dtype))
        inputs = torch.cat([real, fake])
        ones = torch.ones(half, device=real.device)
        targets = torch.cat([ones, torch.zeros_like(ones)])
        d.train()
        dropout.set_dropout_masks(d, draws.masks)
        logits = d(inputs)
        loss = losses.bce_with_logits(logits, targets)
        grads = torch.autograd.grad(loss, params)
        # penalties on the pre-update parameters, then the clamp
        loss = loss.detach() + losses.penalty_loss(params, cfg.d_l1, cfg.d_l2)
        grads = losses.add_penalty_grads(grads, params, cfg.d_l1, cfg.d_l2)
        grads = losses.clamp_grads(grads, cfg.d_clamp)

        logits = logits.detach()
        acc = losses.batch_accuracy(logits, targets)
        # push into the ring, then average (adversarial.lua:154-167)
        k_ring = state.accs.shape[0]
        state.accs.scatter_(0, (state.accs_n % k_ring).long().reshape(1), acc.reshape(1))
        state.accs_n += 1
        acc_avg = state.accs.sum() / torch.clamp(state.accs_n, max=k_ring).float()
        do_train = acc_avg < cfg.d_max_acc
        gated_update(self.tx_d, grads, state.opt_d, params, do_train)
        state.confusion.copy_(metrics.update_confusion(state.confusion, logits, targets))
        state.trained_d += do_train.int()
        state.not_trained_d += (~do_train).int()
        return loss, acc, do_train

    def g_iteration(self, state: GanState, draws: GDraws):
        cfg, g, d = self.cfg, state.g, state.d
        params = list(g.parameters())
        g.train()
        d.train()
        dropout.set_dropout_masks(d, draws.masks)
        imgs = g(draws.noise.to(self.dtype))
        logits = d(imgs)  # D's parameters as the D phase left them
        loss = losses.bce_with_logits(logits, torch.ones(logits.shape[0], device=logits.device))
        grads = torch.autograd.grad(loss, params)
        loss = loss.detach() + losses.penalty_loss(params, cfg.g_l1, cfg.g_l2)
        # the reference's bug (adversarial.lua:223): G_L2 scales the sign term too
        sign_coef = cfg.g_l2 if cfg.reference_g_penalty_bug else cfg.g_l1
        grads = losses.add_penalty_grads(grads, params, sign_coef, cfg.g_l2)
        grads = losses.clamp_grads(grads, cfg.g_clamp)
        gated_update(self.tx_g, grads, state.opt_g, params, True)
        return loss

    def __call__(self, state: GanState, pool: torch.Tensor, draws: StepDraws) -> StepMetrics:
        zero = torch.zeros((), device=pool.device)
        loss_d, acc, gate = zero, zero, torch.zeros((), dtype=torch.bool, device=pool.device)
        for dd in draws.d:
            loss_d, acc, gate = self.d_iteration(state, pool, dd)
        loss_g = zero
        for gd in draws.g:
            loss_g = self.g_iteration(state, gd)
        return StepMetrics(loss_d, loss_g, acc, gate.float())

