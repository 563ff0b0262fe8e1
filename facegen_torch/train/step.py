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

On a data mesh (parallel/mesh.py) each rank runs the step on its local
batch (the global batch over the ranks; its draws at that size, from its
own rows of the pool) and reduces at facegen's points
(facegen/train/step.py:296-310, 358-361): after the D iteration's
backward, both nets' running batch-norm statistics, D's gradients, the
BCE loss and the batch accuracy are averaged and the batch's confusion
counts summed, before the penalty, the clamp and the gate; after the G
iteration's backward, both nets' statistics, G's gradients and the loss
are averaged. Each iteration packs its values into one flat fp32 buffer
and issues one SUM all-reduce (gloo has no average; one collective
beats one per tensor), then divides the averaged part by the number of
ranks. Every rank then holds the same values and takes the same branch
of the gate, so the replicas stay bit-equal.

On a 2-D mesh (parallel/gspmd.py:Mesh2D) the step is facegen's
single-device step on the global batch (facegen/parallel/gspmd.py:
make_gspmd_step): the draws are the global batch's, drawn alike on every
rank (``draw_batch``), and data row i computes its block of them
(``Mesh2D.rows``, ``pair_rows``: ceil(B / dp) rows, the last blocks short
or empty, as GSPMD pads); G's batch norms take the global batch's
statistics; a rank's losses and accuracy are the sums over its rows over
the global batch (``global_rows``; zeros on an empty row), and one SUM
all-reduce over the data group per iteration makes the gradients, the
loss, the accuracy and the confusion counts the global batch's. The
penalty and the clamp follow, once, as on one device, and the update runs
on this rank's shards of the state (``GanState.shards``), which are then
gathered into the nets' weights.

Each iteration ends in ``optim.penalised_update``: the penalty on the
pre-update parameters, its gradient, the clamp, the finite check, the
gate and the update, two kernels over all of the net's leaves on the card
(ops/fused_update.py).

facegen's options with no flag: ``guard_nonfinite`` closes D's gate, and
skips G's update, when any gradient of the iteration is not finite
(counted by the update's first kernel, on the device); ``g_train_in_d_phase = False``
makes D's fakes with G in eval mode, so the D phase moves none of G's
batch-norm statistics. ``--boundaryPad P`` widens the G -> D image
interface to P channels inside the step (``make_boundary_padder``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facegen_torch.config import TrainConfig
from facegen_torch.nn import dropout
from facegen_torch.nn.layers import set_batch_norm_mesh
from facegen_torch.ops.fused_update import _state_tensors
from facegen_torch.parallel.gspmd import Mesh2D, flat_all_reduce, global_rows, shard_params
from facegen_torch.train import losses, metrics
from facegen_torch.train.optim import make_optimizer, penalised_update


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
    # on a 2-D mesh: "g" and "d" -> the masters of their parameters
    # (parallel/gspmd.py:ShardedParams), from which opt_g and opt_d are made
    shards: Optional[dict] = None


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


def init_state(cfg: TrainConfig, g: nn.Module, d: nn.Module, mesh=None) -> GanState:
    """The state of fresh training of ``g`` and ``d``; on a 2-D ``mesh``
    with the masters of their parameters and optimizer moments sharded
    (parallel/gspmd.py:shard_params)."""
    device = next(g.parameters()).device
    zero = torch.zeros((), dtype=torch.int32, device=device)
    shards = shard_params({"g": g, "d": d}, mesh) if isinstance(mesh, Mesh2D) else None
    masters = {k: (shards[k].masters if shards else list(m.parameters()))
               for k, m in (("g", g), ("d", d))}
    return GanState(
        g=g, d=d,
        opt_g=make_optimizer(cfg.g_optmethod, cfg, "G").init(masters["g"]),
        opt_d=make_optimizer(cfg.d_optmethod, cfg, "D").init(masters["d"]),
        accs=torch.zeros((cfg.accs_interval,), dtype=torch.float32, device=device),
        accs_n=zero.clone(), confusion=metrics.empty_confusion(device),
        trained_d=zero.clone(), not_trained_d=zero.clone(), epoch=1, shards=shards,
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
                device, batch: Optional[int] = None) -> StepDraws:
    """Uninitialised buffers of one step's draws, for ``draw_step(out=)``,
    at ``batch`` (``TrainStep.batch``; default the config's batch)."""
    batch = cfg.batch_size if batch is None else batch
    half = batch // 2

    def masks():
        return dropout.empty_masks(mask_specs, device)

    def noise(n):
        return torch.empty(n, cfg.noise_dim, device=device)

    return StepDraws(
        tuple(DDraws(torch.empty(half, dtype=torch.int64, device=device), noise(half), masks())
              for _ in range(cfg.d_iterations)),
        tuple(GDraws(noise(batch), masks()) for _ in range(cfg.g_iterations)))


def draw_step(generator: torch.Generator, cfg: TrainConfig, pool_n: int,
              mask_specs: Dict[str, Tuple[Tuple[int, ...], float]],
              out: Optional[StepDraws] = None) -> StepDraws:
    """One step's draws from ``generator``, on its device. ``mask_specs``
    maps each of D's dropout layers to its mask shape at the step's batch
    and its rate (``TrainStep.mask_specs``). Without ``out`` they are made
    at the config's batch; with ``out`` (``empty_draws``, e.g. a CUDA
    graph's static buffers or a rank's local batch) they are written into
    its tensors: the same values, drawn in the same order."""
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


def _boundary_convs(module: nn.Module, dim: int, channels: int) -> List[str]:
    """Names of ``module``'s convs whose 4-D weight has ``channels``
    entries on ``dim`` (0 = output channels, 1 = input channels), in
    module order: facegen's ``_pad_conv_layers`` (facegen/train/step.py:
    117-158) on the port's OIHW layout."""
    weights = ((name, getattr(m, "weight", None)) for name, m in module.named_modules())
    return [name for name, w in weights
            if isinstance(w, torch.Tensor) and w.dim() == 4 and w.shape[dim] == channels]


class BoundaryPadder:
    """facegen's boundary widening (``make_boundary_padder``,
    facegen/train/step.py:161-206): G's output conv gains ``pad`` zero
    output channels (its bias too), so its pad lanes come out as
    sigmoid(0) = 0.5 (or exactly 0 for the c2f's diff); real images gain
    ``pad`` zero channels; D's first conv gains ``pad`` zero input
    channels. Every logit, loss, gradient and statistic is the unpadded
    one's: zero weights times anything add nothing.

    The padded weights are views made inside the step from the live
    parameters (``F.pad``) and fed to the nets through
    ``torch.func.functional_call``, never cached: autograd slices the
    pad's gradient away, and the stored parameters, the optimizer's
    moments, the penalties and the checkpoints stay unpadded. With
    ``pad`` 0 it is the identity."""

    def __init__(self, pad: int = 0, g_convs: Sequence[str] = (), d_convs: Sequence[str] = ()):
        self.pad, self.g_convs, self.d_convs = pad, tuple(g_convs), tuple(d_convs)

    @property
    def active(self) -> bool:
        return self.pad > 0

    def _weights(self, module: nn.Module, names: Sequence[str], dim: int) -> dict:
        out = {}
        for name in names:
            m = module.get_submodule(name)
            if dim == 0:
                out[f"{name}.weight"] = F.pad(m.weight, (0, 0, 0, 0, 0, 0, 0, self.pad))
                out[f"{name}.bias"] = F.pad(m.bias, (0, self.pad))
            else:
                out[f"{name}.weight"] = F.pad(m.weight, (0, 0, 0, 0, 0, self.pad))
        return out

    def g(self, g: nn.Module, x):
        """G's forward, with its output conv padded."""
        if not self.active:
            return g(x)
        return torch.func.functional_call(g, self._weights(g, self.g_convs, 0), (x,))

    def d(self, d: nn.Module, x):
        """D's forward, with its image convs' input channels padded."""
        if not self.active:
            return d(x)
        return torch.func.functional_call(d, self._weights(d, self.d_convs, 1), (x,))

    def images(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images with ``pad`` zero channels appended."""
        return F.pad(x, (0, self.pad)) if self.active else x


def make_boundary_padder(cfg, g: nn.Module, d: nn.Module) -> BoundaryPadder:
    """The padder of ``cfg.boundary_pad`` = P for the nets ``g`` and ``d``
    (a TrainConfig, or a C2FConfig, whose images are its fine size). It
    pads P - C
    channels when P > C and both nets expose a pure conv image boundary,
    as facegen's ``_boundary`` decides (facegen/train/step.py:250-267):
    exactly one G conv with C output channels, at least one D conv with
    C input channels, and no D dense layer that takes the flattened raw
    image (D16_d's dense branch). Otherwise it is the identity: the flat
    G, D16_d and P <= C train as P = 0 does."""
    channels, scale = cfg.channels, cfg.img_shape[0]
    pad = cfg.boundary_pad - channels
    if cfg.boundary_pad <= 0 or pad <= 0:
        return BoundaryPadder()
    g_convs, d_convs = _boundary_convs(g, 0, channels), _boundary_convs(d, 1, channels)
    flat = scale * scale * channels
    flattens = any(p.dim() == 2 and p.shape[1] == flat for p in d.parameters())
    if len(g_convs) != 1 or not d_convs or flattens:
        return BoundaryPadder()
    return BoundaryPadder(pad, g_convs, d_convs)


class TrainStep:
    """``step(state, pool, draws) -> StepMetrics``, updating ``state`` in
    place. ``pool`` is the epoch's (P, H, W, C) uint8 images on the
    networks' device: this rank's rows on a 1-D ``mesh``, the whole pool
    on a 2-D one."""

    def __init__(self, cfg: TrainConfig, g: nn.Module, d: nn.Module, mesh=None):
        self.exact = isinstance(mesh, Mesh2D)  # the global batch, else local batches
        if not self.exact and mesh is not None and cfg.batch_size % (2 * mesh.size):
            # facegen's shard_map path asserts the same (facegen/train/step.py:235-237)
            raise ValueError(f"batch {cfg.batch_size} does not split into half real and half "
                             f"fake images on each of {mesh.size} ranks")
        self.cfg, self.mesh = cfg, mesh
        n = mesh.size if mesh is not None and not self.exact else 1
        self.draw_batch = cfg.batch_size // n  # the draws' batch: the global one on a 2-D mesh
        # the rows of a G batch this rank computes (its D batch: its rows of each half)
        self.batch = mesh.row_count(cfg.batch_size) if self.exact else self.draw_batch
        # D's halves together and G's batch both have cfg.batch_size rows
        self.global_rows = global_rows(mesh, cfg.batch_size)
        self.tx_d = make_optimizer(cfg.d_optmethod, cfg, "D")
        self.tx_g = make_optimizer(cfg.g_optmethod, cfg, "G")
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.pad = make_boundary_padder(cfg, g, d)
        device = next(d.parameters()).device
        self.mask_specs = dropout.dropout_mask_specs(d, self.draw_batch, cfg.img_shape, device)
        if self.exact:
            set_batch_norm_mesh(g, mesh)
            set_batch_norm_mesh(d, mesh)
        self._flat: Dict[str, torch.Tensor] = {}  # the iterations' reduction buffers

    def _reduce(self, key: str, state: GanState, means: List[torch.Tensor],
                sums: Tuple[torch.Tensor, ...] = (), params=()) -> List[torch.Tensor]:
        """Average both nets' batch-norm statistics (in place) and ``means``
        over the mesh, and sum ``sums``, in one SUM all-reduce of the
        iteration's flat fp32 buffer. Returns the reduced ``means`` and
        ``sums``, fp32 views of the buffer, the first ``len(params)`` of
        ``means`` (the gradients) in their parameters' layouts. On a 2-D
        mesh the statistics are already the global batch's and ``means``
        come as this rank's shares of the global means: all is summed over
        the data group."""
        stats = [] if self.exact else [b for net in (state.g, state.d) for b in net.buffers()]
        out = flat_all_reduce(self.mesh, self._flat, key, stats + means + list(sums),
                              like=[None] * len(stats) + list(params))
        if not self.exact:
            flat = self._flat[key]
            flat[:sum(t.numel() for t in stats + means)].div_(self.mesh.size)  # pmean
            for b, r in zip(stats, out):
                b.copy_(r)
        return out[len(stats):]

    def d_iteration(self, state: GanState, pool: torch.Tensor, draws: DDraws):
        cfg, g, d, pad = self.cfg, state.g, state.d, self.pad
        params = list(d.parameters())
        idx, noise, masks = draws.idx, draws.noise, draws.masks
        if self.exact:  # this data row's rows of the global batch
            rows, pair = self.mesh.rows, self.mesh.pair_rows
            idx, noise, masks = rows(idx), rows(noise), {k: pair(m) for k, m in masks.items()}
        half = idx.shape[0]
        real = pad.images(pool[idx].to(self.dtype) / 255.0)
        # G moves its batch-norm statistics (adversarial.lua:252) unless
        # g_train_in_d_phase is off; the fakes are detached
        g.train(cfg.g_train_in_d_phase)
        with torch.no_grad():
            fake = pad.g(g, noise.to(self.dtype))
        inputs = torch.cat([real, fake])
        ones = torch.ones(half, device=real.device)
        targets = torch.cat([ones, torch.zeros_like(ones)])
        d.train()
        dropout.set_dropout_masks(d, masks)
        logits = pad.d(d, inputs)
        loss = losses.bce_with_logits(logits, targets, self.global_rows)
        grads = torch.autograd.grad(loss, params)
        loss, logits = loss.detach(), logits.detach()
        acc = losses.batch_accuracy(logits, targets, self.global_rows)
        counts = metrics.update_confusion(metrics.empty_confusion(logits.device), logits, targets)
        if self.mesh is not None:  # facegen/train/step.py:296-310
            *grads, loss, acc, counts = self._reduce("d", state, [*grads, loss, acc], (counts,),
                                                     params)
            acc, counts = acc.clone(), counts.to(torch.int32)

        # push into the ring, then average (adversarial.lua:154-167)
        k_ring = state.accs.shape[0]
        state.accs.scatter_(0, (state.accs_n % k_ring).long().reshape(1), acc.reshape(1))
        state.accs_n += 1
        acc_avg = state.accs.sum() / torch.clamp(state.accs_n, max=k_ring).float()
        # the penalty on the pre-update parameters, its gradient, the clamp,
        # and the gate, closed too by a gradient that is not finite under
        # guard_nonfinite (facegen/train/step.py:301-323)
        penalty, do_train = penalised_update(
            self.tx_d, grads, state.opt_d, params, cfg.d_l1, cfg.d_l1, cfg.d_l2, cfg.d_clamp,
            acc_avg < cfg.d_max_acc, cfg.guard_nonfinite,
            shards=None if state.shards is None else state.shards["d"])
        loss = loss + penalty
        state.confusion += counts
        state.trained_d += do_train.int()
        state.not_trained_d += (~do_train).int()
        return loss, acc, do_train

    def g_iteration(self, state: GanState, draws: GDraws):
        cfg, g, d, pad = self.cfg, state.g, state.d, self.pad
        params = list(g.parameters())
        noise, masks = draws.noise, draws.masks
        if self.exact:
            noise, masks = self.mesh.rows(noise), {k: self.mesh.rows(m) for k, m in masks.items()}
        g.train()
        d.train()
        dropout.set_dropout_masks(d, masks)
        imgs = pad.g(g, noise.to(self.dtype))
        logits = pad.d(d, imgs)  # D's parameters as the D phase left them
        loss = losses.bce_with_logits(logits, torch.ones(logits.shape[0], device=logits.device),
                                      self.global_rows)
        grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        if self.mesh is not None:  # facegen/train/step.py:358-361
            *grads, loss = self._reduce("g", state, [*grads, loss], params=params)
        # the reference's bug (adversarial.lua:223): G_L2 scales the sign term
        # too; no gate but the finite check (facegen/train/step.py:362-372)
        sign_coef = cfg.g_l2 if cfg.reference_g_penalty_bug else cfg.g_l1
        penalty, _ = penalised_update(
            self.tx_g, grads, state.opt_g, params, sign_coef, cfg.g_l1, cfg.g_l2, cfg.g_clamp,
            True, cfg.guard_nonfinite, shards=None if state.shards is None else state.shards["g"])
        return loss + penalty

    def __call__(self, state: GanState, pool: torch.Tensor, draws: StepDraws) -> StepMetrics:
        zero = torch.zeros((), device=pool.device)
        loss_d, acc, gate = zero, zero, torch.zeros((), dtype=torch.bool, device=pool.device)
        for dd in draws.d:
            loss_d, acc, gate = self.d_iteration(state, pool, dd)
        loss_g = zero
        for gd in draws.g:
            loss_g = self.g_iteration(state, gd)
        return StepMetrics(loss_d, loss_g, acc, gate.float())


def state_tensors(state: GanState) -> List[torch.Tensor]:
    """Every tensor of ``state``: both nets' parameters and statistics,
    the optimizer states, the ring, the confusion matrix and the counters
    (on a 2-D mesh the optimizer states are this rank's shards)."""
    return [*state.g.parameters(), *state.g.buffers(), *state.d.parameters(),
            *state.d.buffers(), *_state_tensors(state.opt_g), *_state_tensors(state.opt_d),
            state.accs, state.accs_n, state.confusion, state.trained_d, state.not_trained_d]
