"""The GAN train step as a CUDA graph (counterpart of facegen's jit of
``make_epoch_fn`` / ``make_segment_fn``, facegen/train/step.py:396-463).

facegen compiles an epoch into one device program. The port's step is
some 1,650 kernel launches issued from Python, so on the card the host's
launch rate, not the device, sets its pace. ``GraphedStep`` captures one
whole step (``d_iterations`` D iterations, then ``g_iterations`` G
iterations, as ``TrainStep`` runs them) into a CUDA graph once, and then
replays it: one launch a step, besides the step's draws.

A graph replays fixed device addresses, so everything a step reads or
writes lives in tensors that outlive the capture:

- the pool: each epoch's pool is copied into ``self.pool``;
- the draws: ``self.draws``, which ``draw_step(..., out=)`` fills before
  every step from the epoch's generator, in ``draw_step``'s order, so a
  graphed run draws exactly what an eager run draws. D's dropout layers
  are pointed at these masks during the capture (``set_dropout_masks``);
- the state: the parameters, optimizer moments and counts, batch-norm
  statistics, the gate's ring and counters and the confusion matrix of
  ``state``. Every write to them is in place (``gated_update`` and
  ``BatchNorm`` ``copy_``, the ring's ``scatter_`` and ``+=``,
  ``reset_epoch_stats`` ``zero_``, ``load_train_state`` ``copy_``), so no
  state tensor is rebound after the capture; code that rebinds one would
  leave the graph writing the old tensor;
- the step's metrics: the graph's (4,) output, which each step copies
  into its row of the caller's buffer on the device.

Warm-up: the first ``WARMUP_STEPS`` steps on a card run eagerly on a
side stream, as steps of the run with their own draws in order. They
load the kernels' libraries, allocate the dW kernel's stream-K counters
(which must not come from the graph's private pool) and let cuDNN and
cuBLAS choose and set up before anything is captured. The capture
executes nothing, so a run is the same sequence of steps as an eager
run. It happens at the first step after the warm-up: after any
``--network`` resume, which loads in place.

Launch counts: the kernels' wrappers count launches in Python, so a
replay would count nothing. What the capture counted is taken back and
recorded, and each replay adds it (``ops/upsample_conv.py``). The counts
under replay are thus derived from the capture, not observed; that the
replayed kernels ran is shown by the graph's parity with eager steps.

On the CPU (the tests) the same class runs ``TrainStep`` eagerly on the
same buffers: the one place where the two routes part. On a CUDA device
every step after the warm-up replays the graph; a failure to capture or
to replay raises, and nothing falls back to eager steps.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from facegen_torch.ops import upsample_conv as uc
from facegen_torch.train.step import (
    GanState,
    StepMetrics,
    TrainStep,
    draw_step,
    empty_draws,
)

_COUNTERS = ("KERNEL_LAUNCHES", "DX_LAUNCHES", "DW_LAUNCHES")
WARMUP_STEPS = 1  # eager steps on a card before the capture


class GraphedStep:
    """``run(generator, n_steps)``: ``n_steps`` steps of ``step`` on
    ``state`` and the pool last given to ``set_pool``, drawing from
    ``generator``; their metrics stacked on the device."""

    def __init__(self, step: TrainStep, state: GanState, pool_n: int,
                 log: Optional[Callable[[str], None]] = None):
        self.step, self.state, self.pool_n = step, state, pool_n
        self.device = state.accs.device
        self.log = log or (lambda msg: None)
        self.pool: Optional[torch.Tensor] = None
        self.draws = empty_draws(step.cfg, step.mask_specs, self.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.metrics: Optional[torch.Tensor] = None
        self.eager_steps = 0
        self.launches_per_replay: Optional[dict] = None
        self.capture_ms: Optional[float] = None
        self.pool_mib: Optional[float] = None  # device memory reserved by the capture
        self._side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def set_pool(self, pool: torch.Tensor) -> None:
        """Copy an epoch's pool into the static pool (allocated at the first
        call; every epoch's pool has the same shape)."""
        if self.pool is None:
            self.pool = torch.empty_like(pool)
        elif self.pool.shape != pool.shape or self.pool.dtype != pool.dtype:
            raise ValueError(f"pool {tuple(pool.shape)} {pool.dtype}, the graph's is "
                             f"{tuple(self.pool.shape)} {self.pool.dtype}")
        self.pool.copy_(pool)

    def run(self, generator: torch.Generator, n_steps: int) -> StepMetrics:
        if self.pool is None:
            raise RuntimeError("GraphedStep.run before set_pool")
        rows = torch.empty((n_steps, 4), device=self.device)
        for i in range(n_steps):
            self._step(generator, rows[i])
        return StepMetrics(*rows.unbind(1))

    def _draw(self, generator: torch.Generator) -> None:
        draw_step(generator, self.step.cfg, self.pool_n, self.step.mask_specs, out=self.draws)

    def _eager(self, generator: torch.Generator, row: torch.Tensor) -> None:
        self._draw(generator)
        row.copy_(torch.stack(self.step(self.state, self.pool, self.draws)))

    def _step(self, generator: torch.Generator, row: torch.Tensor) -> None:
        if self.device.type != "cuda":
            self._eager(generator, row)
            return
        if self.graph is None and self.eager_steps < WARMUP_STEPS:
            current = torch.cuda.current_stream(self.device)
            self._side.wait_stream(current)
            with torch.cuda.stream(self._side):
                self._eager(generator, row)
            current.wait_stream(self._side)
            self.eager_steps += 1
            return
        if self.graph is None:
            self._capture()
        self._draw(generator)
        self.graph.replay()
        for name, n in self.launches_per_replay.items():
            setattr(uc, name, getattr(uc, name) + n)
        row.copy_(self.metrics)

    def _capture(self) -> None:
        before = {name: getattr(uc, name) for name in _COUNTERS}
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            # read after the context's empty_cache(), before anything is captured
            reserved = torch.cuda.memory_reserved(self.device)
            metrics = torch.stack(self.step(self.state, self.pool, self.draws))
        torch.cuda.synchronize(self.device)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_mib = (torch.cuda.memory_reserved(self.device) - reserved) / 2**20
        self.launches_per_replay = {name: getattr(uc, name) - before[name] for name in _COUNTERS}
        for name, n in before.items():  # the capture launched nothing
            setattr(uc, name, n)
        self.graph, self.metrics = graph, metrics
        self.log(f"<trainer> captured the train step as a CUDA graph in {self.capture_ms:.1f} ms "
                 f"after {self.eager_steps} eager steps; kernel launches per replay "
                 f"{self.launches_per_replay}; {self.pool_mib:.1f} MiB reserved by the capture, "
                 f"max memory allocated {torch.cuda.max_memory_allocated(self.device) / 2**20:.1f} "
                 f"MiB")
