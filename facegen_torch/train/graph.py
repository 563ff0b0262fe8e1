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

On a data mesh (``TrainStep(..., mesh=)``, parallel/mesh.py) the step's
all-reduces are part of what is captured: under NCCL each is issued on
the capture stream inside the graph and replays with it. Its flat
buffer is allocated in the eager warm-up, and ``warmup_collectives``
runs when the object is built, so the communicator exists before the
capture. A gloo all-reduce of a CUDA tensor waits on the host and
cannot be captured: under gloo every step runs eagerly. On a 2-D mesh
(parallel/gspmd.py) the same holds for the step's all-gathers of the
shards over the model group and for its batch norms' all-reduces; the
draws are the global batch's (``TrainStep.draw_batch``) and ``pool_n``
is the whole pool's size.

The route is chosen from the device and the backend when the object is
built (``route``, which the trainer logs): on the CPU (the tests), under
gloo and with ``capture=False`` (the trainer's debug_nans, whose checks
wait for the device) the same class runs ``TrainStep`` eagerly on the
same buffers; otherwise, on a CUDA device alone or under NCCL, every
step after the warm-up replays the graph, and a failure to capture or
to replay raises: nothing falls back to eager steps.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Optional

import torch

from facegen_torch.ops import upsample_conv as uc
from facegen_torch.parallel.multihost import warmup_collectives
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
                 log: Optional[Callable[[str], None]] = None, capture: bool = True):
        self.step, self.state, self.pool_n = step, state, pool_n
        self.device = state.accs.device
        self.log = log or (lambda msg: None)
        self.pool: Optional[torch.Tensor] = None
        self.draws = empty_draws(step.cfg, step.mask_specs, self.device, step.draw_batch)
        mesh = step.mesh
        self.captures = capture and self.device.type == "cuda" and (
            mesh is None or mesh.backend == "nccl")
        if self.captures and step.exact:
            self.route = (f"one CUDA graph replay a step, NCCL's all-reduces and all-gathers "
                          f"over the {mesh.dp}x{mesh.mp} mesh inside it")
        elif self.captures:
            self.route = "one CUDA graph replay a step" + (
                "" if mesh is None else f", NCCL's all-reduces over {mesh.size} ranks inside it")
        elif self.device.type == "cuda" and not capture:
            self.route = "eager steps: debug_nans checks wait for the device, which no capture allows"
        elif self.device.type == "cuda":
            self.route = (f"eager steps: a gloo all-reduce of a CUDA tensor waits on the host "
                          f"and cannot be captured ({mesh.size} ranks)")
        else:
            self.route = "eager steps on the CPU" + (
                "" if mesh is None else f", gloo over {mesh.size} ranks")
        self.log(f"<trainer> step route: {self.route}")
        if mesh is not None:
            warmup_collectives(mesh)
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
        if not self.captures:
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
        # A trainer that became garbage holds its graph in a reference cycle
        # (the trainer, its GraphedStep, the bound log method). A collection
        # during the capture would destroy that graph there, which CUDA
        # forbids and which spoils the capture, and torch's capture no longer
        # collects first: collect here, and hold collections off until the
        # capture ends.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                # read after the context's empty_cache(), before anything is captured
                reserved = torch.cuda.memory_reserved(self.device)
                metrics = torch.stack(self.step(self.state, self.pool, self.draws))
        finally:
            if collecting:
                gc.enable()
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
