"""The trainers' steps as CUDA graphs (counterpart of facegen's jit of
each trainer's epoch: the GAN's ``make_epoch_fn`` / ``make_segment_fn``,
facegen/train/step.py:396-463; the c2f epoch's ``lax.scan``,
facegen/train/c2f.py:205-214; the autoencoder's and the denoiser's
epochs, facegen/train/ae_loop.py:97-106, 280-289).

facegen compiles an epoch into one device program. The port's steps are
hundreds of kernel launches issued from Python (the GAN's some 720, the
c2f's some 490), so on the card the host's launch rate, not the device,
sets their pace. ``StepGraph`` is the one capture core of all four
trainers: it captures one whole step into a CUDA graph once and then
replays it, one launch a step besides the step's draws. A trainer plugs
in two things: its step, a callable of no arguments that runs one step on
the static buffers and returns its metrics as one tensor, and, for each
run of steps, a function that writes step i's draws into those buffers.
``GraphedStep`` is the GAN's (``TrainStep`` on ``draw_step``'s draws);
train/c2f.py and train/ae_loop.py build theirs on the same core.

A graph replays fixed device addresses, so everything a step reads or
writes lives in tensors that outlive the capture:

- the pool: each epoch's pool (a tensor, or a tuple of tensors such as
  the c2f's ``C2FPool``) is copied into ``pool`` by ``set_pool``, which
  refuses another shape or dtype; the autoencoder and the denoiser keep
  one pool for the whole run and read it in place;
- the draws: static buffers the trainer's draw function fills before
  every step, with the values an eager run draws, in its order. The
  step points the dropout layers (``set_dropout_masks``) and the
  denoiser's white noise (``set_white_noise``) at these buffers, so the
  capture records their addresses;
- the state: parameters, optimizer moments and counts, batch-norm
  statistics, the GAN gate's ring and counters and the confusion
  matrices. Every write to them is in place (the update's kernels and
  ``BatchNorm`` ``copy_``, ``+=``, ``zero_``, ``load_train_state``
  ``copy_``), so no state tensor is rebound after the capture; code that
  rebinds one would leave the graph writing the old tensor;
- the step's metrics: the graph's output, which each step copies into
  its row of the run's buffer on the device.

Warm-up: the first ``WARMUP_STEPS`` steps on a card run eagerly on a
side stream, as steps of the run with their own draws in order. They
load the kernels' libraries, allocate the dW kernel's stream-K counters
(which must not come from the graph's private pool) and the mesh steps'
flat all-reduce buffers, and let cuDNN and cuBLAS choose and set up
before anything is captured. The capture executes nothing, so a run is
the same sequence of steps as an eager run. It happens at the first step
after the warm-up: after any resume, which loads in place.

Launch counts: the kernels' wrappers count launches in Python, so a
replay would count nothing. What the capture counted is taken back and
recorded, and each replay adds it (``ops/upsample_conv.py``,
``ops/fused_update.py``: every trainer's update is two kernels a net
iteration, the first left out where it has nothing to do;
``ops/bn_prelu.py``: the GAN's 12, none in the other trainers). The counts
under replay are thus derived from the capture, not observed; that the
replayed kernels ran is shown by the graph's parity with eager steps.

On a mesh (a data mesh, parallel/mesh.py, or the 2-D mesh,
parallel/gspmd.py) the step's collectives are part of what is captured:
under NCCL each all-reduce, the shards' all-gathers over the model group
and the synchronised batch norms' all-reduces are issued on the capture
stream inside the graph and replay with it. ``warmup_collectives`` runs
when the object is built, so the communicators exist before the capture.
A gloo collective of a CUDA tensor waits on the host and cannot be
captured: under gloo every step runs eagerly.

The route is a pure function of the device type, the backend and
``capture`` (``step_route``); each trainer logs it as ``<trainer> step
route: ...``. On the CPU (the tests), under gloo and with
``capture=False`` (the GAN trainer's debug_nans, whose checks wait for
the device) the same object runs the steps eagerly on the same buffers;
otherwise, on a CUDA device alone or under NCCL, every step after the
warm-up replays the graph, and a failure to capture or to replay raises:
nothing falls back to eager steps.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

from facegen_torch.ops import bn_prelu as bp
from facegen_torch.ops import fused_update as fu
from facegen_torch.ops import upsample_conv as uc
from facegen_torch.parallel.gspmd import Mesh2D
from facegen_torch.parallel.multihost import warmup_collectives
from facegen_torch.train.step import (
    GanState,
    StepMetrics,
    TrainStep,
    draw_step,
    empty_draws,
)
from facegen_torch.utils.profiling import span

# the kernels' launch counters: (module, name)
_COUNTERS = ((uc, "KERNEL_LAUNCHES"), (uc, "DX_LAUNCHES"), (uc, "DW_LAUNCHES"),
             (fu, "PREP_LAUNCHES"), (fu, "UPDATE_LAUNCHES"), (bp, "BN_PRELU_LAUNCHES"))
WARMUP_STEPS = 1  # eager steps on a card before the capture
NO_CAPTURE = "capture=False asks for no capture"


def step_route(device_type: str, backend: Optional[str], capture: bool, mesh=None,
               eager_reason: str = NO_CAPTURE) -> Tuple[bool, str]:
    """(whether the steps replay a CUDA graph, the route's description) on a
    ``device_type`` device under ``backend`` (None: no mesh). ``mesh``
    (None, a data mesh or a Mesh2D) only names its size; ``eager_reason``
    says why ``capture=False`` runs eagerly."""
    captures = capture and device_type == "cuda" and backend in (None, "nccl")
    if isinstance(mesh, Mesh2D):
        size, collectives = f"the {mesh.dp}x{mesh.mp} mesh", "all-reduces and all-gathers"
    elif mesh is not None:
        size, collectives = f"{mesh.size} ranks", "all-reduces"
    if captures:
        return True, "one CUDA graph replay a step" + (
            "" if mesh is None else f", NCCL's {collectives} over {size} inside it")
    if device_type == "cuda" and not capture:
        return False, f"eager steps: {eager_reason}"
    if device_type == "cuda":
        return False, (f"eager steps: a gloo all-reduce of a CUDA tensor waits on the host "
                       f"and cannot be captured ({mesh.size} ranks)")
    return False, "eager steps on the CPU" + (
        "" if mesh is None else f", {backend} over {mesh.size} ranks")


def static_like(tree):
    """Uninitialised tensors of ``tree``'s structure, shapes and dtypes."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree)
    if isinstance(tree, dict):
        return {k: static_like(v) for k, v in tree.items()}
    parts = [static_like(v) for v in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


def copy_into(dst, src) -> None:
    """Every tensor of ``dst`` <- its counterpart in ``src`` (``static_like``'s
    structure; dicts matched by key), in place; a shape or dtype that
    differs raises."""
    if isinstance(dst, torch.Tensor):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"{tuple(src.shape)} {src.dtype} into the static "
                             f"{tuple(dst.shape)} {dst.dtype}")
        dst.copy_(src)
    elif isinstance(dst, dict):
        if set(dst) != set(src):
            raise KeyError(f"{sorted(src)} into the static {sorted(dst)}")
        for k, v in dst.items():
            copy_into(v, src[k])
    else:
        for d, s in zip(dst, src, strict=True):
            copy_into(d, s)


class StepGraph:
    """``run_steps(draw, n_steps)``: ``n_steps`` steps of ``step``, each after
    ``draw(i)`` wrote step i's draws into the static buffers ``step`` reads;
    ``step`` returns the step's metrics as one tensor of ``shape``, and the
    run returns them stacked on the device, (n_steps, *shape)."""

    def __init__(self, step: Callable[[], torch.Tensor], shape: Sequence[int], device, mesh=None,
                 log: Optional[Callable[[str], None]] = None, capture: bool = True,
                 eager_reason: str = NO_CAPTURE, name: str = "train step"):
        self.body, self.shape, self.name = step, tuple(shape), name
        self.eager_reason = eager_reason
        self.device = torch.device(device)
        self.log = log or (lambda msg: None)
        self.pool = None
        backend = None if mesh is None else mesh.backend
        self.captures, self.route = step_route(self.device.type, backend, capture, mesh,
                                               eager_reason)
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

    def set_pool(self, pool) -> None:
        """Copy an epoch's pool (a tensor or a tuple of them) into the static
        pool, allocated at the first call; every epoch's pool must have its
        shapes and dtypes."""
        if self.pool is None:
            self.pool = static_like(pool)
        copy_into(self.pool, pool)

    def run_steps(self, draw: Callable[[int], None], n_steps: int) -> torch.Tensor:
        rows = torch.empty((n_steps,) + self.shape, device=self.device)

        def draw_spanned(i: int) -> None:
            with span("step.draw"):
                draw(i)

        for i in range(n_steps):
            self._step(lambda: draw_spanned(i), rows[i])
        return rows

    def _eager(self, draw: Callable[[], None], row: torch.Tensor) -> None:
        with span("step.eager"):
            draw()
            row.copy_(self.body())

    def _step(self, draw: Callable[[], None], row: torch.Tensor) -> None:
        if not self.captures:
            self._eager(draw, row)
            return
        if self.graph is None and self.eager_steps < WARMUP_STEPS:
            current = torch.cuda.current_stream(self.device)
            self._side.wait_stream(current)
            with torch.cuda.stream(self._side):
                self._eager(draw, row)
            current.wait_stream(self._side)
            self.eager_steps += 1
            return
        if self.graph is None:
            self._capture()
        draw()
        with span("step.replay"):
            self.graph.replay()
        for module, name in _COUNTERS:
            setattr(module, name, getattr(module, name) + self.launches_per_replay[name])
        row.copy_(self.metrics)

    def _capture(self) -> None:
        before = {name: getattr(module, name) for module, name in _COUNTERS}
        graph = torch.cuda.CUDAGraph()
        # A trainer that became garbage holds its graph in a reference cycle
        # (the trainer, its StepGraph, the bound log method). A collection
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
                metrics = self.body()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_mib = (torch.cuda.memory_reserved(self.device) - reserved) / 2**20
        self.launches_per_replay = {name: getattr(module, name) - before[name]
                                    for module, name in _COUNTERS}
        for module, name in _COUNTERS:  # the capture launched nothing
            setattr(module, name, before[name])
        self.graph, self.metrics = graph, metrics
        self.log(f"<trainer> captured the {self.name} as a CUDA graph in {self.capture_ms:.1f} "
                 f"ms after {self.eager_steps} eager steps; kernel launches per replay "
                 f"{self.launches_per_replay}; {self.pool_mib:.1f} MiB reserved by the capture, "
                 f"max memory allocated {torch.cuda.max_memory_allocated(self.device) / 2**20:.1f} "
                 f"MiB")


class GraphedStep(StepGraph):
    """The GAN's: ``run(generator, n_steps)``, ``n_steps`` steps of ``step``
    on ``state`` and the pool last given to ``set_pool``, drawing
    ``draw_step``'s draws from ``generator`` into ``draws``; their metrics
    stacked on the device. On a 2-D mesh the draws are the global batch's
    (``TrainStep.draw_batch``) and ``pool_n`` is the whole pool's size."""

    def __init__(self, step: TrainStep, state: GanState, pool_n: int,
                 log: Optional[Callable[[str], None]] = None, capture: bool = True):
        self.step, self.state, self.pool_n = step, state, pool_n
        device = state.accs.device
        self.draws = empty_draws(step.cfg, step.mask_specs, device, step.draw_batch)
        super().__init__(lambda: torch.stack(self.step(self.state, self.pool, self.draws)), (4,),
                         device, step.mesh, log, capture,
                         eager_reason="debug_nans checks wait for the device, which no capture "
                                      "allows")

    def run(self, generator: torch.Generator, n_steps: int) -> StepMetrics:
        if self.pool is None:
            raise RuntimeError("GraphedStep.run before set_pool")
        cfg, specs = self.step.cfg, self.step.mask_specs
        rows = self.run_steps(
            lambda i: draw_step(generator, cfg, self.pool_n, specs, out=self.draws), n_steps)
        return StepMetrics(*rows.unbind(1))
