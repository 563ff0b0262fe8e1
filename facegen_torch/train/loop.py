"""Epoch loop (counterpart of facegen/train/loop.py:52-519).

Per epoch (train.lua:199-208):
  1. draw a fresh pool on the device (TRAIN_DATA);
  2. write the progress grids unless --noplot;
  3. run the epoch's steps through the captured step (train/graph.py),
     whose metrics stay on the device; with --weightsVisFreq N, dump
     activation grids every N steps and after the last;
  4. print the time per sample, the gate counters and the confusion
     matrix (adversarial.lua:302-316), append a metrics.jsonl row, reset
     the counters;
  5. every saveFreq epochs, checkpoint with ``.old`` rotation
     (adversarial.lua:319-329); a bounded run also saves at its end.

--epochsPerCompile N trains N epochs as one chunk (facegen's
``train_epochs_chunk``): the pools of the chunk are drawn first, the
grids written once on the first, and the chunk's results are read back
once; every epoch still gets its metrics.jsonl row, and the checkpoint
is saved once at the end of a chunk that crossed a saveFreq boundary.
0 means 8 under --noplot without --weightsVisFreq, else 1, as in facegen.
A chunk trains the same steps on the same draws as N single epochs.

Two config fields with no flag, as in facegen: ``trace_dir`` profiles
the steps of the second epoch (index 1) into a torch.profiler trace
(utils/profiling.py:trace; ``aggregate_trace`` makes its per-op table)
and holds --epochsPerCompile to 1; ``debug_nans`` turns on
``enable_nan_debugging`` and runs every step eagerly.

With ``--denoise`` the grids include ``samples_denoised.png``: G's fixed
samples through the denoiser trained at the run's scale and channels
(models/ae.py:load_denoiser_fn; a missing checkpoint is an error).

``--network`` resumes parameters, statistics, optimizer state and the
epoch counter, as facegen does (the reference drops the optimizer
state, train.lua:122). Random streams: every epoch draws from
generators seeded by (seed, 10000 + epoch index), so a resumed run draws
fresh pools instead of replaying the first epochs.

Data parallel (``mesh``, parallel/mesh.py; facegen/train/loop.py:52-97,
495-519): one process per device, each with the whole state. Every rank
builds the same weights from the seed and loads the same ``--network``,
and rank 0's state is broadcast after both. Every rank draws the same
epoch pool and keeps its rows; the steps' generator folds in the rank
when the group has more than one, so a 1-rank group draws what a single
device draws. Rank 0 alone logs and writes metrics.jsonl, the
checkpoints, the progress grids (from the whole pool, as facegen's read
the global pool) and the activation dumps.

On a 2-D mesh (parallel/gspmd.py, facegen's GSPMD mode: loop.py:80-87,
114-117, 197-200, 411-416) the trainer runs facegen's single-device
program on the global batch: every rank keeps the whole pool and draws
the global batch's draws from the unfolded generator, so any mesh trains
what one device trains; the masters of the large leaves and their
moments are sharded over the model axis. --epochsPerCompile > 1 runs
per epoch, as facegen's does there. A checkpoint's moments are gathered
from the shards by every rank and written by rank 0; each rank loads the
full checkpoint and keeps its shards.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, List, Optional

import torch

from facegen_torch.config import TrainConfig
from facegen_torch.data.pipeline import make_source
from facegen_torch.models import ae, gan
from facegen_torch.nn.init import seeded_generator
from facegen_torch.parallel.mesh import placement, replicate, shard_pool
from facegen_torch.train import metrics as M
from facegen_torch.train.graph import GraphedStep
from facegen_torch.train.step import (
    StepMetrics,
    TrainStep,
    epoch_summary,
    init_state,
    reset_epoch_stats,
    state_tensors,
    steps_per_epoch,
    summaries_to_host,
)
from facegen_torch.utils import checkpoint as ckpt
from facegen_torch.utils.infer import GanInference
from facegen_torch.utils.profiling import MetricsLogger, enable_nan_debugging, span
from facegen_torch.utils.viz import visualize_progress

CKPT_NAME = "adversarial"  # logs/adversarial.net in the reference


def resolve_epochs_per_compile(cfg: TrainConfig, log, two_d: bool = False) -> int:
    """Epochs per chunk (facegen/train/loop.py:102-118): --epochsPerCompile
    <= 0 is 8 under --noplot without --weightsVisFreq and without a
    trace_dir, else 1; the segmented epoch of --weightsVisFreq, the
    traced epoch and the 2-D mesh (``two_d``) take one epoch at a time."""
    epc = cfg.epochs_per_compile
    if epc <= 0:
        epc = 8 if (cfg.noplot and cfg.weights_vis_freq == 0 and not cfg.trace_dir) else 1
    if epc > 1 and cfg.weights_vis_freq > 0:
        log("<trainer> epochsPerCompile ignored: weightsVisFreq needs the segmented per-epoch "
            "path")
        epc = 1
    if epc > 1 and cfg.trace_dir:
        log("<trainer> epochsPerCompile ignored: --traceDir captures the per-epoch program")
        epc = 1
    if epc > 1 and two_d:
        log("<trainer> epochsPerCompile > 1 not supported on the 2-D GSPMD mesh; running "
            "per-epoch")
        epc = 1
    return epc


class Trainer:
    """Owns the models, the training state, the data source and the step;
    with ``mesh``, this rank's share of data-parallel training on the
    mesh's device: a 1-D ``DataMesh`` (local batches) or a 2-D ``Mesh2D``
    (the global batch)."""

    def __init__(self, cfg: TrainConfig, device=None, verbose: bool = True, mesh=None):
        self.cfg = cfg.validate()
        if cfg.scale not in (16, 32):  # the AE and denoiser CLIs share the flag, not the limit
            raise ValueError(f"--scale {cfg.scale}: G16/G32 only (16 or 32)")
        self.device, self.writes = placement(mesh, device, cfg.gpu)
        self.mesh = mesh
        self.verbose = verbose and self.writes
        self.source = make_source(cfg, self.device)
        # weights drawn on the CPU: the same seed gives the same weights on every device
        g, d = gan.init_gan(torch.Generator().manual_seed(cfg.seed), cfg.scale, cfg.channels,
                            cfg.noise_dim, reference_init=cfg.reference_init,
                            noise_view=cfg.noise_view, device=self.device)
        self.step = TrainStep(cfg, g, d, mesh)
        self.two_d = self.step.exact  # a 2-D mesh: the global batch
        if self.two_d and not cfg.network:  # rank 0's weights, before they are sharded
            replicate([*g.parameters(), *g.buffers(), *d.parameters(), *d.buffers()], mesh)
        self.state = init_state(cfg, g, d, mesh)
        self.inf = GanInference(g, d, cfg.noise_dim, getattr(torch, cfg.compute_dtype))
        self.pool_n = cfg.n_epoch if cfg.n_epoch > 0 else self.source.size
        if cfg.debug_nans:
            enable_nan_debugging(True)
        # the steps draw from this rank's rows of the pool (the whole pool
        # on a 2-D mesh); debug_nans's checks wait for the device, which no
        # CUDA-graph capture allows, so its steps run eagerly
        local_ranks = 1 if mesh is None or self.two_d else mesh.size
        self.graphed = GraphedStep(self.step, self.state, self.pool_n // local_ranks,
                                   log=self._log, capture=not cfg.debug_nans)
        self.epochs_per_compile = resolve_epochs_per_compile(cfg, self._log, self.two_d)
        self.readbacks = 0  # device-to-host reads of epoch results, one per chunk
        # fixed noise for comparable per-epoch samples (train.lua:195)
        self.fixed_noise = self.inf.noise(seeded_generator("cpu", cfg.seed, 999), 100)
        self.metrics_log = MetricsLogger(cfg.save) if self.writes else None
        self.denoiser = ae.load_denoiser_fn(cfg, self.device) if cfg.denoise else None
        if cfg.network:
            self.resume(cfg.network)
        elif mesh is not None and not self.two_d:
            replicate(state_tensors(self.state), mesh)

    # -- checkpoints -------------------------------------------------------
    def save(self):
        """Rank 0 writes; on a 2-D mesh every rank gathers the moments."""
        if not (self.writes or self.two_d):
            return
        meta = {**ckpt.config_meta(self.cfg), "epoch": self.state.epoch}
        path = ckpt.save_train_state(self.cfg.save, CKPT_NAME, self.state, meta,
                                     write=self.writes)
        self._log(f"<trainer> saved checkpoint to {path}")

    def resume(self, network: str):
        """``network``: a checkpoint name under --save or a path; a
        reference-style ``.net`` suffix is dropped."""
        directory, name = ckpt.split_network_arg(network, self.cfg.save)
        ck_view = ckpt.load_meta(directory, name).get("config", {}).get("noise_view")
        # the two noise views have the same parameter shapes, so a mismatch
        # would load cleanly and scramble G's fc -> plane wiring
        if ck_view is not None and ck_view != self.cfg.noise_view:
            raise ValueError(f"checkpoint {network!r} was trained with noise_view={ck_view!r} "
                             f"but this run uses noise_view={self.cfg.noise_view!r}")
        ckpt.load_train_state(directory, name, self.state)  # every rank loads the whole file
        if self.mesh is not None and not self.two_d:
            replicate(state_tensors(self.state), self.mesh)
        self._log(f"<trainer> reloaded previously trained network: {network} "
                  f"(epoch {self.state.epoch})")

    # -- training ------------------------------------------------------------
    def run_steps(self, pool: torch.Tensor, generator: torch.Generator,
                  n_steps: int) -> StepMetrics:
        """``n_steps`` steps on ``pool`` through the captured step; their
        metrics stacked on the device."""
        self.graphed.set_pool(pool)
        return self.graphed.run(generator, n_steps)

    def _epoch_generators(self, epoch_idx: int) -> List[torch.Generator]:
        """The epoch's (pool, steps, grids) generators, the same in a chunk
        and alone; on a 1-D mesh of several ranks the steps' folds in the
        rank (facegen/parallel/mesh.py:113-115), on a 2-D mesh it does not."""
        words = [(k,) for k in range(3)]
        if self.mesh is not None and not self.two_d and self.mesh.size > 1:
            words[1] = (1, self.mesh.rank)
        return [seeded_generator(self.device, self.cfg.seed, 10_000 + epoch_idx, *w)
                for w in words]

    def _rows(self, pool: torch.Tensor) -> torch.Tensor:
        """This rank's rows of an epoch pool: all of them on a 2-D mesh."""
        return pool if self.mesh is None or self.two_d else shard_pool(pool, self.mesh)

    def _epoch_steps(self, pool: torch.Tensor, generator: torch.Generator,
                     n_steps: int) -> StepMetrics:
        """One epoch's steps; with --weightsVisFreq N, N steps at a time,
        each segment followed by an activation dump (_segmented_epoch,
        facegen/train/loop.py:401-436). The segments draw on from the same
        generator, so they train what one run of n_steps trains."""
        freq = self.cfg.weights_vis_freq
        rows = self._rows(pool)
        if freq <= 0:
            return self.run_steps(rows, generator, n_steps)
        parts, done = [], 0
        while done < n_steps:
            seg = min(freq, n_steps - done)
            parts.append(self.run_steps(rows, generator, seg))
            done += seg
            if self.writes:
                self._netvis_dump(pool, done)
        return StepMetrics(*(torch.cat(xs) for xs in zip(*parts)))

    def _traced_epoch(self, pool: torch.Tensor, generator: torch.Generator,
                      n_steps: int) -> StepMetrics:
        """The second epoch (index 1: the first holds the warm-up and the
        capture, so this one is all replays) under ``trace(trace_dir)``,
        the steps alone (facegen/train/loop.py:224-236). It runs whole;
        with --weightsVisFreq it dumps once, after its last step, so that
        the dumps' record has the epoch."""
        from facegen_torch.utils.profiling import trace

        with trace(self.cfg.trace_dir):
            ms = self.run_steps(self._rows(pool), generator, n_steps)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._log(f"<trainer> traced epoch #{self.state.epoch} into {self.cfg.trace_dir}")
        if self.cfg.weights_vis_freq > 0 and self.writes:
            # named, as facegen names it, by the epoch count after the epoch
            self._netvis_dump(pool, n_steps, self.state.epoch + 1)
        return ms

    def _netvis_dump(self, pool: torch.Tensor, step_idx: int, epoch: Optional[int] = None):
        """Activation grids (visualizeNetwork, adversarial.lua:348-406) of D
        on the pool's first 4 images and of G on the first 4 fixed noise
        vectors, under ``<save>/viz/netvis/e{epoch:04d}_s{step:05d}/`` and
        its ``g/`` (facegen/train/loop.py:438-457)."""
        from facegen_torch.utils.netvis import visualize_network

        epoch = self.state.epoch if epoch is None else epoch
        out_dir = os.path.join(self.cfg.save, "viz", "netvis", f"e{epoch:04d}_s{step_idx:05d}")
        probe = pool[: min(4, pool.shape[0])].float() / 255.0
        visualize_network(self.state.d, probe, out_dir)
        noise = self.fixed_noise[: probe.shape[0]].to(self.device)
        visualize_network(self.state.g, noise, os.path.join(out_dir, "g"))

    def train_epoch(self, epoch_idx: int) -> dict:
        return self.train_epochs_chunk(epoch_idx, 1)[0]

    def train_epochs_chunk(self, start_idx: int, n: int) -> List[dict]:
        """Train epochs ``start_idx`` .. ``start_idx + n - 1`` (0-based
        indices of the random streams) with one read-back of their results;
        returns each epoch's stats."""
        cfg = self.cfg
        gens = [self._epoch_generators(start_idx + j) for j in range(n)]
        self._log("Loading new training data...")
        with span("loop.pools"):
            pools = [self.source.epoch_pool(g[0], self.pool_n) for g in gens]
        if not cfg.noplot and self.writes:
            report = visualize_progress(
                self.inf, self.fixed_noise, pools[0], os.path.join(cfg.save, "viz"), gens[0][2],
                denoiser=self.denoiser, epoch=self.state.epoch, window=cfg.window)
            self._log(f"<viz> probe ranks/300: real={report['real_probe_rank']} "
                      f"synth={report['synth_probe_rank']}")

        n_steps = steps_per_epoch(cfg, self.pool_n)
        epoch_before = self.state.epoch
        if n == 1:
            self._log(f"<trainer> Epoch #{epoch_before} [batchSize = {cfg.batch_size}]")
        else:
            self._log(f"<trainer> Epochs #{epoch_before}-#{epoch_before + n - 1} "
                      f"[batchSize = {cfg.batch_size}, epochsPerCompile = {n}]")
        t0 = time.perf_counter()
        summaries = []
        for j, (pool, g) in enumerate(zip(pools, gens)):
            if cfg.trace_dir and start_idx + j == 1:
                ms = self._traced_epoch(pool, g[1], n_steps)
            else:
                ms = self._epoch_steps(pool, g[1], n_steps)
            with span("loop.summary"):
                summaries.append(epoch_summary(self.state, ms))
                reset_epoch_stats(self.state)
            self.state.epoch += 1
        # the chunk's one read-back, which also waits for the device
        with span("loop.readback"):
            summaries = summaries_to_host(summaries)
        self.readbacks += 1
        dt = time.perf_counter() - t0
        del pools

        n_examples = cfg.n_epoch if cfg.n_epoch > 0 else self.pool_n
        self._log(f"<trainer> time required for {'this epoch' if n == 1 else f'{n} epochs'} "
                  f"= {dt:.3f} s")
        self._log(f"<trainer> time to learn 1 sample = {1000 * dt / (n * n_examples):.4f} ms")
        all_stats = []
        for j, s in enumerate(summaries):
            self._log(f"<trainer> {'' if n == 1 else f'epoch #{epoch_before + j}: '}trained D "
                      f"{s.trained_d} of {s.trained_d + s.not_trained_d} times.")
            self._log(M.format_confusion(s.confusion))
            stats = {
                "epoch": epoch_before + j,
                "seconds": dt / n,
                "images_per_sec": n * n_examples / dt,
                "loss_d_mean": s.loss_d,
                "loss_g_mean": s.loss_g,
                "acc_d_mean": s.acc_d,
                "total_valid": s.total_valid,
                "trained_d": s.trained_d,
                "not_trained_d": s.not_trained_d,
            }
            if self.writes:
                self.metrics_log.log(stats)
            all_stats.append(stats)
        # every saveFreq epochs (adversarial.lua:319); a chunk keeps only its
        # last state, so it saves once if it crossed a boundary
        if any((epoch_before + j) % cfg.save_freq == 0 for j in range(n)):
            with span("loop.save"):
                self.save()
        return all_stats

    def run(self, epochs: Optional[int] = None) -> Iterator[dict]:
        """Train ``epochs`` epochs (default --epochs; -1 runs forever like
        the reference's ``while true``), in chunks of --epochsPerCompile,
        yielding each epoch's stats. A bounded run saves once more at its
        end unless its last epoch just saved."""
        n = epochs if epochs is not None else (self.cfg.epochs if self.cfg.epochs > 0 else None)
        start = self.state.epoch - 1
        i = 0
        while n is None or i < n:
            chunk = self.epochs_per_compile if n is None else min(self.epochs_per_compile, n - i)
            yield from self.train_epochs_chunk(start + i, chunk)
            i += chunk
        if (self.state.epoch - 1) % self.cfg.save_freq != 0:
            self.save()

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)


def main(argv=None, device=None) -> Trainer:
    """The trainer CLI, ``python -m facegen_torch.train``: facegen's flags
    and defaults (batch 32, Adam, D_L2 1e-4, D clamp 1, G clamp 5, bf16
    activations over fp32 parameters, 1000 examples or 63 steps per
    epoch) on ``cuda:{--gpu}``, every step after the first few through a
    CUDA graph; it exits with an error without a GPU. Launched as N
    processes (parallel/multihost.py: FACEGEN_COORDINATOR,
    FACEGEN_NUM_PROCESSES, FACEGEN_PROCESS_ID) it trains over them, rank
    r on ``cuda:(r % device_count)``: --meshShape N (or -1) data parallel
    on local batches, 'DP,MP' (or 'DP,1') on the 2-D mesh with the
    single-device program's results, as facegen routes them
    (facegen/train/loop.py:507-519). --boundaryPad P widens the G -> D
    image interface inside the step (train/step.py:make_boundary_padder).
    ``device`` lets the tests run it on the CPU (gloo between ranks); the
    command line has no such flag."""
    from facegen_torch.config import cli_device, train_arg_parser, train_config_from_args
    from facegen_torch.parallel import maybe_initialize, training_mesh

    maybe_initialize(device_type="cuda" if device is None else torch.device(device).type)
    cfg = train_config_from_args(argv)
    try:  # --meshShape against the process group that is up, if any
        mesh = training_mesh(cfg.mesh_shape, device=device)
    except ValueError as e:
        train_arg_parser().error(str(e))
    if mesh is None and device is None:
        device = cli_device(cfg.gpu, "trainer")
    trainer = Trainer(cfg, device=device, mesh=mesh)
    if trainer.writes:
        print(f"Number of free parameters in D: "
              f"{sum(p.numel() for p in trainer.state.d.parameters())}")
        print(f"Number of free parameters in G: "
              f"{sum(p.numel() for p in trainer.state.g.parameters())}")
    for _ in trainer.run():
        pass
    return trainer
