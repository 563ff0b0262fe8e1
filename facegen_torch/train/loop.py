"""Epoch loop (counterpart of facegen/train/loop.py:52-492, single
device, one epoch at a time).

Per epoch (train.lua:199-208):
  1. draw a fresh pool on the device (TRAIN_DATA);
  2. write the progress grids unless --noplot;
  3. run the epoch's steps, whose metrics stay on the device until the
     epoch ends and are fetched once;
  4. print the time per sample, the gate counters and the confusion
     matrix (adversarial.lua:302-316), append a metrics.jsonl row, reset
     the counters;
  5. every saveFreq epochs, checkpoint with ``.old`` rotation
     (adversarial.lua:319-329); a bounded run also saves at its end.

With ``--denoise`` the grids include ``samples_denoised.png``: G's fixed
samples through the denoiser trained at the run's scale and channels
(models/ae.py:load_denoiser_fn; a missing checkpoint is an error).

``--network`` resumes parameters, statistics, optimizer state and the
epoch counter, as facegen does (the reference drops the optimizer
state, train.lua:122). Random streams: every epoch draws from
generators seeded by (seed, 10000 + epoch index), so a resumed run draws
fresh pools instead of replaying the first epochs.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional

import torch

from facegen_torch.config import TrainConfig
from facegen_torch.data.pipeline import make_source
from facegen_torch.models import ae, gan
from facegen_torch.nn.init import seeded_generator
from facegen_torch.train import metrics as M
from facegen_torch.train.step import (
    StepMetrics,
    TrainStep,
    draw_step,
    init_state,
    reset_epoch_stats,
    steps_per_epoch,
)
from facegen_torch.utils import checkpoint as ckpt
from facegen_torch.utils.infer import GanInference
from facegen_torch.utils.profiling import MetricsLogger
from facegen_torch.utils.viz import visualize_progress

CKPT_NAME = "adversarial"  # logs/adversarial.net in the reference


class Trainer:
    """Owns the models, the training state, the data source and the step."""

    def __init__(self, cfg: TrainConfig, device=None, verbose: bool = True):
        self.cfg = cfg.validate()
        if cfg.scale not in (16, 32):  # the AE and denoiser CLIs share the flag, not the limit
            raise ValueError(f"--scale {cfg.scale}: G16/G32 only (16 or 32)")
        self.device = torch.device(device if device is not None else f"cuda:{cfg.gpu}")
        self.verbose = verbose
        self.source = make_source(cfg, self.device)
        # weights drawn on the CPU: the same seed gives the same weights on every device
        g, d = gan.init_gan(torch.Generator().manual_seed(cfg.seed), cfg.scale, cfg.channels,
                            cfg.noise_dim, reference_init=cfg.reference_init,
                            noise_view=cfg.noise_view, device=self.device)
        self.state = init_state(cfg, g, d)
        self.step = TrainStep(cfg, g, d)
        self.inf = GanInference(g, d, cfg.noise_dim, getattr(torch, cfg.compute_dtype))
        self.pool_n = cfg.n_epoch if cfg.n_epoch > 0 else self.source.size
        # fixed noise for comparable per-epoch samples (train.lua:195)
        self.fixed_noise = self.inf.noise(seeded_generator("cpu", cfg.seed, 999), 100)
        self.metrics_log = MetricsLogger(cfg.save)
        self.denoiser = ae.load_denoiser_fn(cfg, self.device) if cfg.denoise else None
        if cfg.epochs_per_compile:
            self._log(f"<trainer> --epochsPerCompile {cfg.epochs_per_compile} ignored: the "
                      f"port runs eagerly, one epoch at a time")
        if cfg.network:
            self.resume(cfg.network)

    # -- checkpoints -------------------------------------------------------
    def save(self):
        meta = {**ckpt.config_meta(self.cfg), "epoch": self.state.epoch}
        path = ckpt.save_train_state(self.cfg.save, CKPT_NAME, self.state, meta)
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
        ckpt.load_train_state(directory, name, self.state)
        self._log(f"<trainer> reloaded previously trained network: {network} "
                  f"(epoch {self.state.epoch})")

    # -- training ------------------------------------------------------------
    def run_steps(self, pool: torch.Tensor, generator: torch.Generator,
                  n_steps: int) -> StepMetrics:
        """``n_steps`` steps on ``pool``; their metrics stacked on the device."""
        ms = [self.step(self.state, pool,
                        draw_step(generator, self.cfg, pool.shape[0], self.step.mask_specs))
              for _ in range(n_steps)]
        return StepMetrics(*(torch.stack(xs) for xs in zip(*ms)))

    def train_epoch(self, epoch_idx: int) -> dict:
        cfg, dev = self.cfg, self.device
        self._log("Loading new training data...")
        pool = self.source.epoch_pool(seeded_generator(dev, cfg.seed, 10_000 + epoch_idx, 0),
                                      self.pool_n)
        if not cfg.noplot:
            report = visualize_progress(
                self.inf, self.fixed_noise, pool, os.path.join(cfg.save, "viz"),
                seeded_generator(dev, cfg.seed, 10_000 + epoch_idx, 2),
                denoiser=self.denoiser, epoch=self.state.epoch, window=cfg.window)
            self._log(f"<viz> probe ranks/300: real={report['real_probe_rank']} "
                      f"synth={report['synth_probe_rank']}")

        n_steps = steps_per_epoch(cfg, self.pool_n)
        self._log(f"<trainer> Epoch #{self.state.epoch} [batchSize = {cfg.batch_size}]")
        t0 = time.perf_counter()
        ms = self.run_steps(pool, seeded_generator(dev, cfg.seed, 10_000 + epoch_idx, 1), n_steps)
        # the epoch's one read-back, which also waits for the device
        host = {k: v.cpu().numpy() for k, v in ms._asdict().items()}
        trained, not_trained = int(self.state.trained_d), int(self.state.not_trained_d)
        conf = self.state.confusion.cpu().numpy()
        dt = time.perf_counter() - t0

        n_examples = cfg.n_epoch if cfg.n_epoch > 0 else self.pool_n
        self._log(f"<trainer> time required for this epoch = {dt:.3f} s")
        self._log(f"<trainer> time to learn 1 sample = {1000 * dt / n_examples:.4f} ms")
        self._log(f"<trainer> trained D {trained} of {trained + not_trained} times.")
        self._log(M.format_confusion(conf))
        self.state.epoch += 1
        stats = {
            "epoch": self.state.epoch - 1,
            "seconds": dt,
            "images_per_sec": n_examples / dt,
            "loss_d_mean": float(host["loss_d"].mean()),
            "loss_g_mean": float(host["loss_g"].mean()),
            "acc_d_mean": float(host["acc_d"].mean()),
            "total_valid": M.total_valid(conf),
            "trained_d": trained,
            "not_trained_d": not_trained,
        }
        reset_epoch_stats(self.state)
        self.metrics_log.log(stats)
        if (self.state.epoch - 1) % cfg.save_freq == 0:
            self.save()
        return stats

    def run(self, epochs: Optional[int] = None) -> Iterator[dict]:
        """Train ``epochs`` epochs (default --epochs; -1 runs forever like
        the reference's ``while true``), yielding each epoch's stats. A
        bounded run saves once more at its end unless its last epoch
        just saved."""
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


def main(argv=None, device=None) -> Trainer:
    """The trainer CLI, ``python -m facegen_torch.train``: facegen's flags
    and defaults (batch 32, Adam, D_L2 1e-4, D clamp 1, G clamp 5, bf16
    activations over fp32 parameters, 1000 examples or 63 steps per
    epoch) on ``cuda:{--gpu}``; it exits with an error without a GPU.
    Flags of paths that are not ported exit with a message that says so:
    --meshShape other than one device, --weightsVisFreq > 0,
    --boundaryPad > 0. --epochsPerCompile is accepted and ignored.
    ``device`` lets the tests run it on the CPU; the command line has no
    such flag."""
    from facegen_torch.config import cli_device, train_config_from_args

    cfg = train_config_from_args(argv)
    if device is None:
        device = cli_device(cfg.gpu, "trainer")
    trainer = Trainer(cfg, device=device)
    print(f"Number of free parameters in D: {sum(p.numel() for p in trainer.state.d.parameters())}")
    print(f"Number of free parameters in G: {sum(p.numel() for p in trainer.state.g.parameters())}")
    for _ in trainer.run():
        pass
    return trainer
