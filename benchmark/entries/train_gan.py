"""GAN training: facegen_torch's ``Trainer`` on the store, chunk after chunk.

Set-up: the store and the weights from the seed (the benchmark's
inputs), the trainer at the configuration's flags with the store as its
data source and the weights loaded, then its first three steps through
``Trainer.run_steps`` (the call every epoch of a chunk makes: one eager
warm-up step, the capture, replays) on epoch 0's pool, and one warm
epoch through ``train_epochs_chunk``. The window: ``train_epochs_chunk``
of ``epochs_per_compile`` epochs (8 under --noplot), as ``Trainer.run``
drives it, until the seconds have passed; each chunk ends in its one
read-back. The trainer's checkpoint writes are counted, not made.

``correct``: the first three steps against the reference's, which
starts from the same weights, works out epoch 0's pool again from the
store and draws the steps' draws from the same seeded stream
(``reference.expected``): each step's losses, each leaf's first gradient
(from Adam's first moment after step 1) and each leaf's change after
step 3; and the pool itself.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from benchmark.lib import flops, harness, stats
from benchmark.lib import training as T
from benchmark.lib import window as W
from benchmark.reference import common as C


def run(cell: harness.Cell) -> harness.Outcome:
    from facegen_torch.config import TrainConfig
    from facegen_torch.data.pipeline import DataSource
    from facegen_torch.train.loop import Trainer

    ref, store, g_leaves, d_leaves, g0, d0 = harness.inputs(cell, "train")
    dev = torch.device(cell.device)
    flags, seed = cell.config["flags"], cell.seed
    log = open(os.path.join(cell.workdir, "program.log"), "w")
    with log, contextlib.redirect_stdout(log):
        cfg = TrainConfig(**flags, seed=seed, synthetic_data=True,
                          save=os.path.join(cell.workdir, "logs"))
        trainer = Trainer(cfg, device=dev)
        trainer.source = DataSource(cfg.scale, cfg.channels, dev, store=store)
        saves = T.load(trainer, g_leaves, d_leaves, g0, d0)

        # the first steps, which the reference follows
        pool = trainer.source.epoch_pool(C.seeded_generator(dev, seed, *ref.POOL_WORDS),
                                         trainer.pool_n)
        prog = T.first_steps(trainer, pool, C.seeded_generator(dev, seed, *ref.STEP_WORDS))
        prog["pools"] = [pool.cpu()]
        del pool
        trainer.train_epochs_chunk(1, 1)  # a warm epoch: pool, steps, summary, read-back

        epc, next_epoch = trainer.epochs_per_compile, 2
        n_examples = cfg.n_epoch if cfg.n_epoch > 0 else trainer.pool_n
        steps_per_epoch = flops.steps_per_epoch(n_examples, cfg.batch_size)
        bad = []

        def chunk():
            nonlocal next_epoch
            stats = trainer.train_epochs_chunk(next_epoch, epc)
            next_epoch += epc
            bad.extend(s["epoch"] for s in stats
                       if not all(torch.isfinite(torch.tensor([s["loss_d_mean"],
                                                               s["loss_g_mean"]]))))

        W.synchronize(dev)
        outcome = harness.Outcome({}, {}, 0, 0, 0)
        setup_s = time.perf_counter() - cell.started
        if cell.trace:
            W.wrap(trainer.source, "epoch_pool", "data.epoch_pool")
            W.wrap(trainer, "run_steps", W.STEPS)
            outcome.trace, outcome.window = W.run_traced(chunk, dev, cell.workdir)
            outcome.breakdown = W.breakdown(outcome.trace, outcome.window)
            units = 1
        else:
            units, window_s = W.run_window(chunk, cell.seconds)
            outcome.metrics = {"train_images_per_s": stats.rate(units * epc * n_examples, window_s),
                               "setup_s": setup_s}
        outcome.attempted, outcome.failed = units * epc, len(bad)
        outcome.memory_peak_bytes = W.peak_memory(dev)
        del trainer
    W.free(dev)

    steps = epc * steps_per_epoch
    g_img, d_img = flops.forward_flops(ref.G_LAYERS), flops.forward_flops(ref.D_LAYERS)
    batch = flags["batch_size"]
    half = batch // 2
    upconv_bound = 0.0
    for n in (half, batch):  # D iteration's G at half a batch: forward only
        for h, cin, cout in ref.UPCONVS:
            fwd, dx, dw = flops.upconv_launches(n, h, cin, cout)
            upconv_bound += fwd if n == half else fwd + dx + dw
    outcome.facts = {
        "steps": steps, "model_flops": steps * flops.gan_step_flops(g_img, d_img, batch),
        "upconv_bound_s": steps * upconv_bound,
        "update_bound_s": steps * T.update_bound_s(flags, g_leaves, d_leaves)}
    outcome.notes.append(f"checkpoint writes counted and not made: {len(saves)}")
    T.judge(outcome, cell, ref, store, g0, d0, prog)
    return outcome
