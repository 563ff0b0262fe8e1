"""Coarse-to-fine training: facegen_torch's ``C2FTrainer``, epoch after epoch.

Set-up: the store and the weights from the seed, the trainer at the
configuration's flags on the store (its first ``val_size`` rows held out
as the validation set), the weights loaded; approxParzen of the loaded
G through ``C2FTrainer.parzen``, the call every epoch ends in; its first
three steps through ``C2FTrainer.run_steps`` (an eager warm-up step, the
capture, replays) on epoch 0's pool; and one warm epoch. The window:
``C2FTrainer.train_epoch`` (pool, 63 graphed steps, read-back,
approxParzen), as ``C2FTrainer.run`` drives it, until the seconds have
passed. The trainer's checkpoint writes (``_best`` whenever approxParzen
improves, every saveFreq epochs) are counted, not made.

``correct``: as the GAN's (losses, first gradients, changes after three
steps, the pools and the validation set), and approxParzen's distances
against the reference's for the same G, rows and noise.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from benchmark.lib import flops, harness, stats
from benchmark.lib import training as T
from benchmark.lib import window as W
from benchmark.reference import common as C


def run(cell: harness.Cell) -> harness.Outcome:
    from facegen_torch.config import C2FConfig
    from facegen_torch.data.c2f import make_triples
    from facegen_torch.data.pipeline import DataSource
    from facegen_torch.train.c2f import C2FTrainer

    ref, store, g_leaves, d_leaves, g0, d0 = harness.inputs(cell, "train")
    dev = torch.device(cell.device)
    flags, seed = cell.config["flags"], cell.seed
    log = open(os.path.join(cell.workdir, "program.log"), "w")
    with log, contextlib.redirect_stdout(log):
        cfg = C2FConfig(**flags, seed=seed, synthetic_data=True,
                        save=os.path.join(cell.workdir, "logs"))
        source = DataSource(cfg.fine_size, cfg.channels, dev, store=store, holdout=cfg.val_size)
        trainer = C2FTrainer(cfg, device=dev, source=source)
        saves = T.load(trainer, g_leaves, d_leaves, g0, d0)

        parzen = trainer.parzen(C.seeded_generator(dev, seed, *ref.PARZEN_WORDS))
        pool = make_triples(source.epoch_pool(C.seeded_generator(dev, seed, *ref.POOL_WORDS),
                                              trainer.pool_n), cfg.coarse_size)
        prog = T.first_steps(trainer, pool, C.seeded_generator(dev, seed, *ref.STEP_WORDS))
        prog["parzen"] = torch.as_tensor(np.asarray(parzen))
        prog["pools"] = [t.cpu() for t in (*pool, *trainer.val_pool)]
        del pool
        trainer.train_epoch(1)  # a warm epoch

        next_epoch, epoch_stats = 2, []

        def epoch():
            nonlocal next_epoch
            epoch_stats.append(trainer.train_epoch(next_epoch))
            next_epoch += 1

        W.synchronize(dev)
        outcome = harness.Outcome({}, {}, 0, 0, 0)
        setup_s = time.perf_counter() - cell.started
        if cell.trace:
            W.wrap(source, "epoch_pool", "data.epoch_pool")
            W.wrap(trainer, "run_steps", W.STEPS)
            W.wrap(trainer, "parzen", "validation.parzen")
            outcome.trace, outcome.window = W.run_traced(epoch, dev, cell.workdir)
            outcome.breakdown = W.breakdown(outcome.trace, outcome.window)
        else:
            units, window_s = W.run_window(epoch, cell.seconds)
            outcome.metrics = {"train_images_per_s": stats.rate(units * flags["n_epoch"], window_s),
                               "setup_s": setup_s}
        outcome.attempted = len(epoch_stats)
        outcome.failed = sum(1 for s in epoch_stats
                             if not np.isfinite([s["loss_d_mean"], s["loss_g_mean"],
                                                 s["parzen"]]).all())
        outcome.memory_peak_bytes = W.peak_memory(dev)
        del trainer, source
    W.free(dev)

    batch = flags["batch_size"]
    steps = flops.steps_per_epoch(flags["n_epoch"], batch) * len(epoch_stats)
    g_img, d_img = flops.forward_flops(ref.G_LAYERS), flops.forward_flops(ref.D_LAYERS)
    parzen_flops = flags["parzen_samples"] * batch * g_img * len(epoch_stats)
    outcome.facts = {
        "steps": steps,
        "model_flops": steps * flops.gan_step_flops(g_img, d_img, batch) + parzen_flops,
        "update_bound_s": steps * T.update_bound_s(flags, g_leaves, d_leaves),
        "parzen_ms": [s["parzen_ms"] for s in epoch_stats]}
    outcome.notes.append(f"checkpoint writes counted and not made: {len(saves)}")
    T.judge(outcome, cell, ref, store, g0, d0, prog)
    return outcome
