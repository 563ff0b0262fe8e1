"""What the training entries share: the benchmark's weights in the
trainer, its checkpoint writes counted, its first steps driven through
the window's own call and read back, the update's byte bound, and the
judgement of those steps against the reference's."""

from __future__ import annotations

from typing import List, Sequence

import torch

from benchmark.lib import checks, flops, harness, weights
from benchmark.reference import common as C

CHECKED_STEPS = 3


def snapshot(tensors) -> List[torch.Tensor]:
    return [t.detach().clone() for t in tensors]


def load(trainer, g_leaves, d_leaves, g0, d0) -> List[int]:
    """Load the weights into ``trainer``'s nets and swap its ``save`` for a
    counter; returns the list that gathers the epoch of each write."""
    weights.load_into(trainer.state.g, g_leaves, g0)
    weights.load_into(trainer.state.d, d_leaves, d0)
    saves: List[int] = []
    trainer.save = lambda *a, **k: saves.append(trainer.state.epoch)
    return saves


def first_steps(trainer, pool, generator: torch.Generator, steps: int = CHECKED_STEPS) -> dict:
    """The trainer's first ``steps`` steps through ``run_steps`` (the eager
    warm-up step, the capture, replays): each step's losses, each net's
    first gradient (from Adam's first moment after step 1) and the weights
    after the steps."""
    first = trainer.run_steps(pool, generator, 1)
    mu_g, mu_d = snapshot(trainer.state.opt_g["mu"]), snapshot(trainer.state.opt_d["mu"])
    rest = trainer.run_steps(pool, generator, steps - 1)
    return {"losses": list(zip(torch.cat([first.loss_d, rest.loss_d]).tolist(),
                               torch.cat([first.loss_g, rest.loss_g]).tolist())),
            "grads_g": checks.adam_first_grads(mu_g), "grads_d": checks.adam_first_grads(mu_d),
            "g": snapshot(trainer.state.g.parameters()),
            "d": snapshot(trainer.state.d.parameters())}


def update_bound_s(flags: dict, g_leaves: Sequence, d_leaves: Sequence) -> float:
    """The byte bound of one step's two fused updates."""
    return flops.bound_s(0, flops.update_bytes(g_leaves, flags["g_l1"] or flags["g_l2"],
                                               flags["g_clamp"])
                         + flops.update_bytes(d_leaves, flags["d_l1"] or flags["d_l2"],
                                              flags["d_clamp"]))


def judge(outcome: harness.Outcome, cell: harness.Cell, ref, store, g0, d0, prog: dict) -> None:
    """Compare the program's first steps with the reference's, worked out
    from the same inputs; the checks and the readings go on ``outcome``."""
    with C.full_fp32():
        want = ref.expected(store, g0, d0, cell.seed, cell.config["flags"], cell.config["lr"],
                            len(prog["losses"]))
    numbers = checks.training(prog, want, g0, d0)
    outcome.notes.append(checks.leaf_report(prog, want, g0, d0))
    outcome.checks, note = checks.compared(numbers, cell.config["limits"]["train"])
    outcome.notes.append(note)
