"""The numbers that decide ``correct``, from the program's outputs and the
reference's, each side from its own start (the reference reads nothing
of the program's state).

Training is judged on its first steps, leaf by leaf: for each leaf the
gap between the program's norm and the reference's, as a share of the
larger of the reference's norm of that leaf and of the median leaf; the
worst leaf, and the median leaf's gap where one small leaf's noise rules
the worst (the configuration's limits name which numbers are compared).
A leaf whose reference gradient is under a thousandth of the median
leaf's (a bias in front of a batch norm, whose gradient is rounding
alone) moves under Adam by the sign of its rounding, in the program and
in the reference alike; its change is left out, by that rule on the
reference's gradient and not by name.
"""

from __future__ import annotations

import statistics
from typing import List, Optional, Sequence

import torch


def norms(tensors: Sequence[torch.Tensor]) -> List[float]:
    return [float(t.double().norm()) for t in tensors]


def moving(reference_grads: Sequence[torch.Tensor]) -> List[bool]:
    """Leaves whose reference gradient is at least a thousandth of the median leaf's."""
    g = norms(reference_grads)
    median = statistics.median(g)
    return [x >= 1e-3 * median for x in g]


def changes(after: Sequence[torch.Tensor], before: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [a.double() - b.double() for a, b in zip(after, before)]


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(program, reference))


def adam_first_grads(mu: Sequence[torch.Tensor], b1: float = 0.9) -> List[torch.Tensor]:
    """The gradient Adam took at its first step, from its first moment
    after that step: mu = (1 - b1) g."""
    return [m.double() / (1.0 - b1) for m in mu]


def leaf_gaps(program: Sequence[torch.Tensor], reference: Sequence[torch.Tensor],
              keep: Optional[Sequence[bool]] = None) -> List[float]:
    """Each leaf's gap: |‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖), the median over
    the ``keep`` leaves (all by default)."""
    p, r = norms(program), norms(reference)
    keep = keep if keep is not None else [True] * len(r)
    median = statistics.median([x for x, k in zip(r, keep) if k])
    return [abs(a - b) / max(b, median, 1e-30) for a, b in zip(p, r)]


def leaf_report(prog: dict, ref: dict, g0, d0) -> str:
    """Each leaf's gradient and change gaps, for standard error ("-": a
    leaf the change leaves out)."""
    parts = []
    for net, start in (("g", g0), ("d", d0)):
        grads = leaf_gaps(prog["grads_" + net], ref["grads_" + net])
        keep = moving(ref["grads_" + net])
        change = leaf_gaps(changes(prog[net], start), changes(ref[net], start), keep)
        parts.append(f"{net} grad " + " ".join(f"{x:.2g}" for x in grads))
        parts.append(f"{net} change " + " ".join(f"{x:.2g}" if k else "-"
                                                for x, k in zip(change, keep)))
    return "leaf gaps: " + "; ".join(parts)


def _gap_max(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.cpu().int() - b.cpu().int()).abs().max())


def training(prog: dict, ref: dict, g0, d0) -> dict:
    """The training numbers. ``prog`` and ``ref``: ``losses`` (per step
    (loss_d, loss_g)), ``grads_g`` / ``grads_d`` (first gradients), ``g`` /
    ``d`` (weights after the steps) and ``pools`` (uint8); with
    ``parzen``, approxParzen's distances; ``g0`` / ``d0`` the weights both
    started from. The configuration's limits name the numbers compared.

    Only D's first iteration works on the weights both sides were given.
    Adam's first step moves every element by the learning rate times the
    sign of its gradient, so where a gradient element is all but cancelled
    the two sides' rounding sends it opposite ways; every later phase
    works on weights that differ so. G's first gradient already comes
    through D after that step: ``g_grad_gap`` reads that spread with G's
    arithmetic; ``first_loss_gap`` and D's first gradient
    (``d_grad_gap``, ``d_grad_median_gap``) measure the arithmetic alone."""
    losses_p = [x for pair in prog["losses"] for x in pair]
    losses_r = [x for pair in ref["losses"] for x in pair]
    out = {"loss_gap": loss_gap(losses_p, losses_r),
           "first_loss_gap": loss_gap(losses_p[:1], losses_r[:1])}
    for net, start in (("g", g0), ("d", d0)):
        grads = leaf_gaps(prog["grads_" + net], ref["grads_" + net])
        keep = moving(ref["grads_" + net])
        change = [x for x, k in zip(leaf_gaps(changes(prog[net], start),
                                              changes(ref[net], start), keep), keep) if k]
        out[f"{net}_grad_gap"] = max(grads)
        out[f"{net}_grad_median_gap"] = statistics.median(grads)
        out[f"{net}_change_gap"] = max(change)
        out[f"{net}_change_median_gap"] = statistics.median(change)
    out["change_gap"] = max(out["g_change_gap"], out["d_change_gap"])
    out["change_median_gap"] = max(out["g_change_median_gap"], out["d_change_median_gap"])
    out["pool_gap"] = max(_gap_max(a, b) for a, b in zip(prog["pools"], ref["pools"]))
    if "parzen" in ref:
        p, r = prog["parzen"].double().cpu(), ref["parzen"].double().cpu()
        out["parzen_gap"] = float(((p - r).abs() / r).max())
        out["parzen_mean_gap"] = float((p.mean() - r.mean()).abs() / r.mean())
    return out


def compared(numbers: dict, limits: dict):
    """(the checks: each number the configuration limits, with its limit;
    a note with every reading)."""
    checks = {k: (numbers[k], limit) for k, limit in limits.items()}
    note = "readings: " + " ".join(f"{k}={v:.4g}" for k, v in numbers.items())
    return checks, note
