"""GAN losses and weight penalties (counterpart of facegen/train/losses.py).

BCE is computed from logits. The L1/L2 penalties' gradients and the
clamp are part of the update tail (ops/fused_update.py:add_penalty_grads,
clamp_grads), as the reference adds them to its flat gradient
(adversarial.lua:103-109, 218-224); here is the penalty's loss term.
Parameters are lists of tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from facegen_torch.ops.fused_update import penalty_sums


def batch_mean(per: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """The mean of a batch's elementwise ``per`` (rows first), or with
    ``rows`` its sum over the elements of that many rows: on a 2-D mesh
    (parallel/gspmd.py) a data row's share of the mean over the global
    batch's ``rows``, 0 for a data row that holds none."""
    if rows is None:
        return per.mean()
    return per.sum() / (rows * math.prod(per.shape[1:]))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    rows: Optional[int] = None) -> torch.Tensor:
    """Mean binary cross-entropy of sigmoid(logits), in fp32, in the stable
    form max(l, 0) - l*t + log1p(exp(-|l|)); with ``rows``, as
    ``batch_mean``."""
    logits = logits.float().reshape(-1)
    targets = targets.float().reshape(-1)
    per = logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return batch_mean(per, rows)


def penalty_loss(params: Sequence[torch.Tensor], l1: float, l2: float) -> torch.Tensor:
    """L1 * ||p||_1 + L2 * ||p||_2^2 / 2 over all parameters
    (adversarial.lua:105-106); a 0-d fp32 tensor on the params' device."""
    if l1 == 0.0 and l2 == 0.0:
        return torch.zeros((), device=params[0].device)
    l1_term, l2_term = penalty_sums(params)
    return l1 * l1_term + l2 * l2_term / 2.0


def batch_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                   rows: Optional[int] = None) -> torch.Tensor:
    """Fraction of the batch classified right at sigmoid > 0.5, i.e.
    logit > 0 (adversarial.lua:126-127); a 0-d fp32 tensor. With
    ``rows``, as ``batch_mean``."""
    pred = (logits.reshape(-1) > 0).float()
    return batch_mean((pred == targets.reshape(-1).float()).float(), rows)
