"""GAN losses and weight penalties (counterpart of facegen/train/losses.py).

BCE is computed from logits, and the L1/L2 penalties are added to the
gradients explicitly, as the reference adds them to its flat gradient
(adversarial.lua:103-109, 218-224). Parameters and gradients are lists
of tensors in the same order.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of sigmoid(logits), in fp32, in the stable
    form max(l, 0) - l*t + log1p(exp(-|l|))."""
    logits = logits.float().reshape(-1)
    targets = targets.float().reshape(-1)
    per = logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return per.mean()


def penalty_loss(params: Sequence[torch.Tensor], l1: float, l2: float) -> torch.Tensor:
    """L1 * ||p||_1 + L2 * ||p||_2^2 / 2 over all parameters
    (adversarial.lua:105-106); a 0-d fp32 tensor on the params' device."""
    device = params[0].device
    if l1 == 0.0 and l2 == 0.0:
        return torch.zeros((), device=device)
    with torch.no_grad():
        l1_term = sum(p.abs().sum() for p in params)
        l2_term = sum((p * p).sum() for p in params)
        return l1 * l1_term + l2 * l2_term / 2.0


def add_penalty_grads(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                      sign_coef: float, linear_coef: float) -> List[torch.Tensor]:
    """grads + sign_coef * sign(p) + linear_coef * p (adversarial.lua:108).
    D passes (D_L1, D_L2). G passes (G_L2, G_L2) with the reference's bug
    (adversarial.lua:223 uses G_L2 for both terms; the step's
    ``reference_g_penalty_bug``), else (G_L1, G_L2)."""
    if sign_coef == 0.0 and linear_coef == 0.0:
        return list(grads)
    return [g + sign_coef * torch.sign(p) + linear_coef * p for g, p in zip(grads, params)]


def clamp_grads(grads: Sequence[torch.Tensor], clamp: float) -> List[torch.Tensor]:
    """Clamp every gradient entry to [-clamp, clamp]; 0 disables
    (adversarial.lua:121-123, 226-228)."""
    if clamp == 0.0:
        return list(grads)
    return [g.clamp(-clamp, clamp) for g in grads]


def batch_accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Fraction of the batch classified right at sigmoid > 0.5, i.e.
    logit > 0 (adversarial.lua:126-127); a 0-d fp32 tensor."""
    pred = (logits.reshape(-1) > 0).float()
    return (pred == targets.reshape(-1).float()).float().mean()
