"""The 2x2 confusion matrix of D's predictions (counterpart of
facegen/train/metrics.py).

Class 0 is generated (Y_GENERATOR), class 1 real; ``confusion[target,
predicted]`` holds int32 counts, on the device the logits are on.
"""

from __future__ import annotations

import numpy as np
import torch


def empty_confusion(device=None) -> torch.Tensor:
    return torch.zeros((2, 2), dtype=torch.int32, device=device)


def update_confusion(confusion: torch.Tensor, logits: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    """Add one batch (predicted class: logit > 0, adversarial.lua:111-117).
    Counted by comparison with the four cells, which, unlike bincount,
    does not read the data back to the host."""
    pred = (logits.reshape(-1) > 0).long()
    idx = targets.reshape(-1).long() * 2 + pred
    cells = torch.arange(4, device=idx.device)
    counts = (idx[:, None] == cells).sum(0).to(torch.int32).reshape(2, 2)
    return confusion + counts


def total_valid(confusion) -> float:
    """Overall accuracy, optim.ConfusionMatrix.totalValid."""
    c = np.asarray(confusion)
    return float(c[0, 0] + c[1, 1]) / float(max(int(c.sum()), 1))


def format_confusion(confusion) -> str:
    """The epoch log's matrix (adversarial.lua:313-314): per-class valid
    fractions and totalValid, in facegen's format."""
    c = np.asarray(confusion)
    lines = ["ConfusionMatrix:"]
    names = ["0 (fake)", "1 (real)"]
    for i in range(2):
        row_total = max(int(c[i].sum()), 1)
        lines.append(
            f"  [{c[i,0]:7d} {c[i,1]:7d}]  {100.0*c[i,i]/row_total:6.3f}%  [class: {names[i]}]"
        )
    lines.append(f"  + average row correct / totalValid: {100.0*total_valid(c):.3f}%")
    return "\n".join(lines)
