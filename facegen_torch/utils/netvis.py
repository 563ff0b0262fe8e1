"""Network-activation grids (counterpart of facegen/utils/netvis.py and
facegen/nn/core.py:111-122's ``sequential_activations``).

PNGs in place of the reference's live ``visualizeNetwork`` windows
(adversarial.lua:348-406): one batch goes through the network, and for
each top-level conv or linear layer the first example's output becomes
a grid of its planes, ``<out_dir>/<key>.png`` with facegen's key
``{i:02d}_{name}``. Linear outputs of fewer than ``min_outputs`` values
are skipped and the others laid out near-square (adversarial.lua:350,
373-386); values map from [-1, 1] to [0, 1] (adversarial.lua:393).
Nested layers (D16_d's branches) are not descended into, as in facegen.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from facegen_torch.nn.layers import full_fp32
from facegen_torch.utils import grids


def _near_square(n: int) -> Optional[Tuple[int, int]]:
    rows = int(math.floor(math.sqrt(n)))
    while n % rows != 0 and rows < n:
        rows += 1
    return (rows, n // rows) if rows < n else None


def sequential_activations(module: nn.Sequential, x: torch.Tensor
                           ) -> Tuple[torch.Tensor, List[Tuple[str, torch.Tensor]]]:
    """Run ``module`` on ``x`` as it is (train or eval mode), capturing
    each top-level child's output with a forward hook: (output,
    [(key, activation), ...]) in order. Activations are NHWC, facegen's
    (N, H, W, C)."""
    acts: List[Tuple[str, torch.Tensor]] = []
    handles = [child.register_forward_hook(lambda m, args, out, key=key: acts.append((key, out)))
               for key, child in module.named_children()]
    try:
        y = module(x)
    finally:
        for h in handles:
            h.remove()
    return y, acts


@torch.no_grad()
def visualize_network(module: nn.Sequential, x: torch.Tensor, out_dir: str,
                      min_outputs: int = 150) -> Dict[str, str]:
    """Dump ``module``'s activation grids for the input ``x``; returns
    {layer key: png path}. The network runs in eval mode (batch norms on
    their running statistics, no dropout), as facegen's ``Ctx(key,
    False)``, in fp32 with TF32 off on the card; its mode is restored."""
    os.makedirs(out_dir, exist_ok=True)
    was_training = module.training
    module.eval()
    try:
        with full_fp32():
            _, acts = sequential_activations(module, x.float())
    finally:
        module.train(was_training)
    written = {}
    for k, a in acts:
        arr = a[0].float().cpu().numpy()  # the first example, like output[1]
        if arr.ndim == 3:  # a feature map (H, W, C) -> one plane per channel
            if "conv" not in k and "upconv" not in k:
                continue
            planes = np.transpose(arr, (2, 0, 1))[..., None]
        elif arr.ndim == 1:  # a linear layer's output
            if "fc" not in k and "dense" not in k:
                continue
            if arr.size < min_outputs:
                continue
            shape = _near_square(arr.size)
            if shape is None:
                continue
            planes = arr.reshape(1, shape[0], shape[1], 1)
        else:
            continue
        planes = np.clip((planes + 1.0) / 2.0, 0.0, 1.0)  # [-1, 1] -> [0, 1]
        path = os.path.join(out_dir, f"{k}.png")
        grids.save_grid(path, planes, nrow=32)
        written[k] = path
    return written
