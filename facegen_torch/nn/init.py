"""Weight-initialisation schemes (counterpart of facegen/nn/init.py).

1. Scheme scales (weight-init.lua:14-37), applied torch-``reset(stdv)``
   style as uniform(-stdv, stdv) on weights and biases, biases then
   zeroed (``zero_biases``). For convs fan_in = inC*kH*kW and
   fan_out = outC*kH*kW.
2. The reference's gaussian overwrite (train.lua:137-138): every
   parameter N(0, 0.005^2), biases N(0, 0.001^2), including PReLU slopes
   and batch-norm gammas, which torch also names ``.weight``.

Draws come from an explicit ``torch.Generator``. They match facegen's
in distribution, not in bits.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def heuristic(fan_in: int, fan_out: int) -> float:
    return math.sqrt(1.0 / (3.0 * fan_in))


def xavier(fan_in: int, fan_out: int) -> float:
    return math.sqrt(2.0 / (fan_in + fan_out))


def xavier_caffe(fan_in: int, fan_out: int) -> float:
    return math.sqrt(1.0 / fan_in)


def kaiming(fan_in: int, fan_out: int) -> float:
    return math.sqrt(4.0 / (fan_in + fan_out))


SCHEMES = {
    "heuristic": heuristic,
    "xavier": xavier,
    "xavier_caffe": xavier_caffe,
    "kaiming": kaiming,
}


def scheme_fn(scheme: str):
    """The named scale scheme; unknown names raise with the valid ones."""
    try:
        return SCHEMES[scheme]
    except KeyError:
        raise ValueError(
            f"unknown init scheme {scheme!r}; choose one of {sorted(SCHEMES)}"
        ) from None


def uniform_(t: torch.Tensor, scale: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` with U(-scale, scale) drawn on the generator's device."""
    with torch.no_grad():
        draw = torch.empty(t.shape, dtype=torch.float32, device=generator.device)
        draw.uniform_(-scale, scale, generator=generator)
        return t.copy_(draw)


def _is_bias(name: str) -> bool:
    return name.rsplit(".", 1)[-1] == "bias"


def zero_biases(module: nn.Module) -> nn.Module:
    """weight-init.lua:70-72: every bias (batch-norm beta included) to 0."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if _is_bias(name):
                p.zero_()
    return module


def gaussian_overwrite(
    module: nn.Module,
    generator: torch.Generator,
    w_std: float = 0.005,
    b_std: float = 0.001,
) -> nn.Module:
    """nn_utils.lua:17-29: biases N(0, b_std^2), every other parameter
    (weights, PReLU slopes, batch-norm gammas) N(0, w_std^2). Buffers
    (batch-norm running statistics) are left alone."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            std = b_std if _is_bias(name) else w_std
            draw = torch.empty(p.shape, dtype=torch.float32, device=generator.device)
            draw.normal_(0.0, std, generator=generator)
            p.copy_(draw)
    return module
