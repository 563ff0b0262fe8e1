"""Layers of the port, eval-mode forward (counterpart of facegen/nn/layers.py).

Activations are NHWC at every module boundary, as in facegen; a conv
runs ``F.conv2d`` on the NCHW view of the NHWC tensor, which is torch's
channels_last layout. Parameters are stored in fp32 in torch's layouts
(Linear (out, in), conv OIHW) and cast to the input's dtype at use, so
bf16 compute is chosen by feeding bf16 activations.

Train mode is not ported yet: batch-norm statistics, dropout draws and
the upsample-conv kernel's backward come with the training slice. Those
layers raise in train mode instead of silently running eval.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from facegen_torch.nn.init import uniform_
from facegen_torch.ops.upsample_conv import _collapse_matrix, collapse_weights, upsample_conv


def _torch_reset_scale(fan_in: int) -> float:
    """torch nn default reset(): uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return 1.0 / math.sqrt(fan_in)


def _eval_only(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: train mode is not ported yet; call .eval()"
        )


def sequential(*layers) -> nn.Sequential:
    """nn.Sequential of (name, module) pairs, children named
    ``{index:02d}_{name}`` like facegen's parameter tree keys."""
    return nn.Sequential(OrderedDict(
        (f"{i:02d}_{name}", m) for i, (name, m) in enumerate(layers)
    ))


class Branches(nn.Module):
    """Feed one input to every branch and concat the outputs on the last
    axis (ConcatTable + JoinTable, models.lua:305-311)."""

    def __init__(self, *branches):
        super().__init__()
        for i, (name, m) in enumerate(branches):
            self.add_module(f"{i:02d}_{name}", m)

    def forward(self, x):
        return torch.cat([m(x) for m in self.children()], dim=-1)


class Dense(nn.Module):
    """nn.Linear; ``w_std`` inits weight and bias U(-w_std, w_std),
    otherwise torch's 1/sqrt(fan_in)."""

    def __init__(self, in_features: int, out_features: int, w_std: Optional[float] = None,
                 *, generator: torch.Generator, device=None):
        super().__init__()
        scale = w_std if w_std is not None else _torch_reset_scale(in_features)
        self.weight = nn.Parameter(uniform_(
            torch.empty(out_features, in_features, device=device), scale, generator))
        self.bias = nn.Parameter(uniform_(
            torch.empty(out_features, device=device), scale, generator))

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Conv2d(nn.Module):
    """Same-pad (k-1)/2 convolution over NHWC input, OIHW weight."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 w_std: Optional[float] = None, *, generator: torch.Generator, device=None):
        super().__init__()
        if kernel % 2 != 1:
            raise ValueError(f"odd kernels only, got {kernel}")
        self.stride, self.padding = stride, (kernel - 1) // 2
        scale = w_std if w_std is not None else _torch_reset_scale(in_channels * kernel * kernel)
        self.weight = nn.Parameter(uniform_(
            torch.empty(out_channels, in_channels, kernel, kernel, device=device),
            scale, generator))
        self.bias = nn.Parameter(uniform_(
            torch.empty(out_channels, device=device), scale, generator))

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), self.bias.to(x.dtype),
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class UpsampleConv(nn.Module):
    """Fused nearest-upsample(2) + same-pad KxK conv (K = 3 or 5), G's
    pyramid op. Parameters as ``Conv2d``. The collapsed GEMM weight is
    computed once per loaded weight and dtype and cached here."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 5,
                 w_std: Optional[float] = None, *, generator: torch.Generator, device=None):
        super().__init__()
        _collapse_matrix(kernel)  # rejects kernels the op cannot collapse
        scale = w_std if w_std is not None else _torch_reset_scale(in_channels * kernel * kernel)
        self.weight = nn.Parameter(uniform_(
            torch.empty(out_channels, in_channels, kernel, kernel, device=device),
            scale, generator))
        self.bias = nn.Parameter(uniform_(
            torch.empty(out_channels, device=device), scale, generator))
        self._collapsed = None  # (cache key, collapsed weight)

    def collapsed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        # _version moves on every in-place write (load_state_dict, optimizer
        # steps) and data_ptr on every move: either one invalidates the cache
        key = (self.weight._version, self.weight.data_ptr(), self.weight.device, dtype)
        if self._collapsed is None or self._collapsed[0] != key:
            with torch.no_grad():
                # cast first, then sum in fp32, like facegen's
                # collapse_weights(w.astype(x.dtype))
                wc = collapse_weights(self.weight.to(dtype)).contiguous()
            self._collapsed = (key, wc)
        return self._collapsed[1]

    def forward(self, x):
        _eval_only(self)
        return upsample_conv(x.contiguous(), self.collapsed_weight(x.dtype),
                             self.bias.to(x.dtype))


class PReLU(nn.Module):
    """PReLU with one shared slope (torch nn.PReLU() default, 0.25)."""

    def __init__(self, init: float = 0.25, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init, device=device))

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


class Sigmoid(nn.Module):
    def forward(self, x):
        return torch.sigmoid(x)


class BatchNorm(nn.Module):
    """Batch norm over the last (channel) axis from running statistics,
    computed in fp32 and cast back to the input dtype
    (facegen/nn/layers.py:205-209). eps 1e-5."""

    def __init__(self, channels: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x):
        _eval_only(self)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean) * inv + self.bias).to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout; the identity in eval mode."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        _eval_only(self)
        return x


class SpatialDropout(Dropout):
    """Drops whole channels (mask (N, 1, 1, C)) in training; the identity
    in eval mode."""


class AvgPool(nn.Module):
    """window x window average pool, stride = window, summed in fp32."""

    def __init__(self, window: int = 2):
        super().__init__()
        self.window = window

    def forward(self, x):
        y = F.avg_pool2d(x.float().permute(0, 3, 1, 2), self.window, self.window)
        return y.permute(0, 2, 3, 1).to(x.dtype)


class Flatten(nn.Module):
    """(N, H, W, C) -> (N, H*W*C) in NHWC order, as facegen flattens."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Reshape(nn.Module):
    """(N, F) -> (N, *shape), e.g. (8, 8, 128) NHWC."""

    def __init__(self, shape: Sequence[int]):
        super().__init__()
        self.shape = tuple(shape)

    def forward(self, x):
        return x.reshape((x.shape[0],) + self.shape)


class NCHWView(nn.Module):
    """The reference's nn.View(c, s0, s0) then CHW -> HWC: fc unit
    ch*s0*s0 + y*s0 + x feeds plane ch at pixel (y, x)
    (facegen/models/gan.py:_nchw_view)."""

    def __init__(self, s0: int, channels: int):
        super().__init__()
        self.s0, self.channels = s0, channels

    def forward(self, x):
        x = x.reshape(x.shape[0], self.channels, self.s0, self.s0)
        return x.permute(0, 2, 3, 1).contiguous()
