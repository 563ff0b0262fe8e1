"""Layers of the port (counterpart of facegen/nn/layers.py).

Activations are NHWC at every module boundary, as in facegen; a conv
runs ``F.conv2d`` on the NCHW view of the NHWC tensor, which is torch's
channels_last layout. Parameters are stored in fp32 in torch's layouts
(Linear (out, in), conv OIHW) and cast to the input's dtype at use, so
bf16 compute is chosen by feeding bf16 activations.

``.train()`` / ``.eval()`` switch batch norm between batch and running
statistics and turn dropout and white noise on and off, like facegen's
``Ctx.train``. Dropout masks and white-noise draws are injected
(``Dropout.mask``, ``WhiteNoise.draw``) or drawn from the layer's
``generator``; training injects them (train/step.py:draw_step,
train/ae_loop.py).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from facegen_torch.nn.init import uniform_
from facegen_torch.ops.upsample_conv import (
    UpsampleConvFunction,
    _collapse_matrix,
    collapse_weights,
    upsample_conv,
)


def _torch_reset_scale(fan_in: int) -> float:
    """torch nn default reset(): uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return 1.0 / math.sqrt(fan_in)


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
    """Convolution over NHWC input, OIHW weight: same-pad (k-1)/2
    (``padding="SAME"``) or unpadded (``padding="VALID"``, the denoiser's
    3x3 convs, train_denoiser.lua:89,92)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 w_std: Optional[float] = None, *, generator: torch.Generator, device=None,
                 padding: str = "SAME"):
        super().__init__()
        if kernel % 2 != 1:
            raise ValueError(f"odd kernels only, got {kernel}")
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}: SAME or VALID")
        self.stride = stride
        self.padding = (kernel - 1) // 2 if padding == "SAME" else 0
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


class SubpixelConv(Conv2d):
    """Same-pad conv to ``features * factor**2`` channels viewed at
    ``factor`` times the resolution, the reference's
    SpatialConvolutionUpsample (facegen/nn/layers.py:411-448); its
    parameters are the inner conv's, with torch's default reset. At
    factor 1 (every c2f call site) it is a plain same-pad conv. At
    factor > 1 the view is the reference's
    row-major (N, C*f*f, H, W) -> (N, C, H*f, W*f), not pixel-shuffle
    order: channel block c's f*f maps land as consecutive row stripes of
    output plane c."""

    def __init__(self, in_channels: int, features: int, kernel: int, factor: int = 1, *,
                 generator: torch.Generator, device=None):
        super().__init__(in_channels, features * factor * factor, kernel,
                         generator=generator, device=device)
        self.features, self.factor = features, factor

    def forward(self, x):
        y = super().forward(x)
        if self.factor == 1:
            return y
        n, h, w, _ = y.shape
        f = self.factor
        y = y.permute(0, 3, 1, 2).reshape(n, self.features, h * f, w * f)
        return y.permute(0, 2, 3, 1)


class UpsampleConv(nn.Module):
    """Fused nearest-upsample(2) + same-pad KxK conv (K = 3 or 5), G's
    pyramid op. Parameters as ``Conv2d``.

    The collapsed weight is computed from the weight on every call: under
    autograd where gradients are needed (its einsum's backward is the
    un-collapse), and ``UpsampleConvFunction`` runs the forward, dx and dW
    kernels; otherwise (eval, or training's no-grad D-phase forward) the
    forward kernel alone."""

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

    def collapsed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        # cast first, then sum in fp32, like facegen's
        # collapse_weights(w.astype(x.dtype))
        return collapse_weights(self.weight.to(dtype)).contiguous()

    def forward(self, x):
        x = x.contiguous()
        wc, b = self.collapsed_weight(x.dtype), self.bias.to(x.dtype)
        if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad
                                        or self.bias.requires_grad):
            return UpsampleConvFunction.apply(x, wc, b)
        return upsample_conv(x, wc, b)


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


class Tanh(nn.Module):
    def forward(self, x):
        return torch.tanh(x)


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class LeakyReLU(nn.Module):
    """x for x > 0, else slope * x (the reference's vendored
    LeakyReLU.lua, slope 1/3 in the denoiser)."""

    def __init__(self, slope: float = 1.0 / 3.0):
        super().__init__()
        self.slope = slope

    def forward(self, x):
        return F.leaky_relu(x, self.slope)


class BatchNorm(nn.Module):
    """Batch norm over the last (channel) axis, computed in fp32 and cast
    back to the input dtype (facegen/nn/layers.py:169-211), eps 1e-5. In
    train mode it normalises by the batch's statistics and moves the
    running ones: new = (1 - momentum) * old + momentum * batch, with the
    unbiased variance (torch's convention, momentum 0.1); in eval mode it
    uses the running statistics."""

    MOMENTUM = 0.1

    def __init__(self, channels: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x):
        xf = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = xf.var(dims, unbiased=False)
            n = x.numel() // x.shape[-1]
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * (var * (n / max(n - 1, 1))))
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * inv + self.bias).to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout (keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate)); the identity in eval mode.

    The keep-mask of the next train-mode forward is ``self.mask`` when one
    was injected (a bool tensor of ``mask_shape(x.shape)``, used once),
    else a draw from ``self.generator`` (torch's default generator when
    None) on the input's device."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate
        self.mask: Optional[torch.Tensor] = None
        self.generator: Optional[torch.Generator] = None

    @staticmethod
    def mask_shape(shape) -> tuple:
        return tuple(shape)

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = self.mask_shape(x.shape)
        mask, self.mask = self.mask, None
        if mask is None:
            mask = torch.rand(shape, generator=self.generator, device=x.device) < keep
        elif tuple(mask.shape) != shape:
            raise ValueError(f"{type(self).__name__}: mask {tuple(mask.shape)} for input "
                             f"{tuple(x.shape)}, want {shape}")
        return torch.where(mask, x / keep, 0).to(x.dtype)


class SpatialDropout(Dropout):
    """Drops whole channels: the mask is (N, 1, 1, C) (reference
    nn.SpatialDropout, facegen/nn/layers.py:230-242)."""

    @staticmethod
    def mask_shape(shape) -> tuple:
        return (shape[0], 1, 1, shape[-1])


class WhiteNoise(nn.Module):
    """Adds mean + std * N(0, 1) in train mode, computed in fp32 and cast
    to the input's dtype (dpnn nn.WhiteNoise, the denoiser's encoder);
    the identity in eval mode.

    The standard-normal draw of the next train-mode forward is
    ``self.draw`` when one was injected (a tensor of the input's shape,
    used once), else a draw from ``self.generator`` (torch's default
    generator when None) on the input's device."""

    def __init__(self, mean: float = 0.0, std: float = 0.1):
        super().__init__()
        self.mean, self.std = mean, std
        self.draw: Optional[torch.Tensor] = None
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training:
            return x
        draw, self.draw = self.draw, None
        if draw is None:
            draw = torch.randn(x.shape, generator=self.generator, device=x.device)
        elif draw.shape != x.shape:
            raise ValueError(f"WhiteNoise: draw {tuple(draw.shape)} for input {tuple(x.shape)}")
        noise = self.mean + self.std * draw.float()
        return (x + noise.to(x.dtype)).to(x.dtype)


class AvgPool(nn.Module):
    """window x window average pool, stride = window, summed in fp32."""

    def __init__(self, window: int = 2):
        super().__init__()
        self.window = window

    def forward(self, x):
        y = F.avg_pool2d(x.float().permute(0, 3, 1, 2), self.window, self.window)
        return y.permute(0, 2, 3, 1).to(x.dtype)


class MaxPool(nn.Module):
    """2x2 max pool of stride 2, no padding (reference
    nn.SpatialMaxPooling(2, 2), facegen/nn/layers.py:287-305)."""

    def forward(self, x):
        y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
        return y.permute(0, 2, 3, 1)


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
