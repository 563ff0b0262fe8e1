"""StyleGAN2's layers (Karras et al., "Analyzing and Improving the Image
Quality of StyleGAN", CVPR 2020, config F), with the equations of
stylegan2-ada-pytorch's training/networks.py and its torch_utils ops.

Activations are NCHW tensors in torch's channels_last memory (the NHWC
layout of the port's other nets); parameters are fp32 and cast to the
activations' dtype at use, so a bf16 input computes in bf16. Every
weight keeps its equalized-learning-rate gain out of storage: a layer
stores N(0, 1) draws and multiplies by 1/sqrt(fan_in) (a linear layer
by lr_multiplier/sqrt(fan_in)) when it runs.

- ``resample_matrix`` / ``resample2d``: upfirdn2d, the FIR resampler:
  zero-insert by ``up``, pad, the 4x4 FIR [1,3,3,1] x [1,3,3,1] / 64
  times ``gain``, keep every ``down``-th row and column. The FIR is
  separable, so a layer holds the banded (out, in) matrix of one axis
  (zero insertion, padding, taps, gain and decimation in it) and
  ``resample2d`` applies it along W and along H as two matrix products
  (span ``sg2.fir``): on the H100 a depthwise 4x4 conv of bf16 NHWC
  maps through cuDNN ran 16-71 times its byte bound, the products 2-8
  times.
- ``EqualLinear`` (FullyConnectedLayer), ``EqualConv2d`` (Conv2dLayer,
  with the FIR-blurred stride-2 downsampling of D's resnet blocks).
- ``ModulatedConv2d`` (SynthesisLayer): the non-fused modulated conv.
  The input is scaled by the layer's style, one conv with the weight
  shared by every sample runs, and its output is scaled by the
  demodulation coefficients rsqrt(sum_{i,k} (w s_i)^2 + 1e-8), computed
  in fp32 from the styles and the squared weight; up=2 is a transposed
  conv of stride 2 followed by the FIR (gain 4). Then the const noise
  times its learned strength, the bias and leaky ReLU(0.2) x sqrt(2),
  as one multiply-add and one activation.
- ``ToRGB``: a modulated 1x1 conv without demodulation, plus bias, fp32 out.
- ``MinibatchStd``: the stddev over groups of ``group`` consecutive
  samples, averaged over channels and pixels, appended as a channel.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from facegen_torch.utils.profiling import span

FIR = (1.0, 3.0, 3.0, 1.0)
LRELU_SLOPE = 0.2
LRELU_GAIN = math.sqrt(2.0)


def randn(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """N(0, 1) fp32 drawn on the generator's device, then moved to ``device``."""
    draw = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    draw.normal_(0.0, 1.0, generator=generator)
    return draw.to(device) if device is not None else draw


def resample_matrix(size: int, up: int = 1, down: int = 1, pad: Tuple[int, int] = (0, 0),
                    gain: float = 1.0, device=None) -> torch.Tensor:
    """The fp32 matrix of upfirdn along one axis of ``size`` samples:
    insert ``up - 1`` zeros after each, pad ``pad[0]`` before and
    ``pad[1]`` after, correlate with the flipped ``FIR`` (normalised to
    sum 1) x sqrt(``gain``), keep every ``down``-th; (size * up + pad[0] +
    pad[1] - 4) // down + 1 rows. Applied along both axes it is the 2-D
    FIR x ``gain``. Its ``size`` columns are padded with zeros to a
    multiple of 8, so that its rows start 16-byte aligned in bf16
    (cuBLAS's fast kernels); ``resample2d`` uses the first ``size``."""
    f = torch.tensor(FIR, dtype=torch.float64).flip(0)
    f = f / f.sum() * math.sqrt(gain)
    k, full = f.shape[0], size * up + pad[0] + pad[1]
    m = torch.zeros(((full - k) // down + 1, -(-size // 8) * 8), dtype=torch.float64)
    for o in range(m.shape[0]):
        for j in range(k):
            p = o * down + j - pad[0]  # the position in the zero-inserted signal
            if 0 <= p < size * up and p % up == 0:
                m[o, p // up] += f[j]
    return m.to(torch.float32).to(device)


def resample2d(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, O, O) in channels_last memory: the (O, >= W)
    ``resample_matrix`` ``m``, cut to its first W = H columns, applied
    along W, then along H, as batched matrix products of the NHWC maps
    in the input's dtype (fp32 accumulation)."""
    with span("sg2.fir"):
        n, c, h, w = x.shape
        o = m.shape[0]
        m = m.to(x.dtype)[:, :w]
        y = x.permute(0, 2, 3, 1).reshape(n * h, w, c)
        y = torch.bmm(m.expand(n * h, o, w), y)  # (N*H, O, C)
        y = torch.bmm(m.expand(n, o, h), y.reshape(n, h, o * c))  # (N, O, O*C)
        return y.reshape(n, o, o, c).permute(0, 3, 1, 2)


class EqualLinear(nn.Module):
    """x @ (weight * lr_multiplier / sqrt(in)).T + bias * lr_multiplier,
    then leaky ReLU x sqrt(2) with ``lrelu``. Stored weight N(0, 1) /
    lr_multiplier, bias ``bias_init``."""

    def __init__(self, in_features: int, out_features: int, lrelu: bool = False,
                 bias_init: float = 0.0, lr_multiplier: float = 1.0, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.weight = nn.Parameter(randn((out_features, in_features), generator, device)
                                   / lr_multiplier)
        self.bias = nn.Parameter(torch.full((out_features,), float(bias_init), device=device))
        self.weight_gain = lr_multiplier / math.sqrt(in_features)
        self.bias_gain = lr_multiplier
        self.lrelu = lrelu

    def forward(self, x):
        gain = LRELU_GAIN if self.lrelu else 1.0
        w = (self.weight * (self.weight_gain * gain)).to(x.dtype)
        x = F.linear(x, w, (self.bias * (self.bias_gain * gain)).to(x.dtype))
        return F.leaky_relu(x, LRELU_SLOPE) if self.lrelu else x


class EqualConv2d(nn.Module):
    """A same-pad conv with weight N(0, 1) x 1/sqrt(Cin k k), bias (or
    none), leaky ReLU x sqrt(2) with ``lrelu``; ``down=2`` blurs an input
    of ``resolution`` with the FIR first (3x3: pad 2, then stride 2; 1x1:
    pad 1 and decimate in the FIR). ``gain`` scales the output (D's resnet
    joins at sqrt(1/2))."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, bias: bool = True,
                 lrelu: bool = True, down: int = 1, resolution: int = 0, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.weight = nn.Parameter(randn((out_channels, in_channels, kernel, kernel),
                                         generator, device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device)) if bias else None
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel * kernel)
        self.lrelu, self.down, self.kernel = lrelu, down, kernel
        if down > 1:
            fir = (resample_matrix(resolution, down=down, pad=(1, 1), device=device)
                   if kernel == 1 else resample_matrix(resolution, pad=(2, 2), device=device))
            self.register_buffer("fir", fir, persistent=False)

    def forward(self, x, gain: float = 1.0):
        gain = gain * (LRELU_GAIN if self.lrelu else 1.0)  # leaky ReLU(g y) = g leaky ReLU(y)
        w = (self.weight * (self.weight_gain * gain)).to(x.dtype)
        b = (self.bias * gain).to(x.dtype) if self.bias is not None else None
        if self.down == 1:
            x = F.conv2d(x, w, b, padding=self.kernel // 2)
        elif self.kernel == 1:
            x = F.conv2d(resample2d(x, self.fir), w, b)
        else:
            x = F.conv2d(resample2d(x, self.fir), w, b, stride=self.down)
        return F.leaky_relu(x, LRELU_SLOPE) if self.lrelu else x


def demodulation(weight: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
    """(N, Cout) rsqrt(sum_{i,k} (weight[o, i, k] styles[n, i])^2 + 1e-8), in fp32."""
    w2 = weight.float().square().sum((2, 3))  # (Cout, Cin)
    return torch.rsqrt(styles.float().square() @ w2.T + 1e-8)


class ModulatedConv2d(nn.Module):
    """SynthesisLayer: the style from w (an ``EqualLinear`` to Cin, bias
    1), the modulated ``kernel`` x ``kernel`` conv (``up`` 1 or 2) with
    demodulation, the const noise ``noise_const`` x ``noise_strength``,
    the bias and leaky ReLU x sqrt(2). The style and the demodulation
    coefficients are fp32; the activations keep the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 kernel: int = 3, up: int = 1, *, generator: torch.Generator, device=None):
        super().__init__()
        self.affine = EqualLinear(w_dim, in_channels, bias_init=1.0, generator=generator,
                                  device=device)
        self.weight = nn.Parameter(randn((out_channels, in_channels, kernel, kernel),
                                         generator, device))
        self.register_buffer("noise_const", randn((resolution, resolution), generator, device))
        self.noise_strength = nn.Parameter(torch.zeros((), device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        self.up, self.kernel = up, kernel
        if up > 1:  # the transposed conv's (resolution + 1)^2 output to resolution^2
            self.register_buffer("fir", resample_matrix(resolution + 1, pad=(1, 1),
                                                        gain=float(up ** 2), device=device),
                                 persistent=False)

    def forward(self, x, w):
        dtype = x.dtype
        styles = self.affine(w.float())
        x = x * styles.to(dtype)[:, :, None, None]
        weight = self.weight.to(dtype)
        if self.up == 1:
            x = F.conv2d(x, weight, padding=self.kernel // 2)
        else:
            x = F.conv_transpose2d(x, weight.transpose(0, 1), stride=self.up)
            x = resample2d(x.contiguous(memory_format=torch.channels_last), self.fir)
        scale = demodulation(self.weight, styles) * LRELU_GAIN
        shift = (self.shift() * LRELU_GAIN).to(dtype)[None]
        if x.is_contiguous(memory_format=torch.channels_last):
            shift = shift.contiguous(memory_format=torch.channels_last)
        x = torch.addcmul(shift, x, scale.to(dtype)[:, :, None, None])
        return F.leaky_relu(x, LRELU_SLOPE)

    def shift(self) -> torch.Tensor:
        """(Cout, H, W): the bias plus the const noise times its strength."""
        return self.bias[:, None, None] + self.noise_const * self.noise_strength


class ToRGB(nn.Module):
    """ToRGBLayer: a modulated 1x1 conv to ``out_channels`` without
    demodulation (style x 1/sqrt(Cin)) plus bias, returned in fp32."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.affine = EqualLinear(w_dim, in_channels, bias_init=1.0, generator=generator,
                                  device=device)
        self.weight = nn.Parameter(randn((out_channels, in_channels, 1, 1), generator, device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        self.weight_gain = 1.0 / math.sqrt(in_channels)

    def forward(self, x, w):
        styles = self.affine(w.float()) * self.weight_gain
        x = F.conv2d(x * styles.to(x.dtype)[:, :, None, None], self.weight.to(x.dtype))
        return x.float() + self.bias[None, :, None, None]


class MinibatchStd(nn.Module):
    """Appends ``channels`` feature maps: for each group of ``group``
    consecutive samples (all N when N < group) and each of ``channels``
    slices of the channels, the stddev over the group, averaged over the
    slice's channels and pixels, in fp32. N must be a multiple of the
    group."""

    def __init__(self, group: int = 4, channels: int = 1):
        super().__init__()
        self.group, self.channels = group, channels

    def forward(self, x):
        n, c, h, w = x.shape
        g = min(self.group, n)
        if n % g:
            raise ValueError(f"minibatch stddev over groups of {g}: a batch of {n} "
                             f"is not a multiple of {g}")
        y = x.float().reshape(n // g, g, self.channels, c // self.channels, h, w)
        y = (y.var(dim=1, unbiased=False) + 1e-8).sqrt().mean(dim=(2, 3, 4))
        y = y.repeat_interleave(g, dim=0)[:, :, None, None].expand(n, self.channels, h, w)
        return torch.cat([x, y.to(x.dtype)], dim=1)
