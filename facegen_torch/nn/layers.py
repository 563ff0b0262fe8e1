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

import contextlib
import math
from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from facegen_torch.nn.init import uniform_
from facegen_torch.ops.bn_prelu import bn_prelu
from facegen_torch.ops.upsample_conv import (
    UpsampleConvFunction,
    _collapse_matrix,
    collapse_weights,
    upsample_conv,
)


@contextlib.contextmanager
def full_fp32():
    """cuDNN convolutions and cuBLAS matmuls in full fp32, not TF32 (on
    by default for cuDNN), for the block; the previous settings after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _torch_reset_scale(fan_in: int) -> float:
    """torch nn default reset(): uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return 1.0 / math.sqrt(fan_in)


def sequential(*layers) -> nn.Sequential:
    """``Sequential`` of (name, module) pairs, children named
    ``{index:02d}_{name}`` like facegen's parameter tree keys."""
    return Sequential(OrderedDict(
        (f"{i:02d}_{name}", m) for i, (name, m) in enumerate(layers)
    ))


class Sequential(nn.Sequential):
    """nn.Sequential whose forward runs each ``BatchNorm`` then ``PReLU``
    pair that ``fused_pair`` accepts as one call of ``ops/bn_prelu.py``
    (its kernels: statistics and apply in train mode, apply in eval, and
    one backward) when the input is on a CUDA device. Every other module,
    and every pair on the CPU, runs its own forward. Children, names and
    state_dict keys are nn.Sequential's."""

    def forward(self, x):
        modules = list(self._modules.values())
        i = 0
        while i < len(modules):
            m = modules[i]
            after = modules[i + 1] if i + 1 < len(modules) else None
            if fused_pair(m, after) and x.is_cuda:
                x = bn_prelu(x, m.weight, m.bias, after.weight, m.running_mean, m.running_var,
                             m.training, m.eps, m.MOMENTUM)
                i += 2
            else:
                x = m(x)
                i += 1
        return x


def fused_pair(m: nn.Module, after: Optional[nn.Module]) -> bool:
    """Whether ``Sequential`` runs ``m`` and the module ``after`` it as one
    batch norm + PReLU call on a CUDA input: a ``BatchNorm`` directly
    followed by a ``PReLU``, unless the batch norm trains over a mesh (the
    2-D mesh's synchronised batch norm keeps its own path; in eval mode
    the mesh changes nothing) or either module carries a forward hook (a
    hook asks for the batch norm's own output, as utils/netvis.py's do)."""
    return (isinstance(m, BatchNorm) and isinstance(after, PReLU)
            and (m.mesh is None or not m.training)
            and not any(k._forward_hooks or k._forward_pre_hooks for k in (m, after)))


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


class SyncBatchNormFunction(torch.autograd.Function):
    """Training-mode batch norm of fp32 ``x`` (channels last) by the
    statistics of the global batch over a mesh's data group
    (parallel/gspmd.py:Mesh2D, whose data rows may hold unequal shares of
    the batch, or none), in two passes as the single-device ``var`` is:
    the channels' fp32 sums and this rank's count are all-reduced for mean
    = S / n, with n the global count, then their sums of squared
    deviations from that mean for var = SS / n (one pass, SS / n - mean^2,
    would lose the variance to cancellation when the mean is large against
    the spread). The backward all-reduces the two channel sums the input's
    gradient needs, sum(dy) and sum(dy * xhat), and returns this rank's own
    as the gradients of the bias and the scale: the train step sums those
    over the data group with the other gradients. An empty local batch
    adds zeros everywhere. Returns (y, mean, var, n); mean, var and the
    global count n (a 0-d fp32 tensor) are not differentiable."""

    @staticmethod
    def forward(ctx, x, weight, bias, mesh, eps):
        dims, c = tuple(range(x.dim() - 1)), x.shape[-1]
        sums = torch.cat([x.sum(dims), x.new_full((1,), x.numel() // c)])
        mesh.all_reduce_sum_(sums)
        n = sums[c]
        mean = sums[:c] / n
        centred = x - mean
        squares = (centred * centred).sum(dims)
        mesh.all_reduce_sum_(squares)
        var = squares / n
        inv = torch.rsqrt(var + eps)
        xhat = centred * inv
        ctx.save_for_backward(xhat, inv, weight, n)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var, n)
        return centred * (inv * weight) + bias, mean, var, n  # as BatchNorm.forward rounds

    @staticmethod
    def backward(ctx, dy, _mean, _var, _n):
        xhat, inv, weight, n = ctx.saved_tensors
        dims, c = tuple(range(dy.dim() - 1)), dy.shape[-1]
        local = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
        total = local.clone()
        ctx.mesh.all_reduce_sum_(total)
        dx = (weight * inv / n) * (n * dy - total[:c] - xhat * total[c:])
        return dx, local[c:], local[:c], None, None


class BatchNorm(nn.Module):
    """Batch norm over the last (channel) axis, computed in fp32 and cast
    back to the input dtype (facegen/nn/layers.py:169-211), eps 1e-5. In
    train mode it normalises by the batch's statistics and moves the
    running ones: new = (1 - momentum) * old + momentum * batch, with the
    unbiased variance (torch's convention, momentum 0.1); in eval mode it
    uses the running statistics. With ``mesh`` (a 2-D mesh of more than
    one data row, ``set_batch_norm_mesh``) the batch is the
    global one: ``SyncBatchNormFunction``, the unbiased factor from the
    global count."""

    MOMENTUM = 0.1

    def __init__(self, channels: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))
        self.mesh = None

    def _move_running(self, mean: torch.Tensor, var: torch.Tensor, n) -> None:
        """``n``: the batch's count, an int or a 0-d tensor (the global
        count of ``SyncBatchNormFunction``, whose factor n / (n - 1) is
        formed in fp64 and rounded once, as the int's is)."""
        with torch.no_grad():
            m = self.MOMENTUM
            if isinstance(n, torch.Tensor):
                n = n.double()
                unbiased = (n / (n - 1).clamp(min=1)).float()
            else:
                unbiased = n / max(n - 1, 1)
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * (var * unbiased))

    def forward(self, x):
        xf = x.float()
        if self.training and self.mesh is not None:
            y, mean, var, n = SyncBatchNormFunction.apply(xf, self.weight, self.bias,
                                                          self.mesh, self.eps)
            self._move_running(mean, var, n)
            return y.to(x.dtype)
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = xf.var(dims, unbiased=False)
            self._move_running(mean, var, x.numel() // x.shape[-1])
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * inv + self.bias).to(x.dtype)


def set_batch_norm_mesh(module: nn.Module, mesh) -> None:
    """Point the module's batch norms at ``mesh``'s data group (a
    parallel/gspmd.py:Mesh2D, or None): in training mode they normalise by
    the global batch's statistics when it has more than one data row."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh if mesh is not None and mesh.dp > 1 else None


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
    """(N, H, W, C) -> (N, H*W*C) in NHWC order, as facegen flattens (N may
    be 0: a data row of a 2-D mesh that holds none of a batch's rows)."""

    def forward(self, x):
        return x.reshape(x.shape[0], math.prod(x.shape[1:]))


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
