"""G's batch norm and the PReLU after it as one kernel family
(csrc/bn_prelu.cu) and its plain version.

``forward`` normalises channels-last activations by the batch's
statistics (train: and moves the running ones in place) or by the
running statistics (eval), scales and shifts, and applies the PReLU with
one shared slope, rounding as ``BatchNorm`` then ``PReLU``
(nn/layers.py) do: z in fp32, rounded to the activation type, then the
PReLU in that type. ``backward`` returns the gradients of the input, the
batch norm's weight and bias, and the slope. ``BatchNormPReLUFunction``
joins the two for autograd, saving the input in its own type and the
per-channel statistics (not an fp32 copy of the normalised input).
``nn/layers.py:Sequential`` runs every batch norm that is directly
followed by a PReLU through ``bn_prelu`` on a CUDA tensor.

No Pallas kernel stands behind it: facegen leaves the pair to XLA's
fusion of facegen/nn/layers.py's batch_norm and prelu.

A CPU tensor takes the plain version, ``forward_reference`` /
``backward_reference``: the same formulas in torch ops. A CUDA tensor
launches the kernels or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from facegen_torch.ops import _build

# Launches of the four kernels in this process: a train-mode forward is 2
# (statistics, apply), an eval-mode forward 1, a backward 2 (reduction,
# dx). Under a CUDA graph, train/graph.py adds the capture's count on each
# replay, as for the other kernels' counters.
BN_PRELU_LAUNCHES = 0

_DTYPES = {torch.bfloat16: 1, torch.float32: 0}
_VEC = {torch.bfloat16: 8, torch.float32: 4}  # channels a 16-byte load holds


# ------------------------------------------------------------ plain versions
def _running_update(running_mean, running_var, mean, var, n: int, momentum: float) -> None:
    """(1 - m) old + m batch, with the variance scaled by n / (n - 1)."""
    with torch.no_grad():
        unbiased = n / max(n - 1, 1)
        running_mean.copy_((1 - momentum) * running_mean + momentum * mean)
        running_var.copy_((1 - momentum) * running_var + momentum * (var * unbiased))


def _z(xf, mean, rstd, weight, bias, dtype):
    return ((xf - mean) * (rstd * weight) + bias).to(dtype)


def forward_reference(x, weight, bias, slope, running_mean, running_var, training: bool,
                      eps: float, momentum: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, scale): the output, and the statistics the backward reads:
    train, the batch's mean and rstd (the running ones moved); eval, the
    running mean and variance."""
    xf = x.float()
    if training:
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dims)
        var = xf.var(dims, unbiased=False)
        _running_update(running_mean, running_var, mean, var, x.numel() // x.shape[-1],
                        momentum)
        scale = torch.rsqrt(var + eps)
        rstd = scale
    else:
        mean, scale = running_mean, running_var
        rstd = torch.rsqrt(scale + eps)
    z = _z(xf, mean, rstd, weight, bias, x.dtype)
    a = slope.to(x.dtype)
    return torch.where(z > 0, z, a * z), mean, scale


def backward_reference(dy, x, mean, scale, training: bool, eps: float, weight, bias, slope
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, d weight, d bias, d slope) for ``forward_reference``'s output
    gradient ``dy``, from its saved ``mean`` and ``scale``."""
    dims = tuple(range(x.dim() - 1))
    xf = x.float()
    rstd = scale if training else torch.rsqrt(scale + eps)
    z = _z(xf, mean, rstd, weight, bias, x.dtype)
    a = slope.to(x.dtype)
    pos = z > 0
    dz = torch.where(pos, dy, a * dy)  # PReLU's backward, in the activation type
    dslope = torch.where(pos, torch.zeros_like(z), z * dy).sum().float().reshape(1)
    dzf = dz.float()
    xhat = (xf - mean) * rstd
    dbias = dzf.sum(dims)
    dweight = (dzf * xhat).sum(dims)
    if training:
        n = x.numel() // x.shape[-1]
        dx = (weight * rstd / n) * (n * dzf - dbias - xhat * dweight)
    else:
        dx = dzf * (rstd * weight)
    return dx.to(x.dtype), dweight, dbias, dslope


# ------------------------------------------------------------------ wrappers
def forward(x, weight, bias, slope, running_mean, running_var, training: bool, eps: float,
            momentum: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``forward_reference``'s result; on CUDA tensors two launches in
    train mode, one in eval."""
    if x.device.type == "cpu":
        return forward_reference(x, weight, bias, slope, running_mean, running_var, training,
                                 eps, momentum)
    if x.device.type != "cuda":
        raise ValueError(f"bn_prelu: no kernel for device {x.device}")
    return _launch_forward(x, weight, bias, slope, running_mean, running_var, training, eps,
                           momentum)


def backward(dy, x, mean, scale, training: bool, eps: float, weight, bias, slope
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``backward_reference``'s result; on CUDA tensors two launches."""
    if x.device.type == "cpu":
        return backward_reference(dy, x, mean, scale, training, eps, weight, bias, slope)
    if x.device.type != "cuda":
        raise ValueError(f"bn_prelu: no kernel for device {x.device}")
    return _launch_backward(dy, x, mean, scale, training, eps, weight, bias, slope)


class BatchNormPReLUFunction(torch.autograd.Function):
    """``forward`` with ``backward`` as its gradient: of the input, the
    weight, the bias and the slope. Saves the input and the per-channel
    statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, slope, running_mean, running_var, training, eps,
                momentum):
        y, mean, scale = forward(x, weight, bias, slope, running_mean, running_var, training,
                                 eps, momentum)
        ctx.save_for_backward(x, mean, scale, weight, bias, slope)
        ctx.training, ctx.eps = training, eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, scale, weight, bias, slope = ctx.saved_tensors
        dx, dweight, dbias, dslope = backward(dy, x, mean, scale, ctx.training,
                                              ctx.eps, weight, bias, slope)
        return dx, dweight, dbias, dslope, None, None, None, None, None


def bn_prelu(x, weight, bias, slope, running_mean, running_var, training: bool, eps: float,
             momentum: float) -> torch.Tensor:
    """``PReLU(slope)(BatchNorm(x))`` for channels-last ``x``: through
    ``BatchNormPReLUFunction`` where a gradient is needed, else the
    forward alone (nothing saved; in train mode the running statistics
    still move)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias, slope)):
        return BatchNormPReLUFunction.apply(x, weight, bias, slope, running_mean, running_var,
                                            training, eps, momentum)
    return forward(x, weight, bias, slope, running_mean, running_var, training, eps,
                   momentum)[0]


# ------------------------------------------------------------------- checks
def check(x: torch.Tensor, *channel_tensors: torch.Tensor, slope: torch.Tensor) -> None:
    """Raise unless the kernels take ``x`` (bf16 or fp32, contiguous, a
    channel count that divides the block and fills 16-byte loads, at least
    one row) with fp32 per-channel tensors of its channel count and a
    one-entry fp32 slope, all contiguous on its device."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"bn_prelu: {x.dtype} activations; the kernels take bf16 and fp32")
    c = x.shape[-1]
    widest = _lib().facegen_bn_prelu_max_channels()
    if c % _VEC[x.dtype] or widest % c:
        raise ValueError(f"bn_prelu: {c} channels; the kernels take a divisor of {widest} "
                         f"that is a multiple of {_VEC[x.dtype]} for {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"bn_prelu: an empty input {tuple(x.shape)}")
    for t in (x,) + channel_tensors + (slope,):
        if t.device != x.device:
            raise ValueError(f"bn_prelu: a tensor on {t.device}, not {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"bn_prelu: a non-contiguous tensor {tuple(t.shape)}")
    for t in channel_tensors:
        if t.dtype != torch.float32 or t.numel() != c:
            raise ValueError(f"bn_prelu: a per-channel tensor {t.dtype} {tuple(t.shape)}; "
                             f"want fp32 of {c}")
    if slope.dtype != torch.float32 or slope.numel() != 1:
        raise ValueError(f"bn_prelu: the slope {slope.dtype} {tuple(slope.shape)}; want fp32 of 1")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels' vector
    loads), copied where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ------------------------------------------------------------------ launches
@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("bn_prelu")
    vp, f, i, ll = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong
    lib.facegen_bn_prelu_forward.argtypes = [i, i, vp, vp, ll, i, f, f, f, f, vp, vp, vp, vp, vp,
                                             vp, vp, vp, vp]
    lib.facegen_bn_prelu_backward.argtypes = [i, i, vp, vp, vp, ll, i, f, vp, vp, vp, vp, vp, vp,
                                              vp, vp, vp, vp, vp]
    lib.facegen_bn_prelu_partials.argtypes = [i]
    lib.facegen_bn_prelu_partials.restype = ll
    for fn in (lib.facegen_bn_prelu_forward, lib.facegen_bn_prelu_backward,
               lib.facegen_bn_prelu_max_channels):
        fn.restype = i
    return lib


# Per device: the reducing kernels' partials (sized for the widest C) and
# their tickets (int32, zeroed once, left zero by every launch). Launches
# on a device share them, so they must not overlap: the port issues them
# on the current stream, in order. Never freed: a captured graph writes them.
_WORKSPACE: dict = {}


def _workspace(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    ws = _WORKSPACE.get(device.index)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("bn_prelu: its workspace would be allocated inside a CUDA graph's "
                               "capture; run one step eagerly first (train/graph.py warms up)")
        lib = _lib()
        floats = lib.facegen_bn_prelu_partials(lib.facegen_bn_prelu_max_channels())
        ws = _WORKSPACE[device.index] = (torch.empty(floats, device=device),
                                         torch.zeros(2, dtype=torch.int32, device=device))
    return ws


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_forward(x, weight, bias, slope, running_mean, running_var, training, eps, momentum):
    global BN_PRELU_LAUNCHES
    x = _aligned(x)
    check(x, weight, bias, running_mean, running_var, slope=slope)
    rows, c = x.numel() // x.shape[-1], x.shape[-1]
    y = torch.empty_like(x)
    stat = torch.empty(2 * c, device=x.device) if training else None
    partials, tickets = _workspace(x.device) if training else (None, None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().facegen_bn_prelu_forward(
            _DTYPES[x.dtype], int(training), x.data_ptr(), y.data_ptr(), rows, c, eps, momentum,
            1 - momentum, rows / max(rows - 1, 1), weight.data_ptr(), bias.data_ptr(),
            slope.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(), _ptr(stat),
            _ptr(partials), _ptr(tickets), stream)
    if err:
        raise RuntimeError(f"bn_prelu forward CUDA kernel launch failed: cudaError {err}")
    BN_PRELU_LAUNCHES += 2 if training else 1
    if training:
        return y, stat[:c], stat[c:]
    return y, running_mean, running_var


def _launch_backward(dy, x, mean, scale, training, eps, weight, bias, slope):
    global BN_PRELU_LAUNCHES
    x, dy = _aligned(x), _aligned(dy)
    check(x, mean, scale, weight, bias, slope=slope)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"bn_prelu: the gradient {dy.dtype} {tuple(dy.shape)} on {dy.device} "
                         f"for the input {x.dtype} {tuple(x.shape)}")
    rows, c = x.numel() // x.shape[-1], x.shape[-1]
    dx = torch.empty_like(x)
    dweight, dbias = torch.empty(c, device=x.device), torch.empty(c, device=x.device)
    dslope = torch.empty(1, device=x.device)
    partials, tickets = _workspace(x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().facegen_bn_prelu_backward(
            _DTYPES[x.dtype], int(training), x.data_ptr(), dy.data_ptr(), dx.data_ptr(), rows, c,
            eps, mean.data_ptr(), scale.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            slope.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), dslope.data_ptr(),
            partials.data_ptr(), tickets.data_ptr() + 4, stream)
    if err:
        raise RuntimeError(f"bn_prelu backward CUDA kernel launch failed: cudaError {err}")
    BN_PRELU_LAUNCHES += 2
    return dx, dweight, dbias, dslope
