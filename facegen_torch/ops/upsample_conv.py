"""Fused nearest-upsample(2x) + KxK same-pad conv: G's pyramid op.

Counterpart of facegen/ops/upsample_conv.py. Every 2x2 output block
reads the same input pixels, so for K = 3 or 5 the op collapses into one
3x3 same-pad conv at input resolution with 4*Cout output channels (phase
block p = 2a+b holds output parity (a, b)), followed by a depth-to-space
interleave: 36 % of the naive upsample-then-5x5 FLOPs and no upsampled
intermediate.

Layouts: activations are NHWC; the conv weight is torch's OIHW
(Cout, Cin, K, K); the collapsed weight ``wc`` is the GEMM matrix
(9*Cin, 4*Cout) with rows ordered (u, v, cin) and columns (a, b, cout),
which is JAX's collapsed HWIO kernel (3, 3, Cin, 4*Cout) flattened.

``upsample_conv`` runs the hand-written CUDA kernel
(csrc/upsample_conv.cu) on CUDA tensors and its plain PyTorch version,
``upsample_conv_reference``, on CPU tensors. It never falls back from
one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from facegen_torch.ops import _build

# Launches of the CUDA kernel in this process. Incremented only where
# the kernel is launched, so a run can show it went through the kernel.
KERNEL_LAUNCHES = 0

_KERNEL_FNS = {
    torch.bfloat16: "facegen_upconv_fwd_bf16",
    torch.float32: "facegen_upconv_fwd_f32",
}


@functools.lru_cache(maxsize=None)
def _collapse_matrix(kernel: int) -> np.ndarray:
    """C[a, k, u]: tap k of the upsampled-domain kernel for output phase
    a lands on collapsed offset u - 1 (facegen/ops/upsample_conv.py:36)."""
    if kernel % 2 != 1:
        raise ValueError(f"odd kernels only, got {kernel}")
    pad = (kernel - 1) // 2
    offsets = {(a, k): (a + k - pad) // 2 for a in range(2) for k in range(kernel)}
    umin, umax = min(offsets.values()), max(offsets.values())
    if (umin, umax) != (-1, 1):
        raise ValueError(
            f"a {kernel}x{kernel} kernel collapses to offsets {umin}..{umax}; "
            f"only the 3x3 footprint (K = 3 or 5) is supported"
        )
    c = np.zeros((2, kernel, 3), np.float32)
    for (a, k), u in offsets.items():
        c[a, k, u + 1] = 1.0
    return c


def collapse_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, K, K) -> the collapsed GEMM weight (9*Cin, 4*Cout),
    summed in fp32 and returned in w's dtype."""
    cout, cin, k, _ = w.shape
    c = torch.from_numpy(_collapse_matrix(k)).to(w.device)
    # wc[u, v, i, a, b, o] = sum_{ky,kx} C[a,ky,u] C[b,kx,v] w[o,i,ky,kx]
    wc = torch.einsum("aku,blv,oikl->uviabo", c, c, w.float())
    return wc.reshape(9 * cin, 4 * cout).to(w.dtype)


def depth_to_space(y: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(N, H, W, f*f*C) with phase-major blocks -> (N, fH, fW, C)."""
    n, h, w, fc = y.shape
    c = fc // (factor * factor)
    y = y.reshape(n, h, w, factor, factor, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h * factor, w * factor, c)


def upsample_conv_reference(x: torch.Tensor, wc: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the phase conv (F.conv2d with
    the collapsed 3x3 kernel), then depth-to-space, then the bias. Equals
    facegen.ops.upsample_conv.upsample_conv.

    x: (N, H, W, Cin); wc: (9*Cin, 4*Cout); b: (Cout,).
    Returns (N, 2H, 2W, Cout).
    """
    cin = x.shape[-1]
    kernel = wc.reshape(3, 3, cin, wc.shape[1]).permute(3, 2, 0, 1)  # OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=1)
    return depth_to_space(y.permute(0, 2, 3, 1)) + b


def upsample_conv(x: torch.Tensor, wc: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused nearest-up(2) + same-pad conv from the collapsed weight.

    A CUDA tensor goes through the CUDA kernel or raises; a CPU tensor
    takes ``upsample_conv_reference``. Shapes as there.
    """
    if x.device.type == "cpu":
        return upsample_conv_reference(x, wc, b)
    if x.device.type != "cuda":
        raise ValueError(f"upsample_conv: no kernel for device {x.device}")
    return _launch(x, wc, b)


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(_build.load("upsample_conv"), _KERNEL_FNS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, wc: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4 or wc.dim() != 2 or b.dim() != 1:
        raise ValueError(
            f"upsample_conv: want x (N,H,W,Cin), wc (9*Cin,4*Cout), b (Cout,); "
            f"got {tuple(x.shape)}, {tuple(wc.shape)}, {tuple(b.shape)}"
        )
    if x.dtype not in _KERNEL_FNS or wc.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(
            f"upsample_conv kernel takes bf16 or fp32, all alike; got "
            f"x {x.dtype}, wc {wc.dtype}, b {b.dtype}"
        )
    if wc.device != x.device or b.device != x.device:
        raise ValueError(
            f"upsample_conv: tensors on {x.device}, {wc.device}, {b.device}"
        )
    n, h, w, cin = x.shape
    cout = b.shape[0]
    if cin % 8 or cout % 8:
        raise ValueError(f"upsample_conv kernel needs Cin, Cout % 8 == 0; got {cin}, {cout}")
    if tuple(wc.shape) != (9 * cin, 4 * cout):
        raise ValueError(
            f"upsample_conv: wc shape {tuple(wc.shape)} != {(9 * cin, 4 * cout)}"
        )
    if max(x.numel(), 4 * n * h * w * cout) >= 2**31:
        raise ValueError("upsample_conv kernel: tensors of 2^31 elements or more")
    for name, t in (("x", x), ("wc", wc), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"upsample_conv kernel: {name} is not contiguous")
    for name, t in (("x", x), ("wc", wc)):  # read with 16-byte vector loads
        if t.data_ptr() % 16:
            raise ValueError(f"upsample_conv kernel: {name} is not 16-byte aligned")


def _launch(x: torch.Tensor, wc: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    global KERNEL_LAUNCHES
    _check(x, wc, b)
    n, h, w, cin = x.shape
    cout = b.shape[0]
    out = torch.empty((n, 2 * h, 2 * w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _kernel(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), wc.data_ptr(), b.data_ptr(), out.data_ptr(),
                 n, h, w, cin, cout, stream)
    if err:
        raise RuntimeError(f"upsample_conv CUDA kernel launch failed: cudaError {err}")
    KERNEL_LAUNCHES += 1
    return out
