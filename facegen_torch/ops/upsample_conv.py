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
``upsample_conv_reference``, on CPU tensors. Its two gradients,
``upsample_conv_dx`` and ``upsample_conv_dw``, do the same with the
kernels of csrc/upsample_conv_bwd.cu; ``UpsampleConvFunction`` joins the
three for autograd. None of them falls back from a kernel to its plain
version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from facegen_torch.ops import _build

# Launches of each CUDA kernel in this process (forward, input gradient,
# weight gradient). Incremented only where the kernel is launched, so a
# run can show it went through the kernels. A launch captured into a CUDA
# graph runs on every replay: train/graph.py takes back what its capture
# counted and adds it on each replay, so under a graph the counts are
# derived from the capture, not observed at launch; the graph's parity with
# eager steps is what shows that the replayed kernels ran.
KERNEL_LAUNCHES = 0
DX_LAUNCHES = 0
DW_LAUNCHES = 0

_KERNEL_FNS = {
    torch.bfloat16: "facegen_upconv_fwd_bf16",
    torch.float32: "facegen_upconv_fwd_f32",
}
_BWD_FNS = {
    ("dx", torch.bfloat16): "facegen_upconv_dx_bf16",
    ("dx", torch.float32): "facegen_upconv_dx_f32",
    ("dw", torch.bfloat16): "facegen_upconv_dw_bf16",
    ("dw", torch.float32): "facegen_upconv_dw_f32",
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


@functools.lru_cache(maxsize=None)
def _collapse_tensor(kernel: int, device: torch.device) -> torch.Tensor:
    """``_collapse_matrix`` on ``device``, copied there once: a copy from
    the host inside a CUDA graph's capture would fail."""
    return torch.from_numpy(_collapse_matrix(kernel)).to(device)


def collapse_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, K, K) -> the collapsed GEMM weight (9*Cin, 4*Cout),
    summed in fp32 and returned in w's dtype."""
    cout, cin, k, _ = w.shape
    c = _collapse_tensor(k, w.device)
    # wc[u, v, i, a, b, o] = sum_{ky,kx} C[a,ky,u] C[b,kx,v] w[o,i,ky,kx]
    wc = torch.einsum("aku,blv,oikl->uviabo", c, c, w.float())
    return wc.reshape(9 * cin, 4 * cout).to(w.dtype)


def depth_to_space(y: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(N, H, W, f*f*C) with phase-major blocks -> (N, fH, fW, C)."""
    n, h, w, fc = y.shape
    c = fc // (factor * factor)
    y = y.reshape(n, h, w, factor, factor, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h * factor, w * factor, c)


def space_to_depth(y: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Inverse of depth_to_space: (N, fH, fW, C) -> (N, H, W, f*f*C)."""
    n, fh, fw, c = y.shape
    y = y.reshape(n, fh // factor, factor, fw // factor, factor, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, fh // factor, fw // factor, factor * factor * c)


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


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32, or fp64 for fp64 inputs (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def upsample_conv_dx_reference(dy: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the input-gradient kernel, as
    upsample_conv_dx_pallas computes it: S2D(dy), then a 3x3 same-pad
    F.conv2d with the collapsed kernel flipped in space and with its
    in/out channels swapped.

    dy: (N, 2H, 2W, Cout); wc: (9*Cin, 4*Cout). Returns (N, H, W, Cin)
    in dy's dtype.
    """
    cin = wc.shape[0] // 9
    dyc = space_to_depth(dy)                                 # (N, H, W, 4*Cout)
    wt = wc.reshape(3, 3, cin, wc.shape[1]).flip(0, 1).permute(2, 3, 0, 1)  # (Cin, 4Co, 3, 3)
    dx = F.conv2d(dyc.permute(0, 3, 1, 2), wt, padding=1)
    return dx.permute(0, 2, 3, 1)


def upsample_conv_dw_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the weight-gradient kernel: the nine
    x_pad[:, u:, v:]^T @ S2D(dy) products of _dw_kernel on the unfolded
    x, in fp32 (fp64 for fp64 inputs).

    x: (N, H, W, Cin); dy: (N, 2H, 2W, Cout). Returns dWc (9*Cin, 4*Cout).
    """
    n, h, w, cin = x.shape
    acc = _acc_dtype(x.dtype)
    dyc = space_to_depth(dy).reshape(n * h * w, -1).to(acc)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).to(acc)
    taps = [xp[:, u:u + h, v:v + w, :].reshape(n * h * w, cin).T @ dyc
            for u in range(3) for v in range(3)]
    return torch.cat(taps)


def upsample_conv_dx(dy: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """Input gradient of ``upsample_conv`` with respect to x.

    A CUDA tensor goes through the CUDA kernel or raises; a CPU tensor
    takes ``upsample_conv_dx_reference``. Shapes as there.
    """
    if dy.device.type == "cpu":
        return upsample_conv_dx_reference(dy, wc)
    if dy.device.type != "cuda":
        raise ValueError(f"upsample_conv_dx: no kernel for device {dy.device}")
    return _launch_bwd("dx", dy, wc)


def upsample_conv_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Gradient of ``upsample_conv`` with respect to the collapsed weight,
    dWc (9*Cin, 4*Cout) in fp32.

    A CUDA tensor goes through the CUDA kernel or raises; a CPU tensor
    takes ``upsample_conv_dw_reference``. Shapes as there.
    """
    if x.device.type == "cpu":
        return upsample_conv_dw_reference(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"upsample_conv_dw: no kernel for device {x.device}")
    return _launch_bwd("dw", x, dy)


class UpsampleConvFunction(torch.autograd.Function):
    """``upsample_conv(x, wc, b)`` with its gradients from the kernels:
    dx from ``upsample_conv_dx``, dWc from ``upsample_conv_dw`` (cast to
    wc's dtype) and db = dy summed over (N, H, W) in fp32. dx is computed
    only when x needs it (G's first upsample-conv takes the fc output,
    which does; a leaf input would not)."""

    @staticmethod
    def forward(ctx, x, wc, b):
        ctx.save_for_backward(x, wc)
        return upsample_conv(x, wc, b)

    @staticmethod
    def backward(ctx, dy):
        x, wc = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dwc = db = None
        if ctx.needs_input_grad[0]:
            dx = upsample_conv_dx(dy, wc)
        if ctx.needs_input_grad[1]:
            dwc = upsample_conv_dw(x, dy).to(wc.dtype)
        if ctx.needs_input_grad[2]:
            db = dy.sum((0, 1, 2), dtype=_acc_dtype(dy.dtype)).to(dy.dtype)
        return dx, dwc, db


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


@functools.lru_cache(maxsize=None)
def _bwd_kernel(which: str, dtype: torch.dtype):
    lib = _build.load("upsample_conv_bwd")
    fn = getattr(lib, _BWD_FNS[(which, dtype)])
    # the bf16 dW takes its stream-K counters after the workspace, and no splits
    if (which, dtype) == ("dw", torch.bfloat16):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    splits = lib.facegen_upconv_bwd_splits
    splits.argtypes = [ctypes.c_int] * 7
    splits.restype = ctypes.c_int
    return fn, splits


@functools.lru_cache(maxsize=None)
def _dw_sizes():
    fn = _build.load("upsample_conv_bwd").facegen_upconv_dw_sizes
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)] * 2
    fn.restype = None
    return fn


# The bf16 dW's stream-K counters, one buffer per device: zeroed once, and
# left zero by every launch. The launches on a device share it, so they
# must not overlap: the port issues them on the current stream, in order.
# A buffer outgrown by a larger shape is kept alive, never freed: a CUDA
# graph captured before still counts in it.
_DW_COUNTERS: dict[int, torch.Tensor] = {}
_DW_COUNTERS_OUTGROWN: list[torch.Tensor] = []


def _dw_counters(device: torch.device, count: int) -> torch.Tensor:
    counters = _DW_COUNTERS.get(device.index)
    if counters is None or counters.numel() < count:
        if counters is not None:
            _DW_COUNTERS_OUTGROWN.append(counters)
        counters = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _DW_COUNTERS[device.index] = counters
    return counters


def _check_bwd(which: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """dx: a = dy (N, 2H, 2W, Cout), b = wc (9*Cin, 4*Cout);
    dw: a = x (N, H, W, Cin), b = dy (N, 2H, 2W, Cout)."""
    name = f"upsample_conv_{which}"
    if a.dim() != 4 or b.dim() != (2 if which == "dx" else 4):
        raise ValueError(f"{name}: bad ranks {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype not in _KERNEL_FNS or b.dtype != a.dtype:
        raise TypeError(f"{name} kernel takes bf16 or fp32, both alike; got {a.dtype}, {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"{name}: tensors on {a.device}, {b.device}")
    if which == "dx":
        n, h2, w2, cout = a.shape
        cin = b.shape[0] // 9
        if tuple(b.shape) != (9 * cin, 4 * cout):
            raise ValueError(f"{name}: wc shape {tuple(b.shape)} does not fit dy's Cout {cout}")
    else:
        n, h, w, cin = a.shape
        h2, w2, cout = b.shape[1:]
        if b.shape[0] != n or (h2, w2) != (2 * h, 2 * w):
            raise ValueError(f"{name}: dy {tuple(b.shape)} is not the output of x {tuple(a.shape)}")
    if h2 % 2 or w2 % 2:
        raise ValueError(f"{name}: dy's spatial size {(h2, w2)} is odd")
    if cin % 8 or cout % 8:
        raise ValueError(f"{name} kernel needs Cin, Cout % 8 == 0; got {cin}, {cout}")
    if max(a.numel(), b.numel(), 36 * cin * cout) >= 2**31:
        raise ValueError(f"{name} kernel: tensors of 2^31 elements or more")
    for t in (a, b):
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: an input is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: an input is not 16-byte aligned")


def _launch_bwd(which: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the dx kernel (a = dy, b = wc) or the dW kernel (a = x,
    b = dy). The wrapper allocates the output and, when the kernel splits
    K, its fp32 workspace of splits x the output; the bf16 dW's stream-K
    workspace and counters have the sizes its library gives."""
    global DX_LAUNCHES, DW_LAUNCHES
    _check_bwd(which, a, b)
    if which == "dx":
        n, h2, w2, cout = a.shape
        h, w, cin = h2 // 2, w2 // 2, b.shape[0] // 9
        out = torch.empty((n, h, w, cin), dtype=a.dtype, device=a.device)
    else:
        n, h, w, cin = a.shape
        cout = b.shape[-1]
        out = torch.empty((9 * cin, 4 * cout), dtype=torch.float32, device=a.device)
    if n * h * w == 0:
        return out.zero_()
    fn, splits_fn = _bwd_kernel(which, a.dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if which == "dw" and a.dtype == torch.bfloat16:
            ws_n, counters_n = ctypes.c_longlong(), ctypes.c_longlong()
            _dw_sizes()(n, h, w, cin, cout, ctypes.byref(ws_n), ctypes.byref(counters_n))
            ws = torch.empty(ws_n.value, dtype=torch.float32, device=a.device)
            counters = _dw_counters(a.device, counters_n.value)
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(),
                     counters.data_ptr(), n, h, w, cin, cout, stream)
        else:
            splits = splits_fn(0 if which == "dx" else 1, int(a.dtype == torch.bfloat16),
                               n, h, w, cin, cout)
            ws = (torch.empty((splits,) + tuple(out.shape), dtype=torch.float32,
                              device=a.device) if splits > 1 else None)
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                     ws.data_ptr() if ws is not None else None,
                     n, h, w, cin, cout, splits, stream)
    if err:
        raise RuntimeError(f"upsample_conv_{which} CUDA kernel launch failed: cudaError {err}")
    if which == "dx":
        DX_LAUNCHES += 1
    else:
        DW_LAUNCHES += 1
    return out
