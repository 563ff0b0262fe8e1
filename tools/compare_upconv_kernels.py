#!/usr/bin/env python3
"""Time the bf16 upsample-conv forward, dx and dW kernels of two source
trees against each other on one CUDA GPU.

    python3 tools/compare_upconv_kernels.py OLD_CSRC NEW_CSRC

Each argument is a directory holding upsample_conv.cu and
upsample_conv_bwd.cu (and the headers they include), e.g. the
facegen_torch/csrc of a parent commit unpacked beside the checkout. Both
are built with facegen_torch's nvcc flags into a temporary directory and
called through their C entry points at G32's forward shapes (N = 1024, 32,
16) and its dx and dW shapes (N = 32). Each kernel's time is device time:
a CUDA graph of 20 launches replayed between two CUDA events, so the
host's launch overhead does not count. The two trees are timed in
alternating turns (old, new, new, old, old, new), medians reported with
their spread, and each output is checked against the plain PyTorch
version (the bf16 tolerance of chip_smoke.py; dW within 1e-4 of the
largest entry). A tree's bf16 dW runs stream-K where it exports
facegen_upconv_dw_sizes (the WMMA dW before it took per-tile K splits).
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from facegen_torch.ops import _build
from facegen_torch.ops import upsample_conv as uc

FWD_SHAPES = [(n, h, cin, cout) for n in (1024, 32, 16)
              for h, cin, cout in ((8, 128, 256), (16, 256, 128))]
DX_SHAPES = [(32, 8, 128, 256), (32, 16, 256, 128)]
DW_SHAPES = DX_SHAPES
BF16_ATOL, BF16_RTOL = 2e-2, 2.0 ** -8
DW_TOL = 1e-4  # of the plain result's largest entry


def build(src_dir: str, name: str, out_dir: str) -> ctypes.CDLL:
    lib = os.path.join(out_dir, f"{name}.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           os.path.join(src_dir, f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src_dir}/{name}.cu:\n{proc.stderr[-3000:]}")
    return ctypes.CDLL(lib)


def bind(lib: ctypes.CDLL):
    fwd = lib.facegen_upconv_fwd_bf16 if hasattr(lib, "facegen_upconv_fwd_bf16") else None
    if fwd is not None:
        fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        return fwd
    fns = {"dx": lib.facegen_upconv_dx_bf16, "dw": lib.facegen_upconv_dw_bf16,
           "splits": lib.facegen_upconv_bwd_splits}
    # the stream-K dW takes its counters after the workspace, and no splits
    stream_k = hasattr(lib, "facegen_upconv_dw_sizes")
    fns["dx"].argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fns["dw"].argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 if stream_k else
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6) + [ctypes.c_void_p]
    fns["splits"].argtypes = [ctypes.c_int] * 7
    for f in fns.values():
        f.restype = ctypes.c_int
    if stream_k:
        fns["sizes"] = lib.facegen_upconv_dw_sizes
        fns["sizes"].argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)] * 2
        fns["sizes"].restype = None
    return fns


def graph_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(calls: dict, rounds: int = 3) -> dict:
    """Medians over rounds in alternating order: the calls in order, then
    reversed (old, new, new, old, old, new for two)."""
    names = list(calls)
    runs = {k: [] for k in names}
    for r in range(rounds):
        for k in names if r % 2 == 0 else names[::-1]:
            runs[k].append(graph_ms(calls[k]))
    return {k: {"ms": statistics.median(v), "runs": v} for k, v in runs.items()}


def dw_call(fns: dict, x, dy, n, h, cin, cout, stream):
    """A call of one tree's bf16 dW with its buffers: the WMMA kernel's
    per-tile K splits (the library's choice, splits x dWc of workspace), or
    stream-K (its workspace and counters)."""
    dwc = torch.empty(9 * cin, 4 * cout, device="cuda")
    if "sizes" not in fns:
        splits = fns["splits"](1, 1, n, h, h, cin, cout)
        ws = torch.empty(max(splits, 1), 9 * cin * 4 * cout, device="cuda")
        return dwc, lambda: fns["dw"](x.data_ptr(), dy.data_ptr(), dwc.data_ptr(), ws.data_ptr(),
                                      n, h, h, cin, cout, splits, stream())
    ws_n, counters_n = ctypes.c_longlong(), ctypes.c_longlong()
    fns["sizes"](n, h, h, cin, cout, ctypes.byref(ws_n), ctypes.byref(counters_n))
    ws = torch.empty(max(ws_n.value, 1), device="cuda")
    counters = torch.zeros(max(counters_n.value, 1), dtype=torch.int32, device="cuda")
    return dwc, lambda: fns["dw"](x.data_ptr(), dy.data_ptr(), dwc.data_ptr(), ws.data_ptr(),
                                  counters.data_ptr(), n, h, h, cin, cout, stream())


def check(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    err = (got.float() - ref).abs()
    if not bool((err <= BF16_ATOL + BF16_RTOL * ref.abs()).all()):
        raise SystemExit(f"{what}: disagrees with the plain version ({float(err.max())})")
    return float(err.max())


def main(argv: list[str]) -> int:
    if len(argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    trees = dict(zip(("old", "new"), argv))
    tmp = tempfile.mkdtemp(prefix="compare_upconv_")
    for k in trees:
        os.makedirs(os.path.join(tmp, k))
    jobs = [(k, name) for k in trees for name in ("upsample_conv", "upsample_conv_bwd")]
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc per source
        libs = list(pool.map(lambda j: build(trees[j[0]], j[1], os.path.join(tmp, j[0])), jobs))
    fns = {(k, name): bind(lib) for (k, name), lib in zip(jobs, libs)}
    print(f"device: {torch.cuda.get_device_name(0)}; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    for n, h, cin, cout in FWD_SHAPES:
        g = torch.Generator().manual_seed(7)
        x = torch.randn(n, h, h, cin, generator=g).cuda().bfloat16()
        w = (torch.randn(cout, cin, 5, 5, generator=g) / (25 * cin) ** 0.5).cuda().bfloat16()
        b = torch.randn(cout, generator=g).cuda().bfloat16()
        wc = uc.collapse_weights(w)
        ref = uc.upsample_conv_reference(x.float(), wc.float(), b.float())
        calls, errs = {}, {}
        for k in trees:
            out = torch.empty(n, 2 * h, 2 * h, cout, device="cuda", dtype=torch.bfloat16)
            f = fns[(k, "upsample_conv")]
            calls[k] = (lambda f=f, out=out: f(x.data_ptr(), wc.data_ptr(), b.data_ptr(),
                                                out.data_ptr(), n, h, h, cin, cout, stream()))
            if calls[k]():
                raise SystemExit(f"forward launch failed ({k})")
            torch.cuda.synchronize()
            errs[k] = check(out, ref, f"forward {k} {n, h, cin, cout}")
        t = compare(calls)
        print(json.dumps({"kernel": "upsample_conv_fwd", "shape": [n, h, cin, cout],
                          "max_abs_err": errs, **{k: v for k, v in t.items()}}))

    for n, h, cin, cout in DX_SHAPES:
        g = torch.Generator().manual_seed(7)
        dy = torch.randn(n, 2 * h, 2 * h, cout, generator=g).cuda().bfloat16()
        wc = (torch.randn(9 * cin, 4 * cout, generator=g) / (36 * cout) ** 0.5).cuda().bfloat16()
        ref = uc.upsample_conv_dx_reference(dy.float(), wc.float())
        calls, errs = {}, {}
        for k in trees:
            bwd = fns[(k, "upsample_conv_bwd")]
            f, splits = bwd["dx"], bwd["splits"](0, 1, n, h, h, cin, cout)
            dx = torch.empty(n, h, h, cin, device="cuda", dtype=torch.bfloat16)
            ws = torch.empty(splits, n * h * h * cin, device="cuda")
            calls[k] = (lambda f=f, dx=dx, ws=ws, s=splits: f(
                dy.data_ptr(), wc.data_ptr(), dx.data_ptr(), ws.data_ptr(), n, h, h, cin, cout,
                s, stream()))
            if calls[k]():
                raise SystemExit(f"dx launch failed ({k})")
            torch.cuda.synchronize()
            errs[k] = check(dx, ref, f"dx {k} {n, h, cin, cout}")
        t = compare(calls)
        print(json.dumps({"kernel": "upsample_conv_dx", "shape": [n, h, cin, cout],
                          "max_abs_err": errs, **{k: v for k, v in t.items()}}))

    for n, h, cin, cout in DW_SHAPES:
        g = torch.Generator().manual_seed(7)
        x = torch.randn(n, h, h, cin, generator=g).cuda().bfloat16()
        dy = torch.randn(n, 2 * h, 2 * h, cout, generator=g).cuda().bfloat16()
        ref = uc.upsample_conv_dw_reference(x.float(), dy.float())
        calls, errs = {}, {}
        for k in trees:
            dwc, calls[k] = dw_call(fns[(k, "upsample_conv_bwd")], x, dy, n, h, cin, cout, stream)
            if calls[k]():
                raise SystemExit(f"dW launch failed ({k})")
            torch.cuda.synchronize()
            errs[k] = float((dwc - ref).abs().max())
            if errs[k] > DW_TOL * float(ref.abs().max()):
                raise SystemExit(f"dW {k} {n, h, cin, cout}: disagrees with the plain "
                                 f"version ({errs[k]})")
        t = compare(calls)
        print(json.dumps({"kernel": "upsample_conv_dw", "shape": [n, h, cin, cout],
                          "max_abs_err": errs, **t}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
