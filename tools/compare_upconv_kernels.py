#!/usr/bin/env python3
"""Time the bf16 upsample-conv forward and dx kernels of two source trees
against each other on one CUDA GPU.

    python3 tools/compare_upconv_kernels.py OLD_CSRC NEW_CSRC

Each argument is a directory holding upsample_conv.cu and
upsample_conv_bwd.cu (and the headers they include), e.g. the
facegen_torch/csrc of a parent commit unpacked beside the checkout. Both
are built with facegen_torch's nvcc flags into a temporary directory and
called through their C entry points at G32's forward shapes (N = 1024, 32,
16) and dx shapes (N = 32). Each kernel's time is device time: a CUDA
graph of 20 launches replayed between two CUDA events, so the host's
launch overhead does not count. The two trees are timed in alternating
turns (old, new, new, old, old, new), medians reported with their spread,
and each output is checked against the plain PyTorch version (bf16
tolerance of chip_smoke.py). Prints one JSON object per shape.
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
BF16_ATOL, BF16_RTOL = 2e-2, 2.0 ** -8


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
    dx = lib.facegen_upconv_dx_bf16
    dx.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    dx.restype = ctypes.c_int
    splits = lib.facegen_upconv_bwd_splits
    splits.argtypes = [ctypes.c_int] * 7
    splits.restype = ctypes.c_int
    return dx, splits


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


def compare(calls: dict, turns=("old", "new", "new", "old", "old", "new")) -> dict:
    runs = {k: [] for k in calls}
    for k in turns:
        runs[k].append(graph_ms(calls[k]))
    return {k: {"ms": statistics.median(v), "runs": v} for k, v in runs.items()}


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
            f, splits_fn = fns[(k, "upsample_conv_bwd")]
            splits = splits_fn(0, 1, n, h, h, cin, cout)
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
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
