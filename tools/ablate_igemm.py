#!/usr/bin/env python3
"""Where the time of the wgmma mainloop (facegen_torch/csrc/igemm_sm90.cuh)
goes: build copies of the bf16 forward, dx and dW with parts switched off
and time them against the whole kernel on one CUDA GPU.

    python3 tools/ablate_igemm.py

Each variant edits a copy of facegen_torch/csrc in a temporary directory
(the checkout is not touched) and fails loudly if an edit no longer
matches the source:

- full: the kernel as it is;
- no_epilogue: no stores to shared or global memory after the mainloop;
- no_mma: no wgmma (the loads, barriers and epilogue run);
- no_a / no_b: one operand not loaded (the stage keeps stale data);
- no_loads: neither operand loaded: the mainloop's products and barriers;
- no_loads_no_epilogue: the products and barriers alone;
- no_fixup: dW's stream-K pieces skip the workspace, the counter and the
  sum, and store through the plain epilogue (the same as full for the
  forward and dx).

Only "full" computes the right result; the others measure. Times are
device time (a CUDA graph of 20 launches between CUDA events), medians of
3 turns in alternating order, at G32's shapes where the kernels lose to
cuDNN (forward N = 1024, dx upconv2 N = 32) and the other layer, and dW
at both training shapes (N = 32).
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from facegen_torch.ops import _build
from facegen_torch.ops import upsample_conv as uc

LOADS = """            mbar_arrive_expect_tx(full(s), A_BYTES + p.b_bytes(w.n0));
            p.load_a(&a_map, a_dst, full(s), ks, w.m0);
            p.load_b(&b_map, a_dst + A_BYTES, full(s), ks, w.n0);"""
NO_A = (LOADS, """            mbar_arrive_expect_tx(full(s), p.b_bytes(w.n0));
            p.load_b(&b_map, a_dst + A_BYTES, full(s), ks, w.n0);""")
NO_B = (LOADS, """            mbar_arrive_expect_tx(full(s), A_BYTES);
            p.load_a(&a_map, a_dst, full(s), ks, w.m0);""")
NO_LOADS = (LOADS, "            mbar_arrive_expect_tx(full(s), 0);")
NO_MMA = ("wgmma_tile<BN, P::TRANS_A, P::TRANS_B>(acc, da, db);", "")
NO_FIXUP = ("!fixup<BN>(p, w, acc, wg, t, reinterpret_cast<volatile int*>(roff))", "false")
OFF = "p.m == -12345"  # false at run time, opaque to the compiler
NO_EPILOGUE = [
    ("*reinterpret_cast<typename P::Stage2*>(tile + r * C::OUT_LD + c) =",
     f"if ({OFF}) *reinterpret_cast<typename P::Stage2*>(tile + r * C::OUT_LD + c) ="),
    ("      if (t < 64) {\n        const int row = w.m0 + wg * 64 + t;",
     f"      if (t < 64 && {OFF}) {{\n        const int row = w.m0 + wg * 64 + t;"),
    ("      if (col < p.n) {\n        const long long coff",
     f"      if (col < p.n && {OFF}) {{\n        const long long coff"),
]
VARIANTS = {
    "full": [],
    "no_epilogue": NO_EPILOGUE,
    "no_mma": [NO_MMA],
    "no_a": [NO_A],
    "no_b": [NO_B],
    "no_loads": [NO_LOADS],
    "no_loads_no_epilogue": [NO_LOADS] + NO_EPILOGUE,
    "no_fixup": [NO_FIXUP],
}
FWD_SHAPES = [(1024, 8, 128, 256), (1024, 16, 256, 128)]
DX_SHAPES = [(32, 8, 128, 256), (32, 16, 256, 128)]


def build(name: str, edits: list) -> dict:
    d = tempfile.mkdtemp(prefix=f"ablate_{name}_")
    for f in os.listdir(_build.CSRC_DIR):
        shutil.copy(_build.CSRC_DIR / f, d)
    header = os.path.join(d, "igemm_sm90.cuh")
    src = open(header).read()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: the edit no longer matches igemm_sm90.cuh:\n{old}")
        src = src.replace(old, new)
    open(header, "w").write(src)
    libs = {}
    for source in ("upsample_conv", "upsample_conv_bwd"):
        lib = os.path.join(d, f"{source}.so")
        proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                               os.path.join(d, f"{source}.cu")], capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{proc.stderr[-3000:]}")
        libs[source] = ctypes.CDLL(lib)
    fwd = libs["upsample_conv"].facegen_upconv_fwd_bf16
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    dx = libs["upsample_conv_bwd"].facegen_upconv_dx_bf16
    dx.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    splits = libs["upsample_conv_bwd"].facegen_upconv_bwd_splits
    splits.argtypes = [ctypes.c_int] * 7
    dw = libs["upsample_conv_bwd"].facegen_upconv_dw_bf16
    dw.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    sizes = libs["upsample_conv_bwd"].facegen_upconv_dw_sizes
    sizes.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)] * 2
    sizes.restype = None
    return {"fwd": fwd, "dx": dx, "splits": splits, "dw": dw, "sizes": sizes}


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


def report(kernel, shape, calls, flop):
    names = list(calls)
    runs = {k: [] for k in names}
    for r in range(3):
        for k in names if r % 2 == 0 else names[::-1]:
            runs[k].append(graph_ms(calls[k]))
    ms = {k: statistics.median(v) for k, v in runs.items()}
    print(json.dumps({"kernel": kernel, "shape": shape, "ms": ms,
                      "tflops": {k: flop / v / 1e9 for k, v in ms.items()}}))


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))
    print(f"device: {torch.cuda.get_device_name(0)}; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    g = torch.Generator().manual_seed(7)
    for n, h, cin, cout in FWD_SHAPES:
        x = torch.randn(n, h, h, cin, generator=g).cuda().bfloat16()
        wc = (torch.randn(9 * cin, 4 * cout, generator=g) / (9 * cin) ** 0.5).cuda().bfloat16()
        b = torch.randn(cout, generator=g).cuda().bfloat16()
        out = torch.empty(n, 2 * h, 2 * h, cout, device="cuda", dtype=torch.bfloat16)
        calls = {k: (lambda f=lib["fwd"]: f(x.data_ptr(), wc.data_ptr(), b.data_ptr(),
                                             out.data_ptr(), n, h, h, cin, cout, stream()))
                 for k, lib in libs.items()}
        calls["full"]()
        ref = uc.upsample_conv_reference(x.float(), wc.float(), b.float())
        if float((out.float() - ref).abs().max()) > 2e-2 + 2.0 ** -8 * float(ref.abs().max()):
            raise SystemExit("the full forward disagrees with its plain version")
        report("upsample_conv_fwd", [n, h, cin, cout], calls, 2 * n * h * h * 9 * cin * 4 * cout)
    for n, h, cin, cout in DX_SHAPES:
        dy = torch.randn(n, 2 * h, 2 * h, cout, generator=g).cuda().bfloat16()
        wc = (torch.randn(9 * cin, 4 * cout, generator=g) / (36 * cout) ** 0.5).cuda().bfloat16()
        dx = torch.empty(n, h, h, cin, device="cuda", dtype=torch.bfloat16)
        s = libs["full"]["splits"](0, 1, n, h, h, cin, cout)
        ws = torch.empty(s, n * h * h * cin, device="cuda")
        calls = {k: (lambda f=lib["dx"]: f(dy.data_ptr(), wc.data_ptr(), dx.data_ptr(),
                                            ws.data_ptr(), n, h, h, cin, cout, s, stream()))
                 for k, lib in libs.items()}
        report("upsample_conv_dx", [n, h, cin, cout], calls, 2 * n * h * h * 9 * cin * 4 * cout)
    for n, h, cin, cout in DX_SHAPES:
        x = torch.randn(n, h, h, cin, generator=g).cuda().bfloat16()
        dy = torch.randn(n, 2 * h, 2 * h, cout, generator=g).cuda().bfloat16()
        dwc = torch.empty(9 * cin, 4 * cout, device="cuda")
        ws_n, counters_n = ctypes.c_longlong(), ctypes.c_longlong()
        libs["full"]["sizes"](n, h, h, cin, cout, ctypes.byref(ws_n), ctypes.byref(counters_n))
        ws = torch.empty(max(ws_n.value, 1), device="cuda")
        # each variant its own counters: one that stops short of the sum
        # would leave them counting for the others
        counters = {k: torch.zeros(max(counters_n.value, 1), dtype=torch.int32, device="cuda")
                    for k in libs}
        calls = {k: (lambda f=lib["dw"], c=counters[k]: f(
            x.data_ptr(), dy.data_ptr(), dwc.data_ptr(), ws.data_ptr(), c.data_ptr(),
            n, h, h, cin, cout, stream())) for k, lib in libs.items()}
        calls["full"]()
        ref = uc.upsample_conv_dw_reference(x.float(), dy.float())
        if float((dwc - ref).abs().max()) > 1e-4 * float(ref.abs().max()):
            raise SystemExit("the full dW disagrees with its plain version")
        report("upsample_conv_dw", [n, h, cin, cout], calls, 2 * n * h * h * 9 * cin * 4 * cout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
