#!/usr/bin/env python3
"""Smoke run of facegen_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles the CUDA kernel from facegen_torch/csrc (seconds);
3. kernels: the upsample + conv kernel against its plain PyTorch version
   (the phase conv) at G's two sampler shapes (N = 1024), at the odd
   shapes of tests/test_upsample_conv.py and at N = 3, in fp32 (TF32 off)
   and in bf16; then times the kernel, the plain phase conv and the
   composed F.interpolate + F.conv2d at the two G shapes;
4. main path: writes a G32 + D32b colour checkpoint (full width, seeded
   random weights) and a synthetic 4096-image store, runs
   ``facegen_torch.sample.main`` with --runs 2 --neighbours, checks the
   files, the kernel's launch count, the scores and the images, holds the
   card's bf16 G against the CPU's fp32 G on the same noise, and reports
   images/s.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero before printing either.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

KERNEL_NAME = "upsample_conv_fwd"
KERNEL_SOURCE = "facegen_torch/csrc/upsample_conv.cu"
KERNEL_REPLACES = "facegen/ops/pallas/upsample_conv.py:121"

# (N, H, Cin, Cout, K): G32's upconv1 and upconv2 at the sampler's batch
G_SHAPES = [(1024, 8, 128, 256, 5), (1024, 16, 256, 128, 5)]
# the odd shapes of tests/test_upsample_conv.py, and a row count that
# is not a multiple of the kernel's tile
ODD_SHAPES = [(2, 8, 16, 24, 5), (2, 4, 8, 8, 3), (2, 16, 32, 16, 5), (3, 8, 128, 256, 5)]

FP32_TOL = 1e-4       # fp32 accumulate on both sides; TF32 off
BF16_ATOL = 2e-2      # plus the bf16 output rounding, half an ulp:
BF16_RTOL = 2.0 ** -8
G_TOL = 3e-2          # card bf16 G vs CPU fp32 G, images in [0, 1]


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase_device():
    import torch

    check(torch.cuda.is_available(), "no CUDA device: torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible)")
    print(smi.stdout.strip().splitlines()[0])
    return name


def phase_build():
    from facegen_torch.ops import _build

    t0 = time.perf_counter()
    _build.load("upsample_conv")
    dt = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.build_log("upsample_conv").splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"build: upsample_conv.cu in {dt:.2f} s")
    for ln in regs:
        print(f"  ptxas: {ln}")


def _inputs(n, h, cin, cout, k, dtype, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, h, cin, generator=g)
    # unit-scale outputs: weights at 1/sqrt(fan_in) of the upsampled conv
    w = torch.randn(cout, cin, k, k, generator=g) / (k * k * cin) ** 0.5
    b = torch.randn(cout, generator=g)
    return [t.to("cuda", dtype) for t in (x, w, b)]


def _time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels():
    """Kernel vs plain version; returns the kernel's summary numbers."""
    import torch
    import torch.nn.functional as F

    from facegen_torch.ops import upsample_conv as uc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    max_err_bf16 = 0.0
    for si, (n, h, cin, cout, k) in enumerate(G_SHAPES + ODD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = _inputs(n, h, cin, cout, k, dtype, seed=si)
            wc = uc.collapse_weights(w)
            got = uc.upsample_conv(x, wc, b)
            torch.cuda.synchronize()
            # reference in fp32 from the same (possibly bf16) inputs
            ref = uc.upsample_conv_reference(x.float(), wc.float(), b.float())
            err = (got.float() - ref).abs()
            max_err = float(err.max())
            if dtype == torch.float32:
                bound = FP32_TOL + FP32_TOL * ref.abs()
            else:
                bound = BF16_ATOL + BF16_RTOL * ref.abs()
            ok = bool((err <= bound).all()) and got.shape == ref.shape
            tag = "fp32" if dtype == torch.float32 else "bf16"
            print(f"kernel check {tag} N={n} {h}x{h}x{cin}->{2 * h}x{2 * h}x{cout} K={k}: "
                  f"max_abs_err={max_err:.3e} {'ok' if ok else 'FAIL'}")
            check(ok, f"kernel disagrees with the plain version ({tag}, shape {n, h, cin, cout, k})")
            if dtype == torch.bfloat16 and (n, h, cin, cout, k) in G_SHAPES:
                max_err_bf16 = max(max_err_bf16, max_err)
            del x, w, b, wc, got, ref, err

    ms = plain_ms = 0.0
    for n, h, cin, cout, k in G_SHAPES:
        x, w, b = _inputs(n, h, cin, cout, k, torch.bfloat16, seed=7)
        wc = uc.collapse_weights(w)
        x_cl = x.permute(0, 3, 1, 2)  # NCHW view of NHWC = channels_last

        def composed():
            up = F.interpolate(x_cl, scale_factor=2, mode="nearest")
            return F.conv2d(up, w, b, padding=(k - 1) // 2).permute(0, 2, 3, 1)

        fns = {"kernel": lambda: uc.upsample_conv(x, wc, b),
               "plain": lambda: uc.upsample_conv_reference(x, wc, b),
               "composed": composed}
        times = {name: [] for name in fns}
        for name in ("plain", "kernel", "composed", "composed", "kernel", "plain"):
            times[name].append(_time_ms(fns[name]))
        t = {name: sum(v) / len(v) for name, v in times.items()}
        flop = 2 * n * h * h * 4 * cout * 9 * cin
        print(f"time bf16 N={n} {h}x{h}x{cin}->{2 * h}x{2 * h}x{cout}: "
              f"kernel {t['kernel']:.4f} ms ({flop / t['kernel'] / 1e9:.1f} TFLOP/s), "
              f"plain phase conv {t['plain']:.4f} ms, "
              f"interpolate+conv2d {t['composed']:.4f} ms "
              f"(runs {', '.join(f'{k_}={v}' for k_, v in times.items())})")
        ms += t["kernel"]
        plain_ms += t["plain"]
        del x, w, b, wc, x_cl
    return {"max_abs_err": max_err_bf16, "ms": ms, "plain_ms": plain_ms}


def calibrate_batch_norm(g, noise):
    """Set each batch norm's running statistics to those of the
    activations it normalises on ``noise``, as training leaves them. With
    the init's statistics (mean 0, var 1) G's output is a near-constant
    0.5, which would hide a wrong kernel from the end-to-end check."""
    import torch

    from facegen_torch.nn.layers import BatchNorm

    def hook(m, args):
        x = args[0].float()
        m.running_mean.copy_(x.mean((0, 1, 2)))
        m.running_var.copy_(x.var((0, 1, 2)))

    handles = [m.register_forward_pre_hook(hook) for m in g.modules()
               if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            g(noise)
    finally:
        for h in handles:
            h.remove()


def phase_main_path(tmp: str):
    """Drive the sampler's CLI end to end; returns the kernel launch count."""
    import numpy as np
    import torch

    from facegen_torch import sample
    from facegen_torch.data.synthetic import draw_synthetic_faces
    from facegen_torch.models import gan
    from facegen_torch.ops import upsample_conv as uc
    from facegen_torch.utils import checkpoint as ckpt
    from facegen_torch.utils.infer import GanInference

    save_dir = os.path.join(tmp, "logs")
    out_dir = os.path.join(tmp, "samples")
    store = os.path.join(tmp, "store.npy")
    runs, seed = 2, 1
    # scheme init (reference_init=False) and calibrated batch norms: the
    # reference's N(0, 0.005^2) overwrite, like the init's statistics,
    # makes G's output a near-constant 0.5
    g, d = gan.init_gan(torch.Generator().manual_seed(0), 32, 3, 100, reference_init=False)
    calibrate_batch_norm(g, GanInference(g, d, 100).noise(torch.Generator().manual_seed(9), 256))
    ckpt.save_gan(save_dir, "adversarial", g, d,
                  {"scale": 32, "grayscale": False, "noise_dim": 100, "noise_view": "nhwc"})
    faces = draw_synthetic_faces(torch.Generator().manual_seed(0), 4096)
    np.save(store, faces.numpy())
    print(f"main path: wrote a G32 + D32b colour checkpoint and a {faces.shape[0]}-image "
          f"synthetic store")

    argv = ["--save_base", save_dir, "--runs", str(runs), "--seed", str(seed), "--neighbours",
            "--datasetDir", store, "--writeto", out_dir]
    torch.cuda.synchronize()
    uc.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    sample.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = uc.KERNEL_LAUNCHES
    # one G call of 1024 per run, two upsample-conv layers per G call
    print(f"main path: sample.main took {run_s:.3f} s; {launches} kernel launches "
          f"for {runs} G calls")
    check(launches == 2 * runs, f"expected {2 * runs} kernel launches, got {launches}")
    for run in range(1, runs + 1):
        for name in (f"random1024_{run:04d}", f"random256_{run:04d}", f"best_{run:04d}",
                     f"worst_{run:04d}", f"random_{run:04d}", f"best_{run:04d}_neighbours"):
            path = os.path.join(out_dir, f"{name}_base.png")
            check(os.path.exists(path) and os.path.getsize(path) > 0, f"missing output {path}")
    print(f"main path: all {6 * runs} grids written")

    # the card's bf16 path against the CPU's fp32 path on run 1's noise
    device = torch.device("cuda", 0)
    g_gpu, d_gpu, _ = gan.restore_gan("adversarial", default_dir=save_dir, device=device)
    g_cpu, d_cpu, _ = gan.restore_gan("adversarial", default_dir=save_dir, device="cpu")
    inf_gpu = GanInference(g_gpu, d_gpu, 100)
    inf_cpu = GanInference(g_cpu, d_cpu, 100, compute_dtype=torch.float32)
    noise = inf_gpu.noise(sample.run_generator(seed, 1), sample.N_SAMPLES)
    img_gpu = inf_gpu.generate(noise)
    scores = inf_gpu.score(img_gpu)
    img_cpu = inf_cpu.generate(noise)
    check(img_gpu.shape == (1024, 32, 32, 3), f"G output shape {tuple(img_gpu.shape)}")
    check(bool(torch.isfinite(scores).all()), "non-finite D scores")
    check(bool(((img_gpu >= 0) & (img_gpu <= 1)).all()), "images outside [0, 1]")
    g_err = float((img_gpu.cpu() - img_cpu).abs().max())
    print(f"main path: card bf16 G vs CPU fp32 G on run 1's noise: max_abs_err={g_err:.3e} "
          f"(tolerance {G_TOL}); image std {float(img_cpu.std()):.4f}; D scores in "
          f"[{float(scores.min()):.4f}, {float(scores.max()):.4f}]")
    check(g_err <= G_TOL, f"card G disagrees with CPU G: {g_err}")

    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        inf_gpu.generate_n(gen, 1024)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        inf_gpu.generate_n(gen, 1024)
    torch.cuda.synchronize()
    gen_s = (time.perf_counter() - t0) / reps
    print(f"main path: generate_n(1024) {1024 / gen_s:.1f} images/s ({gen_s * 1e3:.3f} ms "
          f"per call); whole run {runs * 1024 / run_s:.1f} images/s ({runs} x 1024 in "
          f"{run_s:.3f} s, with checkpoint load, store preparation, NN search and PNGs)")
    return launches


def main() -> int:
    try:
        name = phase_device()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    import torch

    try:
        phase_build()
        summary = phase_kernels()
        with tempfile.TemporaryDirectory() as tmp:
            launches = phase_main_path(tmp)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": KERNEL_NAME, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": summary["max_abs_err"], "ms": summary["ms"],
        "plain_ms": summary["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
