#!/usr/bin/env python3
"""Smoke run of facegen_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles the CUDA kernels from facegen_torch/csrc, one nvcc per
   source, in parallel (seconds), prints ptxas's registers and spills, and
   fails unless the bf16 forward, dx and dW kernels hold HGMMA (wgmma)
   instructions in their SASS (cuobjdump);
3. kernels: the upsample + conv forward kernel against its plain PyTorch
   version (the phase conv) at G's two layers at the sampler's batch
   (N = 1024) and at every batch of the training path (16, 32, 100,
   300), at G16's two layers, at the odd shapes of
   tests/test_upsample_conv.py and at N = 3, in fp32 (TF32 off) and in
   bf16; then times, in alternating turns, the kernel, the plain version,
   one library call (cuDNN's phase conv on pre-made operands) and the
   composed F.interpolate + F.conv2d at both layers at N = 1024, 32 and
   16, and prints each row of the kernel table (median ms and spread,
   bound, share of the bound, launches per G call and per train step);
4. backward kernels: dx and dW against their plain versions at G's two
   training shapes (N = 32), G16's, the odd shapes, N = 3, and the shapes
   of dW's TMA path where a tile holds two taps (Cin = 64, 192) or the
   last K step runs past the last image (N = 3 at 4x4), fp32 and bf16;
   the bf16 dW's bits on a repeat call and on CUDA-graph replays; their
   rows of the kernel table at the training shapes (the library calls:
   cuDNN's conv of a pre-made S2D(dy), and torch.nn.grad.conv2d_weight
   of the phase conv; dW's rows carry the time of the WMMA kernel it
   replaced, from an earlier run); the autograd Function against
   autograd of the plain forward (dx, dW, db);
5. sampler path: writes a G32 + D32b colour checkpoint (full width, seeded
   random weights) and a synthetic 4096-image store, runs
   ``facegen_torch.sample.main`` with --runs 2 --neighbours, checks the
   files, the kernel's launch count, the scores and the images, holds the
   card's bf16 G against the CPU's fp32 G on the same noise, and reports
   images/s;
6. training path: ``facegen_torch.train.main`` at the default flags
   (G32 + D32b colour, batch 32, bf16) on the store for 2 epochs of 63
   steps with --saveFreq 1, then a resume for a third, every step after
   the first a replay of the step's CUDA graph (train/graph.py); checks
   every kernel's launch count against the steps and grids, finite
   losses, metrics.jsonl, the checkpoint and its .old; holds one fp32 step
   on the card against the same step on the CPU; reports training
   images/s, the capture, and the ms per step and a profile of the step
   by kernel family with the device's busy share, for the graphed step
   and for the eager step in the same call;
7. c2f training path: ``facegen_torch.train_c2f.main`` at the default
   flags (fine 32, coarse 16, colour, batch 32, bf16) on the store for 2
   epochs of 63 steps with --saveFreq 1, then a resume for a third; checks
   the checkpoint, its .old, the _best checkpoint with a finite parzen,
   the sample grid and finite losses; reports c2f training images/s, the
   approxParzen ms (6400 refinements), the device ms per step and a
   profile of the step by kernel family;
8. c2f sampler path: writes a G16 + D16_d colour base (full width, seeded
   weights, calibrated batch norms), runs ``facegen_torch.sample.main
   --c2f --runs 2`` on phase 7's c2f checkpoint, checks the 2 x 8 grids
   and the forward kernel's 4 launches (G16's two layers, one G call a
   run), holds the card's fp32 refinement against the CPU's on the same
   noise, and reports the run's wall time and the refinement's ms per
   label;
9. one fp32 c2f step on the card against the same step on the CPU;
10. autoencoder training: ``facegen_torch.train_autoencoder.main`` at its
    defaults (scale 32, gray, noiseDim 256, batch 32, fp32) on the store
    for 2 epochs of 31 steps; checks the checkpoint, the grid, finite
    losses and that no kernel of the port launched; reports the warm
    epoch's images/s, the device ms per step and its profile;
11. denoiser training: ``facegen_torch.train_denoiser.main`` at its
    defaults (scale 16, colour, batch 32, fp32) for 2 epochs, then a
    resume for a third; the same checks and reports;
12. GAN training with --denoise: ``facegen_torch.train.main --scale 16
    --denoise`` for 1 epoch with the grids on, reading phase 11's
    denoiser; checks samples_denoised.png and every kernel's launch count;
13. one fp32 autoencoder step and one fp32 denoiser step on the card
    against the same steps on the CPU;
14. the graphed GAN step against the eager one: 3 steps each from one
    state on the same draws, fp32 (TF32 off) within 1e-5 and bf16 at the
    default flags within 1e-3 relative l2, counters equal; and, as a
    control at the setting the card tests first used (scheme init with
    zero G biases, --G_L2 0, fp32), eager steps against eager steps and
    graphed against eager, with cuDNN free to choose its algorithms
    (printed) and with its deterministic ones (checked: bit-equal);
15. ``train.main --epochsPerCompile 4 --noplot --epochs 8 --saveFreq 4``:
    8 metrics rows, 2 read-backs, the checkpoints, 8 epochs' launches;
16. ``train.main --weightsVisFreq 16 --epochs 1``: the activation dumps
    after steps 16, 32, 48 and 63, each with D's and G's PNGs;
17. the LFW store builder: ``python -m facegen_torch.data.lfw`` on a tree
    of 256 seeded 250x250 JPEGs in 32 person directories, the store's
    shape and type, and one epoch of ``train.main`` on it.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero before printing either.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "upsample_conv_fwd": ("facegen_torch/csrc/upsample_conv.cu",
                          "facegen/ops/pallas/upsample_conv.py:121"),
    "upsample_conv_dx": ("facegen_torch/csrc/upsample_conv_bwd.cu",
                         "facegen/ops/pallas/upsample_conv.py:140"),
    "upsample_conv_dw": ("facegen_torch/csrc/upsample_conv_bwd.cu",
                         "facegen/ops/pallas/upsample_conv.py:158"),
}
SOURCES = ("upsample_conv", "upsample_conv_bwd")

# (N, H, Cin, Cout, K): G32's upconv1 and upconv2 at the sampler's batch
G_SHAPES = [(1024, 8, 128, 256, 5), (1024, 16, 256, 128, 5)]
# the odd shapes of tests/test_upsample_conv.py, and a row count that
# is not a multiple of the kernel's tile
ODD_SHAPES = [(2, 8, 16, 24, 5), (2, 4, 8, 8, 3), (2, 16, 32, 16, 5), (3, 8, 128, 256, 5)]
# G16's upconv1 (4x4) and upconv2 (8x8) in training and at the sampler's batch
G16_SHAPES = [(n, h, cin, cout, 5) for n in (32, 1024)
              for h, cin, cout in ((4, 128, 256), (8, 256, 128))]
# G16's two layers at the sampler's batch: the base G of `sample --c2f`
G16_SAMPLER_SHAPES = G16_SHAPES[2:]
# G32's upconv1 and upconv2 in training (batch 32)
TRAIN_SHAPES = [(32, 8, 128, 256, 5), (32, 16, 256, 128, 5)]
# dW's TMA path: 128-row tiles that hold two taps (Cin = 64, 192; at
# N = 16, 16x16, over 64 K steps), and a last K step past the last image
# (N = 3 at 4x4: 48 pixels)
DW_TMA_SHAPES = [(2, 8, 64, 64, 5), (2, 8, 192, 64, 5), (3, 4, 128, 256, 5), (3, 4, 64, 64, 5),
                 (16, 16, 64, 64, 5)]
# the WMMA dW that the wgmma kernel replaced, device ms at TRAIN_SHAPES:
# not timed here (its source is gone), but by tools/compare_upconv_kernels.py
# against the parent tree on an NVIDIA H100 80GB HBM3 at 700 W; printed
# as a note beside the measured rows, never as one of their numbers
WMMA_DW_MS = {(32, 8, 128, 256): 0.0806, (32, 16, 256, 128): 0.2714}
# every shape the training path gives the forward: both layers in the D
# phase (N = 16), the G phase (N = 32) and the progress grids (100, 300)
FWD_TRAIN_SHAPES = [(n, h, cin, cout, 5) for n in (16, 32, 100, 300)
                    for h, cin, cout in ((8, 128, 256), (16, 256, 128))]

FP32_TOL = 1e-4       # fp32 accumulate on both sides; TF32 off
BF16_ATOL = 2e-2      # plus the bf16 output rounding, half an ulp:
BF16_RTOL = 2.0 ** -8
G_TOL = 3e-2          # card bf16 G vs CPU fp32 G, images in [0, 1]
# fp32 dx, and dW of both types (bf16 inputs are exact in fp32, and dW is
# fp32): max_abs_err <= 1e-4 x the largest |entry| of the plain result.
# Both sides sum up to 9*4*Cout (dx) or N*H*W (dW) products in other
# orders, an error that grows with the count and size of the terms, not
# with the entry they land in; a layout error is O(1) of the largest entry
BWD_TOL = 1e-4
# one fp32 train step, card against CPU (TF32 off), per network, as
# relative l2 errors over all its parameters: the gradients (Adam's first
# moment after one step is 0.1 x the gradient; the second, 0.001 x its
# square) within 1e-3, the parameter updates within 1e-2, the batch-norm
# statistics within 1e-4 of each tensor's largest entry; the counters
# equal. D's PReLU slopes carry its largest gradients, each a sum over up
# to 2M activations with cancellation, which the two devices add in other
# orders (7.5e-5 of D's gradient norm on an H100). Adam's first step
# moves each parameter by about lr x the sign of its gradient, so an
# entry whose gradient is as small as its rounding noise moves either
# way; such entries are few, and the l2 error of the update stays far
# below the O(1) of a wrong gradient. G's upsample-conv biases feed batch
# norms: their exact gradient is 0, so the check gives G nonzero biases
# and an L2 penalty (G_L2 1e-3, with the reference's sign-term bug),
# which makes those gradients the penalty's.
STEP_GRAD_TOL = 1e-3
STEP_UPDATE_TOL = 1e-2
STEP_STAT_TOL = 1e-4
# one fp32 autoencoder or denoiser step, card against CPU (TF32 off): the
# loss(es) within 1e-5 relative, Adam's moments, the parameters' updates
# and the batch-norm statistics within 1e-3 relative l2 per network. The
# denoiser's check runs with --coefL1 1e-4: the biases of conv1, conv2 and
# fc1 feed batch norms, so their exact gradients are 0 and what each
# device computes is rounding noise, which Adam turns into a step of
# either sign; the penalty's sign term makes those gradients its own
AE_STEP_TOL = 1e-3
AE_LOSS_RTOL = 1e-5
# the c2f refinement in fp32 (TF32 off), card against CPU: D's scores and
# the refined images within 2e-4 (nine fp32 convs summed in other orders,
# ~1e-5); the chosen candidate is compared only where the top two scores
# differ by more than twice that
REFINE_TOL = 2e-4

# the graphed GAN step against the eager one, 3 steps from one state on
# the same draws, relative l2 of the parameters and Adam's moments: the
# same kernels on the same inputs, so only the order of a few sums may
# differ (cuDNN's choice of algorithm, atomics); fp32 with TF32 off, and
# bf16 at the default flags, where one bf16 rounding of a sum that moved
# shows as ~4e-3 of that entry
GRAPH_FP32_TOL = 1e-5
GRAPH_BF16_TOL = 1e-3

# the H100 SXM's published dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


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
    from concurrent.futures import ThreadPoolExecutor

    from facegen_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc process per source
        list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        _build.load(name)
    print(f"build: {', '.join(f'{n}.cu' for n in SOURCES)} in {time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        for ln in _build.build_log(name).splitlines():
            if any(w in ln for w in ("registers", "spill", "Function properties", "wgmma",
                                     "setmaxnreg", "arning")):
                print(f"  ptxas {name}: {ln.strip()}")
    # the bf16 forward, dx and dW must run on wgmma: HGMMA in their SASS
    for name, kernel in (("upsample_conv", "UpconvFwd"), ("upsample_conv_bwd", "UpconvDx"),
                         ("upsample_conv_bwd", "UpconvDw")):
        counts = {k: c for k, c in _build.sass_counts(name, "HGMMA").items() if kernel in k}
        print(f"  sass {name}: HGMMA instructions per {kernel} kernel: {counts}")
        check(bool(counts) and all(c > 0 for c in counts.values()),
              f"no HGMMA in the SASS of {kernel}: {counts}")


def _inputs(n, h, cin, cout, k, dtype, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, h, cin, generator=g)
    # unit-scale outputs: weights at 1/sqrt(fan_in) of the upsampled conv
    w = torch.randn(cout, cin, k, k, generator=g) / (k * k * cin) ** 0.5
    b = torch.randn(cout, generator=g)
    return [t.to("cuda", dtype) for t in (x, w, b)]


def _time_ms(fn, iters=20, warmup=3):
    """Device ms per call: a CUDA graph of ``iters`` calls replayed between
    two CUDA events, so the host's launch overhead (the Python wrapper, the
    dispatcher) does not count, for the kernel and its yardsticks alike."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_turns(fns, rounds=3):
    """Median ms of each function over ``rounds`` runs taken in alternating
    turns: the functions in order, then reversed, and so on (k p l | l p k
    | k p l), so a drift of the card's clock hits all of them alike."""
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            times[name].append(_time_ms(fns[name]))
    return {name: statistics.median(v) for name, v in times.items()}, times


def _bound(flop, nbytes):
    """The least time the card could take: the larger of the operations at
    the bf16 tensor-core peak and the bytes at the memory rate."""
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _row(kernel, shape, t, runs, flop, nbytes, **launches):
    """One row of the kernel table: times (median and spread over the
    turns), the bound, the share of it, and the launches on the paths."""
    bound_ms, bound_by = _bound(flop, nbytes)
    n, h, cin, cout = shape
    row = {"kernel": kernel, "shape": f"N={n} {h}x{h}x{cin}->{2 * h}x{2 * h}x{cout}",
           "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
           "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / t["kernel"],
           "tflops": flop / t["kernel"] / 1e9, **launches}
    spread = "; ".join(f"{k} {min(v):.4f}-{max(v):.4f}" for k, v in runs.items())
    print(f"table {json.dumps(row)} spread(ms) {spread}")
    return row


def _sum_rows(rows):
    """The kernels line's numbers over several rows (both layers)."""
    flop_ms = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    byte_ms = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    return {"ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "library_ms": sum(r["library_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}


def phase_kernels():
    """Kernel vs plain version; returns the kernel's summary numbers at the
    training path's shapes, and prints the sampler's on a line of its own."""
    import torch
    import torch.nn.functional as F

    from facegen_torch.ops import upsample_conv as uc

    max_err = {"train": 0.0, "sampler": 0.0, "c2f": 0.0}  # bf16, at the paths' shapes
    for si, (n, h, cin, cout, k) in enumerate(G_SHAPES + FWD_TRAIN_SHAPES + G16_SHAPES
                                              + ODD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = _inputs(n, h, cin, cout, k, dtype, seed=si)
            wc = uc.collapse_weights(w)
            got = uc.upsample_conv(x, wc, b)
            torch.cuda.synchronize()
            # reference in fp32 from the same (possibly bf16) inputs
            ref = uc.upsample_conv_reference(x.float(), wc.float(), b.float())
            err = (got.float() - ref).abs()
            shape_err = float(err.max())
            if dtype == torch.float32:
                bound = FP32_TOL + FP32_TOL * ref.abs()
            else:
                bound = BF16_ATOL + BF16_RTOL * ref.abs()
            ok = bool((err <= bound).all()) and got.shape == ref.shape
            tag = "fp32" if dtype == torch.float32 else "bf16"
            print(f"kernel check {tag} N={n} {h}x{h}x{cin}->{2 * h}x{2 * h}x{cout} K={k}: "
                  f"max_abs_err={shape_err:.3e} {'ok' if ok else 'FAIL'}")
            check(ok, f"kernel disagrees with the plain version ({tag}, shape {n, h, cin, cout, k})")
            if dtype == torch.bfloat16:
                for path, shapes in (("train", FWD_TRAIN_SHAPES), ("sampler", G_SHAPES),
                                     ("c2f", G16_SAMPLER_SHAPES)):
                    if (n, h, cin, cout, k) in shapes:
                        max_err[path] = max(max_err[path], shape_err)
            del x, w, b, wc, got, ref, err

    # kernel, plain version (the phase conv, depth-to-space and bias) and
    # one library call (cuDNN's phase conv on a pre-made NCHW view with a
    # pre-made weight: no depth-to-space, no bias), in alternating turns
    rows = {"train": [], "sampler": [], "c2f": []}
    for n, h, cin, cout, k in G_SHAPES + G16_SAMPLER_SHAPES + TRAIN_SHAPES + FWD_TRAIN_SHAPES[:2]:
        x, w, b = _inputs(n, h, cin, cout, k, torch.bfloat16, seed=7)
        wc = uc.collapse_weights(w)
        x_cl = x.permute(0, 3, 1, 2)  # NCHW view of NHWC = channels_last
        w_phase = wc.reshape(3, 3, cin, 4 * cout).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def composed():
            up = F.interpolate(x_cl, scale_factor=2, mode="nearest")
            return F.conv2d(up, w, b, padding=(k - 1) // 2).permute(0, 2, 3, 1)

        t, runs = _time_turns({"kernel": lambda: uc.upsample_conv(x, wc, b),
                               "plain": lambda: uc.upsample_conv_reference(x, wc, b),
                               "library": lambda: F.conv2d(x_cl, w_phase, padding=1),
                               "composed": composed})
        flop = 2 * n * h * h * 4 * cout * 9 * cin
        nbytes = 2 * (x.numel() + wc.numel() + cout + 4 * n * h * h * cout)
        sampler = (n, h, cin, cout, k) in G_SHAPES + G16_SAMPLER_SHAPES
        row = _row("upsample_conv_fwd", (n, h, cin, cout), t, runs, flop, nbytes,
                   launches_per_g_call=1 if sampler else 0,
                   launches_per_step=0 if sampler else 1)
        print(f"time bf16 N={n} {h}x{h}x{cin}->{2 * h}x{2 * h}x{cout}: "
              f"kernel {t['kernel']:.4f} ms ({row['tflops']:.1f} TFLOP/s, "
              f"{100 * row['share_of_bound']:.1f} % of its {row['bound_ms']:.4f} ms bound), "
              f"plain {t['plain']:.4f} ms, library phase conv {t['library']:.4f} ms, "
              f"interpolate+conv2d {t['composed']:.4f} ms")
        # the kernels line: the G phase's two layers (N = 32)
        for path, shapes in (("train", TRAIN_SHAPES), ("sampler", G_SHAPES),
                             ("c2f", G16_SAMPLER_SHAPES)):
            if (n, h, cin, cout, k) in shapes:
                rows[path].append(row)
        del x, w, b, wc, x_cl, w_phase
    sampler = {**_sum_rows(rows["sampler"]), "max_abs_err": max_err["sampler"],
               "launches_per_g_call": 2}
    print(f"forward at the sampler's shapes (N = 1024, both layers): {json.dumps(sampler)}")
    c2f = {**_sum_rows(rows["c2f"]), "max_abs_err": max_err["c2f"], "launches_per_g_call": 2}
    print(f"forward at the c2f sampler's G16 base (N = 1024, both layers): {json.dumps(c2f)}")
    return {"max_abs_err": max_err["train"], **_sum_rows(rows["train"]),
            "launches_per_step": 4}


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


def phase_main_path(tmp: str, store: str):
    """Drive the sampler's CLI end to end; returns the kernels' launch counts."""
    import torch

    from facegen_torch import sample
    from facegen_torch.models import gan
    from facegen_torch.utils import checkpoint as ckpt
    from facegen_torch.utils.infer import GanInference

    save_dir = os.path.join(tmp, "logs")
    out_dir = os.path.join(tmp, "samples")
    runs, seed = 2, 1
    # scheme init (reference_init=False) and calibrated batch norms: the
    # reference's N(0, 0.005^2) overwrite, like the init's statistics,
    # makes G's output a near-constant 0.5
    g, d = gan.init_gan(torch.Generator().manual_seed(0), 32, 3, 100, reference_init=False)
    calibrate_batch_norm(g, GanInference(g, d, 100).noise(torch.Generator().manual_seed(9), 256))
    ckpt.save_gan(save_dir, "adversarial", g, d,
                  {"scale": 32, "grayscale": False, "noise_dim": 100, "noise_view": "nhwc"})
    print("main path: wrote a G32 + D32b colour checkpoint")

    argv = ["--save_base", save_dir, "--runs", str(runs), "--seed", str(seed), "--neighbours",
            "--datasetDir", store, "--writeto", out_dir]
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    sample.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    by_kernel = _launches()
    launches = by_kernel["upsample_conv_fwd"]
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
    _profile_g_call(inf_gpu, gen)
    return by_kernel


def _profile_g_call(inf, gen, calls=3):
    """Device time of one generate_n(1024), by kernel family (torch.profiler,
    kernel events only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            inf.generate_n(gen, 1024)
        torch.cuda.synchronize()
    families = {"upsample-conv forward (igemm_sm90)": ("igemm_sm90",),
                "batch norm": ("batch_norm", "batchnorm", "bn_"),
                "cuDNN / cuBLAS (conv_out, fc)": ("cudnn", "xmma", "gemm", "conv", "cutlass"),
                "PReLU": ("prelu",)}
    us = dict.fromkeys(list(families) + ["other (casts, sigmoid, noise, copies)"], 0.0)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None) or ev.self_cuda_time_total
        name = ev.key.lower()
        fam = next((f for f, keys in families.items() if any(k in name for k in keys)),
                   "other (casts, sigmoid, noise, copies)")
        us[fam] += t
    total = sum(us.values()) / calls / 1e3
    check(total > 0, "the profiler saw no device time in generate_n")
    print(f"main path: G call device time {total:.4f} ms (torch.profiler, {calls} calls of "
          f"generate_n(1024), kernel events): " + "; ".join(
              f"{f} {v / calls / 1e3:.4f} ms ({100 * v / calls / 1e3 / total:.1f} %)"
              for f, v in sorted(us.items(), key=lambda kv: -kv[1])))


def phase_bwd_kernels():
    """dx and dW kernels vs their plain versions, their times, and the
    autograd Function vs autograd of the plain forward; returns the
    summary numbers of both kernels."""
    import torch

    from facegen_torch.ops import upsample_conv as uc

    err = {"dx": 0.0, "dw": 0.0}
    for si, (n, h, cin, cout, k) in enumerate(TRAIN_SHAPES + G16_SHAPES[:2] + ODD_SHAPES
                                              + DW_TMA_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, _ = _inputs(n, h, cin, cout, k, dtype, seed=100 + si)
            dy = torch.randn(n, 2 * h, 2 * h, cout, generator=torch.Generator().manual_seed(si))
            dy = dy.to("cuda", dtype)
            wc = uc.collapse_weights(w)
            dx, dwc = uc.upsample_conv_dx(dy, wc), uc.upsample_conv_dw(x, dy)
            torch.cuda.synchronize()
            ref_dx = uc.upsample_conv_dx_reference(dy.float(), wc.float())
            ref_dw = uc.upsample_conv_dw_reference(x.float(), dy.float())
            e_dx = (dx.float() - ref_dx).abs()
            e_dw = (dwc - ref_dw).abs()
            if dtype == torch.float32:
                dx_ok = float(e_dx.max()) <= BWD_TOL * float(ref_dx.abs().max())
            else:  # plus the bf16 rounding of dx, as the forward's output
                dx_ok = bool((e_dx <= BF16_ATOL + BF16_RTOL * ref_dx.abs()).all())
            dw_ok = float(e_dw.max()) <= BWD_TOL * float(ref_dw.abs().max())
            ok = dx_ok and dw_ok and dx.shape == ref_dx.shape and dwc.shape == ref_dw.shape
            tag = "fp32" if dtype == torch.float32 else "bf16"
            print(f"bwd check {tag} N={n} {h}x{h}x{cin}->{2 * h}x{2 * h}x{cout}: "
                  f"dx max_abs_err={float(e_dx.max()):.3e} (|dx| <= {float(ref_dx.abs().max()):.2f}), "
                  f"dW max_abs_err={float(e_dw.max()):.3e} (|dW| <= {float(ref_dw.abs().max()):.1f}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"backward kernels disagree with the plain versions ({tag}, {n, h, cin, cout})")
            if dtype == torch.bfloat16 and (n, h, cin, cout, k) in TRAIN_SHAPES:
                err["dx"] = max(err["dx"], float(e_dx.max()))
                err["dw"] = max(err["dw"], float(e_dw.max()))
    _check_dw_repeats()

    # kernel, plain version and one library call, in alternating turns:
    # dx, cuDNN's conv of a pre-made S2D(dy) with the pre-made flipped and
    # transposed phase weight; dW, torch.nn.grad.conv2d_weight of the
    # phase conv (bf16, as the kernel's inputs)
    rows = {"dx": [], "dw": []}
    for n, h, cin, cout, k in TRAIN_SHAPES:
        x, w, _ = _inputs(n, h, cin, cout, k, torch.bfloat16, seed=7)
        dy = torch.randn(n, 2 * h, 2 * h, cout, device="cuda", dtype=torch.bfloat16)
        wc = uc.collapse_weights(w)
        dyc = uc.space_to_depth(dy).permute(0, 3, 1, 2)  # NCHW view, channels_last
        x_cl = x.permute(0, 3, 1, 2)
        w_dx = wc.reshape(3, 3, cin, 4 * cout).flip(0, 1).permute(2, 3, 0, 1).contiguous(
            memory_format=torch.channels_last)
        flop = 2 * n * h * h * cin * 9 * 4 * cout
        for which, kern, plain, library, nbytes in (
                ("dx", lambda: uc.upsample_conv_dx(dy, wc),
                 lambda: uc.upsample_conv_dx_reference(dy, wc),
                 lambda: torch.nn.functional.conv2d(dyc, w_dx, padding=1),
                 2 * (dy.numel() + wc.numel() + x.numel())),
                ("dw", lambda: uc.upsample_conv_dw(x, dy),
                 lambda: uc.upsample_conv_dw_reference(x, dy),
                 lambda: torch.nn.grad.conv2d_weight(x_cl, (4 * cout, cin, 3, 3), dyc, padding=1),
                 2 * (x.numel() + dy.numel()) + 4 * wc.numel())):
            t, runs = _time_turns({"kernel": kern, "plain": plain, "library": library})
            row = _row(f"upsample_conv_{which}", (n, h, cin, cout), t, runs, flop, nbytes,
                       launches_per_g_call=0, launches_per_step=1)
            print(f"time bf16 {which} N={n} {h}x{h}x{cin}->{2 * h}x{2 * h}x{cout}: "
                  f"kernel {t['kernel']:.4f} ms ({row['tflops']:.1f} TFLOP/s, "
                  f"{100 * row['share_of_bound']:.1f} % of its {row['bound_ms']:.4f} ms bound), "
                  f"plain {t['plain']:.4f} ms, library {t['library']:.4f} ms"
                  + (f"; note: the WMMA kernel it replaced took "
                     f"{WMMA_DW_MS[(n, h, cin, cout)]:.4f} ms (not timed in this run: "
                     f"tools/compare_upconv_kernels.py against the parent tree)"
                     if which == "dw" else ""))
            rows[which].append(row)
        del x, w, dy, wc, dyc, x_cl, w_dx

    # the Function's gradients against autograd of the plain forward, fp32
    for si, (n, h, cin, cout, k) in enumerate(TRAIN_SHAPES + ODD_SHAPES[:2]):
        x, w, b = _inputs(n, h, cin, cout, k, torch.float32, seed=200 + si)
        wc = uc.collapse_weights(w)
        dy = torch.randn(n, 2 * h, 2 * h, cout, device="cuda")
        grads = []
        for fn in (uc.UpsampleConvFunction.apply, uc.upsample_conv_reference):
            xs, wcs, bs = (t.clone().requires_grad_() for t in (x, wc, b))
            fn(xs, wcs, bs).backward(dy)
            grads.append((xs.grad, wcs.grad, bs.grad))
        torch.cuda.synchronize()
        errs = [float((a - r).abs().max()) for a, r in zip(*grads)]
        bounds = [float(FP32_TOL * (1 + r.abs().max())) for r in grads[1]]
        ok = all(e <= bnd for e, bnd in zip(errs, bounds))
        print(f"autograd Function vs plain forward's autograd, fp32 N={n} {h}x{h}x{cin}->{cout}: "
              f"dx {errs[0]:.3e}, dWc {errs[1]:.3e}, db {errs[2]:.3e} {'ok' if ok else 'FAIL'}")
        check(ok, f"UpsampleConvFunction's gradients disagree ({n, h, cin, cout})")
    return {w: {"max_abs_err": err[w], **_sum_rows(rows[w]), "launches_per_step": 2}
            for w in rows}


def _check_dw_repeats():
    """The bf16 dW sums each tile's stream-K pieces in a fixed order: a
    repeat call and two replays of a CUDA graph of the call give the bits
    of the first call, at the training shapes and a gather shape."""
    import torch

    from facegen_torch.ops import upsample_conv as uc

    for n, h, cin, cout, k in TRAIN_SHAPES + ODD_SHAPES[:1]:
        x, _, _ = _inputs(n, h, cin, cout, k, torch.bfloat16, seed=300)
        dy = torch.randn(n, 2 * h, 2 * h, cout, generator=torch.Generator().manual_seed(301))
        dy = dy.to("cuda", torch.bfloat16)
        first, second = uc.upsample_conv_dw(x, dy), uc.upsample_conv_dw(x, dy)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = uc.upsample_conv_dw(x, dy)
        same = torch.equal(first, second)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            same &= torch.equal(first, replayed)
        print(f"bwd check bf16 dW N={n} {h}x{h}x{cin}->{2 * h}x{2 * h}x{cout}: repeat call and "
              f"2 CUDA-graph replays bit-identical: {'ok' if same else 'FAIL'}")
        check(same, f"the bf16 dW is not deterministic ({n, h, cin, cout})")
        del graph


def write_store(tmp: str) -> str:
    """A 4096-image synthetic store (64x64 uint8 faces) under ``tmp``."""
    import numpy as np
    import torch

    from facegen_torch.data.synthetic import draw_synthetic_faces

    store = os.path.join(tmp, "store.npy")
    faces = draw_synthetic_faces(torch.Generator().manual_seed(0), 4096)
    np.save(store, faces.numpy())
    print(f"wrote a {faces.shape[0]}-image synthetic store")
    return store


def _reset_launches():
    from facegen_torch.ops import upsample_conv as uc

    uc.KERNEL_LAUNCHES = uc.DX_LAUNCHES = uc.DW_LAUNCHES = 0


def _launches():
    from facegen_torch.ops import upsample_conv as uc

    return {"upsample_conv_fwd": uc.KERNEL_LAUNCHES, "upsample_conv_dx": uc.DX_LAUNCHES,
            "upsample_conv_dw": uc.DW_LAUNCHES}


def phase_training(tmp: str, store: str):
    """Drive the trainer's CLI end to end; returns the kernels' launch
    counts in its 2-epoch run."""
    import torch

    from facegen_torch import train
    from facegen_torch.train.step import draw_step, steps_per_epoch

    save = os.path.join(tmp, "train_logs")
    argv = ["--datasetDir", store, "--save", save, "--saveFreq", "1"]
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    trainer = train.main(argv + ["--epochs", "2"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _launches()
    steps = 2 * steps_per_epoch(trainer.cfg)
    viz_calls = 2  # one progress grid set per epoch: G on 100 fixed + 300 random noise
    print(f"training path: train.main --epochs 2 took {run_s:.3f} s for {steps} steps; "
          f"launches {launches}")
    check(steps == 126, f"expected 2 x 63 steps at the default flags, got {steps}")
    check(launches["upsample_conv_dx"] == 2 * steps,
          f"dx launches {launches['upsample_conv_dx']} != 2 x {steps} steps")
    check(launches["upsample_conv_dw"] == 2 * steps,
          f"dW launches {launches['upsample_conv_dw']} != 2 x {steps} steps")
    # per step: G in the D phase and in the G phase, 2 upsample-convs each;
    # per grid set: G on the fixed and on the random noise
    want_fwd = 4 * steps + 4 * viz_calls
    check(launches["upsample_conv_fwd"] == want_fwd,
          f"forward launches {launches['upsample_conv_fwd']} != {want_fwd}")
    for name in ("adversarial", "adversarial.old"):
        check(os.path.exists(os.path.join(save, name, "arrays.npz")), f"missing checkpoint {name}")
    for name in ("samples_fixed", "best50", "worst50", "real100"):
        path = os.path.join(save, "viz", f"{name}.png")
        check(os.path.exists(path) and os.path.getsize(path) > 0, f"missing grid {path}")

    trainer2 = train.main(argv + ["--epochs", "1", "--network", "adversarial"])
    check(trainer2.state.epoch == 4, f"resumed run ends at epoch {trainer2.state.epoch}, want 4")
    rows = _metrics_rows(save)
    check([r["epoch"] for r in rows] == [1, 2, 3], f"epochs {[r['epoch'] for r in rows]}")
    print("training path: metrics.jsonl " + "; ".join(
        f"epoch {r['epoch']}: loss_d {r['loss_d_mean']:.4f} loss_g {r['loss_g_mean']:.4f} "
        f"acc_d {r['acc_d_mean']:.4f} trained D {r['trained_d']}/"
        f"{r['trained_d'] + r['not_trained_d']} {r['images_per_sec']:.1f} images/s"
        for r in rows))
    print(f"training path: warm epoch (2) {rows[1]['images_per_sec']:.1f} images/s "
          f"(1000 examples per epoch, host clock {rows[1]['seconds']:.3f} s for 63 steps "
          f"with the epoch's read-back; grids and pool outside the clock)")

    graphed = trainer2.graphed
    check(graphed.graph is not None and graphed.launches_per_replay == {
        "KERNEL_LAUNCHES": 4, "DX_LAUNCHES": 2, "DW_LAUNCHES": 2},
        f"the trainer's step was not captured as expected: {graphed.launches_per_replay}")
    print(f"training path: the step was captured as a CUDA graph in {graphed.capture_ms:.1f} ms "
          f"after {graphed.eager_steps} eager steps; kernel launches per replay "
          f"{graphed.launches_per_replay}")

    cfg = trainer2.cfg
    gen = torch.Generator(device=trainer2.device).manual_seed(11)
    pool = trainer2.source.epoch_pool(gen, trainer2.pool_n)

    def run(n):
        return trainer2.run_steps(pool, gen, n)

    def run_eager(n):
        for _ in range(n):
            trainer2.step(trainer2.state, pool,
                          draw_step(gen, cfg, trainer2.pool_n, trainer2.step.mask_specs))

    # in turns: graphed, eager, eager, graphed
    times = {"graphed": [], "eager": []}
    for route in ("graphed", "eager", "eager", "graphed"):
        times[route].append(_step_ms(run if route == "graphed" else run_eager))
    n_epoch, per_epoch = cfg.n_epoch, steps_per_epoch(cfg)
    for route, ts in times.items():
        step_ms = statistics.mean(ts)
        print(f"training path ({route}): {step_ms:.4f} ms per step on the stream (CUDA events "
              f"over 30 steps, mean of 2 turns: {', '.join(f'{t:.4f}' for t in ts)}; batch 32, "
              f"bf16, waits for the host included): {n_epoch / (per_epoch * step_ms / 1e3):.1f} "
              f"images/s at the epoch's count of {n_epoch} examples per {per_epoch} steps")
    _profile_train_steps(run, label="training path (graphed)")
    _profile_train_steps(run_eager, label="training path (eager)")
    return launches


def _step_ms(run, steps=30, warmup=5):
    """Time per step on the stream: CUDA events around ``run(steps)``
    after ``run(warmup)``, the device's work and its waits for the host's
    launches."""
    import torch

    run(warmup)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(steps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def _profile_train_steps(run, steps=5, label="training path", top=0):
    """Device time of a training step by kernel family (torch.profiler,
    kernel events only) against the host's wall time of the same steps:
    the device's busy share; with ``top``, the kernels that take the most
    device time, each with its ms per step. ``run(n)`` runs n steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run(10)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    families = {"upsample-conv dW (UpconvDw)": ("upconvdw",),
                "upsample-conv dx (UpconvDx)": ("upconvdx",),
                "upsample-conv forward (UpconvFwd)": ("upconvfwd",),
                "split-K sums (reduce_splits)": ("reduce_splits",),
                "cuDNN / cuBLAS": ("cudnn", "xmma", "gemm", "conv", "cutlass", "sm90_")}
    other = "elementwise, reductions, copies"
    us = dict.fromkeys(list(families) + [other], 0.0)
    launches, kernels = 0, []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None) or ev.self_cuda_time_total
        name = ev.key.lower()
        us[next((f for f, keys in families.items() if any(k in name for k in keys)), other)] += t
        launches += ev.count
        kernels.append((t, ev.count, ev.key))
    busy_ms = sum(us.values()) / steps / 1e3
    check(busy_ms > 0, f"the profiler saw no device time in the {label} steps")
    for t, count, key in sorted(kernels, reverse=True)[:top]:
        print(f"{label}: kernel {t / steps / 1e3:.4f} ms per step in {count / steps:.0f} "
              f"launches: {key[:160]}")
    print(f"{label}: step profile (torch.profiler, {steps} steps after 10 warm-up, kernel "
          f"events): {busy_ms:.4f} ms of device time in {wall_ms:.3f} ms of host wall per step, "
          f"busy {100 * busy_ms / wall_ms:.1f} %, {launches / steps:.0f} kernels a step; " + "; ".join(
              f"{f} {v / steps / 1e3:.4f} ms ({100 * v / steps / 1e3 / busy_ms:.1f} %)"
              for f, v in sorted(us.items(), key=lambda kv: -kv[1])))


def _rel_l2(ours, ref):
    """Relative l2 error of a list of tensors (any device) against the
    CPU's, over all of them."""
    num = sum(float(((o.detach().cpu() - r.detach()) ** 2).sum()) for o, r in zip(ours, ref))
    den = sum(float((r.detach() ** 2).sum()) for r in ref)
    return (num / max(den, 1e-300)) ** 0.5


def phase_step_parity():
    """One fp32 train step on the card against the same step on the CPU:
    the same weights, pool and injected draws."""
    import torch

    from facegen_torch.config import TrainConfig
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.data.synthetic import draw_synthetic_faces
    from facegen_torch.models import gan
    from facegen_torch.train.step import (
        DDraws,
        GDraws,
        StepDraws,
        TrainStep,
        draw_step,
        init_state,
    )

    cfg = TrainConfig(compute_dtype="float32", reference_init=False, g_l2=1e-3).validate()
    dev = torch.device("cuda", 0)

    def build(device):
        g, d = gan.init_gan(torch.Generator().manual_seed(5), cfg.scale, cfg.channels,
                            cfg.noise_dim, reference_init=False, device=device)
        bias_gen = torch.Generator().manual_seed(8)
        with torch.no_grad():
            for name, p in g.named_parameters():
                if name.endswith("bias"):
                    p.copy_(torch.rand(p.shape, generator=bias_gen) * 0.2 - 0.1)
        return init_state(cfg, g, d), TrainStep(cfg, g, d)

    cpu_state, cpu_step = build("cpu")
    gpu_state, gpu_step = build(dev)
    pool = prepare_pool(draw_synthetic_faces(torch.Generator().manual_seed(6), 256), 32, 3)
    draws = draw_step(torch.Generator().manual_seed(7), cfg, pool.shape[0], cpu_step.mask_specs)
    moved = StepDraws(
        tuple(DDraws(x.idx.to(dev), x.noise.to(dev), {k: m.to(dev) for k, m in x.masks.items()})
              for x in draws.d),
        tuple(GDraws(x.noise.to(dev), {k: m.to(dev) for k, m in x.masks.items()})
              for x in draws.g))
    before = {net: [p.detach().clone() for p in getattr(cpu_state, net).parameters()]
              for net in ("g", "d")}
    cpu_m = cpu_step(cpu_state, pool, draws)
    gpu_m = gpu_step(gpu_state, pool.to(dev), moved)
    torch.cuda.synchronize()
    rel_l2 = _rel_l2

    ok, lines = True, []
    for net in ("g", "d"):
        gpu_net, cpu_net = getattr(gpu_state, net), getattr(cpu_state, net)
        opt_gpu, opt_cpu = getattr(gpu_state, f"opt_{net}"), getattr(cpu_state, f"opt_{net}")
        ok &= int(opt_gpu["count"]) == int(opt_cpu["count"]) == 1
        errs = {kind: rel_l2(opt_gpu[kind], opt_cpu[kind]) for kind in ("mu", "nu")}
        errs["update"] = rel_l2([p.cpu() - b for p, b in zip(gpu_net.parameters(), before[net])],
                                [p - b for p, b in zip(cpu_net.parameters(), before[net])])
        stat = max((float((a.cpu() - cpu_net.get_buffer(n)).abs().max())
                    / float(cpu_net.get_buffer(n).abs().max())
                    for n, a in gpu_net.named_buffers()), default=0.0)
        ok &= (errs["mu"] <= STEP_GRAD_TOL and errs["nu"] <= STEP_GRAD_TOL
               and errs["update"] <= STEP_UPDATE_TOL and stat <= STEP_STAT_TOL)
        lines.append(f"{net.upper()}: gradient (mu) {errs['mu']:.3e}, nu {errs['nu']:.3e}, "
                     f"update {errs['update']:.3e}, BN statistics {stat:.3e}")
    for key in ("accs", "accs_n", "confusion", "trained_d", "not_trained_d"):
        ok &= torch.equal(getattr(gpu_state, key).cpu(), getattr(cpu_state, key))
    print(f"step parity fp32, card vs CPU, G32 + D32b batch 32, relative l2 errors: "
          f"{'; '.join(lines)} (tolerances {STEP_GRAD_TOL}, {STEP_UPDATE_TOL}, "
          f"{STEP_STAT_TOL}); loss_d {float(gpu_m.loss_d):.6f} / {float(cpu_m.loss_d):.6f}, "
          f"loss_g {float(gpu_m.loss_g):.6f} / {float(cpu_m.loss_g):.6f}; counters equal; "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the card's fp32 train step disagrees with the CPU's")


def phase_c2f_training(tmp: str, store: str):
    """Drive the c2f trainer's CLI end to end at the default flags; returns
    its save directory and the kernels' launch counts in its 2-epoch run
    (the c2f nets have no upsample-conv: all 0)."""
    import json as _json
    import math

    import torch

    from facegen_torch import train_c2f
    from facegen_torch.train.c2f import ckpt_name
    from facegen_torch.train.step import steps_per_epoch

    save = os.path.join(tmp, "c2f_logs")
    argv = ["--datasetDir", store, "--save", save, "--saveFreq", "1"]
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    trainer = train_c2f.main(argv + ["--epochs", "2"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _launches()
    cfg = trainer.cfg
    steps = 2 * steps_per_epoch(cfg)
    print(f"c2f training path: train_c2f.main --epochs 2 took {run_s:.3f} s for {steps} steps "
          f"(fine {cfg.fine_size}, coarse {cfg.coarse_size}, batch {cfg.batch_size}, "
          f"{cfg.compute_dtype}); launches {launches}")
    check(steps == 126, f"expected 2 x 63 steps at the default flags, got {steps}")
    name = ckpt_name(cfg)
    for n in (name, name + ".old", name + "_best"):
        check(os.path.exists(os.path.join(save, n, "arrays.npz")), f"missing checkpoint {n}")
    with open(os.path.join(save, name + "_best", "meta.json")) as f:
        best = _json.load(f)
    check(math.isfinite(best.get("parzen", math.nan)), f"_best has no finite parzen: {best}")
    grid = os.path.join(save, "viz", "c2f_samples.png")
    check(os.path.exists(grid) and os.path.getsize(grid) > 0, f"missing grid {grid}")

    trainer2 = train_c2f.main(argv + ["--epochs", "1", "--network", name])
    check(trainer2.state.epoch == 4, f"resumed run ends at epoch {trainer2.state.epoch}, want 4")
    check(trainer2.best_dist <= best["parzen"], "the resume lost the best parzen")
    with open(os.path.join(save, "metrics_c2f.jsonl")) as f:
        rows = [_json.loads(line) for line in f if line.strip()]
    check([r["epoch"] for r in rows] == [1, 2, 3], f"epochs {[r['epoch'] for r in rows]}")
    for r in rows:
        check(all(math.isfinite(r[k]) for k in ("loss_d_mean", "loss_g_mean", "parzen")),
              f"non-finite losses or parzen in {r}")
    print("c2f training path: metrics_c2f.jsonl " + "; ".join(
        f"epoch {r['epoch']}: loss_d {r['loss_d_mean']:.4f} loss_g {r['loss_g_mean']:.4f} "
        f"acc_d {r['acc_d_mean']:.4f} parzen {r['parzen']:.4f} ({r['parzen_ms']:.3f} ms) "
        f"{r['images_per_sec']:.1f} images/s" for r in rows))
    print(f"c2f training path: warm epoch (2) {rows[1]['images_per_sec']:.1f} images/s "
          f"({cfg.n_epoch} examples per epoch, host clock {rows[1]['seconds']:.3f} s for "
          f"{steps // 2} steps with the epoch's read-back; pool, grid and parzen outside the "
          f"clock); approxParzen "
          f"{rows[1]['parzen_ms']:.3f} ms host clock ({cfg.parzen_samples} x {cfg.batch_size} "
          f"refinements, with the draws and the read-back)")

    gen = torch.Generator(device=trainer2.device).manual_seed(12)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    trainer2.parzen(gen)
    parzen_ms = []
    for _ in range(3):
        start.record()
        trainer2.parzen(gen)
        end.record()
        torch.cuda.synchronize()
        parzen_ms.append(start.elapsed_time(end))
    from facegen_torch.data.c2f import make_triples

    pool = make_triples(trainer2.source.epoch_pool(gen, trainer2.pool_n), cfg.coarse_size)

    def run(n):
        return trainer2.run_steps(pool, gen, n)

    step_ms = _step_ms(run)
    per_epoch = steps_per_epoch(cfg)
    print(f"c2f training path: approxParzen {statistics.median(parzen_ms):.3f} ms on the stream "
          f"(CUDA events, median of 3: {', '.join(f'{t:.3f}' for t in parzen_ms)}); "
          f"{step_ms:.4f} ms per step on the stream (CUDA events over 30 steps, waits for the "
          f"host included): {cfg.n_epoch / (per_epoch * step_ms / 1e3):.1f} images/s at "
          f"{cfg.n_epoch} examples per {per_epoch} steps")
    _profile_train_steps(run, label="c2f training path", top=8)
    return save, launches


def phase_c2f_sampler(tmp: str, c2f_save: str):
    """Drive ``sample --c2f`` end to end on a G16 + D16_d base and phase
    7's c2f checkpoint; returns the kernels' launch counts in that run."""
    import torch

    from facegen_torch import sample
    from facegen_torch.config import SampleConfig
    from facegen_torch.models import c2f, gan
    from facegen_torch.utils import checkpoint as ckpt
    from facegen_torch.utils.infer import GanInference

    base_dir = os.path.join(tmp, "g16_logs")
    out_dir = os.path.join(tmp, "c2f_samples")
    runs = 2
    g, d = gan.init_gan(torch.Generator().manual_seed(1), 16, 3, 100, reference_init=False)
    calibrate_batch_norm(g, GanInference(g, d, 100).noise(torch.Generator().manual_seed(9), 256))
    ckpt.save_gan(base_dir, "adversarial", g, d,
                  {"scale": 16, "grayscale": False, "noise_dim": 100, "noise_view": "nhwc"})
    print("c2f sampler path: wrote a G16 + D16_d colour base checkpoint")
    argv = ["--save_base", base_dir, "--runs", str(runs), "--seed", "1", "--c2f",
            "--save_c2f32", c2f_save, "--writeto", out_dir]
    tf32 = torch.backends.cudnn.allow_tf32  # as the CLI finds it: torch's default
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    sample.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _launches()
    check(torch.backends.cudnn.allow_tf32 == tf32, "sample.main left cuDNN's TF32 setting changed")
    print(f"c2f sampler path: sample.main --c2f --runs {runs} took {run_s:.3f} s (cuDNN TF32 "
          f"{'on' if tf32 else 'off'} as torch's default has it; the refinement in fp32); "
          f"launches {launches}")
    check(launches["upsample_conv_fwd"] == 2 * runs,
          f"expected {2 * runs} forward launches (G16's two layers a run), got {launches}")
    for run in range(1, runs + 1):
        for name in ("random1024", "random256", "best", "worst", "random"):
            path = os.path.join(out_dir, f"{name}_{run:04d}_base.png")
            check(os.path.exists(path) and os.path.getsize(path) > 0, f"missing output {path}")
        for name in ("best", "worst", "random"):
            path = os.path.join(out_dir, f"{name}_{run:04d}_c2f_32.png")
            check(os.path.exists(path) and os.path.getsize(path) > 0, f"missing output {path}")
    print(f"c2f sampler path: all {8 * runs} grids written")

    # the card's fp32 refinement against the CPU's on the same base images and noise
    device = torch.device("cuda", 0)
    name = SampleConfig().c2f_network  # the checkpoint the run above refined with
    g_gpu, d_gpu, _, res = c2f.restore_c2f(name, c2f_save, device=device)
    g_cpu, d_cpu, _, _ = c2f.restore_c2f(name, c2f_save, device="cpu")
    fs = res["fine_size"]
    base = GanInference(g.to(device), d.to(device), 100)
    images = base.generate_n(torch.Generator().manual_seed(2), 64)
    noise = torch.rand(64, 10, fs, fs, 1, generator=torch.Generator().manual_seed(3)) * 2 - 1
    refined, scores = sample.refine_c2f(g_gpu, d_gpu, fs, images, noise)
    ref, ref_scores = sample.refine_c2f(g_cpu, d_cpu, fs, images.cpu(), noise)
    score_err = float((scores.cpu() - ref_scores).abs().max())
    top2 = ref_scores.sort(dim=1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * REFINE_TOL
    same = bool((scores.cpu().argmax(1) == ref_scores.argmax(1))[clear].all())
    img_err = float((refined.cpu()[clear] - ref[clear]).abs().max()) if clear.any() else 0.0
    ok = (score_err <= REFINE_TOL * (1 + float(ref_scores.abs().max())) and same
          and img_err <= REFINE_TOL and int(clear.sum()) >= 32
          and bool(torch.isfinite(refined).all()) and refined.shape == (64, fs, fs, 3))
    print(f"c2f sampler path: card vs CPU refinement as served (fp32, TF32 off inside "
          f"refine_c2f; the caller's cuDNN TF32 {'on' if tf32 else 'off'}), 64 images x 10 tries: "
          f"scores max_abs_err={score_err:.3e} (|score| <= {float(ref_scores.abs().max()):.3f}), "
          f"the same choice in {int(clear.sum())} of 64 clear rows, images "
          f"max_abs_err={img_err:.3e} (tolerance {REFINE_TOL}); {'ok' if ok else 'FAIL'}")
    check(ok, "the card's c2f refinement disagrees with the CPU's")

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sample.refine_c2f(g_gpu, d_gpu, fs, images, noise)
    times = []
    for _ in range(5):
        start.record()
        sample.refine_c2f(g_gpu, d_gpu, fs, images, noise)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    print(f"c2f sampler path: refine_c2f of one label (64 images x 10 tries, fp32, TF32 off): "
          f"{statistics.median(times):.3f} ms on the stream (CUDA events, median of 5: "
          f"{', '.join(f'{t:.3f}' for t in times)})")
    return launches


def phase_c2f_step_parity():
    """One fp32 c2f step at the default flags on the card against the same
    step on the CPU: the same weights, pool and draws."""
    import torch

    from facegen_torch.config import C2FConfig
    from facegen_torch.data.c2f import make_triples
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.data.synthetic import draw_synthetic_faces
    from facegen_torch.models import c2f
    from facegen_torch.train.c2f import C2FStep, draw_c2f_step, init_c2f_state

    cfg = C2FConfig(compute_dtype="float32", g_l2=1e-3).validate()
    dev = torch.device("cuda", 0)
    built = {}
    for device in ("cpu", dev):
        g, d = c2f.init_c2f(torch.Generator().manual_seed(5), cfg.fine_size, cfg.channels,
                            device=device)
        built[str(device)] = (init_c2f_state(cfg, g, d), C2FStep(cfg, g, d))
    cpu_state, cpu_step = built["cpu"]
    gpu_state, gpu_step = built[str(dev)]
    fine = prepare_pool(draw_synthetic_faces(torch.Generator().manual_seed(6), 256),
                        cfg.fine_size, cfg.channels)
    pool = make_triples(fine, cfg.coarse_size)
    draws = draw_c2f_step(torch.Generator().manual_seed(7), cfg, pool.size, cpu_step.mask_specs)

    def move(x):
        return x.to(dev) if torch.is_tensor(x) else {k: m.to(dev) for k, m in x.items()}

    moved = type(draws)(*(tuple(type(it)(*map(move, it)) for it in part) for part in draws))
    before = [p.detach().clone() for p in (*cpu_state.g.parameters(), *cpu_state.d.parameters())]
    cpu_m = cpu_step(cpu_state, pool, draws)
    gpu_m = gpu_step(gpu_state, type(pool)(*(t.to(dev) for t in pool)), moved)
    torch.cuda.synchronize()
    rel_l2 = _rel_l2

    ok, lines = True, []
    for net in ("g", "d"):
        opt_gpu, opt_cpu = getattr(gpu_state, f"opt_{net}"), getattr(cpu_state, f"opt_{net}")
        ok &= int(opt_gpu["count"]) == int(opt_cpu["count"]) == 1
        errs = {kind: rel_l2(opt_gpu[kind], opt_cpu[kind]) for kind in ("mu", "nu")}
        ok &= errs["mu"] <= STEP_GRAD_TOL and errs["nu"] <= STEP_GRAD_TOL
        lines.append(f"{net.upper()}: gradient (mu) {errs['mu']:.3e}, nu {errs['nu']:.3e}")
    params = lambda st: [p for p in (*st.g.parameters(), *st.d.parameters())]  # noqa: E731
    update = rel_l2([p.cpu() - b for p, b in zip(params(gpu_state), before)],
                    [p - b for p, b in zip(params(cpu_state), before)])
    ok &= update <= STEP_UPDATE_TOL and torch.equal(gpu_state.confusion.cpu(), cpu_state.confusion)
    print(f"c2f step parity fp32, card vs CPU, G_d + D_c fine 32 batch 32, relative l2 errors: "
          f"{'; '.join(lines)}; update {update:.3e} (tolerances {STEP_GRAD_TOL}, "
          f"{STEP_UPDATE_TOL}); loss_d {float(gpu_m.loss_d):.6f} / {float(cpu_m.loss_d):.6f}, "
          f"loss_g {float(gpu_m.loss_g):.6f} / {float(cpu_m.loss_g):.6f}; confusion equal; "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the card's fp32 c2f step disagrees with the CPU's")


def _check_files(*paths):
    for path in paths:
        check(os.path.exists(path) and os.path.getsize(path) > 0, f"missing output {path}")


def _report_fp32_trainer(label, trainer, run_s, launches, rows, describe):
    """The checks and lines both AE-family phases share: no kernel of
    the port launched, finite losses, the warm epoch's images/s, the
    device ms per step and the step's profile."""
    import math

    import torch

    print(f"{label}: {describe} took {run_s:.3f} s; launches {launches}")
    check(not any(launches.values()), f"the {label} launched the port's kernels: {launches}")
    for r in rows:
        check(all(math.isfinite(v) for k, v in r.items() if k.startswith(("loss", "val"))),
              f"non-finite losses in {r}")
    print(f"{label}: " + "; ".join(
        f"epoch {r['epoch']}: " + " ".join(f"{k} {v:.5f}" for k, v in r.items()
                                           if k.startswith(("loss", "val")))
        + f" {r['images_per_sec']:.1f} images/s" for r in rows))
    cfg, warm = trainer.cfg, rows[1]
    draws = trainer.epoch_draws(torch.Generator(device=trainer.device).manual_seed(13))
    print(f"{label}: warm epoch ({warm['epoch']}) {warm['images_per_sec']:.1f} images/s "
          f"({len(draws)} steps of batch {cfg.batch_size}, host clock {warm['seconds']:.3f} s "
          f"with the epoch's read-back)")

    def run(n):
        return trainer.run_steps(draws[:n])

    step_ms = _step_ms(run)
    print(f"{label}: {step_ms:.4f} ms per step on the stream (CUDA events over 30 steps, fp32, "
          f"waits for the host included): {1e3 * cfg.batch_size / step_ms:.1f} images/s")
    _profile_train_steps(run, label=label, top=5)


def phase_ae_training(tmp: str, store: str):
    """Drive the autoencoder trainer's CLI end to end at its defaults;
    returns the kernels' launch counts in that run (none: the AE is dense
    layers)."""
    import torch

    from facegen_torch import train_autoencoder

    save = os.path.join(tmp, "ae_logs")
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    trainer = train_autoencoder.main(["--datasetDir", store, "--save", save, "--epochs", "2"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _launches()
    cfg = trainer.cfg
    check((cfg.scale, cfg.channels, cfg.noise_dim, cfg.batch_size) == (32, 1, 256, 32),
          f"the AE CLI's defaults: {cfg}")
    check(trainer.epoch == 2 and len(trainer.history) == 2, f"{trainer.epoch} epochs, want 2")
    _check_files(os.path.join(save, "autoencoder", "arrays.npz"),
                 os.path.join(save, "viz", "ae_recon.png"))
    _report_fp32_trainer("ae training path", trainer, run_s, launches, trainer.history,
                         "train_autoencoder.main --epochs 2 (scale 32, gray, noiseDim 256, "
                         "batch 32, fp32)")
    return launches


def phase_denoiser_training(tmp: str, store: str):
    """Drive the denoiser trainer's CLI end to end at its defaults, then a
    resume; returns its save directory and the kernels' launch counts in
    its 2-epoch run (none: VALID 3x3 convs and dense layers)."""
    import json as _json

    import torch

    from facegen_torch import train_denoiser
    from facegen_torch.models.ae import denoiser_ckpt_name

    save = os.path.join(tmp, "denoiser_logs")
    argv = ["--datasetDir", store, "--save", save]
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    trainer = train_denoiser.main(argv + ["--epochs", "2"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _launches()
    cfg = trainer.cfg
    check((cfg.scale, cfg.channels, cfg.batch_size) == (16, 3, 32),
          f"the denoiser CLI's defaults: {cfg}")
    name = denoiser_ckpt_name(cfg.scale, cfg.channels)
    _check_files(os.path.join(save, name, "arrays.npz"),
                 os.path.join(save, "viz", "denoiser_recon.png"))
    trainer2 = train_denoiser.main(argv + ["--epochs", "1", "--network", name])
    steps = trainer2.n_pool // cfg.batch_size
    check(trainer2.epoch == 3 and trainer2.history[0]["epoch"] == 3,
          f"the resumed run ends at epoch {trainer2.epoch}, want 3")
    check(int(trainer2.state.opt1["count"]) == steps,
          f"Adam's count {int(trainer2.state.opt1['count'])} after the resume, want {steps}")
    with open(os.path.join(save, name, "meta.json")) as f:
        check(_json.load(f)["epoch"] == 3, "the resume's checkpoint is not at epoch 3")
    _check_files(os.path.join(save, name + ".old", "arrays.npz"))
    _report_fp32_trainer("denoiser training path", trainer2, run_s, launches,
                         trainer.history + trainer2.history,
                         "train_denoiser.main --epochs 2 (scale 16, colour, batch 32, fp32)")
    return save, launches


def phase_training_denoise(store: str, denoiser_save: str):
    """The GAN trainer's CLI with --denoise at scale 16 for 1 epoch with
    the grids on, reading phase 11's denoiser; returns the kernels' launch
    counts in that run."""
    import torch

    from facegen_torch import train
    from facegen_torch.train.step import steps_per_epoch

    argv = ["--datasetDir", store, "--save", denoiser_save, "--scale", "16", "--denoise",
            "--epochs", "1"]
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    trainer = train.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _launches()
    steps = steps_per_epoch(trainer.cfg)
    print(f"denoise path: train.main --scale 16 --denoise --epochs 1 took {run_s:.3f} s for "
          f"{steps} steps; launches {launches}")
    # per step 4 forward (G in the D and the G phase), 2 dx, 2 dW; the one
    # grid set runs G on the fixed and on the random noise
    want = {"upsample_conv_fwd": 4 * steps + 4, "upsample_conv_dx": 2 * steps,
            "upsample_conv_dw": 2 * steps}
    check(launches == want, f"launches {launches}, want {want}")
    viz = os.path.join(denoiser_save, "viz")
    _check_files(os.path.join(viz, "samples_fixed.png"), os.path.join(viz, "samples_denoised.png"))
    fixed = trainer.inf.generate(trainer.fixed_noise)
    den = trainer.denoiser(fixed)
    check(den.shape == fixed.shape == (100, 16, 16, 3) and den.dtype == torch.float32
          and bool(((den >= 0) & (den <= 1)).all()),
          f"denoised samples {tuple(den.shape)} {den.dtype}")
    print(f"denoise path: samples_denoised.png written; AE1's decoder on G's 100 fixed "
          f"samples: mean |denoised - sample| {float((den - fixed).abs().mean()):.4f}")
    return launches


def phase_ae_step_parity():
    """One fp32 autoencoder step and one fp32 denoiser step, each at its
    CLI's defaults, on the card against the same step on the CPU: the
    same weights, pool and draws."""
    import torch

    from facegen_torch.config import TrainConfig
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.data.synthetic import draw_synthetic_faces
    from facegen_torch.models import ae
    from facegen_torch.nn.init import gaussian_overwrite
    from facegen_torch.train.ae_loop import (
        AEStep,
        DenoiserDraws,
        DenoiserState,
        DenoiserStep,
        ae_epoch_draws,
        denoiser_epoch_draws,
    )
    from facegen_torch.train.optim import adam

    dev = torch.device("cuda", 0)
    faces = draw_synthetic_faces(torch.Generator().manual_seed(6), 256)

    def move(x):
        return x.to(dev) if torch.is_tensor(x) else {k: m.to(dev) for k, m in x.items()}

    def errs(gpu_net, gpu_opt, cpu_net, cpu_opt, before):
        out = {kind: _rel_l2(gpu_opt[kind], cpu_opt[kind]) for kind in ("mu", "nu")}
        out["update"] = _rel_l2([p.cpu() - b for p, b in zip(gpu_net.parameters(), before)],
                                [p - b for p, b in zip(cpu_net.parameters(), before)])
        out["stats"] = _rel_l2(list(gpu_net.buffers()), list(cpu_net.buffers()))
        ok = (all(v <= AE_STEP_TOL for v in out.values())
              and int(gpu_opt["count"]) == int(cpu_opt["count"]) == 1)
        return ok, ", ".join(f"{k} {v:.3e}" for k, v in out.items())

    cfg = TrainConfig(scale=32, grayscale=True, noise_dim=256).validate()
    pool = prepare_pool(faces, 32, 1)

    def build_ae(device):
        gen = torch.Generator().manual_seed(5)
        model = ae.create_autoencoder(32, 1, 256, generator=gen, device=device)
        gaussian_overwrite(model, gen)
        return model, adam(1e-3).init(list(model.parameters())), AEStep(cfg, model)

    (m_c, o_c, s_c), (m_g, o_g, s_g) = build_ae("cpu"), build_ae(dev)
    before = [p.detach().clone() for p in m_c.parameters()]
    draws = ae_epoch_draws(torch.Generator().manual_seed(7), cfg.batch_size, 256,
                           s_c.mask_specs)[0]
    loss_c = float(s_c(m_c, o_c, pool, draws))
    loss_g = float(s_g(m_g, o_g, pool.to(dev), type(draws)(*map(move, draws))))
    ok, line = errs(m_g, o_g, m_c, o_c, before)
    ok &= abs(loss_g - loss_c) <= AE_LOSS_RTOL * abs(loss_c)
    print(f"ae step parity fp32, card vs CPU, scale 32 gray noiseDim 256 batch 32, relative "
          f"l2 errors: {line} (tolerance {AE_STEP_TOL}); L1 loss {loss_g:.7f} / {loss_c:.7f}; "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the card's fp32 autoencoder step disagrees with the CPU's")

    cfg = TrainConfig(scale=16, coef_l1=1e-4).validate()
    pool = prepare_pool(faces, 16, 3)

    def build_denoiser(device):
        enc, dec1, dec2 = ae.init_denoiser(torch.Generator().manual_seed(5), 16, 3, device=device)
        st = DenoiserState(enc, dec1, dec2, adam(1e-3).init(list(dec1.parameters())),
                           adam(1e-3).init(list(dec2.parameters())))
        return st, DenoiserStep(cfg, dec1)

    (st_c, s_c), (st_g, s_g) = build_denoiser("cpu"), build_denoiser(dev)
    before = {k: [p.detach().clone() for p in getattr(st_c, k).parameters()]
              for k in ("dec1", "dec2")}
    draws = denoiser_epoch_draws(torch.Generator().manual_seed(8), cfg.batch_size,
                                 cfg.img_shape, 256, s_c.mask_specs)[0]
    loss_c = s_c(st_c, pool, draws)
    loss_g = s_g(st_g, pool.to(dev), DenoiserDraws(*map(move, draws))).cpu()
    torch.cuda.synchronize()
    ok = bool(((loss_g - loss_c).abs() <= AE_LOSS_RTOL * loss_c.abs()).all())
    lines = []
    for k, opt in (("dec1", "opt1"), ("dec2", "opt2")):
        net_ok, line = errs(getattr(st_g, k), getattr(st_g, opt), getattr(st_c, k),
                            getattr(st_c, opt), before[k])
        ok &= net_ok
        lines.append(f"AE{k[-1]}'s decoder: {line}")
    print(f"denoiser step parity fp32, card vs CPU, scale 16 colour batch 32 coefL1 1e-4, "
          f"relative l2 errors: {'; '.join(lines)} (tolerance {AE_STEP_TOL}); BCE "
          f"{loss_g.tolist()} / {loss_c.tolist()}; {'ok' if ok else 'FAIL'}")
    check(ok, "the card's fp32 denoiser step disagrees with the CPU's")


def phase_graph_parity():
    """3 graphed GAN steps (one eager warm-up, the capture, 2 replays)
    against 3 eager steps from the same state on the same draws, in fp32
    with TF32 off and in bf16 at the default flags; then the control
    ``_graph_control``."""
    import contextlib

    import torch

    from facegen_torch.config import TrainConfig
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.data.synthetic import draw_synthetic_faces
    from facegen_torch.models import gan
    from facegen_torch.sample import full_fp32
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.train.step import TrainStep, draw_step, init_state

    dev = torch.device("cuda", 0)
    pool = prepare_pool(draw_synthetic_faces(torch.Generator().manual_seed(6), 1000), 32, 3)
    pool = pool.to(dev)
    for dtype, tol in (("float32", GRAPH_FP32_TOL), ("bfloat16", GRAPH_BF16_TOL)):
        cfg = TrainConfig(compute_dtype=dtype).validate()

        def build():
            g, d = gan.init_gan(torch.Generator().manual_seed(5), cfg.scale, cfg.channels,
                                cfg.noise_dim, reference_init=cfg.reference_init, device=dev)
            return init_state(cfg, g, d), TrainStep(cfg, g, d)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with full_fp32() if dtype == "float32" else contextlib.nullcontext():
            (eager, eager_step), (graphed, graphed_step) = build(), build()
            gen = torch.Generator(dev).manual_seed(7)
            for _ in range(3):
                eager_step(eager, pool, draw_step(gen, cfg, pool.shape[0], eager_step.mask_specs))
            runner = GraphedStep(graphed_step, graphed, pool.shape[0])
            runner.set_pool(pool)
            ms = runner.run(torch.Generator(dev).manual_seed(7), 3)
            torch.cuda.synchronize()
        errs = {}
        for net in ("g", "d"):
            ours, ref = getattr(graphed, net).state_dict(), getattr(eager, net).state_dict()
            errs[f"{net} params"] = _rel_l2(list(ours.values()), [t.cpu() for t in ref.values()])
            for kind in ("mu", "nu"):
                ref = [t.cpu() for t in getattr(eager, f"opt_{net}")[kind]]
                errs[f"{net} {kind}"] = _rel_l2(getattr(graphed, f"opt_{net}")[kind], ref)
        same = all(torch.equal(getattr(graphed, k), getattr(eager, k)) for k in (
            "accs_n", "confusion", "trained_d", "not_trained_d"))
        same &= all(torch.equal(getattr(graphed, f"opt_{n}")["count"],
                                getattr(eager, f"opt_{n}")["count"]) for n in ("g", "d"))
        ok = (same and runner.graph is not None and all(v <= tol for v in errs.values())
              and bool(torch.isfinite(ms.loss_d).all()))
        print(f"graph parity {dtype}{' (TF32 off)' if dtype == 'float32' else ''}, 3 graphed vs "
              f"3 eager steps, relative l2: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tolerance {tol}); gate {int(graphed.trained_d)}/"
              f"{int(graphed.trained_d) + int(graphed.not_trained_d)}, counters "
              f"{'equal' if same else 'DIFFER'}; capture {runner.capture_ms:.1f} ms, "
              f"{runner.pool_mib:.1f} MiB reserved by it, max memory allocated in the phase "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB (two states, the pool, "
              f"the eager and graphed steps); {'ok' if ok else 'FAIL'}")
        check(ok, f"the graphed {dtype} step disagrees with the eager step")
    _graph_control(pool)


def _state_diffs(a, b):
    """Relative l2 of ``a``'s parameters, statistics and Adam moments
    against ``b``'s, per network and kind, and the leaf whose relative l2
    is largest."""
    errs, worst = {}, (0.0, "")
    for net in ("g", "d"):
        sa, sb = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        leaves = {f"{net}.{k}": (sa[k], sb[k]) for k in sa}
        for kind in ("mu", "nu"):
            for i, (x, y) in enumerate(zip(getattr(a, f"opt_{net}")[kind],
                                           getattr(b, f"opt_{net}")[kind])):
                leaves[f"{net}.{kind}[{i}]"] = (x, y)
        errs[f"{net} params"] = _rel_l2([sa[k] for k in sa], [sb[k].cpu() for k in sa])
        for kind in ("mu", "nu"):
            errs[f"{net} {kind}"] = _rel_l2(getattr(a, f"opt_{net}")[kind],
                                            [t.cpu() for t in getattr(b, f"opt_{net}")[kind]])
        for name, (x, y) in leaves.items():
            worst = max(worst, (_rel_l2([x], [y.cpu()]), name))
    return errs, worst


def _graph_control(pool):
    """At the setting the card tests first used (scheme init, zero G
    biases, --G_L2 0; fp32, TF32 off), from one state on one set of draws:
    3 eager steps against 3 eager steps, and 3 graphed steps against 3
    eager, first with cuDNN free to choose its algorithms (the trainer's
    setting) and then with its deterministic ones. Prints the relative l2
    of each pair and its worst leaf; with deterministic algorithms both
    pairs must be bit-equal."""
    import torch

    from facegen_torch.config import TrainConfig
    from facegen_torch.models import gan
    from facegen_torch.sample import full_fp32
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.train.step import TrainStep, draw_step, init_state

    dev = pool.device
    cfg = TrainConfig(compute_dtype="float32", reference_init=False).validate()

    def build():
        g, d = gan.init_gan(torch.Generator().manual_seed(5), cfg.scale, cfg.channels,
                            cfg.noise_dim, reference_init=False, device=dev)
        return init_state(cfg, g, d), TrainStep(cfg, g, d)

    def eager():
        state, step = build()
        gen = torch.Generator(dev).manual_seed(7)
        for _ in range(3):
            step(state, pool, draw_step(gen, cfg, pool.shape[0], step.mask_specs))
        return state

    def graphed():
        state, step = build()
        runner = GraphedStep(step, state, pool.shape[0])
        runner.set_pool(pool)
        runner.run(torch.Generator(dev).manual_seed(7), 3)
        return state

    saved = torch.backends.cudnn.deterministic
    try:
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            with full_fp32():
                ref, again, replayed = eager(), eager(), graphed()
                torch.cuda.synchronize()
            for label, other in (("eager vs eager", again), ("graphed vs eager", replayed)):
                errs, (worst, leaf) = _state_diffs(other, ref)
                print(f"graph control fp32 (TF32 off), scheme init, zero G biases, G_L2 0, cuDNN "
                      f"{'deterministic' if deterministic else 'free'}: {label}, 3 steps, relative "
                      f"l2: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                      + f"; worst leaf {leaf} {worst:.3e}")
                check(not deterministic or worst == 0.0,
                      f"{label} differ under cuDNN's deterministic algorithms")
    finally:
        torch.backends.cudnn.deterministic = saved


def _metrics_rows(save: str):
    import math

    with open(os.path.join(save, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    for r in rows:
        check(math.isfinite(r["loss_d_mean"]) and math.isfinite(r["loss_g_mean"]),
              f"non-finite losses in {r}")
    return rows


def phase_epochs_per_compile(tmp: str, store: str):
    """``train.main --epochsPerCompile 4 --noplot --epochs 8 --saveFreq 4``
    at the default flags; returns the kernels' launch counts in that run."""
    import torch

    from facegen_torch import train
    from facegen_torch.train.step import steps_per_epoch

    save = os.path.join(tmp, "epc_logs")
    argv = ["--datasetDir", store, "--save", save, "--epochsPerCompile", "4", "--noplot",
            "--epochs", "8", "--saveFreq", "4"]
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    trainer = train.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _launches()
    steps = 8 * steps_per_epoch(trainer.cfg)
    print(f"epochsPerCompile path: train.main {' '.join(argv[4:])} took {run_s:.3f} s for "
          f"{steps} steps; {trainer.readbacks} read-backs; launches {launches}")
    want = {"upsample_conv_fwd": 4 * steps, "upsample_conv_dx": 2 * steps,
            "upsample_conv_dw": 2 * steps}
    check(launches == want, f"launches {launches}, want {want}")
    check(trainer.epochs_per_compile == 4 and trainer.readbacks == 2,
          f"{trainer.epochs_per_compile} epochs per chunk, {trainer.readbacks} read-backs")
    rows = _metrics_rows(save)
    check([r["epoch"] for r in rows] == list(range(1, 9)), f"epochs {[r['epoch'] for r in rows]}")
    for name in ("adversarial", "adversarial.old"):
        _check_files(os.path.join(save, name, "arrays.npz"))
    with open(os.path.join(save, "adversarial", "meta.json")) as f:
        check(json.load(f)["epoch"] == 9, "the last checkpoint is not at epoch 9")
    print(f"epochsPerCompile path: chunk 1 (the eager warm-up step and the capture inside) "
          f"{rows[0]['images_per_sec']:.1f} images/s, chunk 2 (warm) "
          f"{rows[4]['images_per_sec']:.1f} images/s (host clock {4 * rows[4]['seconds']:.3f} s "
          f"for 4 x {steps // 8} steps and the chunk's read-back; pools outside the clock)")
    return launches


def phase_weights_vis(tmp: str, store: str):
    """``train.main --weightsVisFreq 16 --epochs 1`` at the default flags:
    activation dumps after steps 16, 32, 48 and 63; returns the kernels'
    launch counts in that run."""
    import torch

    from facegen_torch import train
    from facegen_torch.train.step import steps_per_epoch

    save = os.path.join(tmp, "netvis_logs")
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    trainer = train.main(["--datasetDir", store, "--save", save, "--weightsVisFreq", "16",
                          "--epochs", "1"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _launches()
    steps = steps_per_epoch(trainer.cfg)
    # per step 4 forward, 2 dx, 2 dW; the grid set 4 forward; each dump's
    # G (fp32, eval) 2 forward
    want = {"upsample_conv_fwd": 4 * steps + 4 + 2 * 4, "upsample_conv_dx": 2 * steps,
            "upsample_conv_dw": 2 * steps}
    print(f"weightsVisFreq path: train.main --weightsVisFreq 16 --epochs 1 took {run_s:.3f} s; "
          f"launches {launches}")
    check(launches == want, f"launches {launches}, want {want}")
    root = os.path.join(save, "viz", "netvis")
    dumps = sorted(os.listdir(root))
    check(dumps == [f"e0001_s{s:05d}" for s in (16, 32, 48, 63)], f"dumps {dumps}")
    for dump in dumps:
        for sub, want_keys in (("", ("conv", "fc")), ("g", ("upconv", "fc"))):
            files = sorted(f for f in os.listdir(os.path.join(root, dump, sub))
                           if f.endswith(".png"))
            check(all(any(k in f for f in files) for k in want_keys),
                  f"{dump}/{sub}: PNGs {files}")
            _check_files(*(os.path.join(root, dump, sub, f) for f in files))
    print(f"weightsVisFreq path: dumps {dumps}, each with D's "
          f"{sorted(f for f in os.listdir(os.path.join(root, dumps[0])) if f.endswith('.png'))} "
          f"and G's {sorted(os.listdir(os.path.join(root, dumps[0], 'g')))}")
    return launches


def phase_lfw_builder(tmp: str):
    """Pack a tree of 256 seeded 250x250 JPEGs in 32 person directories
    with ``python -m facegen_torch.data.lfw``, then train one epoch on the
    store; returns the kernels' launch counts in that epoch."""
    import numpy as np
    import torch
    from PIL import Image

    from facegen_torch import train
    from facegen_torch.train.step import steps_per_epoch

    tree, out = os.path.join(tmp, "lfw_tree"), os.path.join(tmp, "lfw64.npy")
    rs = np.random.RandomState(0)
    for p in range(32):
        person = os.path.join(tree, f"Person_{p:02d}")
        os.makedirs(person)
        for k in range(8):
            coarse = rs.rand(27, 27, 3)
            img = np.kron(coarse, np.ones((10, 10, 1)))[:250, :250] * 200
            img += rs.rand(250, 250, 3) * 55
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(person, f"Person_{p:02d}_{k:04d}.jpg"), quality=90)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "facegen_torch.data.lfw", "--path", tree,
                          "--out", out], cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=300)
    pack_s = time.perf_counter() - t0
    check(run.returncode == 0, f"python -m facegen_torch.data.lfw failed: {run.stderr[-2000:]}")
    store = np.load(out, mmap_mode="r")
    check(store.shape == (256, 64, 64, 3) and store.dtype == np.uint8,
          f"store {store.shape} {store.dtype}")
    check(float(store.std()) > 10, f"store std {float(store.std())}")
    print(f"lfw builder: python -m facegen_torch.data.lfw packed 256 JPEGs (250x250, 32 person "
          f"directories) in {pack_s:.3f} s (with the interpreter's start): {store.shape} "
          f"{store.dtype}, mean {float(store.mean()):.2f}")
    save = os.path.join(tmp, "lfw_logs")
    torch.cuda.synchronize()
    _reset_launches()
    trainer = train.main(["--datasetDir", out, "--save", save, "--epochs", "1", "--noplot"])
    torch.cuda.synchronize()
    launches = _launches()
    steps = steps_per_epoch(trainer.cfg)
    want = {"upsample_conv_fwd": 4 * steps, "upsample_conv_dx": 2 * steps,
            "upsample_conv_dw": 2 * steps}
    check(launches == want, f"launches {launches}, want {want}")
    check(trainer.source.size == 256, f"the trainer's store has {trainer.source.size} rows")
    rows = _metrics_rows(save)
    check(len(rows) == 1, f"{len(rows)} metrics rows")
    print(f"lfw builder: one epoch of train.main on the store: loss_d {rows[0]['loss_d_mean']:.4f} "
          f"loss_g {rows[0]['loss_g_mean']:.4f}, {rows[0]['images_per_sec']:.1f} images/s; "
          f"launches {launches}")
    return launches


def main() -> int:
    try:
        name = phase_device()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    import torch

    # the checks against plain versions and the CPU run in full fp32; the
    # CLIs run with torch's default TF32 settings, as a user's run does
    from facegen_torch.sample import full_fp32

    try:
        phase_build()
        with full_fp32():
            summary = {"upsample_conv_fwd": phase_kernels()}
            bwd = phase_bwd_kernels()
        summary["upsample_conv_dx"], summary["upsample_conv_dw"] = bwd["dx"], bwd["dw"]
        with tempfile.TemporaryDirectory() as tmp:
            store = write_store(tmp)
            by_path = {"sampler": phase_main_path(tmp, store)}
            by_path["training"] = launches = phase_training(tmp, store)
            c2f_save, by_path["c2f_training"] = phase_c2f_training(tmp, store)
            by_path["c2f_sampler"] = phase_c2f_sampler(tmp, c2f_save)
            by_path["ae_training"] = phase_ae_training(tmp, store)
            den_save, by_path["denoiser_training"] = phase_denoiser_training(tmp, store)
            by_path["training_denoise"] = phase_training_denoise(store, den_save)
            by_path["training_epochs_per_compile"] = phase_epochs_per_compile(tmp, store)
            by_path["training_weights_vis"] = phase_weights_vis(tmp, store)
            by_path["training_lfw_store"] = phase_lfw_builder(tmp)
        with full_fp32():
            phase_step_parity()
            phase_c2f_step_parity()
            phase_ae_step_parity()
        phase_graph_parity()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(f"launches by path: {json.dumps(by_path)}")
    # launches: the training path's 2-epoch run, which runs all three
    # kernels; max_abs_err (bf16) and ms (both layers at N = 32) at its
    # shapes; launches_by_path: each path's run, counted from 0
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **summary[name],
         "launches_by_path": {path: counts[name] for path, counts in by_path.items()}}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
