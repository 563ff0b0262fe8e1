#!/usr/bin/env python3
"""Smoke run of facegen_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles the CUDA kernels from facegen_torch/csrc (the
   upsample-conv's three, the update's two, csrc/fused_update.cu, and the
   batch norm + PReLU's four, csrc/bn_prelu.cu), one nvcc per source, in
   parallel (seconds), prints ptxas's registers and spills, and fails
   unless the bf16 forward, dx and dW kernels hold HGMMA (wgmma)
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
   every kernel's launch count against the steps and grids (the update's
   two kernels once per net a step, also in every later GAN path), finite
   losses, metrics.jsonl, the checkpoint and its .old; holds one fp32 step
   on the card against the same step on the CPU; reports training
   images/s, the capture, and the ms per step and a profile of the step
   by kernel family with the device's busy share, for the graphed step
   and for the eager step in the same call, then the graphed step with
   the update's kernels against the same step recaptured with the plain
   update (fused, plain, plain, fused: kernels a step, device time, the
   elementwise share, ms on the stream); phases 7, 10 and 11 do the same;
7. c2f training path: ``facegen_torch.train_c2f.main`` at the default
   flags (fine 32, coarse 16, colour, batch 32, bf16) on the store for 2
   epochs of 63 steps with --saveFreq 1, then a resume for a third; checks
   the checkpoint, its .old, the _best checkpoint with a finite parzen,
   the sample grid and finite losses; reports c2f training images/s, the
   approxParzen ms (6400 refinements); checks the logged step route (a
   CUDA graph replay a step, train/graph.py) and that the capture launched
   none of the port's kernels, and reports the capture's ms and the MiB it
   reserved, then the graphed and the eager step on the same state in
   turns: ms per step on the stream, and a profile by kernel family with
   the device's busy share;
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
    epoch's images/s; the route, the capture and the graphed against the
    eager step as phase 7 does;
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
    shape and type, and one epoch of ``train.main`` on it;
18. data parallel, a 1-rank NCCL group: ``python -m facegen_torch.train
    --meshShape -1`` at the default flags as the one rank of a group
    (FACEGEN_COORDINATOR on a free local port), 2 epochs with --saveFreq
    1: the route (the all-reduces inside the CUDA graph), every kernel's
    launches, metrics.jsonl and the checkpoints; then, in this process,
    a 1-rank NCCL group's graphed step against the single-device graphed
    step, 3 steps from one state in fp32 (TF32 off) under cuDNN's
    deterministic algorithms (bit-equal), and both timed at the default
    flags on the stream and profiled (busy share);
19. data parallel, two ranks sharing the card over gloo (NCCL refuses
    two ranks on one device), run as two processes of this script
    (``--dp-gloo-rank``), and the same 2-rank program on the CPU: 3 fp32
    steps (cuDNN deterministic) at the default flags (local batch 16) on
    per-rank draws from numpy; the card's ranks bit-equal, the card against the CPU within
    the tolerances, the launches by shape (the forward at N = 8 and 16,
    dx and dW at N = 16) and the gloo step's time at the default flags;
20. data-parallel serving: ``run_sampling`` on two replicas sharing the
    card (--runs 2 --neighbours) against one device from the same seed:
    the files, the launches, the wall time; the replicas' images, scores
    and neighbours against one device's in fp32 and in bf16;
21. the quality report: ``python -m facegen_torch.eval.parity`` at full
    width (``--n 1024 --n_train 4096`` on the store) in its three modes,
    with phase 5's seeded checkpoint as A (phase 6's, 3 epochs from the
    reference's init, has a flat G and constant D features, and A's D
    embeds): against phase 6's checkpoint (``--network_b``), against a
    32x32 grid of 1024 of A's samples on other noise (``--samples_b``) and
    alone; facegen's keys, finite numbers and the forward kernel's 4 + 2 +
    2 launches; each run's wall time and the G calls' device ms; the fp32
    report on the card (TF32 off) against the CPU's on the same injected
    draws (n = 256), A against a second seeded GAN, within the CPU tests'
    tolerances;
22. export: ``python -m facegen_torch.export`` of A (phase 5's checkpoint),
    ``NumpyGenerator`` against the card's fp32 G on 64 noise vectors;
23. the trainer's ``trace_dir`` at the default flags for 2 epochs: the
    per-op table of the traced epoch lists UpconvFwd, UpconvDx and UpconvDw
    at 63 x (4, 2, 2) calls, its device time per step within 25 % of phase
    6's profile of the graphed step; ``debug_nans``: 2 eager steps with
    finite losses, then a NaN G weight that must raise;
24. the 2-D data x model mesh (parallel/gspmd.py) at world 1 under NCCL:
    ``make_mesh2d(1, 1)`` of a 1-rank group, its graphed step (all-reduces
    and all-gathers inside the graph) bit-equal to the single-device
    graphed step in fp32 under cuDNN's deterministic algorithms, both
    timed on the stream and profiled at the default flags; the c2f,
    autoencoder and denoiser trainers on that mesh, 3 graphed steps each
    bit-equal to the same trainer's graphed steps on one device; and a
    Trainer on that mesh for one epoch (--N_epoch 256, graphed, every
    kernel);
25. four gloo ranks sharing the card (``maybe_initialize(backend='gloo')``
    before the CLI) on the 2x2 mesh: ``python -m facegen_torch.train --meshShape 2,2`` at the
    default flags for one epoch (--N_epoch 256) from a TCP coordinator,
    its launches per rank; then the step alone (the script re-run with
    ``--gspmd-gloo-rank``), 3 fp32 steps on the global draws against the
    single-device step on the card within 1e-3 relative l2, the four
    gathered states bit-equal, the launches by shape (the forward at
    N = 8 and 16, dx and dW at N = 16), the bf16 step's time, and the
    kernels' rows of phases 3-4 at those local shapes;
26. the c2f, autoencoder and denoiser CLIs at --meshShape 2 (the 2x1
    mesh) on two gloo ranks sharing the card, one epoch each, and 3 fp32
    steps of each on that mesh against its single-device step on the card;
27. ``run_sampling`` at --meshShape 2,2 over ["cuda:0"] * 4 (two replica
    groups holding the large leaves as shards) against one device: the
    files, the launches, the images and scores in fp32 and bf16;
28. the uneven (3, 1) mesh, three gloo ranks sharing the card: ``python -m
    facegen_torch.train --meshShape 3,1`` at the default flags and the c2f,
    autoencoder and denoiser CLIs at --meshShape 3 for one epoch each
    (--N_epoch 256), the launches per rank; 3 fp32 GAN steps at batch 32
    (local batches 6, 6, 4 in the D phase, 11, 11, 10 in the G phase) and at
    batch 4 (rank 2 holds no rows and launches nothing) and 3 of each of
    the family, against the single-device steps on the card; the kernels'
    rows of phases 3-4 at those local shapes (phase 4 also checks the
    wrappers at N = 0);
29. ``--boundaryPad 8``: the trainer CLI at the default flags for one
    epoch, graphed, with the unpadded launches (4, 2, 2 a replay); its step
    and the unpadded one timed on the stream in turns and profiled; 3
    graphed fp32 steps against the unpadded ones; 3 fp32 c2f steps against
    the unpadded ones, and the c2f CLI with --boundaryPad 8 for one epoch;
30. ``guard_nonfinite`` in the graphed step with every D weight NaN: no
    update lands and not_trained_d counts every step;
31. the c2f, autoencoder and denoiser trainers' graphed steps against the
    same trainers built with ``capture=False``: 3 steps each from one
    state on the same pool and draws under cuDNN's deterministic
    algorithms, fp32 (TF32 off) within 1e-5 relative l2 over the
    parameters, batch-norm statistics, Adam's moments and the losses, and
    the c2f's bf16 at its default flags within 1e-3; with cuDNN free to
    choose, eager against eager and graphed against eager (printed: the
    c2f's fp32 convs then differ run to run).

32. the update's two kernels (csrc/fused_update.cu; run after phase 4):
    prep (the penalty's gradient, the clamp, sum |p| and sum p^2, the
    count of entries that are not finite) and the gated update against
    their plain versions on the leaves of G32, D32b, G16, D16_d, the c2f's
    G and D, the autoencoder and a denoiser decoder at full width (Adam;
    Adagrad, SGD and SGD with momentum on D32b), a closed gate bit-equal,
    a second launch bit-equal, the tickets left at 0; then both timed at
    the GAN step's leaves (D32b's and G32's at the default flags) in turns
    with the plain versions and, for the update, torch._fused_adam_ on the
    same leaves (ungated, no penalty): each row's bound (bytes at
    3.35 TB/s) and share of it.
33. the batch norm + PReLU kernels (csrc/bn_prelu.cu; run after phase 32):
    the train-mode statistics and apply, the eval apply and the backward's
    reduction and dx against their plain versions (ops/bn_prelu.py) and
    against BatchNorm then PReLU under autograd, bf16 and fp32, at G32's
    two pairs at N = 16 and 32 (train) and G32's and G16's at N = 1024
    (eval, bit-equal), with their launches; then each kernel's row of the
    table in bf16 at those shapes: its device ms from the profiler's
    events (exactly one a call, or the phase fails), its bound (bytes at
    3.35 TB/s) and share of it (above 1.05 fails), and the ms of the whole
    forward or backward it belongs to beside its plain version's and the
    library's (F.batch_norm then F.prelu). Every path's launch count of
    the four kernels (one counter) is checked: 12 a GAN training step
    (none where the batch norms train over a mesh) and 2 a G call in eval.

Every step profile (phases 5-29) reads the device's events from a trace
(facegen_torch.utils.profiling: ``trace`` + ``aggregate_trace``) and the
host's wall time from as many untraced steps run just before.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero before printing either.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
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
    # the update's two kernels stand for no Pallas kernel but for XLA's
    # fusion of facegen's tree.maps: the penalty, clamp and finite check,
    # and the gated optax update
    "fused_prep": ("facegen_torch/csrc/fused_update.cu", "facegen/train/losses.py:32"),
    "fused_update": ("facegen_torch/csrc/fused_update.cu", "facegen/train/optim.py:48"),
    # G's batch norm + PReLU pairs: no Pallas kernel either, XLA's fusion of
    # facegen/nn/layers.py's batch_norm and prelu
    "bn_prelu_stats": ("facegen_torch/csrc/bn_prelu.cu", "facegen/nn/layers.py:169,126"),
    "bn_prelu_apply": ("facegen_torch/csrc/bn_prelu.cu", "facegen/nn/layers.py:169,126"),
    "bn_prelu_bwd_reduce": ("facegen_torch/csrc/bn_prelu.cu", "facegen/nn/layers.py:169,126"),
    "bn_prelu_bwd_dx": ("facegen_torch/csrc/bn_prelu.cu", "facegen/nn/layers.py:169,126"),
}
UPCONV = ("upsample_conv_fwd", "upsample_conv_dx", "upsample_conv_dw")
BN_PRELU = ("bn_prelu_stats", "bn_prelu_apply", "bn_prelu_bwd_reduce", "bn_prelu_bwd_dx")
# the kernels counted one by one (the four batch norm + PReLU kernels share
# one counter, "bn_prelu" in _launches, ops/bn_prelu.py:BN_PRELU_LAUNCHES)
COUNTED = UPCONV + ("fused_prep", "fused_update")
SOURCES = ("upsample_conv", "upsample_conv_bwd", "fused_update", "bn_prelu")

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
# G32's two layers at the local batch of a 2-rank data-parallel step
# (global batch 32), which is also a rank's on the 2x2 mesh (two data
# rows): the forward at N = 8 in the D phase and 16 in the G phase, dx and
# dW at N = 16
DP_FWD_SHAPES = [(8, 8, 128, 256, 5), (8, 16, 256, 128, 5)]
DP_BWD_SHAPES = [(16, 8, 128, 256, 5), (16, 16, 256, 128, 5)]
DP_ROWS = []  # the kernel table's rows at those shapes
# G32's two layers at the local batches of the (3, 1) mesh at batch 32
# (parallel/gspmd.py:row_block): the forward at N = 6 and 4 in the D phase
# (each half's 16 rows split 6, 6, 4), dx and dW at N = 11 and 10 in the G
# phase (32 rows split 11, 11, 10), where the forward runs at those N too
G32_LAYERS = ((8, 128, 256), (16, 256, 128))
UNEVEN_FWD_SHAPES = [(n, h, cin, cout, 5) for n in (6, 4) for h, cin, cout in G32_LAYERS]
UNEVEN_BWD_SHAPES = [(n, h, cin, cout, 5) for n in (11, 10) for h, cin, cout in G32_LAYERS]
UNEVEN_ROWS = []  # the kernel table's rows at those shapes

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
# 2 ranks sharing the card over gloo against the same 2-rank program on
# the CPU, 3 fp32 steps (TF32 off, cuDNN deterministic), relative l2 per
# network: the parameters' change and Adam's moments within 1e-3;
# counters and confusion equal; the card's two ranks bit-equal
DP_TOL = 1e-3
# the sampler on 2 replicas against one device, fp32 with TF32 off: the
# same convs on half the batch, where cuDNN may choose other algorithms
DP_SERVE_FP32_TOL = 1e-5

# the exported G on NumPy against the card's fp32 G (TF32 off): nine fp32
# sums in other orders over trained weights, ~1e-6
EXPORT_TOL = 1e-4

# the update's kernels against their plain versions on the same card
# tensors: gradients, parameters and optimizer states within 1e-6 relative
# l2 (each product and sum rounded alone on both sides; powf and rsqrtf may
# differ in the last bit); prep's sums of |p| and p^2 within 1e-5 relative
# (fp64 partials against fp32 sums); counts exact
UPDATE_TOL = 1e-6
SUMS_RTOL = 1e-5
# the batch norm + PReLU kernels against their plain versions and against
# BatchNorm then PReLU on the same card tensors (the card tests'
# tolerances): in eval the output bit for bit; in train the batch's mean
# and rstd and the moved running statistics within 1e-5 relative l2 (fp64
# block merges against torch's reductions), the output within the rounding
# a last-bit change of the statistics can flip (BN_Y_TOL), dx within
# BN_DX_TOL of its largest entry, the weight's and bias's gradients within
# 1e-4 relative l2, the slope's within one bf16 rounding (fp32: 1e-4)
BN_STAT_TOL = 1e-5
BN_Y_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=2e-2, rtol=2.0 ** -7)}
BN_DX_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
BN_PARAM_TOL = 1e-4
# G32's and G16's batch norms, (H, C): 16x16x256 and 32x32x128; 8x8x256
# and 16x16x128
BN_LAYERS = {"G32.bn1": (16, 256), "G32.bn2": (32, 128), "G16.bn1": (8, 256),
             "G16.bn2": (16, 128)}
# the main paths' pairs, (layer, N, train): G32's in train mode at N = 16
# (the D phase's no-grad fakes) and 32 (the G phase, forward and
# backward), and in eval at the sampler's N = 1024, G16's too (the c2f
# sampler's base)
BN_SHAPES = ([(layer, n, True) for layer in ("G32.bn1", "G32.bn2") for n in (16, 32)]
             + [(layer, 1024, False) for layer in BN_LAYERS])
# a kernel's reading is refused above this share of its bound: faster than
# the bytes allow means the timer saw other events or too few of them
MAX_SHARE = 1.05

# the H100 SXM's published dense bf16 tensor-core rate, fp32 rate outside
# the tensor cores, and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
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
                                              + ODD_SHAPES + DP_FWD_SHAPES + UNEVEN_FWD_SHAPES
                                              + UNEVEN_BWD_SHAPES):
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
    for n, h, cin, cout, k in (G_SHAPES + G16_SAMPLER_SHAPES + TRAIN_SHAPES + FWD_TRAIN_SHAPES[:2]
                               + DP_FWD_SHAPES + UNEVEN_FWD_SHAPES):
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
        dp = (n, h, cin, cout, k) in DP_FWD_SHAPES
        uneven = (n, h, cin, cout, k) in UNEVEN_FWD_SHAPES
        row = _row("upsample_conv_fwd", (n, h, cin, cout), t, runs, flop, nbytes,
                   launches_per_g_call=1 if sampler else 0,
                   launches_per_step=0 if sampler or dp or uneven else 1,
                   launches_per_rank_step_2_ranks=1 if dp else 0,
                   launches_per_rank_step_2x2=1 if dp else 0,
                   launches_per_rank_step_3x1=1 if uneven else 0)
        if dp:
            DP_ROWS.append(row)
        if uneven:
            UNEVEN_ROWS.append(row)
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
    check(by_kernel["bn_prelu"] == _bn_prelu(g_calls=runs),
          f"expected {_bn_prelu(g_calls=runs)} batch norm + PReLU launches (2 a G call), got "
          f"{by_kernel}")
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


def _device_ops(fn):
    """The device's events while ``fn()`` runs, summed by name: a trace of
    it (facegen_torch.utils.profiling.trace) and its per-op table
    (aggregate_trace; kernels, copies and fills on the GPU's tracks)."""
    import torch

    from facegen_torch.utils.profiling import aggregate_trace, trace

    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir):
            fn()
            torch.cuda.synchronize()
        return aggregate_trace(logdir, top=1 << 30)


def _by_family(ops, families, other):
    """Device us of ``aggregate_trace`` rows by family of kernel name."""
    us = dict.fromkeys(list(families) + [other], 0.0)
    for r in ops:
        name = r["name"].lower()
        us[next((f for f, keys in families.items() if any(k in name for k in keys)),
                other)] += r["total_us"]
    return us


def _profile_g_call(inf, gen, calls=3):
    """Device time of one generate_n(1024), by kernel family (a trace's
    device events)."""
    summary = _device_ops(lambda: [inf.generate_n(gen, 1024) for _ in range(calls)])
    families = {"upsample-conv forward (igemm_sm90)": ("igemm_sm90", "upconvfwd"),
                "batch norm": ("batch_norm", "batchnorm", "bn_"),
                "cuDNN / cuBLAS (conv_out, fc)": ("cudnn", "xmma", "gemm", "conv", "cutlass"),
                "PReLU": ("prelu",)}
    us = _by_family(summary["ops"], families, "other (casts, sigmoid, noise, copies)")
    total = summary["total_us"] / calls / 1e3
    check(total > 0, "the profiler saw no device time in generate_n")
    print(f"main path: G call device time {total:.4f} ms (torch.profiler trace, {calls} calls "
          f"of generate_n(1024), device events): " + "; ".join(
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
                                              + DW_TMA_SHAPES + DP_BWD_SHAPES
                                              + UNEVEN_BWD_SHAPES):
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
    _check_empty_batches()

    # kernel, plain version and one library call, in alternating turns:
    # dx, cuDNN's conv of a pre-made S2D(dy) with the pre-made flipped and
    # transposed phase weight; dW, torch.nn.grad.conv2d_weight of the
    # phase conv (bf16, as the kernel's inputs)
    rows = {"dx": [], "dw": []}
    for n, h, cin, cout, k in TRAIN_SHAPES + DP_BWD_SHAPES + UNEVEN_BWD_SHAPES:
        dp = (n, h, cin, cout, k) in DP_BWD_SHAPES
        uneven = (n, h, cin, cout, k) in UNEVEN_BWD_SHAPES
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
                       launches_per_g_call=0, launches_per_step=0 if dp or uneven else 1,
                       launches_per_rank_step_2_ranks=1 if dp else 0,
                       launches_per_rank_step_2x2=1 if dp else 0,
                       launches_per_rank_step_3x1=1 if uneven else 0)
            if dp:
                DP_ROWS.append(row)
            if uneven:
                UNEVEN_ROWS.append(row)
            print(f"time bf16 {which} N={n} {h}x{h}x{cin}->{2 * h}x{2 * h}x{cout}: "
                  f"kernel {t['kernel']:.4f} ms ({row['tflops']:.1f} TFLOP/s, "
                  f"{100 * row['share_of_bound']:.1f} % of its {row['bound_ms']:.4f} ms bound), "
                  f"plain {t['plain']:.4f} ms, library {t['library']:.4f} ms"
                  + (f"; note: the WMMA kernel it replaced took "
                     f"{WMMA_DW_MS[(n, h, cin, cout)]:.4f} ms (not timed in this run: "
                     f"tools/compare_upconv_kernels.py against the parent tree)"
                     if which == "dw" and not (dp or uneven) else ""))
            if not (dp or uneven):  # the kernels line: the single-device step's shapes
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


def _check_empty_batches():
    """The wrappers at N = 0 (a data row of the (3, 1) mesh that holds no
    rows of a batch), at G32's two layers in both types: the forward and
    dx return empty tensors and dW zeros, as the plain versions on the CPU
    do, and nothing is launched or counted."""
    import torch

    from facegen_torch.ops import upsample_conv as uc

    for h, cin, cout in G32_LAYERS:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.empty(0, h, h, cin, device="cuda", dtype=dtype)
            dy = torch.empty(0, 2 * h, 2 * h, cout, device="cuda", dtype=dtype)
            w = torch.randn(cout, cin, 5, 5, device="cuda").to(dtype)
            wc, b = uc.collapse_weights(w), torch.zeros(cout, device="cuda", dtype=dtype)
            before = _launches()
            y, dx = uc.upsample_conv(x, wc, b), uc.upsample_conv_dx(dy, wc)
            dw = uc.upsample_conv_dw(x, dy)
            torch.cuda.synchronize()
            ref = (uc.upsample_conv_reference(x.cpu().float(), wc.cpu().float(), b.cpu().float()),
                   uc.upsample_conv_dx_reference(dy.cpu().float(), wc.cpu().float()),
                   uc.upsample_conv_dw_reference(x.cpu().float(), dy.cpu().float()))
            ok = (_launches() == before
                  and [tuple(t.shape) for t in (y, dx, dw)] == [tuple(t.shape) for t in ref]
                  and not bool(dw.abs().max()) and not bool(ref[2].abs().max()))
            print(f"empty batch {str(dtype)[6:]} N=0 {h}x{h}x{cin}->{2 * h}x{2 * h}x{cout}: "
                  f"forward {tuple(y.shape)}, dx {tuple(dx.shape)}, dW {tuple(dw.shape)} of "
                  f"zeros, as the plain versions; launches unchanged: {_launches() == before} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"the wrappers at N = 0 ({h}, {cin}, {cout}, {dtype})")


def _update_leaves(shapes, dev, seed, tx):
    """Seeded parameters, gradients (some beyond a clamp of 0.02) and
    ``tx``'s state three steps in, on the card."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    params = [(torch.randn(s, generator=gen) * 0.05).to(dev) for s in shapes]
    grads = [(torch.randn(s, generator=gen) * 0.012).to(dev) for s in shapes]
    state = tx.init(params)
    for key, v in state.items():
        if key == "count":
            v.fill_(3)
        else:
            for t in v:
                t.copy_((torch.rand(t.shape, generator=gen) * 1e-4).to(dev))
    return params, grads, state


def _state_list(state):
    from facegen_torch.ops.fused_update import _state_tensors

    return _state_tensors(state)


def _max_abs(ours, ref):
    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(ours, ref))


def _check_update_kernels(label, shapes, tx, dev, prep_args, gate, seed=0):
    """Both kernels over one net's leaves against their plain versions on
    copies of the same card tensors, a closed gate, and a second launch;
    returns (prep's max abs error, update's)."""
    import torch

    from facegen_torch.ops import fused_update as fu

    params, grads, state = _update_leaves(shapes, dev, seed, tx)
    again = [g.clone() for g in grads]
    ref_grads, ref_stats = fu.prep_reference(params, [g.clone() for g in grads], **prep_args)
    grads, stats = fu.prep(params, grads, **prep_args)  # in place on the card
    again, stats2 = fu.prep(params, again, **prep_args)  # a second launch on the same inputs
    ref_p = [p.clone() for p in params]
    ref_s = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
             for k, v in state.items()}
    fu.update_reference(tx, [g.clone() for g in grads], ref_s, ref_p, gate)
    kept = ([p.clone() for p in params], [t.clone() for t in _state_list(state)])
    closed = torch.zeros((), dtype=torch.bool, device=dev)
    fu.update(tx, grads, state, params, closed)
    torch.cuda.synchronize()
    closed_ok = (all(torch.equal(a, b) for a, b in zip(params, kept[0]))
                 and all(torch.equal(a, b) for a, b in zip(_state_list(state), kept[1])))
    fu.update(tx, grads, state, params, gate)
    torch.cuda.synchronize()
    closed_ok &= all(torch.equal(a, b) for a, b in zip(grads, again))
    closed_ok &= not fu._TICKETS[dev.index].any()  # every launch leaves them at 0
    prep_err, update_err = _max_abs(grads, ref_grads), _max_abs(params, ref_p)
    errs = {"grads": _rel_l2(grads, [g.cpu() for g in ref_grads]),
            "params": _rel_l2(params, [p.cpu() for p in ref_p])}
    for ours, ref in zip(_state_list(state), _state_list(ref_s)):
        if ours.dtype == torch.int32:
            closed_ok &= int(ours) == int(ref)
        else:
            errs["state"] = max(errs.get("state", 0.0), _rel_l2([ours], [ref.cpu()]))
    sums_err = 0.0
    if stats is not None:
        a, b = stats.cpu().double(), ref_stats.cpu().double()
        sums_err = float(((a[:2] - b[:2]).abs() / b[:2].abs().clamp(min=1e-30)).max())
        closed_ok &= bool(a[2] == b[2]) and torch.equal(stats, stats2)  # deterministic sums
    ok = closed_ok and all(v <= UPDATE_TOL for v in errs.values()) and sums_err <= SUMS_RTOL
    print(f"update kernels check {label} ({len(shapes)} leaves, "
          f"{sum(math.prod(sh) for sh in shapes)} parameters): relative l2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f", sums {sums_err:.3e} (tolerances {UPDATE_TOL}, {SUMS_RTOL}); max_abs_err prep "
          f"{prep_err:.3e}, update {update_err:.3e}; closed gate, count and second launch "
          f"{'bit-equal' if closed_ok else 'DIFFER'}; {'ok' if ok else 'FAIL'}")
    check(ok, f"the update's kernels disagree with their plain versions ({label})")
    return prep_err, update_err


def phase_update_kernels():
    """Phase 32: the update's two kernels against their plain versions on
    every trainer's nets at full width, then timed at the GAN step's leaves
    (D32b's and G32's at the default flags) in turns with the plain
    versions and, for the update, one library call (torch._fused_adam_ on
    the same leaves, ungated, no penalty). Returns the kernels line's
    numbers for both, summed over D's and G's launch of a step."""
    import torch

    from facegen_torch.config import TrainConfig
    from facegen_torch.models import ae, c2f, gan
    from facegen_torch.ops import fused_update as fu
    from facegen_torch.train.optim import make_optimizer

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    g32, d32b = gan.init_gan(gen, 32, 3, 100)
    g16, d16 = gan.init_gan(gen, 16, 3, 100)
    c2f_g, c2f_d = c2f.init_c2f(gen, 32, 3)
    nets = {"G32": g32, "D32b": d32b, "G16": g16, "D16_d": d16, "c2f G": c2f_g, "c2f D": c2f_d,
            "AE": ae.create_autoencoder(32, 1, 256, generator=gen),
            "denoiser decoder": ae.init_denoiser(gen, 16, 3)[1]}
    shapes = {k: [tuple(p.shape) for p in m.parameters()] for k, m in nets.items()}
    every = dict(sign_coef=1e-3, linear_coef=1e-4, clamp=0.02, sums=True, count=True)
    gate = torch.ones((), dtype=torch.bool, device=dev)
    for name, sh in shapes.items():
        _check_update_kernels(f"{name}, adam, penalty + clamp + sums + count", sh,
                              make_optimizer("adam", TrainConfig(), "D"), dev, every, gate)
    for method, flags in (("adagrad", {}), ("sgd", {}), ("sgd", {"d_sgd_momentum": 0.9})):
        tx = make_optimizer(method, TrainConfig(**flags), "D")
        _check_update_kernels(f"D32b, {tx.kind}", shapes["D32b"], tx, dev, every, gate)

    # the GAN step's two launches of each, at the default flags: D (the L2
    # penalty's gradient and sums, clamp 1, the accuracy gate on the
    # device) and G (clamp 5; no penalty, G_L2 0; no gate)
    cfg = TrainConfig().validate()
    tx = make_optimizer("adam", cfg, "D")
    main = {"D32b": (dict(sign_coef=cfg.d_l1, linear_coef=cfg.d_l2, clamp=cfg.d_clamp,
                          sums=True), gate, 12),
            "G32": (dict(sign_coef=cfg.g_l2, linear_coef=cfg.g_l2, clamp=cfg.g_clamp), True, 8)}
    errs = {"fused_prep": 0.0, "fused_update": 0.0}
    rows = {"fused_prep": [], "fused_update": []}
    for name, (args, net_gate, prep_bytes) in main.items():
        e_prep, e_update = _check_update_kernels(f"{name} at the default flags", shapes[name],
                                                 tx, dev, args, net_gate, seed=1)
        errs["fused_prep"] = max(errs["fused_prep"], e_prep)
        errs["fused_update"] = max(errs["fused_update"], e_update)
        params, grads, state = _update_leaves(shapes[name], dev, 2, tx)
        numel = sum(p.numel() for p in params)
        steps = [torch.zeros((), device=dev) for _ in params]
        lib_m, lib_v = [t.clone() for t in state["mu"]], [t.clone() for t in state["nu"]]
        lib_p = [p.clone() for p in params]

        def library():
            torch._fused_adam_(lib_p, grads, lib_m, lib_v, [], steps, lr=cfg.d_adam_lr_effective,
                               beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
                               amsgrad=False, maximize=False)

        calls = {
            "fused_prep": ({"kernel": lambda: fu.prep(params, grads, **args),
                            "plain": lambda: fu.prep_reference(params, grads, **args)},
                           numel * prep_bytes, numel * 9),
            "fused_update": ({"kernel": lambda: fu.update(tx, grads, state, params, net_gate),
                              "plain": lambda: fu.update_reference(tx, grads, state, params,
                                                                   net_gate),
                              "library": library}, numel * 28, numel * 14)}
        for kernel, (fns, nbytes, flop) in calls.items():
            t, runs = _time_turns(fns)
            t_ops, t_bytes = flop / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
            row = {"kernel": kernel, "net": name, "leaves": len(params), "parameters": numel,
                   "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t.get("library"),
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops > t_bytes else "bytes",
                   "share_of_bound": max(t_ops, t_bytes) / t["kernel"],
                   "gb_per_s": nbytes / t["kernel"] / 1e6, "launches_per_step": 1}
            spread = "; ".join(f"{k} {min(v):.4f}-{max(v):.4f}" for k, v in runs.items())
            print(f"table {json.dumps(row)} spread(ms) {spread}")
            rows[kernel].append(row)
        del params, grads, state, lib_m, lib_v, lib_p
    out = {}
    for kernel, rs in rows.items():
        lib = [r["library_ms"] for r in rs]
        out[kernel] = {"max_abs_err": errs[kernel], "ms": sum(r["ms"] for r in rs),
                       "plain_ms": sum(r["plain_ms"] for r in rs),
                       "bound_ms": sum(r["bound_ms"] for r in rs), "bound_by": "bytes",
                       "library_ms": None if None in lib else sum(lib),
                       "launches_per_step": len(rs)}
        print(f"{kernel} at the GAN step's leaves (D32b + G32, one launch each): "
              f"{json.dumps(out[kernel])}")
    return out


def _bn_inputs(n, h, c, dtype, seed=0):
    """Card tensors for a batch norm + PReLU pair: x and dy (n, h, h, c),
    and fp32 weight, bias, slope, running mean and running variance."""
    import torch

    g = torch.Generator().manual_seed(seed + n * h + c)
    x = torch.randn(n, h, h, c, generator=g) * 1.5 + torch.rand(c, generator=g) - 0.5
    params = [torch.rand(c, generator=g) + 0.5, torch.rand(c, generator=g) * 0.4 - 0.2,
              torch.rand(1, generator=g) * 0.3 + 0.1, torch.rand(c, generator=g) - 0.5,
              torch.rand(c, generator=g) + 0.5]
    dy = torch.randn(n, h, h, c, generator=g)
    return x.to("cuda", dtype), dy.to("cuda", dtype), [p.cuda() for p in params]


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def _check_bn_prelu(layer, n, dtype, training):
    """The kernels at one shape against ``forward_reference`` /
    ``backward_reference`` and against BatchNorm then PReLU (modules, under
    autograd) on the same card tensors, and their launches; returns the
    largest |error| of the output and of dx against the plain version."""
    import torch

    from facegen_torch.nn.layers import BatchNorm, PReLU
    from facegen_torch.ops import bn_prelu as bp

    h, c = BN_LAYERS[layer]
    tag = str(dtype).removeprefix("torch.")
    x, dy, (w, b, a, rm, rv) = _bn_inputs(n, h, c, dtype)
    bn, pr = BatchNorm(c, device="cuda"), PReLU(device="cuda")
    bn.train(training)
    with torch.no_grad():
        for t, v in ((bn.weight, w), (bn.bias, b), (pr.weight, a), (bn.running_mean, rm),
                     (bn.running_var, rv)):
            t.copy_(v)
    k_rm, k_rv, r_rm, r_rv = rm.clone(), rv.clone(), rm.clone(), rv.clone()
    before = bp.BN_PRELU_LAUNCHES
    y, mean, scale = bp.forward(x, w, b, a, k_rm, k_rv, training, bn.eps, bn.MOMENTUM)
    fwd_launches = bp.BN_PRELU_LAUNCHES - before
    ry, rmean, rscale = bp.forward_reference(x, w, b, a, r_rm, r_rv, training, bn.eps,
                                             bn.MOMENTUM)
    xg = x.clone().requires_grad_()
    my = pr(bn(xg))  # the modules, as G ran them before the kernels
    mdx, mdw, mdb, mda = torch.autograd.grad(my, (xg, bn.weight, bn.bias, pr.weight), dy)
    before = bp.BN_PRELU_LAUNCHES
    dx, dw, db, da = bp.backward(dy, x, mean, scale, training, bn.eps, w, b, a)
    bwd_launches = bp.BN_PRELU_LAUNCHES - before
    rdx, rdw, rdb, rda = bp.backward_reference(dy, x, mean, scale, training, bn.eps, w, b, a)
    torch.cuda.synchronize()
    y_err = float((y.float() - ry.float()).abs().max())
    dx_err = float((dx.float() - rdx.float()).abs().max())
    if training:
        tol = BN_Y_TOL[tag]
        y_ok = all(bool(((y.float() - want.float()).abs()
                         <= tol["atol"] + tol["rtol"] * want.float().abs()).all())
                   for want in (ry, my.detach()))
        stat_errs = [_rel(mean, rmean), _rel(scale, rscale), _rel(k_rm, r_rm), _rel(k_rv, r_rv),
                     _rel(k_rm, bn.running_mean), _rel(k_rv, bn.running_var)]
        y_note = f"y within rounding: {y_ok}; statistics {max(stat_errs):.2e}"
        y_ok = y_ok and max(stat_errs) < BN_STAT_TOL
    else:
        y_ok = (torch.equal(y, ry) and torch.equal(y, my.detach()) and torch.equal(k_rm, rm)
                and torch.equal(k_rv, rv))
        y_note = f"y bit-equal to both: {y_ok}"
    grad_errs = {}
    for label, (gx, gw, gb, ga) in (("plain", (rdx, rdw, rdb, rda)),
                                    ("modules", (mdx, mdw, mdb, mda))):
        grad_errs[label] = (float((dx.float() - gx.float()).abs().max())
                            / float(gx.float().abs().max()), _rel(dw, gw), _rel(db, gb),
                            _rel(da, ga))
    slope_tol = 2.0 ** -7 if dtype == torch.bfloat16 else BN_PARAM_TOL
    grads_ok = all(e[0] <= BN_DX_TOL[tag] and e[1] < BN_PARAM_TOL and e[2] < BN_PARAM_TOL
                   and e[3] < slope_tol for e in grad_errs.values())
    launches_ok = (fwd_launches, bwd_launches) == (2 if training else 1, 2)
    ok = y_ok and grads_ok and launches_ok
    print(f"bn_prelu check {tag} {layer} N={n} {'train' if training else 'eval'}: {y_note}; "
          f"max |y - plain| {y_err:.3e}; gradients (dx of its max, weight, bias, slope) "
          + "; ".join(f"vs {k} " + ", ".join(f"{v:.2e}" for v in e)
                      for k, e in grad_errs.items())
          + f"; launches {fwd_launches} + {bwd_launches}; {'ok' if ok else 'FAIL'}")
    check(ok, f"the batch norm + PReLU kernels disagree ({tag} {layer} N={n} "
              f"{'train' if training else 'eval'})")
    return y_err, dx_err


def _kernel_ms(fn, names, iters=20):
    """Device ms per call of each kernel in ``names`` that ``fn`` launches:
    ``iters`` calls under the profiler (``_device_ops``), each kernel's
    events summed and divided by ``iters``. Refuses a reading with another
    number of events than ``iters`` for any kernel."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ops = _device_ops(lambda: [fn() for _ in range(iters)])["ops"]
    out = {}
    for name in names:
        rows = [r for r in ops if name in r["name"]]
        calls = sum(r["calls"] for r in rows)
        check(calls == iters, f"the profiler saw {calls} events of {name} in {iters} calls")
        out[name] = sum(r["total_us"] for r in rows) / iters / 1e3
    return out


def phase_bn_prelu_kernels():
    """Phase 33: the batch norm + PReLU kernels (csrc/bn_prelu.cu) against
    their plain versions and against BatchNorm then PReLU at every main-path
    shape (BN_SHAPES), bf16 and fp32; then each kernel's row of the table in
    bf16: its ms (the profiler's events, ``_kernel_ms``), its bound (bytes
    at 3.35 TB/s: stats reads x; apply reads x and writes y; the reduction
    reads x and dy; dx reads x and dy and writes dx) and share of it, and,
    for the whole forward or backward it belongs to, the call's ms, the
    plain version's and the library's (F.batch_norm then F.prelu on the
    channels-last view; for the backward, autograd's forward and backward
    less its forward), each a CUDA graph of 20 calls in alternating turns.
    Returns the kernels line's numbers: each kernel summed over its
    launches in a GAN training step (stats and apply at N = 16 and 32,
    the backward at N = 32; both layers)."""
    import torch
    import torch.nn.functional as F

    from facegen_torch.nn.layers import BatchNorm
    from facegen_torch.ops import bn_prelu as bp

    max_err = dict.fromkeys(BN_PRELU, 0.0)
    for layer, n, training in BN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            y_err, dx_err = _check_bn_prelu(layer, n, dtype, training)
            if dtype == torch.bfloat16 and training:
                for k in BN_PRELU:
                    max_err[k] = max(max_err[k], dx_err if k == "bn_prelu_bwd_dx" else y_err)

    eps, mom = 1e-5, BatchNorm.MOMENTUM
    step = {k: [] for k in BN_PRELU}  # the rows of a training step's launches
    evals = []  # the eval applies' rows (N = 1024)
    for layer, n, training in BN_SHAPES:
        h, c = BN_LAYERS[layer]
        x, dy, (w, b, a, rm, rv) = _bn_inputs(n, h, c, torch.bfloat16, seed=7)
        size = x.numel() * x.element_size()
        xl = x.permute(0, 3, 1, 2)  # NCHW view of NHWC = channels_last

        def fwd():
            return bp.forward(x, w, b, a, rm, rv, training, eps, mom)

        def lib_fwd():
            return F.prelu(F.batch_norm(xl, rm, rv, w, b, training, mom, eps), a.to(x.dtype))

        calls = [("forward", ("bn_prelu_stats", "bn_prelu_apply") if training
                  else ("bn_prelu_apply",),
                  {"kernel": fwd, "plain": lambda: bp.forward_reference(x, w, b, a, rm, rv,
                                                                        training, eps, mom),
                   "library": lib_fwd})]
        if training:
            _, mean, scale = fwd()
            wg, bg, ag = (t.detach().requires_grad_() for t in (w, b, a))
            dyl = dy.permute(0, 3, 1, 2)

            def lib_step():  # less lib_fwd: the library's backward
                xg = xl.detach().requires_grad_()
                out = F.prelu(F.batch_norm(xg, rm, rv, wg, bg, True, mom, eps), ag.to(x.dtype))
                return torch.autograd.grad(out, (xg, wg, bg, ag), dyl)

            calls.append(("backward", ("bn_prelu_bwd_reduce", "bn_prelu_bwd_dx"),
                          {"kernel": lambda: bp.backward(dy, x, mean, scale, True, eps, w, b, a),
                           "plain": lambda: bp.backward_reference(dy, x, mean, scale, True, eps,
                                                                  w, b, a),
                           "library": lib_step, "library_forward": lib_fwd}))
        moved = {"bn_prelu_stats": size, "bn_prelu_apply": 2 * size,
                 "bn_prelu_bwd_reduce": 2 * size, "bn_prelu_bwd_dx": 3 * size}
        for call, names, fns in calls:
            per_kernel = _kernel_ms(fns["kernel"], names)
            t, runs = _time_turns(fns)
            library = t["library"] - t.get("library_forward", 0.0)
            spread = "; ".join(f"{k} {min(v):.4f}-{max(v):.4f}" for k, v in runs.items())
            for name in names:
                bound_ms, bound_by = _bound(0, moved[name])
                row = {"kernel": name, "shape": f"{layer} N={n} {h}x{h}x{c}",
                       "mode": "train" if training else "eval", "ms": per_kernel[name],
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "share_of_bound": bound_ms / per_kernel[name],
                       "gb_per_s": moved[name] / per_kernel[name] / 1e6, "call": call,
                       "call_ms": t["kernel"], "plain_ms": t["plain"], "library_ms": library}
                print(f"table {json.dumps(row)} spread(ms) {spread}")
                check(row["share_of_bound"] <= MAX_SHARE,
                      f"{name} at {row['shape']} read {row['share_of_bound']:.2f} of its bound")
                if training and (call == "forward" or n == 32):
                    step[name].append(row)
                elif not training:
                    evals.append(row)
            check(sum(per_kernel.values()) <= MAX_SHARE * t["kernel"],
                  f"{layer} N={n} {call}: its kernels' events add up to "
                  f"{sum(per_kernel.values()):.4f} ms, more than the call's {t['kernel']:.4f} ms")
        del x, dy, xl
    out = {}
    for name, rows in step.items():
        out[name] = {"max_abs_err": max_err[name], "ms": sum(r["ms"] for r in rows),
                     "plain_ms": sum(r["plain_ms"] for r in rows),
                     "library_ms": sum(r["library_ms"] for r in rows),
                     "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": "bytes",
                     "launches_per_step": len(rows),
                     "plain_and_library_of": "the whole forward or backward of each launch"}
        print(f"{name} over a GAN training step's launches: {json.dumps(out[name])}")
    sampler = {k: sum(r[k] for r in evals if r["shape"].startswith("G32."))
               for k in ("ms", "bound_ms", "plain_ms", "library_ms")}
    print(f"bn_prelu_apply at the sampler's G call (G32's two pairs, N = 1024, eval): "
          f"{json.dumps(sampler)}")
    return out


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
    from facegen_torch.ops import bn_prelu as bp
    from facegen_torch.ops import fused_update as fu
    from facegen_torch.ops import upsample_conv as uc

    uc.KERNEL_LAUNCHES = uc.DX_LAUNCHES = uc.DW_LAUNCHES = 0
    fu.PREP_LAUNCHES = fu.UPDATE_LAUNCHES = 0
    bp.BN_PRELU_LAUNCHES = 0


def _launches():
    from facegen_torch.ops import bn_prelu as bp
    from facegen_torch.ops import fused_update as fu
    from facegen_torch.ops import upsample_conv as uc

    return {"upsample_conv_fwd": uc.KERNEL_LAUNCHES, "upsample_conv_dx": uc.DX_LAUNCHES,
            "upsample_conv_dw": uc.DW_LAUNCHES, "fused_prep": fu.PREP_LAUNCHES,
            "fused_update": fu.UPDATE_LAUNCHES, "bn_prelu": bp.BN_PRELU_LAUNCHES}


def _counter(kernel):
    """The key of ``_launches`` that counts ``kernel``'s launches."""
    return "bn_prelu" if kernel in BN_PRELU else kernel


def _bn_prelu(steps=0, g_calls=0):
    """The batch norm + PReLU kernels' launches on a GAN path of G32 or G16:
    12 a training step (G's two pairs, 2 forward launches each in the D
    and the G phase, 2 backward launches each in the G phase) and 2 an
    eval G call (one apply a pair)."""
    return 12 * steps + 2 * g_calls


def _upconv_replay(per_replay):
    """The upsample-conv kernels' entries of a graph's launches per replay."""
    return {k: v for k, v in per_replay.items()
            if k not in ("PREP_LAUNCHES", "UPDATE_LAUNCHES", "BN_PRELU_LAUNCHES")}


def _upconv(launches):
    """The upsample-conv kernels' entries of a launch count."""
    return {k: launches[k] for k in UPCONV}


def _updates(iterations, prep=None):
    """The update kernels' launches for ``iterations`` net iterations, one
    of each a net iteration; ``prep`` where prep has no work in some."""
    return {"fused_prep": iterations if prep is None else prep, "fused_update": iterations}


# a GAN step's launches per replay: the upsample-conv's forward at both
# layers in both phases, dx and dW in the G phase, D's and G's update, and
# G's two batch norm + PReLU pairs (2 forward launches each in both phases,
# 2 backward launches each in the G phase)
GAN_REPLAY = {"KERNEL_LAUNCHES": 4, "DX_LAUNCHES": 2, "DW_LAUNCHES": 2, "PREP_LAUNCHES": 2,
              "UPDATE_LAUNCHES": 2, "BN_PRELU_LAUNCHES": 12}


def phase_training(tmp: str, store: str):
    """Drive the trainer's CLI end to end; returns the kernels' launch
    counts in its 2-epoch run and the graphed step's device ms from its
    profile."""
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
    # per step: D's and G's update, each prep (D: the L2 penalty, its sums
    # and the clamp; G: the clamp) and the update
    check({k: launches[k] for k in ("fused_prep", "fused_update")} == _updates(2 * steps),
          f"update launches {launches} != 2 x {steps} steps each")
    # 12 a step, 2 a G call of the grids
    check(launches["bn_prelu"] == _bn_prelu(steps, 2 * viz_calls),
          f"batch norm + PReLU launches {launches['bn_prelu']} != "
          f"{_bn_prelu(steps, 2 * viz_calls)}")
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
    check(graphed.graph is not None and graphed.launches_per_replay == GAN_REPLAY,
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
    graphed_ms = _profile_train_steps(run, label="training path (graphed)")
    _profile_train_steps(run_eager, label="training path (eager)")
    _fused_vs_plain("training path", graphed, run, top=12)
    return launches, graphed_ms


STEP_PROFILES = {}  # label -> the last step profile of that label (_profile_train_steps)


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
    """Device time of a training step by kernel family (a trace's device
    events over ``steps`` steps) against the host's wall time of as many
    steps run untraced just before: the device's busy share; with ``top``,
    the kernels that take the most device time, each with its ms per step.
    ``run(n)`` runs n steps. Returns the device ms per step."""
    import torch

    run(10)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    summary = _device_ops(lambda: run(steps))
    families = {"upsample-conv dW (UpconvDw)": ("upconvdw",),
                "upsample-conv dx (UpconvDx)": ("upconvdx",),
                "upsample-conv forward (UpconvFwd)": ("upconvfwd",),
                "split-K sums (reduce_splits)": ("reduce_splits",),
                "update (fused_prep, fused_update)": ("fused_prep", "fused_update"),
                "cuDNN / cuBLAS": ("cudnn", "xmma", "gemm", "conv", "cutlass", "sm90_")}
    us = _by_family(summary["ops"], families, "elementwise, reductions, copies")
    busy_ms = summary["total_us"] / steps / 1e3
    launches = sum(r["calls"] for r in summary["ops"])
    check(busy_ms > 0, f"the profiler saw no device time in the {label} steps")
    for r in summary["ops"][:top]:
        print(f"{label}: kernel {r['total_us'] / steps / 1e3:.4f} ms per step in "
              f"{r['calls'] / steps:.0f} launches: {r['name'][:160]}")
    STEP_PROFILES[label] = {"device_ms": busy_ms, "wall_ms": wall_ms,
                            "busy": busy_ms / wall_ms, "kernels": launches / steps,
                            "elementwise": us["elementwise, reductions, copies"] / steps / 1e3
                            / busy_ms}
    print(f"{label}: step profile (torch.profiler trace of {steps} steps after 10 warm-up, "
          f"device events; host wall of {steps} untraced steps): {busy_ms:.4f} ms of device "
          f"time in {wall_ms:.3f} ms of host wall per step, busy {100 * busy_ms / wall_ms:.1f} "
          f"%, {launches / steps:.0f} kernels a step; " + "; ".join(
              f"{f} {v / steps / 1e3:.4f} ms ({100 * v / steps / 1e3 / busy_ms:.1f} %)"
              for f, v in sorted(us.items(), key=lambda kv: -kv[1])))
    return busy_ms


def _rel_l2(ours, ref):
    """Relative l2 error of a list of tensors (any device) against the
    CPU's, over all of them."""
    num = sum(float(((o.detach().cpu() - r.detach()) ** 2).sum()) for o, r in zip(ours, ref))
    den = sum(float((r.detach() ** 2).sum()) for r in ref)
    return (num / max(den, 1e-300)) ** 0.5


class _Tee:
    """A stdout that also keeps what is written to it."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _logged(fn):
    """(``fn()``, what it printed), its output still printed."""
    import contextlib

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = fn()
    return result, "".join(tee.parts)


GRAPH_ROUTE = "<trainer> step route: one CUDA graph replay a step"


def _graph_vs_eager(label, runner, log, run, run_eager, updates, top=0):
    """A trainer's step as its CLI ran it: the logged route (a CUDA graph
    replay a step), the capture (its ms, the MiB it reserved, none of the
    upsample-conv kernels and ``updates`` = (prep, update) launches of the
    update's kernels in it), then the graphed and the eager step on the
    same state, timed on the stream in turns (graphed, eager, eager,
    graphed) and profiled (device ms, host wall, busy share); then the
    graphed step with the update's kernels against it with the plain
    update (``_fused_vs_plain``)."""
    route = next((ln for ln in log.splitlines() if "step route:" in ln), "")
    check(route.strip() == GRAPH_ROUTE and runner.graph is not None,
          f"{label}: the step was not captured: {route!r}")
    want = {"KERNEL_LAUNCHES": 0, "DX_LAUNCHES": 0, "DW_LAUNCHES": 0,
            "PREP_LAUNCHES": updates[0], "UPDATE_LAUNCHES": updates[1], "BN_PRELU_LAUNCHES": 0}
    check(runner.launches_per_replay == want,
          f"{label}: launches per replay {runner.launches_per_replay}, want {want}")
    print(f"{label}: {route.strip()}; captured in {runner.capture_ms:.1f} ms after "
          f"{runner.eager_steps} eager steps, {runner.pool_mib:.1f} MiB reserved by the capture; "
          f"kernel launches per replay {runner.launches_per_replay}")
    runs = {"graphed": run, "eager": run_eager}
    times = {"graphed": [], "eager": []}
    for which in ("graphed", "eager", "eager", "graphed"):
        times[which].append(_step_ms(runs[which]))
    for which, ts in times.items():
        print(f"{label} ({which}): {statistics.mean(ts):.4f} ms per step on the stream (CUDA "
              f"events over 30 steps, mean of 2 turns: {', '.join(f'{t:.4f}' for t in ts)}; "
              f"waits for the host included)")
    _profile_train_steps(run, label=f"{label} (graphed)", top=top)
    _profile_train_steps(run_eager, label=f"{label} (eager)")
    graphed, eager = STEP_PROFILES[f"{label} (graphed)"], STEP_PROFILES[f"{label} (eager)"]
    print(f"{label}: graphed against eager in this run: {statistics.mean(times['graphed']):.4f} "
          f"/ {statistics.mean(times['eager']):.4f} ms per step on the stream; device "
          f"{graphed['device_ms']:.4f} / {eager['device_ms']:.4f} ms, host wall "
          f"{graphed['wall_ms']:.3f} / {eager['wall_ms']:.3f} ms, busy "
          f"{100 * graphed['busy']:.1f} / {100 * eager['busy']:.1f} % a step; capture "
          f"{runner.capture_ms:.1f} ms, {runner.pool_mib:.1f} MiB")
    _fused_vs_plain(label, runner, run)


@contextlib.contextmanager
def _plain_update():
    """Every trainer's update tail as the plain composition of torch ops,
    leaf by leaf (the wrappers' plain versions on the card, and no layout
    copies), for the step profiles' comparison in the same call; never on
    the port's own path."""
    from facegen_torch.ops import fused_update as fu

    saved = fu.prep, fu.update, fu.in_layouts_of
    fu.prep, fu.update = fu.prep_reference, fu.update_reference
    fu.in_layouts_of = lambda params, grads: list(grads)
    try:
        yield
    finally:
        fu.prep, fu.update, fu.in_layouts_of = saved


def _fused_vs_plain(label, runner, run, top=0):
    """The graphed step with the update's two kernels against the same
    step recaptured with the plain update (``_plain_update``), on the same
    state: kernels per step, device time, the elementwise share and the ms
    per step on the stream, in turns (fused, plain, plain, fused; each turn
    recaptures, after one eager warm-up step); with ``top``, the first
    fused turn lists the kernels that take the most device time. ``run(n)``
    runs n steps through ``runner``."""
    turns = {"fused": [], "plain": []}
    for route in ("fused", "plain", "plain", "fused"):
        runner.graph, runner.eager_steps = None, 0  # recapture at the next step
        with _plain_update() if route == "plain" else contextlib.nullcontext():
            run(1)
            ms = _step_ms(run)
        _profile_train_steps(run, label=f"{label} ({route} update)",
                             top=top if route == "fused" and not turns["fused"] else 0)
        turns[route].append((ms, STEP_PROFILES[f"{label} ({route} update)"]))
    check(runner.graph is not None, f"{label}: the step was not recaptured")
    means = {route: {k: statistics.mean(p[k] for _, p in ts) for k in ("device_ms", "kernels",
                                                                       "elementwise")}
             for route, ts in turns.items()}
    print(f"{label}: the update's kernels against the plain update, graphed, in turns (fused, "
          f"plain, plain, fused): " + "; ".join(
              f"{route}: {statistics.mean(ms for ms, _ in ts):.4f} ms per step on the stream "
              f"({', '.join(f'{ms:.4f}' for ms, _ in ts)}), device {means[route]['device_ms']:.4f} "
              f"ms in {means[route]['kernels']:.0f} kernels a step, elementwise "
              f"{100 * means[route]['elementwise']:.1f} %" for route, ts in turns.items()))
    STEP_PROFILES[f"{label}: fused vs plain"] = means


def phase_step_parity():
    """One fp32 train step on the card against the same step on the CPU:
    the same weights, pool and injected draws."""
    import torch

    from facegen_torch.config import TrainConfig
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.data.synthetic import draw_synthetic_faces
    from facegen_torch.train.step import (
        DDraws,
        GDraws,
        StepDraws,
        TrainStep,
        draw_step,
    )

    cfg = TrainConfig(compute_dtype="float32", reference_init=False, g_l2=1e-3).validate()
    dev = torch.device("cuda", 0)

    def build(device):
        state = _train_state(cfg, device, g_biases=True)
        return state, TrainStep(cfg, state.g, state.d)

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
    from facegen_torch.train.c2f import ckpt_name, draw_c2f_step
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
    # D's and G's update a step; the c2f's nets hold no batch norm
    want = {**dict.fromkeys(UPCONV, 0), **_updates(2 * steps), "bn_prelu": 0}
    check(launches == want, f"c2f launches {launches}, want {want}")
    name = ckpt_name(cfg)
    for n in (name, name + ".old", name + "_best"):
        check(os.path.exists(os.path.join(save, n, "arrays.npz")), f"missing checkpoint {n}")
    with open(os.path.join(save, name + "_best", "meta.json")) as f:
        best = _json.load(f)
    check(math.isfinite(best.get("parzen", math.nan)), f"_best has no finite parzen: {best}")
    grid = os.path.join(save, "viz", "c2f_samples.png")
    check(os.path.exists(grid) and os.path.getsize(grid) > 0, f"missing grid {grid}")

    trainer2, log = _logged(lambda: train_c2f.main(argv + ["--epochs", "1", "--network", name]))
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

    def run_eager(n):
        for _ in range(n):
            trainer2.step(trainer2.state, pool,
                          draw_c2f_step(gen, cfg, pool.size, trainer2.step.mask_specs))

    step_ms = _step_ms(run)
    per_epoch = steps_per_epoch(cfg)
    print(f"c2f training path: approxParzen {statistics.median(parzen_ms):.3f} ms on the stream "
          f"(CUDA events, median of 3: {', '.join(f'{t:.3f}' for t in parzen_ms)}); "
          f"{step_ms:.4f} ms per graphed step on the stream (CUDA events over 30 steps, waits "
          f"for the host included): {cfg.n_epoch / (per_epoch * step_ms / 1e3):.1f} images/s at "
          f"{cfg.n_epoch} examples per {per_epoch} steps")
    _graph_vs_eager("c2f training path", trainer2.graphed, log, run, run_eager, (2, 2), top=8)
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
    check(launches["bn_prelu"] == _bn_prelu(g_calls=runs),
          f"expected {_bn_prelu(g_calls=runs)} batch norm + PReLU launches (G16's two pairs a "
          f"run), got {launches}")
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


def _report_fp32_trainer(label, trainer, run_s, launches, rows, describe, log, run_eager,
                         updates):
    """The checks and lines both AE-family phases share: none of the
    upsample-conv kernels launched and the update's kernels ``updates`` =
    (prep, update) times a step, finite losses, the warm epoch's images/s,
    the route and the capture, and the graphed step's time and profile
    beside the eager step's (``run_eager(draws)``)."""
    import math

    import torch

    print(f"{label}: {describe} took {run_s:.3f} s; launches {launches}")
    steps = 2 * (trainer.n_pool // trainer.cfg.batch_size)  # the counted run's 2 epochs
    want = {**dict.fromkeys(UPCONV, 0), **_updates(updates[1] * steps, updates[0] * steps),
            "bn_prelu": 0}  # the family's batch norms feed LeakyReLUs
    check(launches == want, f"the {label} launched {launches}, want {want}")
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
    print(f"{label}: {step_ms:.4f} ms per graphed step on the stream (CUDA events over 30 "
          f"steps, fp32, waits for the host included): {1e3 * cfg.batch_size / step_ms:.1f} "
          f"images/s")
    _graph_vs_eager(label, trainer.graphed, log, run, lambda n: run_eager(draws[:n]), updates,
                    top=5)


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
    trainer, log = _logged(lambda: train_autoencoder.main(["--datasetDir", store, "--save",
                                                           save, "--epochs", "2"]))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _launches()
    cfg = trainer.cfg
    check((cfg.scale, cfg.channels, cfg.noise_dim, cfg.batch_size) == (32, 1, 256, 32),
          f"the AE CLI's defaults: {cfg}")
    check(trainer.epoch == 2 and len(trainer.history) == 2, f"{trainer.epoch} epochs, want 2")
    _check_files(os.path.join(save, "autoencoder", "arrays.npz"),
                 os.path.join(save, "viz", "ae_recon.png"))
    def run_eager(draws):
        for d in draws:
            trainer.step(trainer.model, trainer.opt, trainer.pool, d)

    _report_fp32_trainer("ae training path", trainer, run_s, launches, trainer.history,
                         "train_autoencoder.main --epochs 2 (scale 32, gray, noiseDim 256, "
                         "batch 32, fp32)", log, run_eager, (0, 1))
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
    trainer2, log = _logged(lambda: train_denoiser.main(argv + ["--epochs", "1", "--network",
                                                              name]))
    steps = trainer2.n_pool // cfg.batch_size
    check(trainer2.epoch == 3 and trainer2.history[0]["epoch"] == 3,
          f"the resumed run ends at epoch {trainer2.epoch}, want 3")
    check(int(trainer2.state.opt1["count"]) == steps,
          f"Adam's count {int(trainer2.state.opt1['count'])} after the resume, want {steps}")
    with open(os.path.join(save, name, "meta.json")) as f:
        check(_json.load(f)["epoch"] == 3, "the resume's checkpoint is not at epoch 3")
    _check_files(os.path.join(save, name + ".old", "arrays.npz"))
    def run_eager(draws):
        for d in draws:
            trainer2.step(trainer2.state, trainer2.pool, d)

    _report_fp32_trainer("denoiser training path", trainer2, run_s, launches,
                         trainer.history + trainer2.history,
                         "train_denoiser.main --epochs 2 (scale 16, colour, batch 32, fp32)",
                         log, run_eager, (2, 2))
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
            "upsample_conv_dw": 2 * steps, **_updates(2 * steps), "bn_prelu": _bn_prelu(steps, 2)}
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
    from facegen_torch.sample import full_fp32
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.train.step import TrainStep, draw_step

    dev = torch.device("cuda", 0)
    pool = prepare_pool(draw_synthetic_faces(torch.Generator().manual_seed(6), 1000), 32, 3)
    pool = pool.to(dev)
    for dtype, tol in (("float32", GRAPH_FP32_TOL), ("bfloat16", GRAPH_BF16_TOL)):
        cfg = TrainConfig(compute_dtype=dtype).validate()

        def build():
            state = _train_state(cfg, dev)
            return state, TrainStep(cfg, state.g, state.d)

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


FAMILY = ("c2f", "autoencoder", "denoiser")


def _family_trainer(kind, save, dtype="float32", **kw):
    """A c2f, autoencoder or denoiser trainer on cuda:0 at its CLI's
    defaults on synthetic data (--N_epoch 256), fp32 unless ``dtype`` (the
    c2f's); the c2f with --G_L2 1e-3 and the AE family with --coefL1 1e-4,
    which make the gradients of the biases that feed batch norms the
    penalty's (their exact gradient is 0: rounding noise, which Adam turns
    into a step of either sign)."""
    import torch

    from facegen_torch.config import C2FConfig, TrainConfig
    from facegen_torch.train.ae_loop import AETrainer, DenoiserTrainer
    from facegen_torch.train.c2f import C2FTrainer

    dev, common = torch.device("cuda", 0), dict(synthetic_data=True, n_epoch=256, save=save)
    if kind == "c2f":
        cfg = C2FConfig(compute_dtype=dtype, g_l2=1e-3, **common)
        return C2FTrainer(cfg, device=dev, verbose=False, **kw)
    if kind == "autoencoder":
        cfg = TrainConfig(scale=32, grayscale=True, noise_dim=256, coef_l1=1e-4, **common)
        return AETrainer(cfg, device=dev, verbose=False, **kw)
    cfg = TrainConfig(scale=16, coef_l1=1e-4, **common)
    return DenoiserTrainer(cfg, device=dev, verbose=False, **kw)


def _family_steps(trainer, n=3, seed=7):
    """``n`` steps of ``trainer.run_steps`` on an epoch's pool and draws
    from ``seed``; their losses, (n, k) on the device."""
    import torch

    from facegen_torch.data.c2f import make_triples
    from facegen_torch.train.c2f import C2FTrainer

    gen = torch.Generator(trainer.device).manual_seed(seed)
    if isinstance(trainer, C2FTrainer):
        pool = make_triples(trainer.source.epoch_pool(gen, trainer.pool_n),
                            trainer.cfg.coarse_size)
        return torch.stack(trainer.run_steps(pool, gen, n), 1)
    return trainer.run_steps(trainer.epoch_draws(gen)[:n]).reshape(n, -1)


def _family_state(trainer):
    """({group: tensors}: each net's parameters, batch-norm statistics and
    Adam moments; [the optimizer counts and the confusion matrix])."""
    from facegen_torch.train.ae_loop import AETrainer, DenoiserTrainer

    st = getattr(trainer, "state", None)
    if isinstance(trainer, AETrainer):
        nets, opts, exact = {"ae": trainer.model}, {"ae": trainer.opt}, []
    elif isinstance(trainer, DenoiserTrainer):
        nets, opts, exact = {"dec1": st.dec1, "dec2": st.dec2}, {"dec1": st.opt1,
                                                                 "dec2": st.opt2}, []
    else:
        nets, opts, exact = {"g": st.g, "d": st.d}, {"g": st.opt_g, "d": st.opt_d}, [st.confusion]
    groups = {}
    for k, net in nets.items():
        groups[f"{k} parameters"] = list(net.parameters())
        if list(net.buffers()):
            groups[f"{k} statistics"] = list(net.buffers())
        for kind in ("mu", "nu"):
            groups[f"{k} {kind}"] = opts[k][kind]
    return groups, [opt["count"] for opt in opts.values()] + exact


def _family_diffs(a, b, losses_a, losses_b):
    """Relative l2 of trainer ``a``'s state groups and losses against
    ``b``'s, and whether their counts (and the c2f's confusion) are equal."""
    import torch

    (ga, ea), (gb, eb) = _family_state(a), _family_state(b)
    errs = {k: _rel_l2(ga[k], [t.cpu() for t in gb[k]]) for k in ga}
    errs["losses"] = _rel_l2([losses_a], [losses_b.cpu()])
    return errs, all(torch.equal(x, y) for x, y in zip(ea, eb))


def phase_family_graph_parity(tmp: str):
    """The c2f, autoencoder and denoiser trainers' graphed steps against
    their eager steps (the same trainer built with ``capture=False``): 3
    steps each from one state on the same pool and draws, in fp32 (TF32
    off) and the c2f also in bf16 at its default flags. Under cuDNN's
    deterministic algorithms (checked): within 1e-5 (fp32) and 1e-3 (bf16)
    relative l2 over the parameters, the batch-norm statistics, Adam's
    moments and the losses, the counts and the confusion equal, no kernel
    of the port in the captures. As a control, with cuDNN free to choose
    (printed): a second eager run against the first, and the graphed run
    against it."""
    import contextlib

    import torch

    from facegen_torch.sample import full_fp32

    cases = [("c2f", "float32", GRAPH_FP32_TOL), ("c2f", "bfloat16", GRAPH_BF16_TOL),
             ("autoencoder", "float32", GRAPH_FP32_TOL), ("denoiser", "float32", GRAPH_FP32_TOL)]
    saved = torch.backends.cudnn.deterministic
    try:
        for kind, dtype, tol in cases:
            save = os.path.join(tmp, f"family_graph_{kind}_{dtype}")
            runs = {}
            for deterministic in (False, True):
                torch.backends.cudnn.deterministic = deterministic
                names = ("eager", "graphed") + (() if deterministic else ("eager again",))
                with full_fp32() if dtype == "float32" else contextlib.nullcontext():
                    trainers = {n: _family_trainer(kind, save, dtype, capture=n == "graphed")
                                for n in names}
                    losses = {n: _family_steps(tr) for n, tr in trainers.items()}
                    torch.cuda.synchronize()
                runs[deterministic] = trainers, losses
            trainers, losses = runs[False]
            control = {n: max(_family_diffs(trainers[n], trainers["eager"], losses[n],
                                            losses["eager"])[0].values())
                       for n in ("eager again", "graphed")}
            trainers, losses = runs[True]
            graphed, runner = trainers["graphed"], trainers["graphed"].graphed
            errs, same = _family_diffs(graphed, trainers["eager"], losses["graphed"],
                                       losses["eager"])
            ok = (same and runner.graph is not None and trainers["eager"].graphed.graph is None
                  and not any(_upconv_replay(runner.launches_per_replay).values())
                  and runner.launches_per_replay["UPDATE_LAUNCHES"] > 0
                  and all(v <= tol for v in errs.values())
                  and bool(torch.isfinite(losses["graphed"]).all()))
            print(f"family graph parity ({kind}, {dtype}"
                  f"{', TF32 off' if dtype == 'float32' else ''}), 3 graphed vs 3 eager steps "
                  f"under cuDNN's deterministic algorithms, relative l2: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + f" (tolerance {tol}); counts {'equal' if same else 'DIFFER'}; capture "
                  f"{runner.capture_ms:.1f} ms, {runner.pool_mib:.1f} MiB reserved by it, "
                  f"launches per replay {runner.launches_per_replay}; control with cuDNN free "
                  f"to choose, worst group: eager vs eager {control['eager again']:.3e}, graphed "
                  f"vs eager {control['graphed']:.3e}; {'ok' if ok else 'FAIL'}")
            check(ok, f"the graphed {kind} {dtype} step disagrees with the eager step")
    finally:
        torch.backends.cudnn.deterministic = saved


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
    from facegen_torch.sample import full_fp32
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.train.step import TrainStep, draw_step

    dev = pool.device
    cfg = TrainConfig(compute_dtype="float32", reference_init=False).validate()

    def build():
        state = _train_state(cfg, dev)
        return state, TrainStep(cfg, state.g, state.d)

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
            "upsample_conv_dw": 2 * steps, **_updates(2 * steps), "bn_prelu": _bn_prelu(steps)}
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
    # G (fp32, eval) 2 forward; the dumps hook G's modules, so their batch
    # norms and PReLUs run their own forwards
    want = {"upsample_conv_fwd": 4 * steps + 4 + 2 * 4, "upsample_conv_dx": 2 * steps,
            "upsample_conv_dw": 2 * steps, **_updates(2 * steps), "bn_prelu": _bn_prelu(steps, 2)}
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
            "upsample_conv_dw": 2 * steps, **_updates(2 * steps), "bn_prelu": _bn_prelu(steps)}
    check(launches == want, f"launches {launches}, want {want}")
    check(trainer.source.size == 256, f"the trainer's store has {trainer.source.size} rows")
    rows = _metrics_rows(save)
    check(len(rows) == 1, f"{len(rows)} metrics rows")
    print(f"lfw builder: one epoch of train.main on the store: loss_d {rows[0]['loss_d_mean']:.4f} "
          f"loss_g {rows[0]['loss_g_mean']:.4f}, {rows[0]['images_per_sec']:.1f} images/s; "
          f"launches {launches}")
    return launches


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _coordinator_env(port: int, world: int, rank: int) -> dict:
    return {"FACEGEN_COORDINATOR": f"127.0.0.1:{port}", "FACEGEN_NUM_PROCESSES": str(world),
            "FACEGEN_PROCESS_ID": str(rank)}


def _train_state(cfg, device, seed=5, g_biases=False, mesh=None):
    """A GanState of seeded G and D (weights drawn on the CPU from
    ``seed``); ``g_biases``: G's biases U(-0.1, 0.1) from seed 8; on a 2-D
    ``mesh`` with its masters sharded."""
    import torch

    from facegen_torch.models import gan
    from facegen_torch.train.step import init_state

    g, d = gan.init_gan(torch.Generator().manual_seed(seed), cfg.scale, cfg.channels,
                        cfg.noise_dim, reference_init=cfg.reference_init, device=device)
    if g_biases:
        bias_gen = torch.Generator().manual_seed(8)
        with torch.no_grad():
            for name, p in g.named_parameters():
                if name.endswith("bias"):
                    p.copy_(torch.rand(p.shape, generator=bias_gen) * 0.2 - 0.1)
    return init_state(cfg, g, d, mesh)


# the 1-rank NCCL trainer run: python -m facegen_torch.train as a rank of
# a group, with the wrappers' counts set to 0 before it and printed after
DP_CLI = (
    "import json, runpy, sys\n"
    "from facegen_torch.ops import bn_prelu as bp\n"
    "from facegen_torch.ops import fused_update as fu\n"
    "from facegen_torch.ops import upsample_conv as uc\n"
    "uc.KERNEL_LAUNCHES = uc.DX_LAUNCHES = uc.DW_LAUNCHES = 0\n"
    "fu.PREP_LAUNCHES = fu.UPDATE_LAUNCHES = 0\n"
    "bp.BN_PRELU_LAUNCHES = 0\n"
    "sys.argv = ['facegen_torch.train'] + sys.argv[1:]\n"
    "runpy.run_module('facegen_torch.train', run_name='__main__', alter_sys=True)\n"
    "print('launches ' + json.dumps({'upsample_conv_fwd': uc.KERNEL_LAUNCHES, "
    "'upsample_conv_dx': uc.DX_LAUNCHES, 'upsample_conv_dw': uc.DW_LAUNCHES, "
    "'fused_prep': fu.PREP_LAUNCHES, 'fused_update': fu.UPDATE_LAUNCHES, "
    "'bn_prelu': bp.BN_PRELU_LAUNCHES}))\n"
)


# a rank of a gloo group (ranks that share a card: NCCL refuses them) that
# runs a CLI snippet: the group is up before the CLI's own
# maybe_initialize, which then finds it and does nothing
def _on_gloo(snippet: str) -> str:
    return ("from facegen_torch.parallel import maybe_initialize\n"
            "maybe_initialize(backend='gloo')\n" + snippet)


def phase_dp_nccl(tmp: str, store: str):
    """``python -m facegen_torch.train`` as a 1-rank NCCL group (--meshShape
    -1, the default flags, 2 epochs, --saveFreq 1); then, in this process,
    a 1-rank NCCL group's graphed step against the single-device graphed
    step: bit-equal in fp32 under cuDNN's deterministic algorithms, and
    both timed at the default flags. Returns the CLI run's launch counts."""
    import torch
    import torch.distributed as dist

    from facegen_torch.config import TrainConfig
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.data.synthetic import draw_synthetic_faces
    from facegen_torch.parallel import make_mesh, maybe_initialize
    from facegen_torch.sample import full_fp32
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.train.step import TrainStep, steps_per_epoch

    save = os.path.join(tmp, "dp_nccl_logs")
    argv = ["--datasetDir", store, "--save", save, "--saveFreq", "1", "--epochs", "2",
            "--meshShape", "-1"]
    env = dict(os.environ, **_coordinator_env(_free_port(), 1, 0))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", DP_CLI, *argv], env=env, capture_output=True,
                         text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    run_s = time.perf_counter() - t0
    check(run.returncode == 0, f"the 1-rank NCCL trainer failed: {run.stderr[-3000:]}")
    out = run.stdout
    launches = json.loads(out.rsplit("launches ", 1)[1].splitlines()[0])
    route = next((ln for ln in out.splitlines() if "step route:" in ln), "")
    captured = next((ln for ln in out.splitlines() if "captured the train step" in ln), "")
    print(f"dp nccl path: python -m facegen_torch.train --meshShape -1 as rank 0 of 1 (NCCL) "
          f"took {run_s:.3f} s with the interpreter's start; {route.strip()}; launches {launches}")
    print(f"dp nccl path: {captured.strip()}")
    check("NCCL's all-reduces over 1 ranks inside it" in route, f"route: {route!r}")
    check(bool(captured), "the 1-rank NCCL trainer did not capture its step")
    steps = 2 * steps_per_epoch(TrainConfig())
    want = {"upsample_conv_fwd": 4 * steps + 4 * 2, "upsample_conv_dx": 2 * steps,
            "upsample_conv_dw": 2 * steps, **_updates(2 * steps), "bn_prelu": _bn_prelu(steps, 4)}
    check(launches == want, f"launches {launches}, want {want}")
    rows = _metrics_rows(save)
    check([r["epoch"] for r in rows] == [1, 2], f"epochs {[r['epoch'] for r in rows]}")
    for name in ("adversarial", "adversarial.old"):
        _check_files(os.path.join(save, name, "arrays.npz"))
    print(f"dp nccl path: metrics.jsonl " + "; ".join(
        f"epoch {r['epoch']}: loss_d {r['loss_d_mean']:.4f} loss_g {r['loss_g_mean']:.4f} "
        f"{r['images_per_sec']:.1f} images/s" for r in rows))

    dev = torch.device("cuda", 0)
    check(maybe_initialize(_coordinator_env(_free_port(), 1, 0)), "no NCCL group")
    try:
        mesh = make_mesh((-1,))
        check(mesh.backend == "nccl" and mesh.device == dev, f"mesh {mesh}")
        pool = prepare_pool(draw_synthetic_faces(torch.Generator().manual_seed(6), 1000), 32, 3)
        pool = pool.to(dev)

        def graphed(cfg, dp):
            state = _train_state(cfg, dev)
            runner = GraphedStep(TrainStep(cfg, state.g, state.d, mesh if dp else None), state,
                                 pool.shape[0])
            runner.set_pool(pool)
            return state, runner

        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            cfg = TrainConfig(compute_dtype="float32").validate()
            with full_fp32():
                (plain, r_plain), (dp, r_dp) = graphed(cfg, False), graphed(cfg, True)
                r_plain.run(torch.Generator(dev).manual_seed(7), 3)
                r_dp.run(torch.Generator(dev).manual_seed(7), 3)
                torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = saved
        errs, (worst, leaf) = _state_diffs(dp, plain)
        same = all(torch.equal(getattr(dp, k), getattr(plain, k)) for k in (
            "accs", "accs_n", "confusion", "trained_d", "not_trained_d"))
        print(f"dp nccl parity fp32 (TF32 off, cuDNN deterministic), 3 graphed steps of a 1-rank "
              f"NCCL group vs the single-device graphed step, relative l2: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in errs.items()) + f"; worst leaf {leaf} {worst:.3e}; "
              f"counters {'equal' if same else 'DIFFER'}; {r_dp.route}")
        check(r_dp.graph is not None and worst == 0.0 and same,
              "the 1-rank NCCL graphed step is not bit-equal to the single-device one")

        cfg = TrainConfig().validate()  # the default flags: bf16
        (_, r_plain), (_, r_dp) = graphed(cfg, False), graphed(cfg, True)
        gens = {"single": torch.Generator(dev).manual_seed(11),
                "dp": torch.Generator(dev).manual_seed(11)}
        runs = {"single": lambda n: r_plain.run(gens["single"], n),
                "dp": lambda n: r_dp.run(gens["dp"], n)}
        times = {"single": [], "dp": []}
        for route in ("single", "dp", "dp", "single"):
            times[route].append(_step_ms(runs[route]))
        for route, ts in times.items():
            print(f"dp nccl path ({route}): {statistics.mean(ts):.4f} ms per graphed step on the "
                  f"stream (CUDA events over 30 steps, mean of 2 turns: "
                  f"{', '.join(f'{t:.4f}' for t in ts)}; default flags, batch 32, bf16)")
        _profile_train_steps(runs["single"], label="dp nccl path (single-device graphed step)")
        _profile_train_steps(runs["dp"], label="dp nccl path (1-rank NCCL graphed step)")
    finally:
        dist.destroy_process_group()
    return launches


# the shared-card 2-rank program: a rank of a gloo group on ``device``
# takes 3 eager fp32 steps at the default flags (local batch 16) on its
# draws from numpy, writes its state and its launches by shape, and
# times steps at the default flags (bf16)
DP_WORKER_FLAG = "--dp-gloo-rank"


def dp_gloo_rank(rank: int, port: int, device: str, out: str) -> None:
    import collections

    import numpy as np
    import torch
    import torch.distributed as dist

    from facegen_torch.config import TrainConfig
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.data.synthetic import draw_synthetic_faces
    from facegen_torch.ops import fused_update as fu
    from facegen_torch.ops import upsample_conv as uc
    from facegen_torch.parallel import make_mesh, maybe_initialize, shard_pool
    from facegen_torch.sample import full_fp32
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.train.step import DDraws, GDraws, StepDraws, TrainStep
    from facegen_torch.utils import checkpoint as ckpt

    torch.set_num_threads(3)
    dev = torch.device(device)
    maybe_initialize(_coordinator_env(port, 2, rank), device_type=dev.type, backend="gloo")
    try:
        mesh = make_mesh((2,), device=dev)
        by_shape = collections.Counter()
        launch, launch_bwd = uc._launch, uc._launch_bwd

        def counted(x, wc, b):
            by_shape[f"upsample_conv_fwd N={x.shape[0]}"] += 1
            return launch(x, wc, b)

        def counted_bwd(which, a, b):
            by_shape[f"upsample_conv_{which} N={a.shape[0]}"] += 1
            return launch_bwd(which, a, b)

        def counted_update(launch_update):  # by the net's leaf count
            def wrapper(*args):
                params = args[0] if launch_update is launch_prep else args[3]
                name = "fused_prep" if launch_update is launch_prep else "fused_update"
                by_shape[f"{name} leaves={len(params)}"] += 1
                return launch_update(*args)
            return wrapper

        uc._launch, uc._launch_bwd = counted, counted_bwd
        launch_prep, launch_update = fu._launch_prep, fu._launch_update
        fu._launch_prep, fu._launch_update = (counted_update(launch_prep),
                                              counted_update(launch_update))
        pool = prepare_pool(draw_synthetic_faces(torch.Generator().manual_seed(6), 256), 32, 3)
        cfg = TrainConfig(compute_dtype="float32", reference_init=False, g_l2=1e-3).validate()
        # cuDNN's deterministic algorithms: with its free ones two fp32 runs
        # of the same steps differ by up to ~5e-4 (phase 14's control)
        torch.backends.cudnn.deterministic = True
        with full_fp32():
            state = _train_state(cfg, dev, g_biases=True)
            step = TrainStep(cfg, state.g, state.d, mesh)
            local = shard_pool(pool, mesh).to(dev)
            rs = np.random.RandomState(100 + rank)

            def draws():
                def masks():
                    return {k: torch.from_numpy(rs.rand(*shape) < 1.0 - rate).to(dev)
                            for k, (shape, rate) in step.mask_specs.items()}

                half, nd = step.batch // 2, cfg.noise_dim
                d = DDraws(torch.from_numpy(rs.randint(0, local.shape[0], half)).to(dev),
                           torch.from_numpy(rs.uniform(-1, 1, (half, nd)).astype(np.float32))
                           .to(dev), masks())
                g = GDraws(torch.from_numpy(rs.uniform(-1, 1, (step.batch, nd))
                                            .astype(np.float32)).to(dev), masks())
                return StepDraws((d,), (g,))

            for _ in range(3):
                step(state, local, draws())
        torch.backends.cudnn.deterministic = False
        uc._launch, uc._launch_bwd = launch, launch_bwd
        fu._launch_prep, fu._launch_update = launch_prep, launch_update
        arrays, meta = ckpt.train_state_arrays(state), {"launches": dict(by_shape)}
        if dev.type == "cuda":  # the gloo step's time at the default flags
            cfg = TrainConfig().validate()
            state = _train_state(cfg, dev)
            runner = GraphedStep(TrainStep(cfg, state.g, state.d, mesh), state, local.shape[0])
            runner.set_pool(local)
            gen = torch.Generator(dev).manual_seed(11 + rank)
            runner.run(gen, 3)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            runner.run(gen, 10)
            end.record()
            torch.cuda.synchronize()
            meta.update(stream_ms=start.elapsed_time(end) / 10,
                        host_ms=(time.perf_counter() - t0) * 1e3 / 10, route=runner.route)
        ckpt.save(out, f"rank{rank}", arrays, meta)
    finally:
        dist.destroy_process_group()


def phase_dp_gloo(tmp: str):
    """Two ranks sharing cuda:0 over gloo, and the same 2-rank program on
    the CPU (plain kernel versions), all four processes at once: 3 fp32
    steps each at the default flags from one seeded state on per-rank
    draws, cuDNN's algorithms deterministic. The card's ranks must be bit-equal to each other and within
    DP_TOL of the CPU's. Returns the card's
    launches (both ranks)."""
    import collections

    import numpy as np

    from facegen_torch.config import TrainConfig
    from facegen_torch.utils import checkpoint as ckpt

    here = os.path.abspath(__file__)
    outs = {dev: os.path.join(tmp, f"dp_gloo_{dev.split(':')[0]}") for dev in ("cuda:0", "cpu")}
    procs = []
    t0 = time.perf_counter()
    for dev, out in outs.items():
        port = _free_port()
        procs += [subprocess.Popen([sys.executable, here, DP_WORKER_FLAG, str(r), str(port), dev,
                                    out], cwd=os.path.dirname(here), stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    run_s = time.perf_counter() - t0
    for p, log in zip(procs, logs):
        check(p.returncode == 0, f"a dp gloo rank failed: {log[-3000:]}")
    (c0, m0), (c1, m1) = (ckpt.load(outs["cuda:0"], f"rank{r}") for r in range(2))
    (p0, _), (p1, _) = (ckpt.load(outs["cpu"], f"rank{r}") for r in range(2))
    ranks_equal = sorted(c0) == sorted(c1) and all(np.array_equal(c0[k], c1[k]) for k in c0)
    cpu_ranks_equal = all(np.array_equal(p0[k], p1[k]) for k in p0)
    start = ckpt.train_state_arrays(_train_state(
        TrainConfig(compute_dtype="float32", reference_init=False).validate(), "cpu",
        g_biases=True))
    errs = {}
    for net in ("g", "d"):
        keys = [k for k in c0 if k.startswith(f"params_{net}/")]
        errs[f"{net} update"] = _np_rel_l2([c0[k] - start[k] for k in keys],
                                           [p0[k] - start[k] for k in keys])
        for kind in ("mu", "nu"):
            keys = [k for k in c0 if k.startswith(f"opt_{net}/0/{kind}/")]
            errs[f"{net} {kind}"] = _np_rel_l2([c0[k] for k in keys], [p0[k] for k in keys])
    worst = max((_np_rel_l2([c0[k] - start.get(k, 0)], [p0[k] - start.get(k, 0)]), k)
                for k in c0 if k.startswith(("params_", "opt_")) and c0[k].dtype.kind == "f")
    exact = [k for k in c0 if "/" not in k or k.endswith("/count")]
    counters = all(np.array_equal(c0[k], p0[k]) for k in exact)
    ok = (ranks_equal and cpu_ranks_equal and counters
          and all(v <= DP_TOL for v in errs.values()))
    by_shape = dict(collections.Counter(m0["launches"]) + collections.Counter(m1["launches"]))
    print(f"dp gloo path: 2 ranks sharing cuda:0 over gloo and 2 on the CPU, 3 fp32 steps at the "
          f"default flags (local batch 16) in {run_s:.3f} s (4 processes, with their start); card "
          f"ranks bit-equal: {ranks_equal}; CPU ranks bit-equal: {cpu_ranks_equal}; card vs CPU "
          f"relative l2: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tolerance {DP_TOL}); worst leaf {worst[1]} {worst[0]:.3e}; counters and "
          f"confusion {'equal' if counters else 'DIFFER'} (confusion {c0['confusion'].tolist()}); "
          f"{'ok' if ok else 'FAIL'}")
    print(f"dp gloo path: kernel launches on the card by shape (both ranks, 3 steps): "
          f"{json.dumps(dict(sorted(by_shape.items())))}")
    for r, m in enumerate((m0, m1)):
        print(f"dp gloo path (rank {r}): {m['stream_ms']:.4f} ms per step on the stream, "
              f"{m['host_ms']:.3f} ms of host clock (CUDA events over 10 steps after 3, default "
              f"flags, local batch 16, bf16; {m['route']})")
    check(ok, "the 2-rank gloo step on the card disagrees")
    want = {"upsample_conv_fwd N=8": 2 * 2 * 3, "upsample_conv_fwd N=16": 2 * 2 * 3,
            "upsample_conv_dx N=16": 2 * 2 * 3, "upsample_conv_dw N=16": 2 * 2 * 3,
            **{f"{k} leaves={n}": 2 * 3 for k in ("fused_prep", "fused_update")
               for n in (20, 15)}}  # D32b's and G32's update, 3 steps on 2 ranks
    check(by_shape == want, f"launches by shape {by_shape}, want {want}")
    return {name: sum(v for k, v in by_shape.items() if k.startswith(name + " "))
            for name in COUNTED}


def _np_rel_l2(ours, ref):
    """Relative l2 error of a list of numpy arrays, in fp64."""
    import numpy as np

    num = sum(float(((o.astype(np.float64) - r) ** 2).sum()) for o, r in zip(ours, ref))
    den = sum(float((r.astype(np.float64) ** 2).sum()) for r in ref)
    return (num / max(den, 1e-300)) ** 0.5


def phase_dp_sampler(tmp: str, store: str):
    """``run_sampling`` served by two replicas on cuda:0 (--runs 2
    --neighbours) against the single-device run from the same seed: the
    files, the launches and the wall time; then the replicas' images,
    scores and neighbours against one device's, in fp32 (TF32 off) within
    DP_SERVE_FP32_TOL with equal indices, and in the served bf16 within
    the bf16 tolerance. Returns the replicated run's launches."""
    import contextlib

    import torch

    from facegen_torch import sample
    from facegen_torch.config import SampleConfig
    from facegen_torch.models import gan
    from facegen_torch.sample import full_fp32
    from facegen_torch.utils.infer import GanInference, nearest_neighbours, prepare_nn_dataset

    dev = torch.device("cuda", 0)
    save_dir = os.path.join(tmp, "logs")  # phase 5's checkpoint
    walls, launches = {}, {}
    for label, devices in (("one device", None), ("2 replicas", [dev, dev])):
        cfg = SampleConfig(save=save_dir, runs=2, neighbours=True, dataset_dir=store,
                           writeto=os.path.join(tmp, f"dp_samples_{len(devices or [0])}"))
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        paths = sample.run_sampling(cfg, device=dev, devices=devices, verbose=False)
        torch.cuda.synchronize()
        walls[label], launches[label] = time.perf_counter() - t0, _launches()
        check(len(paths) == 12, f"{label}: {len(paths)} files")
        _check_files(*paths)
    print(f"dp sampler path: run_sampling --runs 2 --neighbours took {walls['2 replicas']:.3f} s "
          f"on 2 replicas sharing cuda:0 against {walls['one device']:.3f} s on one device "
          f"(host clock, with checkpoint load, store preparation, NN search and PNGs); launches "
          f"{launches['2 replicas']} against {launches['one device']}")
    check(launches["2 replicas"]["upsample_conv_fwd"] == 2 * 2 * 2,
          f"2 replicas x 2 layers x 2 runs forward launches, got {launches['2 replicas']}")
    check(launches["2 replicas"]["bn_prelu"] == _bn_prelu(g_calls=2 * 2),
          f"2 replicas x 2 runs x 2 batch norm + PReLU launches, got {launches['2 replicas']}")

    g, d, _ = gan.restore_gan("adversarial", default_dir=save_dir, device=dev)
    noise = GanInference(g, d, 100).noise(sample.run_generator(1, 1), sample.N_SAMPLES)
    data = sample.load_dataset(SampleConfig(scale=32, grayscale=False, dataset_dir=store), dev)
    lines, ok = [], True
    for dtype, ctx in ((torch.float32, full_fp32), (torch.bfloat16, contextlib.nullcontext)):
        with ctx():
            one = GanInference(g, d, 100, dtype)
            two = GanInference(g, d, 100, dtype, devices=[dev, dev])
            imgs, imgs2 = one.generate(noise), two.generate(noise)
            scores, scores2 = one.score(imgs), two.score(imgs)
            best = one.rank(imgs, max_out=16)[0]
            idx, _ = nearest_neighbours(best, prepare_nn_dataset(data, dev))
            idx2, _ = nearest_neighbours(best, prepare_nn_dataset(data, [dev, dev]))
            torch.cuda.synchronize()
        e_img = float((imgs2 - imgs).abs().max())
        e_score = float((scores2 - scores).abs().max())
        if dtype == torch.float32:
            good = e_img <= DP_SERVE_FP32_TOL and e_score <= DP_SERVE_FP32_TOL
        else:
            good = (bool(((imgs2 - imgs).abs() <= BF16_ATOL + BF16_RTOL * imgs.abs()).all())
                    and bool(((scores2 - scores).abs() <= BF16_ATOL + BF16_RTOL
                              * scores.abs()).all()))
        good &= bool((idx == idx2).all())
        ok &= good
        lines.append(f"{'fp32 (TF32 off)' if dtype == torch.float32 else 'bf16 (served)'}: "
                     f"images {e_img:.3e}, scores {e_score:.3e}, neighbour indices "
                     f"{'equal' if (idx == idx2).all() else 'DIFFER'}")
    print(f"dp sampler path: 2 replicas vs one device on run 1's noise (1024): {'; '.join(lines)} "
          f"(tolerances {DP_SERVE_FP32_TOL} fp32, {BF16_ATOL} + {BF16_RTOL:.4f} x |ref| bf16); "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the replicated sampler disagrees with one device")
    return launches["2 replicas"]


def phase_gspmd_nccl(tmp: str, store: str):
    """The 2-D step at world 1 under NCCL: ``make_mesh2d(1, 1)`` over a
    1-rank group, its graphed step against the single-device graphed step
    (3 fp32 steps, TF32 off, cuDNN deterministic: bit-equal), both timed
    at the default flags on the stream and profiled (busy share); then a
    Trainer on that mesh for one epoch at the default flags
    (--N_epoch 256: 16 steps), its step graphed. Returns the trainer's
    launches."""
    import torch
    import torch.distributed as dist

    from facegen_torch.config import TrainConfig
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.data.synthetic import draw_synthetic_faces
    from facegen_torch.parallel import make_mesh2d, maybe_initialize
    from facegen_torch.sample import full_fp32
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.train.loop import Trainer
    from facegen_torch.train.step import TrainStep, steps_per_epoch

    dev = torch.device("cuda", 0)
    check(maybe_initialize(_coordinator_env(_free_port(), 1, 0)), "no NCCL group")
    try:
        mesh = make_mesh2d(1, 1)
        check(mesh.backend == "nccl" and mesh.device == dev, f"mesh {mesh}")
        pool = prepare_pool(draw_synthetic_faces(torch.Generator().manual_seed(6), 1000), 32, 3)
        pool = pool.to(dev)

        def graphed(cfg, two_d):
            state = _train_state(cfg, dev, mesh=mesh if two_d else None)
            runner = GraphedStep(TrainStep(cfg, state.g, state.d, mesh if two_d else None),
                                 state, pool.shape[0])
            runner.set_pool(pool)
            return state, runner

        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            cfg = TrainConfig(compute_dtype="float32").validate()
            with full_fp32():
                (plain, r_plain), (two, r_two) = graphed(cfg, False), graphed(cfg, True)
                r_plain.run(torch.Generator(dev).manual_seed(7), 3)
                r_two.run(torch.Generator(dev).manual_seed(7), 3)
                torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = saved
        errs, (worst, leaf) = _state_diffs(two, plain)
        same = all(torch.equal(getattr(two, k), getattr(plain, k)) for k in (
            "accs", "accs_n", "confusion", "trained_d", "not_trained_d"))
        print(f"gspmd nccl parity fp32 (TF32 off, cuDNN deterministic), 3 graphed steps on "
              f"make_mesh2d(1, 1) of a 1-rank NCCL group vs the single-device graphed step, "
              f"relative l2: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f"; worst leaf {leaf} {worst:.3e}; counters {'equal' if same else 'DIFFER'}; "
              f"{r_two.route}")
        check(r_two.graph is not None and "all-gathers over the 1x1 mesh" in r_two.route,
              f"the 2-D step was not captured: {r_two.route}")
        check(worst == 0.0 and same, "the 1x1 graphed step is not bit-equal to the single-device one")

        cfg = TrainConfig().validate()  # the default flags: bf16
        (_, r_plain), (_, r_two) = graphed(cfg, False), graphed(cfg, True)
        gens = {"single": torch.Generator(dev).manual_seed(11),
                "2-D 1x1": torch.Generator(dev).manual_seed(11)}
        runs = {"single": lambda n: r_plain.run(gens["single"], n),
                "2-D 1x1": lambda n: r_two.run(gens["2-D 1x1"], n)}
        times = {"single": [], "2-D 1x1": []}
        for route in ("single", "2-D 1x1", "2-D 1x1", "single"):
            times[route].append(_step_ms(runs[route]))
        for route, ts in times.items():
            print(f"gspmd nccl path ({route}): {statistics.mean(ts):.4f} ms per graphed step on "
                  f"the stream (CUDA events over 30 steps, mean of 2 turns: "
                  f"{', '.join(f'{t:.4f}' for t in ts)}; default flags, batch 32, bf16)")
        _profile_train_steps(runs["single"], label="gspmd nccl path (single-device graphed step)")
        _profile_train_steps(runs["2-D 1x1"], label="gspmd nccl path (1x1 graphed step)")

        _family_on_1x1(tmp, mesh)

        save = os.path.join(tmp, "gspmd_nccl_logs")
        tcfg = TrainConfig(dataset_dir=store, save=save, n_epoch=256, epochs=1).validate()
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        trainer = Trainer(tcfg, mesh=mesh, verbose=False)
        stats = list(trainer.run())
        torch.cuda.synchronize()
        run_s, launches = time.perf_counter() - t0, _launches()
    finally:
        dist.destroy_process_group()
    steps = steps_per_epoch(tcfg)
    want = {"upsample_conv_fwd": 4 * steps + 4, "upsample_conv_dx": 2 * steps,
            "upsample_conv_dw": 2 * steps, **_updates(2 * steps), "bn_prelu": _bn_prelu(steps, 2)}
    print(f"gspmd nccl path: Trainer on make_mesh2d(1, 1), 1 epoch of {steps} steps at the "
          f"default flags in {run_s:.3f} s (with the capture and the grids): loss_d "
          f"{stats[0]['loss_d_mean']:.4f} loss_g {stats[0]['loss_g_mean']:.4f}; "
          f"{trainer.graphed.route}; launches {launches}")
    check(trainer.graphed.graph is not None, "the 1x1 trainer did not capture its step")
    check(launches == want, f"launches {launches}, want {want}")
    _check_files(os.path.join(save, "adversarial", "arrays.npz"))
    return launches


def _family_on_1x1(tmp: str, mesh):
    """The c2f, autoencoder and denoiser trainers on ``mesh`` (the 1x1
    mesh of a 1-rank NCCL group), their all-reduces inside the CUDA graph,
    against the same trainers on one device: 3 graphed steps each in fp32
    (TF32 off) under cuDNN's deterministic algorithms, bit for bit."""
    import torch

    from facegen_torch.sample import full_fp32

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for kind in FAMILY:
            with full_fp32():
                save = os.path.join(tmp, f"gspmd_nccl_{kind}")
                one, two = _family_trainer(kind, save), _family_trainer(kind, save, mesh=mesh)
                losses_one, losses_two = _family_steps(one), _family_steps(two)
                torch.cuda.synchronize()
            errs, same = _family_diffs(two, one, losses_two, losses_one)
            same &= bool(torch.equal(losses_two, losses_one))
            runner = two.graphed
            ok = (same and max(errs.values()) == 0.0 and one.graphed.graph is not None
                  and runner.graph is not None and "all-gathers over the 1x1 mesh" in runner.route)
            print(f"gspmd nccl family parity ({kind}, fp32, TF32 off, cuDNN deterministic): 3 "
                  f"graphed steps on make_mesh2d(1, 1) vs the single-device graphed steps, "
                  f"relative l2: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + f"; counts and losses {'equal' if same else 'DIFFER'}; {runner.route}; "
                  f"capture {runner.capture_ms:.1f} ms; {'ok' if ok else 'FAIL'}")
            check(ok, f"the 1x1 graphed {kind} step is not bit-equal to the single-device one")
    finally:
        torch.backends.cudnn.deterministic = saved


# the 2-D programs of ranks sharing the card over gloo: a rank of a gloo
# group of ``world`` on ``device``; "gan" (4 ranks, the 2x2 mesh): 3 fp32
# GAN steps at the default flags on the global draws from numpy, the
# gathered state, the launches by shape and the step's time (bf16);
# "family" (2 ranks, the 2x1 mesh): 3 fp32 steps each of the c2f, the
# autoencoder and the denoiser
GSPMD_WORKER_FLAG = "--gspmd-gloo-rank"
GSPMD_TOL = 1e-3  # as DP_TOL: the parameters' change and the moments, relative l2
# the c2f at its default SGD lr (0.02, momentum 0.9): after one step the
# 2x1 mesh's traces are 7e-7 from one device's (CPU), after three 6.5e-4,
# and 8.6e-5 at a tenth of the lr: the step moves the nets far enough for
# their ReLUs' fp32 kinks to amplify the first step's rounding, as
# tests/test_torch_port_parallel.py's G16 + D16_d case does (5e-3 there)
C2F_GSPMD_TOL = 5e-3


def _gan_global_draws(step, cfg, dev, rs, pool_n):
    """One step's global draws from numpy ``rs`` (the same on every rank and
    on one device)."""
    import numpy as np
    import torch

    from facegen_torch.train.step import DDraws, GDraws, StepDraws

    def masks():
        return {k: torch.from_numpy(rs.rand(*shape) < 1.0 - rate).to(dev)
                for k, (shape, rate) in step.mask_specs.items()}

    bs, nd = cfg.batch_size, cfg.noise_dim
    d = DDraws(torch.from_numpy(rs.randint(0, pool_n, bs // 2)).to(dev),
               torch.from_numpy(rs.uniform(-1, 1, (bs // 2, nd)).astype(np.float32)).to(dev),
               masks())
    g = GDraws(torch.from_numpy(rs.uniform(-1, 1, (bs, nd)).astype(np.float32)).to(dev), masks())
    return StepDraws((d,), (g,))


def gspmd_gan_steps(dev, mesh=None, batch=32):
    """3 fp32 GAN steps at the default flags (G32 + D32b, at ``batch``) from
    a seeded state on the global draws; the gathered state's leaves."""
    import numpy as np
    import torch

    from facegen_torch.config import TrainConfig
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.data.synthetic import draw_synthetic_faces
    from facegen_torch.train.step import TrainStep
    from facegen_torch.utils import checkpoint as ckpt

    cfg = TrainConfig(compute_dtype="float32", reference_init=False, g_l2=1e-3,
                      batch_size=batch).validate()
    pool = prepare_pool(draw_synthetic_faces(torch.Generator().manual_seed(6), 256), 32, 3).to(dev)
    state = _train_state(cfg, dev, g_biases=True, mesh=mesh)
    step = TrainStep(cfg, state.g, state.d, mesh)
    rs = np.random.RandomState(100)
    for _ in range(3):
        step(state, pool, _gan_global_draws(step, cfg, dev, rs, pool.shape[0]))
    return ckpt.train_state_arrays(state)


def _mask_draws(rs, specs, dev):
    import torch

    return {k: torch.from_numpy(rs.rand(*shape) < 1.0 - rate).to(dev)
            for k, (shape, rate) in specs.items()}


def gspmd_family_steps(dev, mesh=None, steps=3):
    """``steps`` fp32 steps each of the c2f (its default flags but SGD with
    momentum 0.9), the autoencoder (scale 32, gray, noiseDim 256) and the
    denoiser (scale 16, colour, --coefL1 1e-4) at batch 32 from seeded nets
    on global draws from numpy; each one's gathered leaves and losses.
    The c2f runs SGD because Adam's first steps move an entry by about lr
    x the sign of its gradient, and at full width thousands of the c2f
    nets' gradient entries are as small as their rounding noise (the 2x1
    mesh against one device on the CPU: 0.3 % of G's entries moved by up
    to 2.2e-3 against each other, 1.2e-2 relative l2); SGD's step is
    linear in the gradient, and its momentum trace is sharded state as
    Adam's moments are."""
    import numpy as np
    import torch

    from facegen_torch.config import C2FConfig, TrainConfig
    from facegen_torch.data.c2f import make_triples
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.data.synthetic import draw_synthetic_faces
    from facegen_torch.models import ae, c2f
    from facegen_torch.nn.init import gaussian_overwrite
    from facegen_torch.nn.layers import set_batch_norm_mesh
    from facegen_torch.parallel.gspmd import shard_params
    from facegen_torch.train.ae_loop import (
        AEDraws,
        AEStep,
        DenoiserDraws,
        DenoiserState,
        DenoiserStep,
    )
    from facegen_torch.train.c2f import (
        C2FDDraws,
        C2FGDraws,
        C2FStep,
        C2FStepDraws,
        init_c2f_state,
    )
    from facegen_torch.train.optim import adam
    from facegen_torch.utils import checkpoint as ckpt

    faces = draw_synthetic_faces(torch.Generator().manual_seed(6), 256)
    out, rs = {}, np.random.RandomState(200)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    # c2f at its default flags in fp32, SGD with momentum
    cfg = C2FConfig(compute_dtype="float32", d_optmethod="sgd", g_optmethod="sgd",
                    d_sgd_momentum=0.9, g_sgd_momentum=0.9).validate()
    g, d = c2f.init_c2f(torch.Generator().manual_seed(3), cfg.fine_size, cfg.channels, device=dev)
    state, step = init_c2f_state(cfg, g, d, mesh), C2FStep(cfg, g, d, mesh)
    pool = make_triples(prepare_pool(faces, 32, 3).to(dev), cfg.coarse_size)
    bs, fs, losses = cfg.batch_size, cfg.fine_size, []
    for _ in range(steps):
        noise = [t(rs.uniform(-1, 1, (n, fs, fs, 1)).astype(np.float32)) for n in (bs // 2, bs)]
        draws = C2FStepDraws(
            (C2FDDraws(t(rs.randint(0, 256, bs // 2)), t(rs.randint(0, 256, bs // 2)), noise[0],
                       _mask_draws(rs, step.mask_specs, dev)),),
            (C2FGDraws(t(rs.randint(0, 256, bs)), noise[1], _mask_draws(rs, step.mask_specs, dev)),))
        losses.append([float(v) for v in step(state, pool, draws)])
    out["c2f"] = (ckpt.train_state_arrays(state), losses)
    # the autoencoder
    cfg = TrainConfig(scale=32, grayscale=True, noise_dim=256).validate()
    gen = torch.Generator().manual_seed(4)
    model = ae.create_autoencoder(32, 1, 256, generator=gen, device=dev)
    gaussian_overwrite(model, gen)
    shards = shard_params({"m": model}, mesh)["m"] if mesh is not None else None
    opt = adam(1e-3).init(shards.masters if shards else list(model.parameters()))
    step, pool = AEStep(cfg, model, mesh, shards), prepare_pool(faces, 32, 1).to(dev)
    losses = [float(step(model, opt, pool, AEDraws(t(rs.permutation(256)[:32]),
                                                   _mask_draws(rs, step.mask_specs, dev))))
              for _ in range(steps)]
    opt = shards.full_opt(opt) if shards else opt
    out["autoencoder"] = (ckpt.autoencoder_arrays(model, opt), losses)
    # the denoiser
    cfg = TrainConfig(scale=16, coef_l1=1e-4).validate()
    enc, dec1, dec2 = ae.init_denoiser(torch.Generator().manual_seed(5), 16, 3, device=dev)
    shards = shard_params({"dec1": dec1, "dec2": dec2}, mesh) if mesh is not None else None
    tx = adam(1e-3)
    st = DenoiserState(enc, dec1, dec2, *(tx.init(shards[k].masters if shards else
                                                  list(m.parameters()))
                                          for k, m in (("dec1", dec1), ("dec2", dec2))), shards)
    step, pool = DenoiserStep(cfg, dec1, mesh), prepare_pool(faces, 16, 3).to(dev)
    set_batch_norm_mesh(dec1, mesh)
    set_batch_norm_mesh(dec2, mesh)
    losses = []
    for _ in range(steps):
        def normal():
            return t(rs.standard_normal((32, 16, 16, 3)).astype(np.float32))

        draws = DenoiserDraws(t(rs.permutation(256)[:32]), normal(),
                              _mask_draws(rs, step.mask_specs, dev), normal(),
                              _mask_draws(rs, step.mask_specs, dev),
                              _mask_draws(rs, step.mask_specs, dev))
        losses.append(step(st, pool, draws).tolist())
    arrays = ckpt.denoiser_arrays(dec1, dec2)
    for key, k, dec, o in (("AE1_DECODER", "dec1", dec1, st.opt1),
                           ("AE2_DECODER", "dec2", dec2, st.opt2)):
        arrays.update(ckpt.module_arrays(dec, f"{key}/p", f"{key}/s",
                                         shards[k].full_opt(o) if shards else o, f"{key}/opt"))
    out["denoiser"] = (arrays, losses)
    return out


def gspmd_gloo_rank(kind: str, rank: int, world: int, port: int, device: str, out: str) -> None:
    import collections

    import torch
    import torch.distributed as dist

    from facegen_torch.ops import upsample_conv as uc
    from facegen_torch.parallel import make_mesh2d, maybe_initialize
    from facegen_torch.sample import full_fp32
    from facegen_torch.utils import checkpoint as ckpt

    torch.set_num_threads(2)
    dev = torch.device(device)
    maybe_initialize(_coordinator_env(port, world, rank), device_type=dev.type, backend="gloo")
    try:
        mesh = make_mesh2d(world // 2, 2, device=dev) if kind == "gan" else make_mesh2d(
            world, 1, device=dev)
        by_shape = collections.Counter()
        launch, launch_bwd = uc._launch, uc._launch_bwd

        def counted(x, wc, b):
            by_shape[f"upsample_conv_fwd N={x.shape[0]}"] += 1
            return launch(x, wc, b)

        def counted_bwd(which, a, b):
            by_shape[f"upsample_conv_{which} N={a.shape[0]}"] += 1
            return launch_bwd(which, a, b)

        uc._launch, uc._launch_bwd = counted, counted_bwd
        torch.backends.cudnn.deterministic = True
        with full_fp32():
            if kind == "gan":
                results = {"gan": (gspmd_gan_steps(dev, mesh), [])}
            else:
                results = gspmd_family_steps(dev, mesh)
        torch.backends.cudnn.deterministic = False
        uc._launch, uc._launch_bwd = launch, launch_bwd
        meta = {"launches": dict(by_shape), "losses": {k: v[1] for k, v in results.items()}}
        if kind == "gan" and dev.type == "cuda":  # the 2-D gloo step's time, default flags
            from facegen_torch.config import TrainConfig
            from facegen_torch.data.pipeline import prepare_pool
            from facegen_torch.data.synthetic import draw_synthetic_faces
            from facegen_torch.train.graph import GraphedStep
            from facegen_torch.train.step import TrainStep

            cfg = TrainConfig().validate()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            state = _train_state(cfg, dev, mesh=mesh)
            meta["state_bytes"] = torch.cuda.memory_allocated(dev) - before
            pool = prepare_pool(draw_synthetic_faces(torch.Generator().manual_seed(6), 256), 32,
                                3).to(dev)
            runner = GraphedStep(TrainStep(cfg, state.g, state.d, mesh), state, pool.shape[0])
            runner.set_pool(pool)
            gen = torch.Generator(dev).manual_seed(11)
            runner.run(gen, 3)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            runner.run(gen, 10)
            end.record()
            torch.cuda.synchronize()
            meta.update(stream_ms=start.elapsed_time(end) / 10,
                        host_ms=(time.perf_counter() - t0) * 1e3 / 10, route=runner.route)
        for name, (arrays, _) in results.items():
            ckpt.save(out, f"{name}_rank{rank}", arrays, meta)
    finally:
        dist.destroy_process_group()


def _run_ranks(argv_of, world: int, timeout: int = 900, env=None):
    """``world`` processes, rank r running ``argv_of(r)``, all at once; their
    outputs, after all have ended (each must exit 0)."""
    procs = [subprocess.Popen(argv_of(r), cwd=os.path.dirname(os.path.abspath(__file__)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=None if env is None else env(r))
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        check(p.returncode == 0, f"a rank failed: {log[-3000:]}")
    return logs


def _leaf_group(key: str) -> str:
    """A leaf's group: its root (``params_g``, ``opt_d``, ``params``), or a
    denoiser decoder's root and kind (``AE1_DECODER/opt``)."""
    parts = key.split("/")
    return "/".join(parts[:2]) if parts[0].endswith("_DECODER") else parts[0]


def _gspmd_compare(ranks_arrays, ref, start):
    """The ranks' gathered states bit-equal, and rank 0's against the
    single-device ``ref``, per group of leaves: relative l2 of the
    parameters' change from ``start`` and of the other floating leaves
    (moments, batch-norm statistics); the counters equal."""
    import numpy as np

    a0 = ranks_arrays[0]
    equal = all(sorted(a) == sorted(a0) and all(np.array_equal(a[k], a0[k]) for k in a0)
                for a in ranks_arrays[1:])
    errs = {}
    for group in sorted({_leaf_group(k) for k in ref if "/" in k}):
        keys = [k for k in ref if _leaf_group(k) == group and ref[k].dtype.kind == "f"]
        if not keys:
            continue
        if group.split("/")[-1] in ("params", "p", "params_g", "params_d"):
            errs[group] = _np_rel_l2([a0[k] - start[k] for k in keys],
                                     [ref[k] - start[k] for k in keys])
        else:
            errs[group] = _np_rel_l2([a0[k] for k in keys], [ref[k] for k in keys])
    exact = [k for k in ref if "/" not in k or k.endswith("/count")]
    counters = all(np.array_equal(a0[k], ref[k]) for k in exact)
    return equal, errs, counters


def phase_gspmd_gloo(tmp: str, store: str):
    """Four gloo ranks sharing cuda:0 on the 2x2 mesh: ``python -m
    facegen_torch.train --meshShape 2,2`` at the default flags for one short
    epoch (--N_epoch 256: 16 steps) from a TCP coordinator; then the step
    alone, 3 fp32 steps on the global draws against the single-device step
    on the card (the four gathered states bit-equal), the launches by shape
    and the step's time, and the kernels' rows at its local shapes.
    Returns the CLI's launches (all four ranks)."""
    import torch

    from facegen_torch.config import TrainConfig
    from facegen_torch.parallel.gspmd import torch_shard_dim
    from facegen_torch.train.step import steps_per_epoch
    from facegen_torch.utils import checkpoint as ckpt

    port, world = _free_port(), 4
    saves = [os.path.join(tmp, "gspmd_2x2_cli", f"rank{r}") for r in range(world)]

    def env(r):
        return dict(os.environ, **_coordinator_env(port, world, r))

    argv = ["--datasetDir", store, "--N_epoch", "256", "--epochs", "1", "--meshShape", "2,2"]
    t0 = time.perf_counter()
    logs = _run_ranks(lambda r: [sys.executable, "-c", _on_gloo(DP_CLI), *argv, "--save",
                                 saves[r]], world, env=env)
    run_s = time.perf_counter() - t0
    per_rank = [json.loads(log.rsplit("launches ", 1)[1].splitlines()[0]) for log in logs]
    route = next((ln for ln in logs[0].splitlines() if "step route:" in ln), "")
    steps = steps_per_epoch(TrainConfig(n_epoch=256))
    # the batch norms train over the mesh (their own path); rank 0's grids
    # run G in eval, where its pairs take the kernel
    want = [{"upsample_conv_fwd": 4 * steps + (4 if r == 0 else 0),
             "upsample_conv_dx": 2 * steps, "upsample_conv_dw": 2 * steps,
             **_updates(2 * steps), "bn_prelu": _bn_prelu(g_calls=2 if r == 0 else 0)}
            for r in range(world)]
    rows = _metrics_rows(saves[0])
    print(f"gspmd 2x2 path: python -m facegen_torch.train --meshShape 2,2 as 4 gloo ranks sharing "
          f"cuda:0 (maybe_initialize(backend='gloo') before the CLI), 1 epoch of {steps} steps "
          f"at the default flags in "
          f"{run_s:.3f} s (4 processes, with their start); {route.strip()}; launches per rank "
          f"{per_rank} (rank 0 also draws the grids); epoch 1: loss_d {rows[0]['loss_d_mean']:.4f}"
          f" loss_g {rows[0]['loss_g_mean']:.4f} {rows[0]['images_per_sec']:.1f} images/s")
    check(per_rank == want, f"launches per rank {per_rank}, want {want}")
    check("gloo over" in route or "gloo all-reduce" in route, f"route: {route!r}")
    _check_files(os.path.join(saves[0], "adversarial", "arrays.npz"))
    check(not any(os.path.exists(s) for s in saves[1:]), "a rank other than 0 wrote")

    here = os.path.abspath(__file__)
    out = os.path.join(tmp, "gspmd_2x2_steps")
    port = _free_port()
    t0 = time.perf_counter()
    _run_ranks(lambda r: [sys.executable, here, GSPMD_WORKER_FLAG, "gan", str(r), str(world),
                          str(port), "cuda:0", out], world)
    steps_s = time.perf_counter() - t0
    loaded = [ckpt.load(out, f"gan_rank{r}") for r in range(world)]
    ref = _single_device_refs()["gan32"]
    start = ckpt.train_state_arrays(_train_state(
        TrainConfig(compute_dtype="float32", reference_init=False).validate(), "cpu",
        g_biases=True))
    equal, errs, counters = _gspmd_compare([a for a, _ in loaded], ref, start)
    ok = equal and counters and all(v <= GSPMD_TOL for v in errs.values())
    print(f"gspmd 2x2 parity: 3 fp32 steps at the default flags (global batch 32, local 16) on "
          f"4 gloo ranks sharing cuda:0 vs the single-device step on the card, the same global "
          f"draws (TF32 off, cuDNN deterministic), in {steps_s:.3f} s (4 processes): ranks' "
          f"gathered states bit-equal: {equal}; relative l2 " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()) + f" (tolerance {GSPMD_TOL}); counters and "
          f"confusion {'equal' if counters else 'DIFFER'}; {'ok' if ok else 'FAIL'}")
    for r, (_, m) in enumerate(loaded):
        print(f"gspmd 2x2 path (rank {r}): launches by shape over the 3 steps "
              f"{json.dumps(dict(sorted(m['launches'].items())))}; the bf16 step at the default "
              f"flags: {m['stream_ms']:.4f} ms per step on the stream, {m['host_ms']:.3f} ms of "
              f"host clock (CUDA events over 10 steps after 3; {m['route']})")
    for row in DP_ROWS:
        print(f"gspmd 2x2 path: kernel at its local shape {json.dumps(row)}")
    # the state's memory: one device's nets and Adam moments against a 2x2
    # rank's work weights, masters and moments (torch.cuda.memory_allocated
    # around building the state at the default flags, in each process)
    cfg = TrainConfig().validate()
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    one = _train_state(cfg, dev)
    one_bytes = torch.cuda.memory_allocated(dev) - before
    params = [p for net in (one.g, one.d) for p in net.parameters()]
    total = sum(p.numel() for p in params)
    sharded = sum(p.numel() for p in params if torch_shard_dim(p.shape, 2) is not None)
    del one, params
    want = 4 * (total + 3 * sharded // 2 + 2 * (total - sharded))  # P + 3S/mp + 2(P - S)
    rank_bytes = [m["state_bytes"] for _, m in loaded]
    print(f"gspmd 2x2 path: the state's memory at the default flags (G32 + D32b, Adam), "
          f"torch.cuda.memory_allocated around building it: one device {one_bytes} bytes, a "
          f"rank of the 2x2 mesh {rank_bytes} bytes (mp = 2: {sharded} of {total} parameters "
          f"sharded; the work weights whole, the masters and moments halved: {want} bytes "
          f"counted, {min(rank_bytes) / one_bytes:.4f} of one device)")
    check(ok, "the 2x2 step on the card disagrees with the single-device step")
    check(all(b < one_bytes for b in rank_bytes),
          f"a 2x2 rank's state ({rank_bytes} bytes) is not below one device's ({one_bytes})")
    want = {"upsample_conv_fwd N=8": 2 * 3, "upsample_conv_fwd N=16": 2 * 3,
            "upsample_conv_dx N=16": 2 * 3, "upsample_conv_dw N=16": 2 * 3}
    for r, (_, m) in enumerate(loaded):
        check(m["launches"] == want, f"rank {r} launches by shape {m['launches']}, want {want}")
    return {name: sum(lr[name] for lr in per_rank) for name in COUNTED + ("bn_prelu",)}


GSPMD_FAMILY_CLI = (
    "import json, sys, time\n"
    "from facegen_torch import train_autoencoder, train_c2f, train_denoiser\n"
    "from facegen_torch.ops import fused_update as fu\n"
    "from facegen_torch.ops import upsample_conv as uc\n"
    "uc.KERNEL_LAUNCHES = uc.DX_LAUNCHES = uc.DW_LAUNCHES = 0\n"
    "fu.PREP_LAUNCHES = fu.UPDATE_LAUNCHES = 0\n"
    "store, save = sys.argv[1], sys.argv[2]\n"
    "common = ['--datasetDir', store, '--N_epoch', '256', '--epochs', '1', '--meshShape', '2']\n"
    "walls = {}\n"
    "for name, main in (('c2f', train_c2f.main), ('autoencoder', train_autoencoder.main), "
    "('denoiser', train_denoiser.main)):\n"
    "    t0 = time.perf_counter()\n"
    "    tr = main(common + ['--save', save + '/' + name])\n"
    "    walls[name] = time.perf_counter() - t0\n"
    "    assert tr.mesh is not None and (tr.mesh.dp, tr.mesh.mp) == (2, 1), tr.mesh\n"
    "print('family ' + json.dumps({'walls': walls, 'launches': [uc.KERNEL_LAUNCHES, "
    "uc.DX_LAUNCHES, uc.DW_LAUNCHES, fu.PREP_LAUNCHES, fu.UPDATE_LAUNCHES]}))\n"
)


def phase_gspmd_family(tmp: str, store: str):
    """The c2f, autoencoder and denoiser CLIs at --meshShape 2 (the 2x1
    mesh) on two gloo ranks sharing cuda:0, one short epoch each
    (--N_epoch 256); then 3 fp32 steps of each on the 2x1 mesh against its
    single-device step on the card. Returns the CLIs' launches over both
    ranks (the update's kernels only: these nets have no upsample-conv)."""
    import numpy as np

    from facegen_torch.utils import checkpoint as ckpt

    port, world = _free_port(), 2
    saves = [os.path.join(tmp, "gspmd_family_cli", f"rank{r}") for r in range(world)]

    def env(r):
        return dict(os.environ, **_coordinator_env(port, world, r))

    t0 = time.perf_counter()
    logs = _run_ranks(lambda r: [sys.executable, "-c", _on_gloo(GSPMD_FAMILY_CLI), store,
                                 saves[r]], world, env=env)
    run_s = time.perf_counter() - t0
    res = [json.loads(log.rsplit("family ", 1)[1].splitlines()[0]) for log in logs]
    _check_files(*(os.path.join(saves[0], sub, "arrays.npz") for sub in (
        "c2f/adversarial_c2f_16_to_32", "c2f/adversarial_c2f_16_to_32_best",
        "autoencoder/autoencoder", "denoiser/denoiser_3x16x16")))
    check(not os.path.exists(saves[1]), "rank 1 wrote")
    print(f"gspmd family path: the c2f, autoencoder and denoiser CLIs at --meshShape 2 on 2 gloo "
          f"ranks sharing cuda:0, one epoch each (--N_epoch 256) in {run_s:.3f} s (2 processes, "
          f"with their start); wall s per CLI on rank 0 {res[0]['walls']}; launches "
          f"(fwd, dx, dW, prep, update) per rank {[r['launches'] for r in res]}")
    check(all(r["launches"][:3] == [0, 0, 0] and r["launches"][4] > 0 for r in res),
          "an upsample-conv kernel launched, or the update's kernels did not")
    routes = [ln.strip() for ln in logs[0].splitlines() if "step route:" in ln]
    print(f"gspmd family path: rank 0's step routes {routes}")
    check(len(routes) == 3 and all("gloo all-reduce of a CUDA tensor" in r for r in routes),
          f"the family's routes under gloo: {routes}")

    here = os.path.abspath(__file__)
    out = os.path.join(tmp, "gspmd_family_steps")
    port = _free_port()
    _run_ranks(lambda r: [sys.executable, here, GSPMD_WORKER_FLAG, "family", str(r), str(world),
                          str(port), "cuda:0", out], world)
    refs = _single_device_refs()
    ref, start = refs["family"], refs["family_start"]
    ok_all = True
    for name, (ref_arrays, ref_losses) in ref.items():
        loaded = [ckpt.load(out, f"{name}_rank{r}") for r in range(world)]
        equal, errs, _ = _gspmd_compare([a for a, _ in loaded], ref_arrays, start[name][0])
        losses = loaded[0][1]["losses"][name]
        loss_err = float(np.max(np.abs(np.asarray(losses) - np.asarray(ref_losses))
                                / np.maximum(np.abs(np.asarray(ref_losses)), 1e-12)))
        tol = C2F_GSPMD_TOL if name == "c2f" else GSPMD_TOL
        ok = equal and loss_err <= tol and all(v <= tol for v in errs.values())
        ok_all &= ok
        print(f"gspmd family parity ({name}): 3 fp32 steps on the 2x1 mesh (2 gloo ranks sharing "
              f"cuda:0) vs one device on the card, the same global draws: ranks bit-equal "
              f"{equal}; losses' relative error {loss_err:.3e}; relative l2 (parameters: "
              f"their change) "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tolerance {tol}); {'ok' if ok else 'FAIL'}")
    check(ok_all, "a 2x1 family step disagrees with its single-device step")
    return dict(zip(COUNTED, (sum(r["launches"][k] for r in res) for k in range(len(COUNTED)))))


# the uneven (3, 1) mesh: three gloo ranks sharing the card, each of
# which runs the trainer CLIs on one group of three and then the steps
UNEVEN_WORKER_FLAG = "--uneven-gloo-rank"


def uneven_gloo_rank(rank: int, world: int, port: int, store: str, out: str) -> None:
    """A rank of the (3, 1) mesh, on cuda:0 in a gloo group of ``world``:
    ``python -m facegen_torch.train --meshShape 3,1`` at the default flags
    for one epoch (--N_epoch 256) and the c2f, autoencoder and denoiser
    CLIs at --meshShape 3, each with the wrappers' counts set to 0 before
    it and read after; then 3 fp32 GAN steps at batch 32 and at batch 4
    (this mesh's rank 2 then holds no rows) and 3 of each of the family on
    the global draws, with the launches by shape, saved under ``out``."""
    import collections

    import torch
    import torch.distributed as dist

    from facegen_torch import train, train_autoencoder, train_c2f, train_denoiser
    from facegen_torch.ops import upsample_conv as uc
    from facegen_torch.parallel import make_mesh2d, maybe_initialize
    from facegen_torch.sample import full_fp32
    from facegen_torch.utils import checkpoint as ckpt

    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    maybe_initialize(_coordinator_env(port, world, rank), device_type="cuda", backend="gloo")
    try:
        meta, common = {"cli": {}}, ["--datasetDir", store, "--N_epoch", "256", "--epochs", "1"]
        for name, main, shape in (("gan", train.main, "3,1"), ("c2f", train_c2f.main, "3"),
                                  ("autoencoder", train_autoencoder.main, "3"),
                                  ("denoiser", train_denoiser.main, "3")):
            _reset_launches()
            t0 = time.perf_counter()
            tr = main(common + ["--meshShape", shape, "--save",
                                os.path.join(out, f"{name}_cli", f"rank{rank}")])
            torch.cuda.synchronize()
            check((tr.mesh.dp, tr.mesh.mp) == (3, 1), f"{name}: mesh {tr.mesh}")
            meta["cli"][name] = {"s": time.perf_counter() - t0, "launches": _launches()}
            if name == "gan":
                meta["cli"][name]["route"] = tr.graphed.route
        mesh = make_mesh2d(world, 1, device=dev)
        by_shape = collections.Counter()
        launch, launch_bwd = uc._launch, uc._launch_bwd

        def counted(fn, key, n, *args):  # by shape, where the wrapper counted a launch
            before = _launches()
            out = fn(*args)
            if _launches() != before:
                by_shape[f"{key} N={n}"] += 1
            return out

        uc._launch = lambda x, wc, b: counted(launch, "upsample_conv_fwd", x.shape[0], x, wc, b)
        uc._launch_bwd = lambda which, a, b: counted(launch_bwd, f"upsample_conv_{which}",
                                                     a.shape[0], which, a, b)
        torch.backends.cudnn.deterministic = True
        with full_fp32():
            results = {"gan32": (gspmd_gan_steps(dev, mesh), []),
                       "gan4": (gspmd_gan_steps(dev, mesh, batch=4), []),
                       **gspmd_family_steps(dev, mesh)}
        torch.backends.cudnn.deterministic = False
        uc._launch, uc._launch_bwd = launch, launch_bwd
        meta.update(launches=dict(by_shape), losses={k: v[1] for k, v in results.items()})
        for name, (arrays, _) in results.items():
            ckpt.save(out, f"{name}_rank{rank}", arrays, meta)
    finally:
        dist.destroy_process_group()


_REFS = {}  # the single-device references phases 25, 26 and 28 share


def _single_device_refs():
    """The GAN steps at batch 32 and 4 and the family's steps on one
    device (fp32, TF32 off, cuDNN deterministic), and the family's start."""
    import torch

    if not _REFS:
        from facegen_torch.sample import full_fp32

        dev = torch.device("cuda", 0)
        torch.backends.cudnn.deterministic = True
        with full_fp32():
            _REFS.update(gan32=gspmd_gan_steps(dev), gan4=gspmd_gan_steps(dev, batch=4),
                         family=gspmd_family_steps(dev),
                         family_start=gspmd_family_steps(dev, steps=0))
        torch.backends.cudnn.deterministic = False
    return _REFS


def phase_uneven_mesh(tmp: str, store: str):
    """Three gloo ranks sharing cuda:0 on the (3, 1) mesh, whose data rows
    hold unequal blocks of a batch: the GAN CLI at --meshShape 3,1 and the
    c2f, autoencoder and denoiser CLIs at --meshShape 3 for one epoch each
    (the launches per rank: the forward at N = 6, 6, 4 in the D phase and
    11, 11, 10 in the G phase, with dx and dW); then 3 fp32 GAN steps at
    batch 32 and at batch 4 (rank 2 holds no rows and launches nothing)
    and 3 of each of the family, against the single-device steps on the
    card; and the kernels' rows of phases 3-4 at the mesh's local shapes.
    Returns the GAN CLI's launches (all three ranks)."""
    import numpy as np

    from facegen_torch.config import TrainConfig
    from facegen_torch.train.step import steps_per_epoch
    from facegen_torch.utils import checkpoint as ckpt

    port, world = _free_port(), 3
    out = os.path.join(tmp, "uneven_3x1")
    here = os.path.abspath(__file__)
    t0 = time.perf_counter()
    _run_ranks(lambda r: [sys.executable, here, UNEVEN_WORKER_FLAG, str(r), str(world), str(port),
                          store, out], world)
    run_s = time.perf_counter() - t0
    loaded = {name: [ckpt.load(out, f"{name}_rank{r}") for r in range(world)]
              for name in ("gan32", "gan4", "c2f", "autoencoder", "denoiser")}
    metas = [m for _, m in loaded["gan32"]]
    steps = steps_per_epoch(TrainConfig(n_epoch=256))
    # the batch norms train over the mesh (their own path); rank 0's grids
    # run G in eval, where its pairs take the kernel
    want = [{"upsample_conv_fwd": 4 * steps + (4 if r == 0 else 0),
             "upsample_conv_dx": 2 * steps, "upsample_conv_dw": 2 * steps,
             **_updates(2 * steps), "bn_prelu": _bn_prelu(g_calls=2 if r == 0 else 0)}
            for r in range(world)]
    cli = [m["cli"] for m in metas]
    print(f"uneven 3x1 path: 3 gloo ranks sharing cuda:0 in {run_s:.3f} s (3 processes, with "
          f"their start, the CLIs and the steps); python -m facegen_torch.train --meshShape 3,1 "
          f"at the default flags, 1 epoch of {steps} steps: {cli[0]['gan']['s']:.3f} s on rank "
          f"0, launches per rank {[c['gan']['launches'] for c in cli]} (rank 0 also draws the "
          f"grids); step route: {cli[0]['gan']['route']}; the c2f, autoencoder and denoiser "
          f"CLIs at --meshShape 3, 1 epoch each: " + ", ".join(
              f"{k} {cli[0][k]['s']:.3f} s" for k in ("c2f", "autoencoder", "denoiser")))
    check([c["gan"]["launches"] for c in cli] == want,
          f"3x1 CLI launches {[c['gan']['launches'] for c in cli]}, want {want}")
    check(all(_upconv(c[k]["launches"]) == dict.fromkeys(UPCONV, 0)
              and c[k]["launches"]["fused_update"] > 0 for c in cli
              for k in ("c2f", "autoencoder", "denoiser")),
          "a family CLI launched an upsample-conv kernel, or not the update's")
    saves = [os.path.join(out, "gan_cli", f"rank{r}") for r in range(world)]
    rows = _metrics_rows(saves[0])
    print(f"uneven 3x1 path: epoch 1 loss_d {rows[0]['loss_d_mean']:.4f} loss_g "
          f"{rows[0]['loss_g_mean']:.4f} {rows[0]['images_per_sec']:.1f} images/s")
    _check_files(os.path.join(saves[0], "adversarial", "arrays.npz"),
                 *(os.path.join(out, f"{k}_cli", "rank0", sub, "arrays.npz") for k, sub in (
                     ("c2f", "adversarial_c2f_16_to_32"), ("autoencoder", "autoencoder"),
                     ("denoiser", "denoiser_3x16x16"))))
    check(not any(os.path.exists(s) for s in saves[1:]), "a rank other than 0 wrote")

    refs = _single_device_refs()
    start = ckpt.train_state_arrays(_train_state(
        TrainConfig(compute_dtype="float32", reference_init=False).validate(), "cpu",
        g_biases=True))
    ok_all = True
    for name, batch in (("gan32", 32), ("gan4", 4)):
        equal, errs, counters = _gspmd_compare([a for a, _ in loaded[name]], refs[name], start)
        finite = all(np.isfinite(v).all() for a, _ in loaded[name] for v in a.values()
                     if v.dtype.kind == "f")
        ok = equal and counters and finite and all(v <= GSPMD_TOL for v in errs.values())
        ok_all &= ok
        a0, ref = loaded[name][0][0], refs[name]
        worst = max((_np_rel_l2([a0[k] - start[k]], [ref[k] - start[k]]), k) for k in ref
                    if k.startswith("params_") and ref[k].dtype.kind == "f")
        print(f"uneven 3x1 parity (GAN, batch {batch}): 3 fp32 steps at the default flags on 3 "
              f"gloo ranks sharing cuda:0 vs the single-device step on the card, the same "
              f"global draws (TF32 off, cuDNN deterministic): ranks' gathered states bit-equal: "
              f"{equal}; every leaf finite: {finite}; relative l2 " + ", ".join(
                  f"{k} {v:.3e}" for k, v in errs.items()) + f" (tolerance {GSPMD_TOL}); "
              f"the parameter whose change differs most {worst[1]} {worst[0]:.3e}; "
              f"counters and confusion {'equal' if counters else 'DIFFER'}; "
              f"{'ok' if ok else 'FAIL'}")
    for name, (ref_arrays, ref_losses) in refs["family"].items():
        equal, errs, _ = _gspmd_compare([a for a, _ in loaded[name]], ref_arrays,
                                        refs["family_start"][name][0])
        losses = loaded[name][0][1]["losses"][name]
        loss_err = float(np.max(np.abs(np.asarray(losses) - np.asarray(ref_losses))
                                / np.maximum(np.abs(np.asarray(ref_losses)), 1e-12)))
        tol = C2F_GSPMD_TOL if name == "c2f" else GSPMD_TOL
        ok = equal and loss_err <= tol and all(v <= tol for v in errs.values())
        ok_all &= ok
        print(f"uneven 3x1 parity ({name}): 3 fp32 steps on the 3x1 mesh vs one device on the "
              f"card: ranks bit-equal {equal}; losses' relative error {loss_err:.3e}; relative "
              f"l2 " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tolerance {tol}); {'ok' if ok else 'FAIL'}")
    # the 3 GAN steps at batch 32 and at batch 4: per step the forward at
    # the D phase's and the G phase's rows, dx and dW at the G phase's
    rows32, rows4 = (6, 6, 4), (1, 1, 0)
    g32, g4 = (11, 11, 10), (2, 2, 0)
    for r, (_, m) in enumerate(loaded["gan32"]):
        want = _sum_counts(
            {f"upsample_conv_fwd N={rows32[r]}": 6, f"upsample_conv_fwd N={g32[r]}": 6,
             f"upsample_conv_dx N={g32[r]}": 6, f"upsample_conv_dw N={g32[r]}": 6},
            {f"upsample_conv_fwd N={rows4[r]}": 6, f"upsample_conv_fwd N={g4[r]}": 6,
             f"upsample_conv_dx N={g4[r]}": 6, f"upsample_conv_dw N={g4[r]}": 6})
        want = {k: v for k, v in want.items() if not k.endswith(" N=0")}
        print(f"uneven 3x1 path (rank {r}): launches by shape over the GAN's 3 steps at batch "
              f"32 and 3 at batch 4 {json.dumps(dict(sorted(m['launches'].items())))}")
        check(m["launches"] == want, f"rank {r} launches by shape {m['launches']}, want {want}")
    for row in UNEVEN_ROWS:
        print(f"uneven 3x1 path: kernel at its local shape {json.dumps(row)}")
    check(ok_all, "a 3x1 step disagrees with its single-device step")
    return {name: sum(c["gan"]["launches"][name] for c in cli)
            for name in COUNTED + ("bn_prelu",)}


def _sum_counts(*counts):
    """The key-wise sum of dicts of counts."""
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


# --boundaryPad 8 against the unpadded step, 3 graphed fp32 steps (TF32
# off, cuDNN deterministic) from one state on one set of draws, relative
# l2 of the parameters and Adam's moments per network, as the card-against-
# CPU step check holds its gradients (STEP_GRAD_TOL): the padded convs are
# other cuDNN calls (G's output conv to 8 channels, D's first conv from 8)
# whose fp32 sums run in another order, and D's PReLU slopes and biases sum
# up to 2M such terms with cancellation (6.4e-5 read on D's first moment on
# an H100, a bias's 4.0e-4); a wrong pad (a lane that leaks) is O(1)
BOUNDARY_PAD_TOL = 1e-3


def phase_boundary_pad(tmp: str, store: str):
    """--boundaryPad 8 (train/step.py:make_boundary_padder): the trainer CLI
    at the default flags for one epoch, graphed, with 4, 2 and 2 launches a
    replay as unpadded; its step and the unpadded one timed on the stream
    in turns and profiled (busy share); 3 graphed fp32 steps padded
    against unpadded; the c2f CLI with --boundaryPad 8 for one epoch and 3
    fp32 c2f steps padded against unpadded. Returns the padded CLI's
    launches."""
    import torch

    from facegen_torch import train, train_c2f
    from facegen_torch.config import C2FConfig, TrainConfig
    from facegen_torch.data.c2f import make_triples
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.data.synthetic import draw_synthetic_faces
    from facegen_torch.models import c2f
    from facegen_torch.sample import full_fp32
    from facegen_torch.train.c2f import C2FStep, draw_c2f_step, init_c2f_state
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.train.step import TrainStep, steps_per_epoch

    trainers, launches = {}, None
    for pad in (8, 0):
        save = os.path.join(tmp, f"boundary_pad_{pad}")
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        trainers[pad] = train.main(["--datasetDir", store, "--save", save, "--epochs", "1",
                                    "--boundaryPad", str(pad)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        if pad:
            launches = _launches()
            tr = trainers[pad]
            steps = steps_per_epoch(tr.cfg)
            print(f"boundary pad path: train.main --boundaryPad 8 --epochs 1 took {run_s:.3f} s "
                  f"for {steps} steps; padder {tr.step.pad.pad} channels on G's "
                  f"{tr.step.pad.g_convs} and D's {tr.step.pad.d_convs}; launches {launches}; "
                  f"per replay {tr.graphed.launches_per_replay}; epoch 1 "
                  f"{_metrics_rows(save)[0]['images_per_sec']:.1f} images/s")
            check(tr.step.pad.active and tr.step.pad.pad == 5, "the padder is not on")
            check(launches == {"upsample_conv_fwd": 4 * steps + 4,
                               "upsample_conv_dx": 2 * steps, "upsample_conv_dw": 2 * steps,
                               **_updates(2 * steps), "bn_prelu": _bn_prelu(steps, 2)},
                  f"padded launches {launches}")
            check(tr.graphed.launches_per_replay == GAN_REPLAY,
                  f"padded launches per replay {tr.graphed.launches_per_replay}")
            _check_files(os.path.join(save, "adversarial", "arrays.npz"))
            stored = tr.state.g.get_parameter("09_conv_out.weight").shape
            check(tuple(stored) == (3, 128, 3, 3), f"G's stored output conv is {tuple(stored)}")
    runs = {}
    for pad, tr in trainers.items():
        gen = torch.Generator(device=tr.device).manual_seed(11)
        pool = tr.source.epoch_pool(gen, tr.pool_n)
        runs[pad] = (lambda t, p, g: (lambda n: t.run_steps(p, g, n)))(tr, pool, gen)
    times = {8: [], 0: []}
    for pad in (8, 0, 0, 8):  # in turns
        times[pad].append(_step_ms(runs[pad]))
    for pad, ts in times.items():
        print(f"boundary pad path (--boundaryPad {pad}, graphed): {statistics.mean(ts):.4f} ms per "
              f"step on the stream (CUDA events over 30 steps, mean of 2 turns: "
              f"{', '.join(f'{t:.4f}' for t in ts)}; batch 32, bf16)")
    for pad in (8, 0):
        _profile_train_steps(runs[pad], label=f"boundary pad path (--boundaryPad {pad}, graphed)",
                             top=4)

    dev = torch.device("cuda", 0)
    pool = prepare_pool(draw_synthetic_faces(torch.Generator().manual_seed(6), 256), 32, 3).to(dev)
    states = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with full_fp32():
            for pad in (8, 0):
                cfg = TrainConfig(compute_dtype="float32", reference_init=False, g_l2=1e-3,
                                  boundary_pad=pad).validate()
                state = _train_state(cfg, dev, g_biases=True)
                runner = GraphedStep(TrainStep(cfg, state.g, state.d), state, pool.shape[0])
                runner.set_pool(pool)
                runner.run(torch.Generator(dev).manual_seed(7), 3)
                states[pad] = state
            torch.cuda.synchronize()
            errs, (worst, leaf) = _state_diffs(states[8], states[0])
            same = all(torch.equal(getattr(states[8], k), getattr(states[0], k))
                       for k in ("accs_n", "confusion", "trained_d", "not_trained_d"))
            ok = same and all(v <= BOUNDARY_PAD_TOL for v in errs.values())
            print(f"boundary pad parity fp32 (TF32 off, cuDNN deterministic), 3 graphed steps "
                  f"--boundaryPad 8 vs 0 from one state on the same draws, relative l2: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + f"; worst leaf {leaf} {worst:.3e} (tolerance {BOUNDARY_PAD_TOL}); counters "
                  f"{'equal' if same else 'DIFFER'}; {'ok' if ok else 'FAIL'}")
            check(ok, "the padded GAN step disagrees with the unpadded one")

            faces = draw_synthetic_faces(torch.Generator().manual_seed(6), 256)
            cpool = make_triples(prepare_pool(faces, 32, 3).to(dev), 16)
            arrays = {}
            for pad in (8, 0):  # SGD with momentum, as phase 26 and for its reason
                ccfg = C2FConfig(compute_dtype="float32", d_optmethod="sgd", g_optmethod="sgd",
                                 d_sgd_momentum=0.9, g_sgd_momentum=0.9,
                                 boundary_pad=pad).validate()
                g, d = c2f.init_c2f(torch.Generator().manual_seed(3), 32, 3, device=dev)
                cstate, cstep = init_c2f_state(ccfg, g, d), C2FStep(ccfg, g, d)
                gen = torch.Generator(dev).manual_seed(9)
                for _ in range(3):
                    cstep(cstate, cpool, draw_c2f_step(gen, ccfg, 256, cstep.mask_specs))
                arrays[pad] = [*g.parameters(), *d.parameters(), *cstate.opt_g["trace"],
                               *cstate.opt_d["trace"]]
            torch.cuda.synchronize()
            cerr = _rel_l2(arrays[8], [t.cpu() for t in arrays[0]])
            print(f"boundary pad parity c2f fp32 (TF32 off, cuDNN deterministic), 3 steps "
                  f"--boundaryPad 8 vs 0 (SGD, momentum 0.9), relative l2 of the parameters and "
                  f"the momentum traces {cerr:.3e} (tolerance {BOUNDARY_PAD_TOL}); "
                  f"{'ok' if cerr <= BOUNDARY_PAD_TOL else 'FAIL'}")
            check(cerr <= BOUNDARY_PAD_TOL, "the padded c2f step disagrees with the unpadded one")
    finally:
        torch.backends.cudnn.deterministic = saved

    save = os.path.join(tmp, "boundary_pad_c2f")
    t0 = time.perf_counter()
    tr = train_c2f.main(["--datasetDir", store, "--save", save, "--epochs", "1",
                         "--boundaryPad", "8"])
    torch.cuda.synchronize()
    check(tr.step.pad.active, "the c2f padder is not on")
    _check_files(os.path.join(save, "adversarial_c2f_16_to_32", "arrays.npz"))
    print(f"boundary pad path: train_c2f.main --boundaryPad 8 --epochs 1 took "
          f"{time.perf_counter() - t0:.3f} s; padder on G's {tr.step.pad.g_convs} and D's "
          f"{tr.step.pad.d_convs}")
    return launches


def phase_guard_nonfinite():
    """guard_nonfinite in the graphed GAN step (fp32, TF32 off): every D
    weight NaN, 3 steps (one eager, the capture, replays): no update lands
    (D's gate closes and G's update is skipped, on the device), and
    not_trained_d counts the 3 steps."""
    import torch

    from facegen_torch.config import TrainConfig
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.data.synthetic import draw_synthetic_faces
    from facegen_torch.sample import full_fp32
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.train.step import TrainStep

    dev = torch.device("cuda", 0)
    pool = prepare_pool(draw_synthetic_faces(torch.Generator().manual_seed(6), 256), 32, 3).to(dev)
    cfg = TrainConfig(compute_dtype="float32", reference_init=False,
                      guard_nonfinite=True).validate()
    with full_fp32():
        state = _train_state(cfg, dev)
        with torch.no_grad():
            for p in state.d.parameters():
                p.fill_(float("nan"))
        before = [t.detach().clone() for t in (*state.g.parameters(), *state.opt_g["mu"])]
        runner = GraphedStep(TrainStep(cfg, state.g, state.d), state, pool.shape[0])
        runner.set_pool(pool)
        ms = runner.run(torch.Generator(dev).manual_seed(7), 3)
        torch.cuda.synchronize()
    after = [*state.g.parameters(), *state.opt_g["mu"]]
    unchanged = all(torch.equal(a, b) for a, b in zip(after, before))
    counts = (int(state.trained_d), int(state.not_trained_d),
              int(state.opt_g["count"]), int(state.opt_d["count"]))
    ok = runner.graph is not None and unchanged and counts == (0, 3, 0, 0)
    print(f"guard_nonfinite path: 3 graphed fp32 steps with every D weight NaN: trained D "
          f"{counts[0]}, not trained {counts[1]}; Adam's counts (G, D) {counts[2:]}; G's "
          f"parameters and moments unchanged: {unchanged}; gate {ms.gate_open.tolist()}; "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "guard_nonfinite let a non-finite update land")


def phase_gspmd_sampler(tmp: str, store: str):
    """``run_sampling`` at --meshShape 2,2 over ["cuda:0"] * 4 (2 replica
    groups of 2, the large leaves as shards) against one device from the
    same seed (--runs 2 --neighbours), and GanInference on that grid
    against one device in fp32 (TF32 off) and bf16. Returns its launches."""
    import contextlib

    import torch

    from facegen_torch import sample
    from facegen_torch.config import SampleConfig
    from facegen_torch.models import gan
    from facegen_torch.sample import full_fp32
    from facegen_torch.utils.infer import GanInference

    dev = torch.device("cuda", 0)
    save_dir = os.path.join(tmp, "logs")  # phase 5's checkpoint
    walls, launches, scores = {}, {}, {}
    for label, shape, devices in (("one device", (), None), ("2x2", (2, 2), [dev] * 4)):
        cfg = SampleConfig(save=save_dir, runs=2, neighbours=True, dataset_dir=store,
                           mesh_shape=shape, writeto=os.path.join(tmp, f"gspmd_samples_{label}"))
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        paths = sample.run_sampling(cfg, device=dev, devices=devices, verbose=False)
        torch.cuda.synchronize()
        walls[label], launches[label] = time.perf_counter() - t0, _launches()
        check(len(paths) == 12, f"{label}: {len(paths)} files")
        _check_files(*paths)
    print(f"gspmd sampler path: run_sampling --meshShape 2,2 --runs 2 --neighbours over "
          f"['cuda:0'] * 4 took {walls['2x2']:.3f} s against {walls['one device']:.3f} s on one "
          f"device (host clock, with checkpoint load, store preparation, NN search and PNGs); "
          f"launches {launches['2x2']} against {launches['one device']}")
    check(launches["2x2"]["upsample_conv_fwd"] == 2 * 2 * 2,
          f"2 groups x 2 layers x 2 runs forward launches, got {launches['2x2']}")
    check(launches["2x2"]["bn_prelu"] == _bn_prelu(g_calls=2 * 2),
          f"2 groups x 2 runs x 2 batch norm + PReLU launches, got {launches['2x2']}")
    g, d, _ = gan.restore_gan("adversarial", default_dir=save_dir, device=dev)
    noise = GanInference(g, d, 100).noise(sample.run_generator(1, 1), sample.N_SAMPLES)
    lines, ok = [], True
    for dtype, ctx in ((torch.float32, full_fp32), (torch.bfloat16, contextlib.nullcontext)):
        with ctx():
            one = GanInference(g, d, 100, dtype)
            grid = GanInference(g, d, 100, dtype, devices=[dev] * 4, mp=2)
            imgs, imgs2 = one.generate(noise), grid.generate(noise)
            s1, s2 = one.score(imgs), grid.score(imgs)
            torch.cuda.synchronize()
        e_img, e_score = float((imgs2 - imgs).abs().max()), float((s2 - s1).abs().max())
        if dtype == torch.float32:
            good = e_img <= DP_SERVE_FP32_TOL and e_score <= DP_SERVE_FP32_TOL
        else:
            good = (bool(((imgs2 - imgs).abs() <= BF16_ATOL + BF16_RTOL * imgs.abs()).all())
                    and bool(((s2 - s1).abs() <= BF16_ATOL + BF16_RTOL * s1.abs()).all()))
        ok &= good
        lines.append(f"{'fp32 (TF32 off)' if dtype == torch.float32 else 'bf16 (served)'}: "
                     f"images {e_img:.3e}, scores {e_score:.3e}")
    held = [tuple(s.shape) for _, _, shards in grid.g_replicas[0].leaves for s in shards[:1]]
    print(f"gspmd sampler path: the 2x2 grid vs one device on run 1's noise (1024): "
          f"{'; '.join(lines)} (tolerances {DP_SERVE_FP32_TOL} fp32, {BF16_ATOL} + "
          f"{BF16_RTOL:.4f} x |ref| bf16); G's sharded leaves per card {held}; "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the 2x2 sampler disagrees with one device")
    return launches["2x2"]


# facegen's report keys (facegen/eval/parity.py:325-345, 388-451, 479-484),
# None for a leaf
PARITY_KEYS = {
    "n_samples": None, "labels": None,
    "rank_correlation": dict.fromkeys(("spearman_rho", "pool", "pool_size")),
    "nn_distance": dict.fromkeys(("mean_a", "mean_b", "std_a", "std_b", "ks_stat",
                                  "ks_pvalue")),
    "frechet_d_features": dict.fromkeys(("a_vs_real", "b_vs_real", "a_vs_b")),
    "parity": dict.fromkeys(("rank_parity", "nn_parity")),
}
_VS = ("ours_vs_reference", "ours_vs_real", "reference_vs_real")
SAMPLE_KEYS = {
    "n_samples": dict.fromkeys(("ours", "reference")), "labels": None,
    "d_score": dict.fromkeys(("mean_ours", "mean_reference", "ks_stat", "ks_pvalue")),
    "frechet_d_features": dict.fromkeys(_VS), "frechet_pixels": dict.fromkeys(_VS),
    "pixel_moments": dict.fromkeys(("mean_ours", "mean_reference", "std_ours",
                                    "std_reference")),
    "nn_distance": dict.fromkeys(("mean_ours", "mean_reference", "ks_stat", "ks_pvalue")),
    "calibration": {"note": None, "nn_half_vs_half": dict.fromkeys(("mean", "p10", "p90")),
                    "nn_leave_one_out": dict.fromkeys(("mean", "p10", "p90"))},
}
SELF_KEYS = {"n_samples": None, "nn_distance": dict.fromkeys(("mean", "std", "min", "max")),
             "frechet_vs_real": None}


def _key_tree(report):
    return {k: _key_tree(v) if isinstance(v, dict) else None for k, v in report.items()}


def _numbers(report):
    """Every number of a report (bools and strings left out)."""
    for v in report.values():
        if isinstance(v, dict):
            yield from _numbers(v)
        elif isinstance(v, list):
            yield from (x for x in v if isinstance(x, float))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield v


def _g_call_ms(inf, noise, reps=5):
    """Device ms of one G call on ``noise`` (CUDA events, median of
    ``reps`` after 2 warm-up calls)."""
    import torch

    times = []
    for i in range(reps + 2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        inf.generate(noise)
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_quality_report(tmp: str, store: str):
    """``python -m facegen_torch.eval.parity`` in its three modes at full
    width (G32 + D32b, --n 1024 --n_train 4096) on the store: A is phase
    5's seeded checkpoint, B phase 6's trained one, the grid 1024 of A's
    samples on other noise; then the fp32 report on the card against the
    CPU's on injected draws (n = 256), A against a second seeded GAN.
    Returns the kernels' launch counts in the three runs."""
    import contextlib
    import io

    import numpy as np
    import torch
    from PIL import Image

    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.eval import parity
    from facegen_torch.models import gan
    from facegen_torch.models.gan import restore_gan
    from facegen_torch.sample import full_fp32
    from facegen_torch.utils.infer import GanInference

    dev = torch.device("cuda", 0)
    # A embeds the populations with its D. Phase 6's checkpoint, 3 epochs
    # from the reference's init, generates one flat image and its D's
    # penultimate features are constant (every Fréchet distance 0 as A), so
    # it is B, and phase 5's seeded G32 + D32b with calibrated batch norms is A
    net_a = os.path.join(tmp, "logs", "adversarial")
    net_b = os.path.join(tmp, "train_logs", "adversarial")
    infs = {k: GanInference(*restore_gan(net, device=dev)[:2], 100)
            for k, net in (("A", net_a), ("B", net_b))}
    noise = infs["A"].noise(torch.Generator().manual_seed(4), 1024)
    tiles = (infs["A"].generate(noise).cpu().numpy() * 255.0 + 0.5).clip(0, 255).astype(np.uint8)
    grid = os.path.join(tmp, "grid1024.png")
    Image.fromarray(tiles.reshape(32, 32, 32, 32, 3).transpose(0, 2, 1, 3, 4).reshape(
        1024, 1024, 3)).save(grid)

    common = ["--network_a", net_a, "--n", "1024", "--n_train", "4096", "--data", store]
    runs = {"parity (A vs B)": (common + ["--network_b", net_b], PARITY_KEYS, 4),
            "sample (A vs a grid of 1024 of A's samples)": (common + ["--samples_b", grid],
                                                     SAMPLE_KEYS, 2),
            "self (A)": (common, SELF_KEYS, 2)}
    total = dict.fromkeys(COUNTED + ("bn_prelu",), 0)
    for label, (argv, keys, fwd) in runs.items():
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            report = parity.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _launches()
        total = {k: total[k] + launches[k] for k in total}
        check(json.loads(out.getvalue()) == report, f"{label}: printed report differs")
        check(_key_tree(report) == keys, f"{label}: keys {_key_tree(report)}")
        check(all(np.isfinite(v) for v in _numbers(report)), f"{label}: non-finite {report}")
        want = {"upsample_conv_fwd": fwd, "upsample_conv_dx": 0, "upsample_conv_dw": 0,
                **_updates(0), "bn_prelu": _bn_prelu(g_calls=fwd // 2)}
        check(launches == want, f"{label}: launches {launches}, want {want}")
        print(f"quality report {label}: parity.main took {run_s:.3f} s (wall, with checkpoint "
              f"loads, store preparation and host statistics); launches {launches}")
        print(f"quality report {label}: {json.dumps(report)}")
    for k, inf in infs.items():
        print(f"quality report: G call {k} at N = 1024, bf16: "
              f"{_g_call_ms(inf, noise.to(dev)):.4f} ms on the device (CUDA events, median of 5)")

    # the fp32 report, card against CPU, on the same injected draws
    n = 256
    gen = torch.Generator().manual_seed(8)
    draws = dict(noise_a=torch.rand(n, 100, generator=gen) * 2 - 1,
                 noise_b=torch.rand(n, 100, generator=gen) * 2 - 1,
                 real_perm=torch.randperm(1024, generator=gen))
    train = prepare_pool(torch.from_numpy(np.load(store)[:1024]).to(dev), 32, 3).cpu().numpy()
    g_c, d_c = gan.init_gan(torch.Generator().manual_seed(1), 32, 3, 100, reference_init=False)
    calibrate_batch_norm(g_c, draws["noise_b"])
    reports = {}
    for where in (dev, "cpu"):
        g_a, d_a, _ = restore_gan(net_a, device=where)
        g_b, d_b = (copy.deepcopy(m).to(where) for m in (g_c, d_c))
        t0 = time.perf_counter()
        with full_fp32():
            reports[str(where)] = parity.parity_report(
                g_a, d_a, g_b, d_b, train, n_samples=n, compute_dtype=torch.float32, **draws)
        print(f"quality report fp32 parity_report (n = {n}) on {where}: "
              f"{time.perf_counter() - t0:.3f} s")
    diffs = parity.report_diffs(reports[str(dev)], reports["cpu"], n)
    print(f"quality report fp32, card vs CPU: card {json.dumps(reports[str(dev)])}; "
          f"CPU {json.dumps(reports['cpu'])}; {'ok' if not diffs else f'FAIL {diffs}'}")
    check(not diffs, f"the card's fp32 report departs from the CPU's: {diffs}")
    return total


def phase_export(tmp: str):
    """``python -m facegen_torch.export`` of phase 21's A (phase 5's seeded
    checkpoint, whose G is not flat); ``NumpyGenerator`` against the card's
    fp32 G on 64 noise vectors."""
    import numpy as np
    import torch

    from facegen_torch import export
    from facegen_torch.models.gan import restore_gan
    from facegen_torch.sample import full_fp32
    from facegen_torch.utils.infer import GanInference

    out = os.path.join(tmp, "generator.npz")
    export.main(["--save", os.path.join(tmp, "logs"), "--network", "adversarial", "--out", out])
    gen = export.NumpyGenerator(out)
    g, d, _ = restore_gan(os.path.join(tmp, "logs", "adversarial"), device=torch.device("cuda", 0))
    z = np.random.RandomState(0).uniform(-1, 1, (64, 100)).astype(np.float32)
    t0 = time.perf_counter()
    ours = gen(z)
    np_s = time.perf_counter() - t0
    with full_fp32():
        ref = GanInference(g, d, 100, compute_dtype=torch.float32).generate(
            torch.from_numpy(z)).cpu().numpy()
    err = float(np.abs(ours - ref).max())
    print(f"export: NumpyGenerator ({os.path.getsize(out) / 2**20:.1f} MiB file, 64 samples in "
          f"{np_s:.3f} s on the host) vs the card's fp32 G: max_abs_err={err:.3e} (tolerance "
          f"{EXPORT_TOL}); image std {float(ref.std()):.4f}")
    check(ours.shape == (64, 32, 32, 3) and err <= EXPORT_TOL, f"export disagrees: {err}")


def phase_trace_and_debug(tmp: str, store: str, graphed_ms: float):
    """The trainer at the default flags with trace_dir for 2 epochs: the
    per-op table of the traced epoch (its 63 steps alone) against phase 6's
    profile of the graphed step; then debug_nans: 2 eager steps with finite
    losses, and a NaN G weight, which must raise. Returns the kernels'
    launch counts in the traced run."""
    import math

    import torch

    from facegen_torch.config import TrainConfig
    from facegen_torch.train.loop import Trainer
    from facegen_torch.train.step import steps_per_epoch
    from facegen_torch.utils.profiling import aggregate_trace, enable_nan_debugging, \
        format_op_table

    trace_dir = os.path.join(tmp, "trace")
    cfg = TrainConfig(dataset_dir=store, save=os.path.join(tmp, "trace_logs"),
                      trace_dir=trace_dir).validate()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    trainer = Trainer(cfg)
    rows = list(trainer.run(2))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _launches()
    steps = steps_per_epoch(cfg)
    want = {"upsample_conv_fwd": 4 * 2 * steps + 4 * 2, "upsample_conv_dx": 2 * 2 * steps,
            "upsample_conv_dw": 2 * 2 * steps, **_updates(2 * 2 * steps),
            "bn_prelu": _bn_prelu(2 * steps, 4)}
    print(f"trace path: Trainer(trace_dir=...).run(2) took {run_s:.3f} s; launches {launches}")
    check(launches == want, f"launches {launches}, want {want}")
    check(trainer.epochs_per_compile == 1 and trainer.graphed.graph is not None,
          "the traced run did not replay a graph one epoch at a time")
    check(all(math.isfinite(r["loss_d_mean"]) for r in rows), f"non-finite losses {rows}")
    summary = aggregate_trace(trace_dir, top=1 << 30)
    calls = {k: sum(r["calls"] for r in summary["ops"] if k.lower() in r["name"].lower())
             for k in ("UpconvFwd", "UpconvDx", "UpconvDw")}
    want_calls = {"UpconvFwd": 4 * steps, "UpconvDx": 2 * steps, "UpconvDw": 2 * steps}
    print(f"trace path: the traced epoch's table lists {calls} (want {want_calls}); its first "
          f"12 rows:")
    print(format_op_table({**summary, "ops": summary["ops"][:12]}))
    check(calls == want_calls, f"traced kernel calls {calls}, want {want_calls}")
    per_step = summary["total_us"] / steps / 1e3
    print(f"trace path: {per_step:.4f} ms of device time per step in the traced epoch "
          f"({summary['total_us'] / 1e3:.3f} ms over {steps} steps, "
          f"{sum(r['calls'] for r in summary['ops']) / steps:.0f} device events a step) against "
          f"{graphed_ms:.4f} ms in phase 6's profile of the graphed step (limit 25 %)")
    check(abs(per_step / graphed_ms - 1) <= 0.25, "the traced epoch's device time per step is "
          "more than 25 % from phase 6's profile")

    dbg = TrainConfig(dataset_dir=store, save=os.path.join(tmp, "debug_logs"), debug_nans=True,
                      n_epoch=32, noplot=True).validate()
    try:
        t0 = time.perf_counter()
        trainer = Trainer(dbg)
        rows = list(trainer.run(1))
        torch.cuda.synchronize()
        print(f"debug_nans: {steps_per_epoch(dbg)} eager steps in {time.perf_counter() - t0:.3f} "
              f"s (route: {trainer.graphed.route}); loss_d {rows[0]['loss_d_mean']:.4f}, loss_g "
              f"{rows[0]['loss_g_mean']:.4f}")
        check(trainer.graphed.graph is None and steps_per_epoch(dbg) == 2
              and math.isfinite(rows[0]["loss_d_mean"] + rows[0]["loss_g_mean"]),
              "the debug_nans run did not run 2 finite eager steps")
        trainer = Trainer(dataclasses.replace(dbg, save=os.path.join(tmp, "debug_nan_logs")))
        with torch.no_grad():
            trainer.state.g.get_submodule("00_fc").weight[0, 0] = float("nan")
        try:
            list(trainer.run(1))
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        print(f"debug_nans with a NaN G weight: {'raised: ' + raised if raised else 'FAIL'}")
        check(raised is not None and "00_fc" in raised, "a NaN weight did not raise")
    finally:
        enable_nan_debugging(False)
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
            summary.update(phase_update_kernels())
            summary.update(phase_bn_prelu_kernels())
        summary["upsample_conv_dx"], summary["upsample_conv_dw"] = bwd["dx"], bwd["dw"]
        with tempfile.TemporaryDirectory() as tmp:
            store = write_store(tmp)
            by_path = {"sampler": phase_main_path(tmp, store)}
            launches, graphed_ms = phase_training(tmp, store)
            by_path["training"] = launches
            c2f_save, by_path["c2f_training"] = phase_c2f_training(tmp, store)
            by_path["c2f_sampler"] = phase_c2f_sampler(tmp, c2f_save)
            by_path["ae_training"] = phase_ae_training(tmp, store)
            den_save, by_path["denoiser_training"] = phase_denoiser_training(tmp, store)
            by_path["training_denoise"] = phase_training_denoise(store, den_save)
            by_path["training_epochs_per_compile"] = phase_epochs_per_compile(tmp, store)
            by_path["training_weights_vis"] = phase_weights_vis(tmp, store)
            by_path["training_lfw_store"] = phase_lfw_builder(tmp)
            by_path["training_dp_nccl_1_rank"] = phase_dp_nccl(tmp, store)
            by_path["training_dp_gloo_2_ranks_one_card"] = phase_dp_gloo(tmp)
            by_path["sampler_dp_2_replicas"] = phase_dp_sampler(tmp, store)
            by_path["training_gspmd_nccl_1x1"] = phase_gspmd_nccl(tmp, store)
            by_path["training_gspmd_gloo_2x2_one_card"] = phase_gspmd_gloo(tmp, store)
            by_path["c2f_ae_denoiser_gspmd_2x1_one_card"] = phase_gspmd_family(tmp, store)
            by_path["sampler_gspmd_2x2"] = phase_gspmd_sampler(tmp, store)
            by_path["training_gspmd_gloo_3x1_one_card"] = phase_uneven_mesh(tmp, store)
            by_path["training_boundary_pad"] = phase_boundary_pad(tmp, store)
            by_path["quality_report"] = phase_quality_report(tmp, store)
            phase_export(tmp)
            by_path["training_traced"] = phase_trace_and_debug(tmp, store, graphed_ms)
        with full_fp32():
            phase_step_parity()
            phase_c2f_step_parity()
            phase_ae_step_parity()
        phase_graph_parity()
        with tempfile.TemporaryDirectory() as tmp:
            phase_family_graph_parity(tmp)
        phase_guard_nonfinite()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(f"launches by path: {json.dumps(by_path)}")
    # launches: the training path's 2-epoch run, which runs all nine
    # kernels; max_abs_err (bf16) and ms (both layers at N = 32; the
    # update's kernels: D32b's and G32's launch at the default flags; the
    # batch norm + PReLU kernels: their launches in a step) at its shapes;
    # launches_by_path: each path's run, counted from 0 (the batch norm +
    # PReLU kernels: their one counter, the four together; null where a
    # path counts launches by shape through the other kernels' wrappers)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[_counter(name)], **summary[name],
         **({"launch_counter": "bn_prelu (all four kernels)"} if name in BN_PRELU else {}),
         "launches_by_path": {path: counts.get(_counter(name))
                              for path, counts in by_path.items()}}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [DP_WORKER_FLAG]:  # a rank of phase 19
        dp_gloo_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        sys.exit(0)
    if sys.argv[1:2] == [UNEVEN_WORKER_FLAG]:  # a rank of phase 28
        uneven_gloo_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                         sys.argv[6])
        sys.exit(0)
    if sys.argv[1:2] == [GSPMD_WORKER_FLAG]:  # a rank of phase 25 or 26
        gspmd_gloo_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]),
                        sys.argv[6], sys.argv[7])
        sys.exit(0)
    sys.exit(main())
