"""Plain reference of the g32_d32b configuration: G32 and D32b (the
reference's models.lua:27-81 and :382-416) at 32x32 colour, their
training step at train.py's defaults and the sampler's request.

Activations are NCHW inside a net; a net's input and output are NHWC, as
the program's are. Parameters are lists of fp32 tensors in the order of
the leaf tables below (the program's module order). The arithmetic is
fp32 with TF32 off (``common.full_fp32``), or, with ``Precision("fp8")``,
the control's.

G32: Linear(100 -> 8*8*128) -> NHWC view (8, 8, 128) -> PReLU -> 2 x
[nearest upsample x2 -> 5x5 conv -> BatchNorm -> PReLU] (256, then 128
channels) -> 3x3 conv to 3 -> sigmoid.
D32b: 4 x [3x3 conv -> PReLU -> spatial dropout 0.2 -> 2x2 average
pool] (64, 128, 256, 512) -> NHWC flatten -> Linear 512 -> PReLU ->
dropout 0.5 -> Linear 512 -> PReLU -> dropout 0.5 -> Linear 1 (a logit).

A training step (adversarial.lua:240-288, facegen's step): one D
iteration on half a batch of pool images and half of fakes G makes in
train mode without gradients, BCE, D's L1/L2 penalty and the gradients'
clamp, Adam; then one G iteration on a batch of noise through G and the
updated D, all targets real, G's penalty (zero at the defaults) and
clamp, Adam. Its draws come from one generator in the program's order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import common as C

NOISE_DIM, SCALE, CHANNELS, S0 = 100, 32, 3, 8
D_WIDTHS = (64, 128, 256, 512)


def _conv(name, cin, cout, k):
    return [(f"{name}.weight", (cout, cin, k, k)), (f"{name}.bias", (cout,))]


def g_shapes():
    fc = 128 * S0 * S0
    return [("fc.weight", (fc, NOISE_DIM)), ("fc.bias", (fc,)), ("prelu0.weight", (1,)),
            *_conv("upconv1", 128, 256, 5), ("bn1.weight", (256,)), ("bn1.bias", (256,)),
            ("prelu1.weight", (1,)),
            *_conv("upconv2", 256, 128, 5), ("bn2.weight", (128,)), ("bn2.bias", (128,)),
            ("prelu2.weight", (1,)), *_conv("conv_out", 128, CHANNELS, 3)]


def d_shapes():
    out, cin = [], CHANNELS
    for w in D_WIDTHS:
        out += [*_conv(f"conv{w}", cin, w, 3), (f"prelu{w}.weight", (1,))]
        cin = w
    return out + [("fc1.weight", (512, 2 * 2 * 512)), ("fc1.bias", (512,)),
                  ("prelu_fc1.weight", (1,)), ("fc2.weight", (512, 512)), ("fc2.bias", (512,)),
                  ("prelu_fc2.weight", (1,)), ("fc_out.weight", (1, 512)), ("fc_out.bias", (1,))]


def leaves(net: str, init: str):
    """The weight table of ``net`` ("g" or "d") under ``init``:

    - "reference": train.lua:137-138's overwrite of every parameter, N(0,
      0.005^2), biases N(0, 0.001^2), PReLU slopes and batch-norm scales
      included (what training starts from);
    - "he": weights N(0, 2 / fan_in), biases 0, PReLU slopes 0.25,
      batch-norm scales 1 and shifts 0: the sampler's stand-in for a
      trained pair, under which G's faces and D's scores spread (under
      the reference's overwrite G makes a flat grey and D one score).
    """
    if init not in ("reference", "he"):
        raise ValueError(f"init {init!r}: reference or he")
    out = []
    for name, shape in (g_shapes() if net == "g" else d_shapes()):
        kind = name.split(".")[0]
        if init == "reference":
            rule = ("normal", 0.001 if name.endswith(".bias") else 0.005)
        elif kind.startswith("prelu"):
            rule = ("const", 0.25)
        elif kind.startswith("bn"):
            rule = ("const", 1.0 if name.endswith(".weight") else 0.0)
        elif name.endswith(".bias"):
            rule = ("const", 0.0)
        else:
            rule = ("normal", math.sqrt(2.0 / math.prod(shape[1:])))
        out.append((name, shape, rule))
    return out


# forward FLOPs of one image, by layer: (kind, input channels, output
# channels, kernel taps, output positions); the upsample-conv counted as
# the phase-collapsed 3x3 conv to 4 * Cout at the input resolution
G_LAYERS = [("linear", NOISE_DIM, 128 * S0 * S0, 1, 1),
            ("upconv", 128, 4 * 256, 9, 8 * 8), ("upconv", 256, 4 * 128, 9, 16 * 16),
            ("conv", 128, CHANNELS, 9, 32 * 32)]
D_LAYERS = [("conv", CHANNELS, 64, 9, 32 * 32), ("conv", 64, 128, 9, 16 * 16),
            ("conv", 128, 256, 9, 8 * 8), ("conv", 256, 512, 9, 4 * 4),
            ("linear", 2048, 512, 1, 1), ("linear", 512, 512, 1, 1), ("linear", 512, 1, 1, 1)]
# the upsample-convs of one G call: (input size, Cin, Cout)
UPCONVS = [(8, 128, 256), (16, 256, 128)]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _batch_norm(x, gamma, beta, train: bool, eps: float = 1e-5):
    if train:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
    else:  # fresh running statistics
        mean, var = torch.zeros_like(gamma), torch.ones_like(gamma)
    inv = torch.rsqrt(var + eps) * gamma
    return (x - mean[None, :, None, None]) * inv[None, :, None, None] + beta[None, :, None, None]


def generate(p: Sequence[torch.Tensor], z: torch.Tensor, train: bool,
             prec: C.Precision = C.FP32) -> torch.Tensor:
    """(N, 100) noise -> (N, 32, 32, 3) images in [0, 1], fp32."""
    (fc_w, fc_b, a0, u1_w, u1_b, bn1_w, bn1_b, a1, u2_w, u2_b, bn2_w, bn2_b, a2,
     out_w, out_b) = p
    x = prec.linear(z, fc_w, fc_b).reshape(-1, S0, S0, 128)
    x = C.prelu(_nchw(x), a0)
    for w, b, gamma, beta, a in ((u1_w, u1_b, bn1_w, bn1_b, a1), (u2_w, u2_b, bn2_w, bn2_b, a2)):
        x = prec.conv(F.interpolate(x, scale_factor=2, mode="nearest"), w, b, padding=2)
        x = C.prelu(_batch_norm(x, gamma, beta, train), a)
    x = torch.sigmoid(prec.conv(x, out_w, out_b, padding=1))
    return x.permute(0, 2, 3, 1)


def d_mask_specs(batch: int):
    """(NHWC mask shape, rate) of D's dropout layers at ``batch``."""
    spatial = [((batch, 1, 1, w), 0.2) for w in D_WIDTHS]
    return spatial + [((batch, 512), 0.5), ((batch, 512), 0.5)]


def discriminate(p: Sequence[torch.Tensor], images: torch.Tensor,
                 masks=None, prec: C.Precision = C.FP32) -> torch.Tensor:
    """(N, 32, 32, 3) -> (N, 1) logits; ``masks`` (D's keep-masks, in
    order) for a training forward, None for eval."""
    x = _nchw(images.float())
    for i in range(4):
        w, b, a = p[3 * i:3 * i + 3]
        x = C.prelu(prec.conv(x, w, b, padding=1), a)
        if masks is not None:
            x = C.apply_dropout(x, masks[i].permute(0, 3, 1, 2), 0.2)
        x = F.avg_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    fc1_w, fc1_b, a1, fc2_w, fc2_b, a2, out_w, out_b = p[12:]
    for j, (w, b, a) in enumerate(((fc1_w, fc1_b, a1), (fc2_w, fc2_b, a2))):
        x = C.prelu(prec.linear(x, w, b), a)
        if masks is not None:
            x = C.apply_dropout(x, masks[4 + j], 0.5)
    return prec.linear(x, out_w, out_b)


def train_steps(g0: List[torch.Tensor], d0: List[torch.Tensor], pool: torch.Tensor,
                generator: torch.Generator, n_steps: int, hp: Dict,
                prec: C.Precision = C.FP32) -> Dict:
    """``n_steps`` training steps from the weights ``g0``, ``d0`` on the
    uint8 ``pool`` (P, 32, 32, 3), drawing from ``generator``. ``hp``: the
    configuration's batch_size, d_l1, d_l2, d_clamp, g_l1, g_l2, g_clamp,
    lr. Returns the losses of each step ((loss_d, loss_g), penalties
    included), each net's first gradients as its optimizer took them
    (``grads_g``, ``grads_d``) and the weights after the steps."""
    batch, half = hp["batch_size"], hp["batch_size"] // 2
    gp = [t.detach().clone().requires_grad_() for t in g0]
    dp = [t.detach().clone().requires_grad_() for t in d0]
    sg, sd = {}, {}
    specs = d_mask_specs(batch)
    ones = torch.ones(half, device=pool.device)
    targets = torch.cat([ones, torch.zeros_like(ones)])
    out = {"losses": [], "grads_g": None, "grads_d": None}
    for _ in range(n_steps):
        idx = torch.randint(0, pool.shape[0], (half,), generator=generator,
                            device=generator.device)
        z_d = C.noise(generator, (half, NOISE_DIM))
        masks_d = C.dropout_masks(generator, specs)
        z_g = C.noise(generator, (batch, NOISE_DIM))
        masks_g = C.dropout_masks(generator, specs)

        real = pool[idx].float() / 255.0
        with torch.no_grad():
            fake = generate(gp, z_d, True, prec)
        logits = discriminate(dp, torch.cat([real, fake]), masks_d, prec)
        grads = torch.autograd.grad(C.bce(logits, targets), dp)
        with torch.no_grad():
            loss_d = C.bce(logits, targets) + C.penalty(dp, hp["d_l1"], hp["d_l2"])
            grads = C.penalised_grads(dp, grads, hp["d_l1"], hp["d_l2"], hp["d_clamp"])
            if out["grads_d"] is None:
                out["grads_d"] = [g.clone() for g in grads]
            C.adam_step(dp, grads, sd, hp["lr"])

        logits = discriminate(dp, generate(gp, z_g, True, prec), masks_g, prec)
        loss = C.bce(logits, torch.ones(batch, device=pool.device))
        grads = torch.autograd.grad(loss, gp)
        with torch.no_grad():
            loss_g = loss + C.penalty(gp, hp["g_l1"], hp["g_l2"])
            # the reference's G_L2 bug: G_L2 scales the sign term too
            grads = C.penalised_grads(gp, grads, hp["g_l2"], hp["g_l2"], hp["g_clamp"])
            if out["grads_g"] is None:
                out["grads_g"] = [g.clone() for g in grads]
            C.adam_step(gp, grads, sg, hp["lr"])
        out["losses"].append((float(loss_d), float(loss_g)))
    out["g"] = [t.detach() for t in gp]
    out["d"] = [t.detach() for t in dp]
    return out


# epoch 0's streams, seeded as the trainer seeds an epoch's: its pool, its steps
POOL_WORDS, STEP_WORDS = (10_000, 0), (10_000, 1)


def expected(store: torch.Tensor, g0, d0, seed: int, flags: Dict, lr: float, steps: int = 3,
             prec: C.Precision = C.FP32, pool_hold=C.same) -> Dict:
    """What the program's first ``steps`` steps from ``g0``, ``d0`` on epoch
    0's pool give: ``train_steps``'s outputs and ``pools`` (the pool), the
    model's arithmetic in ``prec`` and the pool's held by ``pool_hold``."""
    dev = store.device
    pool = C.epoch_pool(store, C.seeded_generator(dev, seed, *POOL_WORDS), flags["n_epoch"],
                        flags["scale"], hold=pool_hold)
    out = train_steps(g0, d0, pool, C.seeded_generator(dev, seed, *STEP_WORDS), steps,
                      {**flags, "lr": lr}, prec)
    out["pools"] = [pool]
    return out


def nn_dataset(store: torch.Tensor) -> torch.Tensor:
    """The store at 32x32 as (N, 3072) fp64 rows in [0, 1], 4096 images at a time."""
    rows = [C.to_u8(C.resize(store[s:s + 4096].float() / 255.0, SCALE))
            for s in range(0, store.shape[0], 4096)]
    return torch.cat(rows).reshape(store.shape[0], -1).double() / 255.0
