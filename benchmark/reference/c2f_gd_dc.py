"""Plain reference of the c2f_gd_dc configuration: the coarse-to-fine
refiner G_d and D_c (models_c2f.lua:113-145 and :237-278), fine 32,
coarse 16, colour; its training step at train_c2f.lua's defaults and
approxParzen (adversarial_c2f.lua:305-344).

A pool row is a fine image and its coarse version: the fine image
resized to 16 and back to 32, both antialiased bilinear, kept as uint8;
a batch's diff is fine - coarse. G_d takes (noise (N, 32, 32, 1) U(-1,
1), coarse) joined on the channel axis through five same-pad convs
(3x3 64, 3x3 64, 5x5 128, 5x5 256, 7x7 3) with PReLU between, and
returns a signed diff. D_c takes (diff, coarse), adds them back into the
fine image, then 3x3 convs 64, 64, max pool, 128, 256, max pool,
dropout 0.5, NHWC flatten, Linear 512, PReLU, dropout 0.5, Linear 1.

A step: one D iteration (half a batch of real diffs on their coarse
conditions, half of G's diffs on the coarse conditions of other rows),
BCE, D's L1 penalty 1e-7 on the gradients and the clamp 1, Adam; one G
iteration on a batch of conditions, all targets real, G's clamp 5, Adam.
No gate. approxParzen: for each of 200 validation rows, 32 refinements
of its coarse; the least L2 distance to the true fine image.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import common as C

FINE, COARSE, CHANNELS = 32, 16, 3
G_CONVS = [(CHANNELS + 1, 64, 3), (64, 64, 3), (64, 128, 5), (128, 256, 5), (256, CHANNELS, 7)]
D_CONVS = [(CHANNELS, 64), (64, 64), (64, 128), (128, 256)]


def g_shapes():
    out = []
    for i, (cin, cout, k) in enumerate(G_CONVS):
        if i:
            out.append((f"prelu{i}.weight", (1,)))
        out += [(f"conv{i + 1}.weight", (cout, cin, k, k)), (f"conv{i + 1}.bias", (cout,))]
    return out


def d_shapes():
    out = []
    for i, (cin, cout) in enumerate(D_CONVS):
        out += [(f"conv{i + 1}.weight", (cout, cin, 3, 3)), (f"conv{i + 1}.bias", (cout,)),
                (f"prelu{i + 1}.weight", (1,))]
    return out + [("fc1.weight", (512, 8 * 8 * 256)), ("fc1.bias", (512,)),
                  ("prelu_fc1.weight", (1,)), ("fc_out.weight", (1, 512)), ("fc_out.bias", (1,))]


def leaves(net: str, init: str = "reset"):
    """The weight table of ``net`` ("g" or "d"): torch's reset, U(+-1 /
    sqrt(fan_in)) on weights and biases (the nets the reference's
    heuristic init never reaches), PReLU slopes 0.25."""
    if init != "reset":
        raise ValueError(f"init {init!r}: the c2f nets start from torch's reset")
    shapes = g_shapes() if net == "g" else d_shapes()
    out = []
    for i, (name, shape) in enumerate(shapes):
        if name.startswith("prelu"):
            out.append((name, shape, ("const", 0.25)))
            continue
        weight = shapes[i - 1][1] if name.endswith(".bias") else shape
        out.append((name, shape, ("uniform", 1.0 / math.sqrt(math.prod(weight[1:])))))
    return out


G_LAYERS = [("conv", cin, cout, k * k, FINE * FINE) for cin, cout, k in G_CONVS]
D_LAYERS = [("conv", CHANNELS, 64, 9, 32 * 32), ("conv", 64, 64, 9, 32 * 32),
            ("conv", 64, 128, 9, 16 * 16), ("conv", 128, 256, 9, 16 * 16),
            ("linear", 8 * 8 * 256, 512, 1, 1), ("linear", 512, 1, 1, 1)]


def triples(fine_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 32, 32, 3) uint8 -> (fine, coarse) uint8."""
    x = fine_u8.float() / 255.0
    return fine_u8, C.to_u8(C.resize(C.resize(x, COARSE), FINE))


def generate(p: Sequence[torch.Tensor], z: torch.Tensor, coarse: torch.Tensor,
             prec: C.Precision = C.FP32) -> torch.Tensor:
    """(noise (N, 32, 32, 1), coarse (N, 32, 32, 3)) -> diff (N, 32, 32, 3)."""
    x = torch.cat([z.float(), coarse.float()], -1).permute(0, 3, 1, 2)
    i = 0
    for j, (_, _, k) in enumerate(G_CONVS):
        if j:
            x = C.prelu(x, p[i])
            i += 1
        x = prec.conv(x, p[i], p[i + 1], padding=(k - 1) // 2)
        i += 2
    return x.permute(0, 2, 3, 1)


def d_mask_specs(batch: int):
    return [((batch, 8, 8, 256), 0.5), ((batch, 512), 0.5)]


def discriminate(p: Sequence[torch.Tensor], diff: torch.Tensor, coarse: torch.Tensor,
                 masks=None, prec: C.Precision = C.FP32) -> torch.Tensor:
    x = (diff.float() + coarse.float()).permute(0, 3, 1, 2)
    for i in range(4):
        w, b, a = p[3 * i:3 * i + 3]
        x = C.prelu(prec.conv(x, w, b, padding=1), a)
        if i in (1, 3):
            x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1)
    if masks is not None:
        x = C.apply_dropout(x, masks[0], 0.5)
    x = x.reshape(x.shape[0], -1)
    fc1_w, fc1_b, a, out_w, out_b = p[12:]
    x = C.prelu(prec.linear(x, fc1_w, fc1_b), a)
    if masks is not None:
        x = C.apply_dropout(x, masks[1], 0.5)
    return prec.linear(x, out_w, out_b)


def _gather(pool, idx):
    fine = pool[0][idx].float() / 255.0
    coarse = pool[1][idx].float() / 255.0
    return coarse, fine - coarse


def train_steps(g0: List[torch.Tensor], d0: List[torch.Tensor], pool, generator: torch.Generator,
                n_steps: int, hp: Dict, prec: C.Precision = C.FP32) -> Dict:
    """As g32_d32b.train_steps, on a (fine, coarse) pool."""
    batch, half = hp["batch_size"], hp["batch_size"] // 2
    gp = [t.detach().clone().requires_grad_() for t in g0]
    dp = [t.detach().clone().requires_grad_() for t in d0]
    sg, sd = {}, {}
    specs = d_mask_specs(batch)
    dev = pool[0].device
    ones = torch.ones(half, device=dev)
    targets = torch.cat([ones, torch.zeros_like(ones)])
    n = pool[0].shape[0]
    out = {"losses": [], "grads_g": None, "grads_d": None}

    def idx(k):
        return torch.randint(0, n, (k,), generator=generator, device=generator.device)

    def noise(k):
        return C.noise(generator, (k, FINE, FINE, 1))

    for _ in range(n_steps):
        idx_real, idx_fake, z_d = idx(half), idx(half), noise(half)
        masks_d = C.dropout_masks(generator, specs)
        idx_g, z_g = idx(batch), noise(batch)
        masks_g = C.dropout_masks(generator, specs)

        cond_real, diff_real = _gather(pool, idx_real)
        cond_fake, _ = _gather(pool, idx_fake)
        with torch.no_grad():
            diff_fake = generate(gp, z_d, cond_fake, prec)
        logits = discriminate(dp, torch.cat([diff_real, diff_fake]),
                              torch.cat([cond_real, cond_fake]), masks_d, prec)
        grads = torch.autograd.grad(C.bce(logits, targets), dp)
        with torch.no_grad():
            loss_d = C.bce(logits, targets) + C.penalty(dp, hp["d_l1"], hp["d_l2"])
            grads = C.penalised_grads(dp, grads, hp["d_l1"], hp["d_l2"], hp["d_clamp"])
            if out["grads_d"] is None:
                out["grads_d"] = [g.clone() for g in grads]
            C.adam_step(dp, grads, sd, hp["lr"])

        conds, _ = _gather(pool, idx_g)
        logits = discriminate(dp, generate(gp, z_g, conds, prec), conds, masks_g, prec)
        loss = C.bce(logits, torch.ones(batch, device=dev))
        grads = torch.autograd.grad(loss, gp)
        with torch.no_grad():
            loss_g = loss + C.penalty(gp, hp["g_l1"], hp["g_l2"])
            grads = C.penalised_grads(gp, grads, hp["g_l2"], hp["g_l2"], hp["g_clamp"])
            if out["grads_g"] is None:
                out["grads_g"] = [g.clone() for g in grads]
            C.adam_step(gp, grads, sg, hp["lr"])
        out["losses"].append((float(loss_d), float(loss_g)))
    out["g"] = [t.detach() for t in gp]
    out["d"] = [t.detach() for t in dp]
    return out


@torch.no_grad()
def parzen(g: Sequence[torch.Tensor], val_pool, generator: torch.Generator, samples: int,
           refinements: int, prec: C.Precision = C.FP32, block: int = 25) -> torch.Tensor:
    """approxParzen's per-row distances (samples,), ``block`` rows at a time."""
    dev = generator.device
    idx = torch.randint(0, val_pool[0].shape[0], (samples,), generator=generator, device=dev)
    z = C.noise(generator, (samples, refinements, FINE, FINE, 1))
    fine = val_pool[0][idx].float() / 255.0
    coarse = val_pool[1][idx].float() / 255.0
    out = []
    for s in range(0, samples, block):
        f, c = fine[s:s + block], coarse[s:s + block]
        m = f.shape[0]
        cond = c[:, None].expand(m, refinements, FINE, FINE, CHANNELS).reshape(-1, FINE, FINE,
                                                                              CHANNELS)
        diff = generate(g, z[s:s + block].reshape(-1, FINE, FINE, 1), cond, prec)
        refined = (diff + cond).reshape(m, refinements, -1)
        d = torch.sqrt(((refined - f.reshape(m, 1, -1)) ** 2).sum(-1))
        out.append(d.min(dim=1).values)
    return torch.cat(out)


# epoch 0's streams, seeded as the trainer seeds an epoch's: its pool, its
# steps, its approxParzen
POOL_WORDS, STEP_WORDS, PARZEN_WORDS = (20_000, 0), (20_000, 1), (20_000, 2)


def expected(store: torch.Tensor, g0, d0, seed: int, flags: Dict, lr: float, steps: int = 3,
             prec: C.Precision = C.FP32, pool_hold=C.same) -> Dict:
    """What the program gives from ``g0``, ``d0``: approxParzen's distances
    of ``g0`` on the validation rows (``parzen``), then its first ``steps``
    steps on epoch 0's pool (``train_steps``'s outputs); ``pools``: the
    pool's and the validation set's (fine, coarse). The model's arithmetic
    in ``prec``, the pools' held by ``pool_hold``."""
    dev = store.device
    fine = C.epoch_pool(store, C.seeded_generator(dev, seed, *POOL_WORDS), flags["n_epoch"],
                        flags["fine_size"], holdout=flags["val_size"], hold=pool_hold)
    pool = triples(fine)
    val = triples(C.range_pool(store, flags["val_size"], flags["fine_size"], pool_hold))
    dists = parzen(g0, val, C.seeded_generator(dev, seed, *PARZEN_WORDS), flags["parzen_samples"],
                   flags["batch_size"], prec)
    out = train_steps(g0, d0, pool, C.seeded_generator(dev, seed, *STEP_WORDS), steps,
                      {**flags, "lr": lr}, prec)
    out["pools"] = [*pool, *val]
    out["parzen"] = dists
    return out
