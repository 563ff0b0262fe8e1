"""Coarse-to-fine refinement models (counterpart of facegen/models/c2f.py).

- ``create_g`` = G_d (models_c2f.lua:113-145): (noise (H, W, 1), coarse
  (H, W, C)) -> channel concat -> five same-pad convs (kernels 3, 3, 5,
  5, 7; widths 64, 64, 128, 256, C) with PReLU between -> a signed diff
  image (no output activation). Every conv is a ``SubpixelConv`` at
  factor 1, as the reference's SpatialConvolutionUpsample call sites are.
- ``create_d`` = D_c (models_c2f.lua:237-278): (diff, coarse) -> their
  sum (the fine image) -> 3x3 convs 64, 64, max pool, 128, 256, max pool
  -> dropout -> 512 -> dropout -> 1 logit.
- The unused variants G_a, G_b, G_c, D_a and D_b (models_c2f.lua:16-111,
  156-235).

A model is a ``WithHead``: its ``head`` joins the input pair, its
``body`` is the layer stack, so a state_dict key such as
``body.00_conv1.weight`` is facegen's leaf ``params_g/body/00_conv1/w``.
The nets keep torch's default reset (uniform(+-1/sqrt(fan_in)) on
weights and biases), drawn from an explicit generator: the reference's
heuristic init reaches only top-level modules and so never touches them
(facegen/models/c2f.py:17-22). Factories return modules in eval mode.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from facegen_torch.nn.layers import (
    Conv2d,
    Dense,
    Dropout,
    Flatten,
    MaxPool,
    PReLU,
    SubpixelConv,
    sequential,
)


class ConcatChannels(nn.Module):
    """(a, b) -> a and b concatenated on the channel axis, b cast to a's
    dtype (nn.JoinTable(2, 2), models_c2f.lua:116)."""

    def forward(self, xs):
        a, b = xs
        return torch.cat([a, b.to(a.dtype)], dim=-1)


class AddPair(nn.Module):
    """(a, b) -> a + b in a's dtype (nn.CAddTable, models_c2f.lua:240):
    diff + coarse = the fine image."""

    def forward(self, xs):
        a, b = xs
        return a + b.to(a.dtype)


class WithHead(nn.Module):
    """``body(head(xs))`` (facegen/models/c2f.py:72-83). facegen folds its
    key with 0 for the head and 1 for the body, then with each layer's
    index, so a dropout layer's key path is its module name with that
    index in front of the first part: ``fold_path``, the hook by which
    nn/dropout.py names a model's dropout layers."""

    FOLDS = {"head": 0, "body": 1}

    def __init__(self, head: nn.Module, body: nn.Module):
        super().__init__()
        self.head = head
        self.body = body

    def forward(self, xs):
        return self.body(self.head(xs))

    def fold_path(self, name: str) -> str:
        """``body.10_dropout`` -> ``01_body.10_dropout``."""
        first, dot, rest = name.partition(".")
        return f"{self.FOLDS[first]:02d}_{first}{dot}{rest}"


def _pool_out(size: int) -> int:
    """Spatial size after a 2x2 max pool of stride 2."""
    return (size - 2) // 2 + 1


def _g(channels: int, widths, kernels, generator, device) -> WithHead:
    """Same-pad SubpixelConv(factor 1) stack over (noise, coarse), PReLU
    between the convs, the last conv to ``channels`` without one."""
    kw = dict(generator=generator, device=device)
    layers, in_c = [], channels + 1
    for i, (out_c, k) in enumerate(zip(tuple(widths) + (channels,), kernels)):
        if i:
            layers.append(("prelu", PReLU(device=device)))
        layers.append((f"conv{i + 1}", SubpixelConv(in_c, out_c, k, 1, **kw)))
        in_c = out_c
    return WithHead(ConcatChannels(), sequential(*layers)).eval()


def _d(fine_size: int, channels: int, blocks, generator, device) -> WithHead:
    """Blocks of 3x3 convs with PReLU, each block ending in a 2x2 max
    pool, then dropout -> flatten -> fc1 512 -> PReLU -> dropout -> fc_out."""
    kw = dict(generator=generator, device=device)
    layers, in_c, size, i = [], channels, fine_size, 0
    for block in blocks:
        for out_c in block:
            i += 1
            layers += [(f"conv{i}", Conv2d(in_c, out_c, 3, **kw)),
                       ("prelu", PReLU(device=device))]
            in_c = out_c
        layers.append(("max_pool", MaxPool()))
        size = _pool_out(size)
    layers += [
        ("dropout", Dropout(0.5)), ("flatten", Flatten()),
        ("fc1", Dense(size * size * in_c, 512, **kw)), ("prelu", PReLU(device=device)),
        ("dropout", Dropout(0.5)), ("fc_out", Dense(512, 1, **kw)),
    ]
    return WithHead(AddPair(), sequential(*layers)).eval()


def create_g(fine_size: int, channels: int, *, generator: torch.Generator,
             device=None) -> WithHead:
    """G_d: ((noise (N, H, W, 1), coarse (N, H, W, C))) -> diff (N, H, W, C)."""
    return _g(channels, (64, 64, 128, 256), (3, 3, 5, 5, 7), generator, device)


def create_d(fine_size: int, channels: int, *, generator: torch.Generator,
             device=None) -> WithHead:
    """D_c: ((diff, coarse)) -> (N, 1) logits."""
    return _d(fine_size, channels, ((64, 64), (128, 256)), generator, device)


def create_g_a(fine_size: int, channels: int, *, generator: torch.Generator,
               device=None) -> WithHead:
    """Unused G_a (models_c2f.lua:16-45): 64 3x3, 128 7x7, C 5x5."""
    return _g(channels, (64, 128), (3, 7, 5), generator, device)


def create_g_b(fine_size: int, channels: int, *, generator: torch.Generator,
               device=None) -> WithHead:
    """Unused G_b (models_c2f.lua:47-78): 64 3x3, 64 3x3, 256 5x5, C 7x7."""
    return _g(channels, (64, 64, 256), (3, 3, 5, 7), generator, device)


def create_g_c(fine_size: int, channels: int, *, generator: torch.Generator,
               device=None) -> WithHead:
    """Unused G_c (models_c2f.lua:80-111): 64 3x3, 128 3x3, 256 5x5, C 7x7."""
    return _g(channels, (64, 128, 256), (3, 3, 5, 7), generator, device)


def create_d_a(fine_size: int, channels: int, *, generator: torch.Generator,
               device=None) -> WithHead:
    """Unused D_a (models_c2f.lua:155-192): 64, 64, one max pool, the fc head."""
    return _d(fine_size, channels, ((64, 64),), generator, device)


def create_d_b(fine_size: int, channels: int, *, generator: torch.Generator,
               device=None) -> WithHead:
    """Unused D_b (models_c2f.lua:194-235): 64, 64, pool, 128, 128, pool, the fc head."""
    return _d(fine_size, channels, ((64, 64), (128, 128)), generator, device)


def init_c2f(generator: torch.Generator, fine_size: int, channels: int,
             device=None) -> Tuple[WithHead, WithHead]:
    """G_d and D_c with torch's default reset drawn from ``generator``."""
    g = create_g(fine_size, channels, generator=generator, device=device)
    d = create_d(fine_size, channels, generator=generator, device=device)
    return g, d


def restore_c2f(network: str, default_dir: str = "logs", seed: int = 0, device=None):
    """G and D from a c2f checkpoint, rebuilt from its own stored config
    (fine_size, coarse_size, grayscale; facegen/models/c2f.py:218-241).
    Returns (g, d, meta, resolved), resolved mapping fine_size,
    coarse_size, grayscale and channels to the restored values."""
    from facegen_torch.utils import checkpoint as ckpt

    directory, name = ckpt.split_network_arg(network, default_dir)
    stored = ckpt.load_meta(directory, name).get("config", {})
    resolved = {
        "fine_size": int(stored.get("fine_size", 32)),
        "coarse_size": int(stored.get("coarse_size", 16)),
        "grayscale": bool(stored.get("grayscale", False)),
    }
    resolved["channels"] = 1 if resolved["grayscale"] else 3
    g, d = init_c2f(torch.Generator().manual_seed(seed), resolved["fine_size"],
                    resolved["channels"], device=device)
    meta = ckpt.load_gan(directory, name, g, d)
    return g, d, meta, resolved
