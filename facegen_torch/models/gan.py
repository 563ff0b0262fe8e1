"""Generator / discriminator factories (counterpart of facegen/models/gan.py).

- ``create_g``: G16 / G32 (models.lua:27-81): Linear(noise -> 128*s0*s0)
  -> view -> PReLU -> 2 x [nearest-up x2 + 5x5 conv -> BN -> PReLU]
  -> 3x3 conv -> sigmoid.
- ``create_d``: D16_d at 16px, D32b at 32px (models.lua:279-316,
  382-416), returning logits; the reference's final sigmoid is applied
  where a probability is needed.
- ``restore_gan`` also rebuilds a StyleGAN2 checkpoint (its meta's
  ``arch``; models/stylegan2.py), which the sampler serves.
- The reference's unused variants, which no CLI reaches: the
  three-branch ``create_d16``, ``create_d16_b``, ``create_d16_c``,
  ``create_d32`` and the flat ``create_g_flat`` (facegen/models/gan.py:203-346).

Children are named ``{index:02d}_{name}`` like facegen's parameter tree,
so a state_dict key such as ``03_upconv1.weight`` is the checkpoint leaf
``params_g/03_upconv1/w`` (utils/checkpoint.py). The factories return
modules in eval mode; ``.train()`` turns on batch statistics and
dropout. D's dropout masks are addressed by qualified module name
(nn/dropout.py), the path along which facegen folds its PRNG key into
each layer (facegen/nn/core.py:49-53,101-105).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
from torch import nn

from facegen_torch.models import stylegan2
from facegen_torch.nn import init as winit
from facegen_torch.nn.layers import (
    AvgPool,
    BatchNorm,
    Branches,
    Conv2d,
    Dense,
    Dropout,
    Flatten,
    MaxPool,
    NCHWView,
    PReLU,
    Reshape,
    Sigmoid,
    SpatialDropout,
    UpsampleConv,
    sequential,
)


def _conv_out(size: int, stride: int) -> int:
    """Spatial size after a 3x3 same-pad conv of the given stride."""
    return (size + 2 - 3) // stride + 1


def create_g(
    scale: int, channels: int, noise_dim: int, scheme: str = "heuristic",
    noise_view: str = "nhwc", *, generator: torch.Generator, device=None,
) -> nn.Sequential:
    """G16/G32. ``scheme`` picks the init scale of every conv and linear
    (weight-init.lua:40-75); ``noise_view`` the fc -> plane wiring:
    "nhwc" reshapes to (s0, s0, 128), "nchw" reproduces the reference's
    nn.View(128, s0, s0) unit order (facegen/models/gan.py:96-109)."""
    s0 = 4 if scale == 16 else scale // 4
    std = winit.scheme_fn(scheme)
    if noise_view == "nchw":
        view = NCHWView(s0, 128)
    elif noise_view == "nhwc":
        view = Reshape((s0, s0, 128))
    else:
        raise ValueError(f"unknown noise_view {noise_view!r}")
    kw = dict(generator=generator, device=device)
    fc = 128 * s0 * s0
    return sequential(
        ("fc", Dense(noise_dim, fc, w_std=std(noise_dim, fc), **kw)),
        ("reshape", view),
        ("prelu", PReLU(device=device)),
        ("upconv1", UpsampleConv(128, 256, 5, w_std=std(128 * 25, 256 * 25), **kw)),
        ("batch_norm", BatchNorm(256, device=device)),
        ("prelu", PReLU(device=device)),
        ("upconv2", UpsampleConv(256, 128, 5, w_std=std(256 * 25, 128 * 25), **kw)),
        ("batch_norm", BatchNorm(128, device=device)),
        ("prelu", PReLU(device=device)),
        ("conv_out", Conv2d(128, channels, 3, w_std=std(128 * 9, channels * 9), **kw)),
        ("sigmoid", Sigmoid()),
    ).eval()


def create_d(scale: int, channels: int, *, generator: torch.Generator,
             device=None) -> nn.Sequential:
    """D dispatch (models.lua:98-104): D16_d at 16px, D32b otherwise."""
    if scale == 16:
        return create_d16_d(scale, channels, generator=generator, device=device)
    return create_d32b(scale, channels, generator=generator, device=device)


def create_d32b(scale: int, channels: int, *, generator: torch.Generator,
                device=None) -> nn.Sequential:
    """models.lua:382-416, logits out."""
    kw = dict(generator=generator, device=device)
    layers, in_c, size = [], channels, scale
    for out_c in (64, 128, 256, 512):
        layers += [
            (f"conv{out_c}", Conv2d(in_c, out_c, 3, **kw)),
            ("prelu", PReLU(device=device)),
            ("spatial_dropout", SpatialDropout(0.2)),
            ("avg_pool", AvgPool(2)),
        ]
        in_c, size = out_c, size // 2
    return sequential(
        *layers,
        ("flatten", Flatten()),
        ("fc1", Dense(size * size * 512, 512, **kw)),
        ("prelu", PReLU(device=device)),
        ("dropout", Dropout(0.5)),
        ("fc2", Dense(512, 512, **kw)),
        ("prelu", PReLU(device=device)),
        ("dropout", Dropout(0.5)),
        ("fc_out", Dense(512, 1, **kw)),
    ).eval()


def create_d16_d(scale: int, channels: int, *, generator: torch.Generator,
                 device=None) -> nn.Sequential:
    """models.lua:279-316 (the 16px D the reference uses), logits out."""
    kw = dict(generator=generator, device=device)
    size = _conv_out(_conv_out(scale // 2, 2), 2)
    conv_branch = sequential(
        ("conv1", Conv2d(channels, 128, 3, **kw)),
        ("prelu", PReLU(device=device)),
        ("conv2", Conv2d(128, 128, 3, **kw)),
        ("prelu", PReLU(device=device)),
        ("avg_pool", AvgPool(2)),
        ("conv3", Conv2d(128, 512, 3, stride=2, **kw)),
        ("prelu", PReLU(device=device)),
        ("conv4", Conv2d(512, 1024, 3, stride=2, **kw)),
        ("prelu", PReLU(device=device)),
        ("spatial_dropout", SpatialDropout(0.5)),
        ("flatten", Flatten()),
        ("fc", Dense(size * size * 1024, 1024, **kw)),
        ("prelu", PReLU(device=device)),
    )
    dense_branch = sequential(
        ("flatten", Flatten()),
        ("fc1", Dense(scale * scale * channels, 128, **kw)),
        ("prelu", PReLU(device=device)),
        ("dropout", Dropout(0.5)),
        ("fc2", Dense(128, 128, **kw)),
        ("prelu", PReLU(device=device)),
    )
    return sequential(
        ("branches", Branches(("conv_branch", conv_branch), ("dense_branch", dense_branch))),
        ("fc_out", Dense(1024 + 128, 1, **kw)),
    ).eval()


def _three_branch_d(fine: nn.Module, coarse: nn.Module, dense: nn.Module, joined: int,
                    kw: dict) -> nn.Sequential:
    """Branches (fine, coarse, dense) -> fc_join 1024 -> PReLU -> dropout
    -> fc_out, the unused Ds' common head (facegen/models/gan.py:224-229)."""
    device = kw["device"]
    return sequential(
        ("branches", Branches(("fine", fine), ("coarse", coarse), ("dense", dense))),
        ("fc_join", Dense(joined, 1024, **kw)),
        ("prelu", PReLU(device=device)),
        ("dropout", Dropout(0.5)),
        ("fc_out", Dense(1024, 1, **kw)),
    ).eval()


def _dense_branch(in_features: int, kw: dict) -> nn.Sequential:
    device = kw["device"]
    return sequential(
        ("flatten", Flatten()),
        ("fc1", Dense(in_features, 1024, **kw)), ("prelu", PReLU(device=device)),
        ("dropout", Dropout(0.5)),
        ("fc2", Dense(1024, 1024, **kw)), ("prelu", PReLU(device=device)),
    )


def _conv_stack(channels: int, kernel: int, widths, kw: dict, strides=None) -> list:
    """conv{i} -> PReLU pairs of the given widths (stride 1 unless given)."""
    layers, in_c = [], channels
    for i, out_c in enumerate(widths):
        stride = strides[i] if strides else 1
        layers += [(f"conv{i + 1}", Conv2d(in_c, out_c, kernel, stride=stride, **kw)),
                   ("prelu", PReLU(device=kw["device"]))]
        in_c = out_c
    return layers


def create_d16(scale: int, channels: int, *, generator: torch.Generator,
               device=None) -> nn.Sequential:
    """Unused variant models.lua:110-159 (facegen/models/gan.py:203-229), logits."""
    kw = dict(generator=generator, device=device)
    half = scale // 2

    def branch(kernel, widths):
        return sequential(
            *_conv_stack(channels, kernel, widths, kw),
            ("max_pool", MaxPool()), ("spatial_dropout", SpatialDropout(0.5)),
            ("flatten", Flatten()), ("fc", Dense(half * half * widths[-1], 1024, **kw)),
            ("prelu", PReLU(device=device)), ("dropout", Dropout(0.5)),
        )

    return _three_branch_d(branch(3, (64, 64)), branch(5, (32, 64)),
                           _dense_branch(scale * scale * channels, kw), 3 * 1024, kw)


def create_d16_b(scale: int, channels: int, *, generator: torch.Generator,
                 device=None) -> nn.Sequential:
    """Unused variant models.lua:161-216 (facegen/models/gan.py:232-263):
    strided 3x3 and 5x5 branches, logits."""
    kw = dict(generator=generator, device=device)
    size = _conv_out(scale, 2)

    def branch(kernel):
        return sequential(
            *_conv_stack(channels, kernel, (64, 64, 128, 128), kw, strides=(1, 1, 1, 2)),
            ("spatial_dropout", SpatialDropout(0.5)),
            ("flatten", Flatten()), ("fc", Dense(size * size * 128, 512, **kw)),
            ("prelu", PReLU(device=device)), ("dropout", Dropout(0.5)),
        )

    return _three_branch_d(branch(3), branch(5), _dense_branch(scale * scale * channels, kw),
                           512 + 512 + 1024, kw)


def create_d16_c(scale: int, channels: int, *, generator: torch.Generator,
                 device=None) -> nn.Sequential:
    """Unused variant models.lua:218-277 (facegen/models/gan.py:266-299):
    deeper strided branches, logits."""
    kw = dict(generator=generator, device=device)
    size = _conv_out(_conv_out(scale, 2), 2)

    def branch(kernel):
        return sequential(
            *_conv_stack(channels, kernel, (64, 64, 128, 128, 512), kw,
                         strides=(1, 1, 1, 2, 2)),
            ("spatial_dropout", SpatialDropout(0.5)),
            ("flatten", Flatten()), ("fc", Dense(size * size * 512, 1024, **kw)),
            ("prelu", PReLU(device=device)),
        )

    return _three_branch_d(branch(3), branch(5), _dense_branch(scale * scale * channels, kw),
                           3 * 1024, kw)


def create_d32(scale: int, channels: int, *, generator: torch.Generator,
               device=None) -> nn.Sequential:
    """Unused variant models.lua:322-376 (facegen/models/gan.py:316-346), logits."""
    kw = dict(generator=generator, device=device)
    half, quarter = scale // 2, scale // 4
    fine = sequential(
        *_conv_stack(channels, 3, (64, 64), kw),
        ("max_pool", MaxPool()), ("spatial_dropout", SpatialDropout(0.5)),
        ("flatten", Flatten()), ("fc", Dense(half * half * 64, 1024, **kw)),
        ("prelu", PReLU(device=device)),
    )
    coarse = sequential(
        *_conv_stack(channels, 5, (32, 32), kw),
        ("max_pool", MaxPool()),
        ("conv3", Conv2d(32, 54, 5, **kw)), ("prelu", PReLU(device=device)),
        ("conv4", Conv2d(54, 54, 5, **kw)), ("prelu", PReLU(device=device)),
        ("max_pool", MaxPool()), ("spatial_dropout", SpatialDropout(0.5)),
        ("flatten", Flatten()), ("fc1", Dense(quarter * quarter * 54, 1024, **kw)),
        ("prelu", PReLU(device=device)), ("dropout", Dropout(0.5)),
        ("fc2", Dense(1024, 1024, **kw)), ("prelu", PReLU(device=device)),
    )
    return _three_branch_d(fine, coarse, _dense_branch(scale * scale * channels, kw),
                           3 * 1024, kw)


def create_g_flat(scale: int, channels: int, noise_dim: int, *, generator: torch.Generator,
                  device=None) -> nn.Sequential:
    """The dead first create_G (models.lua:12-21, facegen/models/gan.py:302-313):
    Linear -> 2048 -> PReLU -> Linear -> sigmoid -> image."""
    kw = dict(generator=generator, device=device)
    return sequential(
        ("fc1", Dense(noise_dim, 2048, **kw)),
        ("prelu", PReLU(device=device)),
        ("fc2", Dense(2048, scale * scale * channels, **kw)),
        ("sigmoid", Sigmoid()),
        ("reshape", Reshape((scale, scale, channels))),
    ).eval()


def init_gan(
    generator: torch.Generator,
    scale: int,
    channels: int,
    noise_dim: int,
    reference_init: bool = True,
    scheme: str = "heuristic",
    noise_view: str = "nhwc",
    device=None,
) -> Tuple[nn.Sequential, nn.Sequential]:
    """G and D with the reference's initialisation (facegen init_gan):
    scheme init on G with zeroed biases, D with torch's default reset;
    with ``reference_init`` the gaussian overwrite of both on top
    (train.lua:137-138). All draws come from ``generator``."""
    g = create_g(scale, channels, noise_dim, scheme=scheme, noise_view=noise_view,
                 generator=generator, device=device)
    winit.zero_biases(g)
    d = create_d(scale, channels, generator=generator, device=device)
    if reference_init:
        winit.gaussian_overwrite(g, generator)
        winit.gaussian_overwrite(d, generator)
    return g, d


def restore_gan(
    network: str,
    default_dir: str = "logs",
    scale: Optional[int] = None,
    grayscale: Optional[bool] = None,
    noise_dim: Optional[int] = None,
    seed: int = 0,
    device=None,
):
    """Rebuild G/D from a checkpoint using the checkpoint's own config
    (facegen/models/gan.py:396-450). Non-None keyword values are checked
    overrides: one that contradicts the stored config raises with both
    values. Returns (g, d, resolved) where resolved maps
    scale/grayscale/channels/noise_dim/noise_view to the values used. A
    StyleGAN2 checkpoint (its "arch") is rebuilt from its stored widths
    (models/stylegan2.py); its resolved values carry ``arch`` too."""
    from facegen_torch.utils import checkpoint as ckpt

    directory, name = ckpt.split_network_arg(network, default_dir)
    stored = ckpt.load_meta(directory, name).get("config", {})

    def pick(given, key, fallback):
        have = stored.get(key)
        if given is not None and have is not None and given != have:
            raise ValueError(
                f"checkpoint {os.path.join(directory, name)!r} was trained "
                f"with {key}={have!r} but {key}={given!r} was requested; "
                f"drop the flag to use the checkpoint's own value"
            )
        if given is not None:
            return given
        return have if have is not None else fallback

    resolved = {
        "scale": int(pick(scale, "scale", 32)),
        "grayscale": bool(pick(grayscale, "grayscale", False)),
        "noise_dim": int(pick(noise_dim, "noise_dim", 100)),
    }
    resolved["channels"] = 1 if resolved["grayscale"] else 3
    if stored.get("arch") == stylegan2.ARCH:
        g, d = stylegan2.create_stylegan2(stylegan2.StyleGAN2Config.from_meta(stored),
                                          generator=torch.Generator().manual_seed(seed),
                                          device=device)
        ckpt.load_stylegan2(directory, name, g, d)
        return g, d, {**resolved, "arch": stylegan2.ARCH}
    resolved["noise_view"] = str(pick(None, "noise_view", "nhwc"))
    g, d = init_gan(
        torch.Generator().manual_seed(seed), resolved["scale"], resolved["channels"],
        resolved["noise_dim"], noise_view=resolved["noise_view"], device=device,
    )
    ckpt.load_gan(directory, name, g, d)
    return g, d, resolved
