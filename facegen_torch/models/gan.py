"""Generator / discriminator factories (counterpart of facegen/models/gan.py).

- ``create_g``: G16 / G32 (models.lua:27-81): Linear(noise -> 128*s0*s0)
  -> view -> PReLU -> 2 x [nearest-up x2 + 5x5 conv -> BN -> PReLU]
  -> 3x3 conv -> sigmoid.
- ``create_d``: D16_d at 16px, D32b at 32px (models.lua:279-316,
  382-416), returning logits; the reference's final sigmoid is applied
  where a probability is needed.

Children are named ``{index:02d}_{name}`` like facegen's parameter tree,
so a state_dict key such as ``03_upconv1.weight`` is the checkpoint leaf
``params_g/03_upconv1/w`` (utils/checkpoint.py). The factories return
modules in eval mode; ``.train()`` turns on batch statistics and
dropout. D's dropout masks are addressed by qualified module name
(``dropout_layers``, ``set_dropout_masks``), the path along which facegen
folds its PRNG key into each layer (facegen/nn/core.py:49-53,101-105).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from facegen_torch.nn import init as winit
from facegen_torch.nn.layers import (
    AvgPool,
    BatchNorm,
    Branches,
    Conv2d,
    Dense,
    Dropout,
    Flatten,
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


def dropout_layers(model: nn.Module) -> Dict[str, Dropout]:
    """The model's dropout layers (SpatialDropout included) by qualified
    name, e.g. ``02_spatial_dropout`` or
    ``00_branches.01_dense_branch.03_dropout``. The indices along a name
    are the ones facegen folds into its key on the way to that layer."""
    return {name: m for name, m in model.named_modules() if isinstance(m, Dropout)}


@torch.no_grad()
def dropout_mask_shapes(model: nn.Module, batch: int, in_shape, device=None
                        ) -> Dict[str, Tuple[int, ...]]:
    """Each dropout layer's mask shape for a batch of ``batch`` inputs of
    per-example shape ``in_shape``, found by one eval-mode forward of a
    single zero input."""
    layers = dropout_layers(model)
    shapes, handles = {}, []
    for name, m in layers.items():
        def hook(mod, args, name=name):
            shapes[name] = mod.mask_shape((batch,) + tuple(args[0].shape[1:]))
        handles.append(m.register_forward_pre_hook(hook))
    was_training = model.training
    try:
        model.eval()(torch.zeros((1,) + tuple(in_shape), device=device))
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return shapes


def set_dropout_masks(model: nn.Module, masks: Mapping[str, torch.Tensor]) -> None:
    """Inject the keep-mask of each named dropout layer for its next
    train-mode forward. Every dropout layer must get one."""
    layers = dropout_layers(model)
    if set(masks) != set(layers):
        raise KeyError(f"dropout masks for {sorted(masks)}, layers are {sorted(layers)}")
    for name, m in layers.items():
        m.mask = masks[name]


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
    scale/grayscale/channels/noise_dim/noise_view to the values used."""
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
    resolved["noise_view"] = str(pick(None, "noise_view", "nhwc"))
    g, d = init_gan(
        torch.Generator().manual_seed(seed), resolved["scale"], resolved["channels"],
        resolved["noise_dim"], noise_view=resolved["noise_view"], device=device,
    )
    ckpt.load_gan(directory, name, g, d)
    return g, d, resolved
