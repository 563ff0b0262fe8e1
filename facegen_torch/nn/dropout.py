"""Dropout masks of a model, addressed by name (the train steps inject
them; facegen/nn/core.py:49-53,101-105 draws them from keys folded along
each layer's path).

A dropout layer's name is its qualified module name, e.g.
``02_spatial_dropout`` or ``00_branches.01_dense_branch.03_dropout``:
the indices along it are the ones facegen folds into its key on the way
to that layer. A model whose children carry no such index defines
``fold_path(name) -> str``, which maps a module name to its key path;
without one the module name is the key path. ``models/c2f.WithHead``
defines it (``body.10_dropout`` -> ``01_body.10_dropout``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from facegen_torch.nn.layers import Dropout


def dropout_layers(model: nn.Module) -> Dict[str, Dropout]:
    """The model's dropout layers (SpatialDropout included) by key path."""
    fold_path = getattr(model, "fold_path", lambda name: name)
    return {fold_path(name): m for name, m in model.named_modules() if isinstance(m, Dropout)}


def _zero_input(in_shape, device):
    """One zero example of per-example shape ``in_shape``, or a tuple of
    them for a model whose input is a tuple of tensors (a tuple of shapes)."""
    if isinstance(in_shape[0], (tuple, list)):
        return tuple(_zero_input(s, device) for s in in_shape)
    return torch.zeros((1,) + tuple(in_shape), device=device)


@torch.no_grad()
def dropout_mask_shapes(model: nn.Module, batch: int, in_shape, device=None
                        ) -> Dict[str, Tuple[int, ...]]:
    """Each dropout layer's mask shape for a batch of ``batch`` inputs of
    per-example shape ``in_shape`` (a tuple of shapes for a pair input),
    found by one eval-mode forward of a single zero input."""
    layers = dropout_layers(model)
    shapes, handles = {}, []
    for name, m in layers.items():
        def hook(mod, args, name=name):
            shapes[name] = mod.mask_shape((batch,) + tuple(args[0].shape[1:]))
        handles.append(m.register_forward_pre_hook(hook))
    was_training = model.training
    try:
        model.eval()(_zero_input(in_shape, device))
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return shapes


def dropout_mask_specs(model: nn.Module, batch: int, in_shape, device=None
                       ) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Each dropout layer's (mask shape at ``batch``, rate), by key path."""
    shapes = dropout_mask_shapes(model, batch, in_shape, device)
    rates = {name: m.rate for name, m in dropout_layers(model).items()}
    return {name: (shape, rates[name]) for name, shape in shapes.items()}


def empty_masks(specs: Mapping[str, Tuple[Tuple[int, ...], float]], device
                ) -> Dict[str, torch.Tensor]:
    """Uninitialised bool masks of ``specs``' shapes, for ``draw_masks(out=)``."""
    return {name: torch.empty(shape, dtype=torch.bool, device=device)
            for name, (shape, _) in specs.items()}


def draw_masks(generator: torch.Generator,
               specs: Mapping[str, Tuple[Tuple[int, ...], float]],
               out: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """One keep-mask per layer of ``specs`` (``dropout_mask_specs``), drawn
    in order on the generator's device. With ``out`` (bool masks of those
    shapes, e.g. a CUDA graph's static buffers) the masks are written into
    its tensors, with the same values."""
    dev = generator.device
    if out is None:
        out = empty_masks(specs, dev)
    for name, (shape, rate) in specs.items():
        torch.lt(torch.rand(shape, generator=generator, device=dev), 1.0 - rate, out=out[name])
    return out


def set_dropout_masks(model: nn.Module, masks: Mapping[str, torch.Tensor]) -> None:
    """Inject the keep-mask of each named dropout layer for its next
    train-mode forward. Every dropout layer must get one."""
    layers = dropout_layers(model)
    if set(masks) != set(layers):
        raise KeyError(f"dropout masks for {sorted(masks)}, layers are {sorted(layers)}")
    for name, m in layers.items():
        m.mask = masks[name]
