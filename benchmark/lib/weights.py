"""Weights made from the seed on the device, in two large draws a net.

A net is described by its leaves in the order its module lists its
parameters: (name, shape, rule), where a rule is ``("normal", std)``,
``("uniform", bound)`` for U(-bound, bound), or ``("const", value)``.
All of a net's normal leaves come from one ``randn`` and all of its
uniform leaves from one ``rand``, on a generator on the device seeded
from the seed and the net's index, so the same seed gives the same
weights to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], Tuple[str, float]]


def make(leaves: Sequence[Leaf], generator: torch.Generator) -> List[torch.Tensor]:
    dev = generator.device
    sizes = {kind: sum(math.prod(shape) for _, shape, (k, _) in leaves if k == kind)
             for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=generator, device=dev),
             "uniform": torch.rand(sizes["uniform"], generator=generator, device=dev)}
    at = {"normal": 0, "uniform": 0}
    out = []
    for _, shape, (kind, value) in leaves:
        n = math.prod(shape)
        if kind == "const":
            out.append(torch.full(shape, float(value), device=dev))
            continue
        draw = pools[kind][at[kind]:at[kind] + n].reshape(shape)
        at[kind] += n
        out.append(draw * value if kind == "normal" else (draw * 2.0 - 1.0) * value)
    return out


def load_into(module: torch.nn.Module, leaves: Sequence[Leaf],
              values: Sequence[torch.Tensor]) -> None:
    """Copy ``values`` into ``module``'s parameters, matched in order; every
    shape must agree with the table."""
    params = list(module.parameters())
    if len(params) != len(leaves):
        raise ValueError(f"{type(module).__name__} has {len(params)} parameters, "
                         f"the table {len(leaves)}")
    with torch.no_grad():
        for p, (name, shape, _), v in zip(params, leaves, values):
            if tuple(p.shape) != tuple(shape):
                raise ValueError(f"leaf {name}: the program's {tuple(p.shape)}, "
                                 f"the table's {tuple(shape)}")
            p.copy_(v)
