"""Optimizers with optax's semantics and the interruptible gate
(counterpart of facegen/train/optim.py).

An optimizer here is a pair of functions on lists of tensors, like an
optax transformation: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, new_state)``. A state is a
dict of tensors (``count``, ``mu``, ``nu`` for Adam; ``sum_of_squares``
for Adagrad; ``trace`` for SGD with momentum), lists in parameter order.
The checkpoint writes them under optax's leaf names (utils/checkpoint.py).
On a 2-D mesh ``init`` gets a rank's masters (parallel/gspmd.py:
ShardedParams), so the moments have the shards' shapes.

``gated_update`` applies an update only where the gate is open and
leaves parameters, moments and Adam's step count untouched otherwise,
as the reference's interruptible optimizers skip a step
(interruptable_optimizers.lua:22-27). The gate is a device tensor and the
choice is ``torch.where``: no value is read back to the host. With
``do_update=True`` it is a plain update: G's step and the c2f trainer's
stock optimizers (``make_c2f_optimizer``), which have no gate.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Sequence, Union

import torch

State = Dict[str, object]


class Optimizer(NamedTuple):
    init: Callable[[Sequence[torch.Tensor]], State]
    update: Callable[..., tuple]


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """optax.adam: moments updated as (1-b)*g + b*m, bias-corrected by the
    incremented step count, eps outside the square root."""

    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32, device=params[0].device),
                "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params=None):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state["nu"])]
        count = state["count"] + 1
        c = count.float()
        bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
        updates = [-lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)) for m, v in zip(mu, nu)]
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def adagrad(lr: float = 1e-2, initial_accumulator_value: float = 0.0,
            eps: float = 1e-10) -> Optimizer:
    """optax.adagrad: updates g / sqrt(sum of g^2 + eps), 0 where the sum
    is 0."""

    def init(params):
        return {"sum_of_squares": [torch.full_like(p, initial_accumulator_value)
                                   for p in params]}

    def update(grads, state, params=None):
        sos = [g * g + s for g, s in zip(grads, state["sum_of_squares"])]
        updates = [-lr * (torch.where(s > 0, torch.rsqrt(s + eps), 0.0) * g)
                   for g, s in zip(grads, sos)]
        return updates, {"sum_of_squares": sos}

    return Optimizer(init, update)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """optax.sgd: plain steps, or with momentum a trace g + momentum*t."""
    if momentum <= 0:
        return Optimizer(lambda params: {},
                         lambda grads, state, params=None: ([-lr * g for g in grads], {}))

    def init(params):
        return {"trace": _zeros(params)}

    def update(grads, state, params=None):
        trace = [g + momentum * t for g, t in zip(grads, state["trace"])]
        return [-lr * t for t in trace], {"trace": trace}

    return Optimizer(init, update)


def make_optimizer(method: str, cfg, which: str) -> Optimizer:
    """D's or G's optimizer per the reference's defaults
    (facegen/train/optim.py:26-45): Adam at lr 1e-3 unless --{D,G}_adam_lr,
    b (0.9, 0.999), eps 1e-8; Adagrad at lr 1e-2; SGD from its flags."""
    if which == "D":
        adam_lr, sgd_lr, sgd_mom = cfg.d_adam_lr_effective, cfg.d_sgd_lr, cfg.d_sgd_momentum
    else:
        adam_lr, sgd_lr, sgd_mom = cfg.g_adam_lr_effective, cfg.g_sgd_lr, cfg.g_sgd_momentum
    if method == "adam":
        return adam(adam_lr)
    if method == "adagrad":
        return adagrad(1e-2, initial_accumulator_value=0.0, eps=1e-10)
    if method == "sgd":
        return sgd(sgd_lr, sgd_mom)
    raise ValueError(f"unknown optimizer {method!r}")


def make_c2f_optimizer(method: str, cfg, which: str) -> Optimizer:
    """The c2f trainer's stock optimizers (facegen/train/c2f.py:59-70):
    Adam at lr 1e-3; Adagrad at lr 1e-3 for D and 3e-3 for G
    (train_c2f.lua:163-166), accumulator 0, eps 1e-10; SGD with lr and
    momentum from the flags."""
    if method == "adam":
        return adam(1e-3)
    if method == "adagrad":
        return adagrad(1e-3 if which == "D" else 3e-3, initial_accumulator_value=0.0,
                       eps=1e-10)
    if method == "sgd":
        if which == "D":
            return sgd(cfg.d_sgd_lr, cfg.d_sgd_momentum)
        return sgd(cfg.g_sgd_lr, cfg.g_sgd_momentum)
    raise ValueError(f"unknown optimizer {method!r}")


def _state_tensors(state: State) -> List[torch.Tensor]:
    out = []
    for key in sorted(state):
        v = state[key]
        out.extend(v if isinstance(v, list) else [v])
    return out


@torch.no_grad()
def gated_update(tx: Optimizer, grads: Sequence[torch.Tensor], state: State,
                 params: Sequence[torch.Tensor],
                 do_update: Union[bool, torch.Tensor]) -> None:
    """Apply ``tx`` in place to ``params`` and ``state`` where ``do_update``
    holds. ``do_update`` is a 0-d bool tensor (the D gate), chosen per
    element with torch.where on the device, or the Python True (G's
    ungated step). In place: the port updates the parameters the
    modules hold, where facegen returns new arrays."""
    updates, new_state = tx.update(list(grads), state, list(params))
    new_params = [p + u for p, u in zip(params, updates)]
    olds, news = list(params) + _state_tensors(state), new_params + _state_tensors(new_state)
    for old, new in zip(olds, news):
        old.copy_(new if do_update is True else torch.where(do_update, new, old))
