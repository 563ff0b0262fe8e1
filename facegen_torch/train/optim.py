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

``penalised_update`` is every trainer's iteration tail in facegen's
order: the penalty on the pre-update parameters, its gradient, the clamp,
the finite check, the gate, the update. It is the one place that chooses
where an update runs: on a net's parameters, or on a 2-D mesh on this
rank's masters followed by their gather. The update is applied only where
the gate is open and leaves parameters, moments and Adam's step count
untouched otherwise, as the reference's interruptible optimizers skip a
step (interruptable_optimizers.lua:22-27). The gate is a device tensor:
no value is read back to the host. With ``gate=True`` it is a plain
update: G's step and the c2f trainer's stock optimizers
(``make_c2f_optimizer``), which have no gate. On CUDA tensors it is two
kernels over all of a net's leaves (ops/fused_update.py); on the CPU
their plain versions there (``gated_update`` and the rest). Each
optimizer names its ``kind`` and ``hyper``-parameters for the kernel.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence, Tuple, Union

import torch

from facegen_torch.ops import fused_update

State = Dict[str, object]


class Optimizer(NamedTuple):
    init: Callable[[Sequence[torch.Tensor]], State]
    update: Callable[..., tuple]
    kind: str                  # the update kernel's optimizer: ops/fused_update.KINDS
    hyper: Dict[str, float]    # its hyperparameters by name


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

    return Optimizer(init, update, "adam", {"lr": lr, "b1": b1, "b2": b2, "eps": eps})


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

    return Optimizer(init, update, "adagrad", {"lr": lr, "eps": eps})


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """optax.sgd: plain steps, or with momentum a trace g + momentum*t."""
    if momentum <= 0:
        return Optimizer(lambda params: {},
                         lambda grads, state, params=None: ([-lr * g for g in grads], {}),
                         "sgd", {"lr": lr})

    def init(params):
        return {"trace": _zeros(params)}

    def update(grads, state, params=None):
        trace = [g + momentum * t for g, t in zip(grads, state["trace"])]
        return [-lr * t for t in trace], {"trace": trace}

    return Optimizer(init, update, "sgd_momentum", {"lr": lr, "momentum": momentum})


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


@torch.no_grad()
def penalised_update(tx: Optimizer, grads: Sequence[torch.Tensor], state: State,
                     params: Sequence[torch.Tensor], sign_coef: float, l1: float, l2: float,
                     clamp: float = 0.0, gate: Union[bool, torch.Tensor] = True,
                     guard: bool = False, penalty: bool = True,
                     shards=None) -> Tuple[torch.Tensor, Union[bool, torch.Tensor]]:
    """One iteration's tail, in facegen's order (facegen/train/step.py:
    301-325, 362-373): the gradients gain ``sign_coef * sign(p) + l2 * p``
    of the pre-update ``params`` and are clamped to [-clamp, clamp] (0: no
    clamp); with ``guard`` the gate closes when any of them is not finite;
    then ``tx`` updates ``params`` and ``state`` in place where the gate
    holds. On a 2-D mesh the update runs on ``shards``'s masters
    (parallel/gspmd.py:ShardedParams), which ``state`` is made from, with
    this rank's shards of the penalised, clamped full gradients, and the
    masters are then gathered into ``params``.

    Returns (the loss's penalty ``l1 * ||p||_1 + l2 * ||p||_2^2 / 2``
    (losses.penalty_loss; zeros without ``penalty`` or with both 0), the
    gate applied: ``gate``, and'd with the finite check under ``guard``).
    ``grads`` may be overwritten. On the card a gradient that does not
    share its parameter's layout is first copied into it (one copy a conv
    weight: ops/fused_update.py:in_layouts_of); on a mesh the gradients
    come in the parameters' layouts, a sharded leaf's shard-major, so that
    its shard shares its master's (parallel/gspmd.py:flat_all_reduce)."""
    params = list(params)
    if params[0].device.type == "cuda":  # the kernels walk p and g in one layout
        grads = fused_update.in_layouts_of(params, grads)
    sums = penalty and (l1 != 0.0 or l2 != 0.0)
    grads, stats = fused_update.prep(params, grads, sign_coef, l2, clamp, sums=sums,
                                     count=guard)
    term = (l1 * stats[0] + l2 * stats[1] / 2.0 if sums
            else torch.zeros((), device=params[0].device))
    if guard:
        finite = stats[2] == 0
        gate = finite if gate is True else gate & finite
    if shards is None:
        fused_update.update(tx, grads, state, params, gate)
    else:
        fused_update.update(tx, shards.shards(grads), state, shards.masters, gate)
        shards.gather_()
    return term, gate
