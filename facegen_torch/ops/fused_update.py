"""The update tail of a train step over all of one net's leaves: two
kernels (csrc/fused_update.cu) and their plain versions.

``prep`` adds the L1/L2 penalty's gradient, clamps, and reduces the
pre-update parameters' sum |p| and sum p^2 (for the penalty in the loss)
and the count of clamped gradient entries that are not finite (for
``guard_nonfinite``). ``update`` is the gated update of an optimizer of
``train/optim.py``: Adam, Adagrad, SGD and SGD with momentum, applied
only where a device bool gate holds. ``train/optim.py:penalised_update``
joins the two for every trainer's iteration.

Neither replaces a Pallas kernel: they stand for what XLA fuses from
facegen's tree.maps of the update (facegen/train/losses.py:32-62,
facegen/train/optim.py:48-67). The plain versions are the port's
composition of torch ops, leaf by leaf, and live here:
``add_penalty_grads``, ``clamp_grads``, ``penalty_sums`` and the finite
check, and ``gated_update``.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel
or raises; nothing falls back. The kernels update in place, and a leaf's
p, g and optimizer state must share one dense layout (on the 2-D mesh the
masters are permuted views of one flat buffer, and the step's gradients
come in the same layout: parallel/gspmd.py:flat_all_reduce).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from facegen_torch.ops import _build

# Launches of each kernel in this process, counted where the kernel is
# launched (a table of more than 64 leaves takes more than one launch).
# Under a CUDA graph, train/graph.py adds the capture's counts on each
# replay, as for ops/upsample_conv.py's counters.
PREP_LAUNCHES = 0
UPDATE_LAUNCHES = 0

# prep's flags and update's optimizers, as csrc/fused_update.cu has them
_PENALISE, _CLAMP, _SUMS, _COUNT, _ACCUMULATE = 1, 2, 4, 8, 16
KINDS = {"adam": 0, "adagrad": 1, "sgd": 2, "sgd_momentum": 3}
# the state lists each optimizer keeps, as the kernel's m and v
_STATE_KEYS = {"adam": ("mu", "nu"), "adagrad": ("sum_of_squares",), "sgd": (),
               "sgd_momentum": ("trace",)}

Gate = Union[bool, torch.Tensor]


# ------------------------------------------------------------ plain versions
def penalty_sums(params: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(||p||_1, ||p||_2^2) over all parameters, 0-d fp32 tensors."""
    with torch.no_grad():
        return sum(p.abs().sum() for p in params), sum((p * p).sum() for p in params)


def add_penalty_grads(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                      sign_coef: float, linear_coef: float) -> List[torch.Tensor]:
    """grads + sign_coef * sign(p) + linear_coef * p (adversarial.lua:108).
    D passes (D_L1, D_L2). G passes (G_L2, G_L2) with the reference's bug
    (adversarial.lua:223 uses G_L2 for both terms; the step's
    ``reference_g_penalty_bug``), else (G_L1, G_L2)."""
    if sign_coef == 0.0 and linear_coef == 0.0:
        return list(grads)
    return [g + sign_coef * torch.sign(p) + linear_coef * p for g, p in zip(grads, params)]


def clamp_grads(grads: Sequence[torch.Tensor], clamp: float) -> List[torch.Tensor]:
    """Clamp every gradient entry to [-clamp, clamp]; 0 disables
    (adversarial.lua:121-123, 226-228)."""
    if clamp == 0.0:
        return list(grads)
    return [g.clamp(-clamp, clamp) for g in grads]


def _state_tensors(state: dict) -> List[torch.Tensor]:
    out = []
    for key in sorted(state):
        v = state[key]
        out.extend(v if isinstance(v, list) else [v])
    return out


@torch.no_grad()
def gated_update(tx, grads: Sequence[torch.Tensor], state: dict,
                 params: Sequence[torch.Tensor], do_update: Gate) -> None:
    """Apply ``tx`` (an optimizer of train/optim.py) in place to ``params``
    and ``state`` where ``do_update`` holds. ``do_update`` is a 0-d bool
    tensor (the D gate), chosen per element with torch.where on the
    device, or the Python True (G's ungated step). In place: the port
    updates the parameters the modules hold, where facegen returns new
    arrays."""
    updates, new_state = tx.update(list(grads), state, list(params))
    new_params = [p + u for p, u in zip(params, updates)]
    olds, news = list(params) + _state_tensors(state), new_params + _state_tensors(new_state)
    for old, new in zip(olds, news):
        old.copy_(new if do_update is True else torch.where(do_update, new, old))


def prep_reference(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                   sign_coef: float, linear_coef: float, clamp: float, sums: bool = False,
                   count: bool = False) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """(the gradients with ``sign_coef * sign(p) + linear_coef * p`` added and
    clamped to [-clamp, clamp] (0: no clamp), new tensors; and, when
    ``sums`` or ``count``, a (3,) fp32 tensor of sum |p| and sum p^2 over
    all parameters (0 unless ``sums``) and the number of entries of the
    new gradients that are not finite (0 unless ``count``), else None)."""
    grads = clamp_grads(add_penalty_grads(grads, params, sign_coef, linear_coef), clamp)
    if not (sums or count):
        return grads, None
    zero = torch.zeros((), device=params[0].device)
    l1, l2 = penalty_sums(params) if sums else (zero, zero)
    bad = sum((~torch.isfinite(g)).sum() for g in grads).float() if count else zero
    return grads, torch.stack([l1, l2, bad])


update_reference = gated_update  # ``update``'s plain version


# ------------------------------------------------------------------ wrappers
def prep(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], sign_coef: float,
         linear_coef: float, clamp: float, sums: bool = False,
         count: bool = False) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """``prep_reference``'s result. On CUDA tensors the kernel writes the
    gradients in place and returns them, with the (3,) sums from one
    deterministic reduction; with nothing to do (no penalty, clamp, sums
    or count) it launches nothing."""
    device = params[0].device
    if device.type == "cpu":
        return prep_reference(params, grads, sign_coef, linear_coef, clamp, sums, count)
    if device.type != "cuda":
        raise ValueError(f"fused_update.prep: no kernel for device {device}")
    return _launch_prep(list(params), list(grads), sign_coef, linear_coef, clamp, sums, count)


def update(tx, grads: Sequence[torch.Tensor], state: dict, params: Sequence[torch.Tensor],
           gate: Gate) -> None:
    """``update_reference``: ``tx`` applied in place to ``params`` and
    ``state`` where ``gate`` (True, or a 0-d bool device tensor) holds. On
    CUDA tensors one kernel over all the leaves; a closed gate writes
    nothing."""
    device = params[0].device
    if device.type == "cpu":
        return update_reference(tx, grads, state, params, gate)
    if device.type != "cuda":
        raise ValueError(f"fused_update.update: no kernel for device {device}")
    return _launch_update(tx, list(grads), state, list(params), gate)


# ------------------------------------------------------------------- checks
def _strides(t: torch.Tensor) -> tuple:
    """The strides that place ``t``'s entries (those of dims of size > 1)."""
    return tuple(s for n, s in zip(t.shape, t.stride()) if n > 1)


def shares_layout(p: torch.Tensor, t: torch.Tensor) -> bool:
    """Whether ``t`` lays out its entries as ``p`` does and covers one block
    of memory without gaps or overlaps, in any order of its dims (a
    contiguous tensor, or a permuted view of one)."""
    if _strides(t) != _strides(p):
        return False
    expected = 1
    for stride, size in sorted((s, n) for n, s in zip(t.shape, t.stride()) if n > 1):
        if stride != expected:
            return False
        expected *= size
    return True


def check_leaves(name: str, leaves: Sequence[Sequence[torch.Tensor]]) -> None:
    """Raise unless every leaf's tensors (p, g, then the optimizer's
    state) are fp32 on one device, of one shape and one dense layout, with
    fewer than 2^31 entries: the kernels walk each leaf as one flat block
    of memory, the same for all its tensors."""
    device = leaves[0][0].device
    for i, tensors in enumerate(leaves):
        p = tensors[0]
        for t in tensors:
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: leaf {i} has a {t.dtype} tensor; the kernel is fp32")
            if t.device != device:
                raise ValueError(f"{name}: leaf {i} on {t.device}, not {device}")
            if t.shape != p.shape:
                raise ValueError(f"{name}: leaf {i}'s shapes {tuple(p.shape)} and "
                                 f"{tuple(t.shape)} differ")
            if not shares_layout(p, t):
                raise ValueError(
                    f"{name}: leaf {i} {tuple(p.shape)}: its tensors do not share one dense "
                    f"layout (strides {p.stride()} and {t.stride()})")
        if p.numel() >= 2**31:
            raise ValueError(f"{name}: leaf {i} has 2^31 entries or more")


def in_layouts_of(params: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``grads``, each in its parameter's layout: a gradient laid out
    otherwise is copied into one (a conv weight's, which autograd gives in
    the NHWC convs' channels-last order, or G's upsample-convs' from the
    collapse's einsum); the others are returned as they are."""
    return [g if shares_layout(p, g) else torch.empty_like(p).copy_(g)
            for p, g in zip(params, grads)]


def segments(numels: Sequence[int], max_segments: int) -> List[Tuple[int, int]]:
    """The launches of a table of leaves of ``numels`` entries: [start,
    stop) ranges of the non-empty leaves' positions, at most
    ``max_segments`` leaves each, in order."""
    live = [i for i, n in enumerate(numels) if n > 0]
    return [(live[k], live[min(k + max_segments, len(live)) - 1] + 1)
            for k in range(0, len(live), max_segments)]


# ------------------------------------------------------------------ launches
@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fused_update")
    u64, i64 = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_longlong)
    f, vp = ctypes.c_float, ctypes.c_void_p
    lib.facegen_fused_prep.argtypes = [ctypes.c_int, u64, u64, i64, f, f, f, ctypes.c_int,
                                       vp, vp, vp, vp]
    lib.facegen_fused_update.argtypes = [ctypes.c_int, ctypes.c_int, u64, u64, u64, u64, i64,
                                         f, f, f, f, f, f, f, vp, vp, vp, ctypes.c_int, vp]
    for fn in (lib.facegen_fused_prep, lib.facegen_fused_update, lib.facegen_fused_max_segments,
               lib.facegen_fused_chunk):
        fn.restype = ctypes.c_int
    return lib


# Per device: the tickets (prep's, update's; int32, zeroed once and left
# zero by every launch) and prep's fp64 partials, grown on demand. Launches
# on a device share them, so they must not overlap: the port issues them on
# the current stream, in order. A workspace outgrown is kept alive, never
# freed: a CUDA graph captured before still writes it.
_TICKETS: dict = {}
_PARTIALS: dict = {}
_OUTGROWN: list = []


def _tickets(device: torch.device) -> torch.Tensor:
    t = _TICKETS.get(device.index)
    if t is None:
        _no_capture("its tickets")
        t = _TICKETS[device.index] = torch.zeros(2, dtype=torch.int32, device=device)
    return t


def _partials(device: torch.device, blocks: int) -> torch.Tensor:
    w = _PARTIALS.get(device.index)
    if w is None or w.numel() < 3 * blocks:
        _no_capture("its workspace")
        if w is not None:
            _OUTGROWN.append(w)
        w = _PARTIALS[device.index] = torch.empty(max(3 * blocks, 3 * 4096),
                                                  dtype=torch.float64, device=device)
    return w


def _no_capture(what: str) -> None:
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"fused_update: {what} would be allocated inside a CUDA graph's "
                           f"capture; run one step eagerly first (train/graph.py warms up)")


def _ptrs(tensors):
    return (ctypes.c_uint64 * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch_prep(params, grads, sign_coef, linear_coef, clamp, sums, count):
    global PREP_LAUNCHES
    flags = ((_PENALISE if sign_coef != 0.0 or linear_coef != 0.0 else 0)
             | (_CLAMP if clamp != 0.0 else 0) | (_SUMS if sums else 0) | (_COUNT if count else 0))
    if not flags:
        return grads, None
    check_leaves("fused_update.prep", list(zip(params, grads)))
    lib, device = _lib(), params[0].device
    chunk, tickets = lib.facegen_fused_chunk(), _tickets(device)
    spans = segments([p.numel() for p in params], lib.facegen_fused_max_segments())
    # written whole by the first launch; zeros where there is none (no entries)
    stats = torch.empty(3, device=device) if sums or count else None
    if stats is not None and not spans:
        stats.zero_()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for k, (lo, hi) in enumerate(spans):
            ps, gs = zip(*[(p, g) for p, g in zip(params[lo:hi], grads[lo:hi]) if p.numel()])
            numel = [p.numel() for p in ps]
            partials = _partials(device, math.ceil(sum(numel) / chunk))
            err = lib.facegen_fused_prep(
                len(ps), _ptrs(ps), _ptrs(gs), (ctypes.c_longlong * len(ps))(*numel),
                sign_coef, linear_coef, clamp, flags | (_ACCUMULATE if k else 0),
                stats.data_ptr() if stats is not None else None, partials.data_ptr(),
                tickets.data_ptr(), stream)
            if err:
                raise RuntimeError(f"fused_update.prep CUDA kernel launch failed: cudaError {err}")
            PREP_LAUNCHES += 1
    return grads, stats


def _launch_update(tx, grads, state, params, gate):
    global UPDATE_LAUNCHES
    kind = tx.kind
    if kind not in KINDS:
        raise ValueError(f"fused_update.update: no kernel for the optimizer {kind!r}")
    neg_lr, b1, b2, eps, momentum = (
        -tx.hyper.get("lr", 0.0), tx.hyper.get("b1", 0.0), tx.hyper.get("b2", 0.0),
        tx.hyper.get("eps", 0.0), tx.hyper.get("momentum", 0.0))
    moments = [state[k] for k in _STATE_KEYS[kind]]
    check_leaves("fused_update.update", list(zip(params, grads, *moments)))
    device = params[0].device
    if gate is True:
        gate_ptr = None
    elif isinstance(gate, torch.Tensor) and gate.dtype == torch.bool and gate.numel() == 1:
        if gate.device != device:
            raise ValueError(f"fused_update.update: the gate is on {gate.device}, not {device}")
        gate_ptr = gate.data_ptr()
    else:
        raise TypeError(f"fused_update.update: the gate must be True or a 0-d bool tensor, "
                        f"got {gate!r}")
    count = state.get("count")
    if kind == "adam" and (count is None or count.dtype != torch.int32
                           or count.device != device):
        raise ValueError("fused_update.update: Adam's state needs an int32 count on the device")
    lib = _lib()
    tickets = _tickets(device)
    spans = segments([p.numel() for p in params], lib.facegen_fused_max_segments())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for n, (lo, hi) in enumerate(spans):
            leaves = [leaf for leaf in zip(params[lo:hi], grads[lo:hi],
                                           *[m[lo:hi] for m in moments]) if leaf[0].numel()]
            cols = list(zip(*leaves))
            m_ptrs = _ptrs(cols[2]) if len(cols) > 2 else None
            v_ptrs = _ptrs(cols[3]) if len(cols) > 3 else None
            numel = [t.numel() for t in cols[0]]
            # the count advances once, after every launch of the table has read it
            err = lib.facegen_fused_update(
                KINDS[kind], len(leaves), _ptrs(cols[0]), _ptrs(cols[1]), m_ptrs, v_ptrs,
                (ctypes.c_longlong * len(leaves))(*numel), neg_lr, b1, 1.0 - b1, b2, 1.0 - b2,
                eps, momentum, gate_ptr, count.data_ptr() if kind == "adam" else None,
                tickets.data_ptr() + 4, int(n == len(spans) - 1), stream)
            if err:
                raise RuntimeError(
                    f"fused_update.update CUDA kernel launch failed: cudaError {err}")
            UPDATE_LAUNCHES += 1
