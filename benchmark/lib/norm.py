"""The batch norm + PReLU kernels of the traced slice (the program's
csrc/bn_prelu.cu): every kernel whose name holds ``bn_prelu``. A program
without them (a parent commit) reads None, never 0."""

from __future__ import annotations

from typing import Optional

from benchmark.lib import trace as T
from benchmark.lib.readers import _slice
from benchmark.lib.spans import REPLAY, per_view


def is_bn_prelu(name: str) -> bool:
    return "bn_prelu" in name


def launches_per_replay(outcome) -> Optional[float]:
    """The family's kernels that start inside the device views of the
    program's ``step.replay`` spans, over those spans."""
    n = per_view(outcome, REPLAY, lambda tr, views: sum(
        T.kernel_time(tr, s, e, is_bn_prelu)[1] for s, e in views))
    return n if n else None


def device_ms_per(outcome, per: str) -> Optional[float]:
    """The family's device time in the slice, in ms per ``facts[per]``."""
    got = _slice(outcome)
    if got is None or not outcome.facts.get(per):
        return None
    tr, (lo, hi) = got
    seconds, launches = T.kernel_time(tr, lo, hi, is_bn_prelu)
    return seconds * 1e3 / outcome.facts[per] if launches else None
