"""What the per-layer readers share: the traced slice's device idle share,
kernel counts, utilisation and a kernel family's share of its bound.

Each returns None where the trace holds nothing to read (no trace, no
device track, no kernel of the family), never 0 for a share.
"""

from __future__ import annotations

from typing import Callable, Optional

from benchmark.lib import flops
from benchmark.lib import trace as T


def _slice(outcome):
    if outcome.trace is None or outcome.window is None:
        return None
    return outcome.trace, outcome.window


def idle_pct(outcome) -> Optional[float]:
    got = _slice(outcome)
    if got is None or not got[0].device():
        return None
    tr, (lo, hi) = got
    return 100.0 * (1.0 - T.busy_seconds(tr, lo, hi) / ((hi - lo) * 1e-6))


def kernels_per_step(outcome, span: str) -> Optional[float]:
    """Device kernels that start inside the device's view of the ``span``
    spans of the slice, over the slice's steps."""
    got = _slice(outcome)
    if got is None or not outcome.facts.get("steps"):
        return None
    tr, (lo, hi) = got
    spans = [(s, e) for s, e in tr.annotation(span, "gpu_user_annotation") if s >= lo and e <= hi]
    n = T.kernels_in(tr, spans)
    return n / outcome.facts["steps"] if n else None


def mfu_pct(outcome) -> Optional[float]:
    got = _slice(outcome)
    if got is None or not got[0].device() or not outcome.facts.get("model_flops"):
        return None
    _, (lo, hi) = got
    return 100.0 * outcome.facts["model_flops"] / ((hi - lo) * 1e-6 * flops.PEAK_BF16_FLOPS)


def roofline_pct(outcome, bound_key: str, match: Callable[[str], bool]) -> Optional[float]:
    """The family's bound time over its traced kernel time, in %."""
    got = _slice(outcome)
    if got is None or not outcome.facts.get(bound_key):
        return None
    tr, (lo, hi) = got
    seconds, launches = T.kernel_time(tr, lo, hi, match)
    if not launches or seconds <= 0:
        return None
    return 100.0 * outcome.facts[bound_key] / seconds


def is_upconv(name: str) -> bool:
    """The upsample-conv's forward, dx and dW kernels (and dx's split sum)."""
    low = name.lower()
    return "upconv" in low or "reduce_splits" in low


def is_update(name: str) -> bool:
    return "fused_prep" in name or "fused_update" in name


def span_device_ms(outcome, span: str, per: str) -> Optional[float]:
    """The device's time under the named span, in ms per ``facts[per]``."""
    got = _slice(outcome)
    if got is None or not outcome.facts.get(per):
        return None
    tr, (lo, hi) = got
    spans = [(s, e) for s, e in tr.annotation(span, "gpu_user_annotation") if s >= lo and e <= hi]
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e-3 / outcome.facts[per]
