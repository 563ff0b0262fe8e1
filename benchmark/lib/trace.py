"""Reading a torch.profiler Chrome trace: device intervals, their union
and gaps, what the host was doing in a gap, and time by kernel.

Device work is the complete events ("ph": "X") of the categories
``kernel``, ``gpu_memcpy`` and ``gpu_memset``; the busy time is the
length of the union of their intervals, so work that overlaps on two
streams counts once. The host's activity is its ``cpu_op``,
``user_annotation``, ``python_function`` and ``cuda_runtime`` events;
a gap is named by the innermost of them (the latest to start) that
covers the gap's middle. Times in the file are microseconds; this
module returns seconds.
"""

from __future__ import annotations

import gzip
import json
from bisect import bisect_right
from typing import Dict, List, Sequence, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
                   "cuda_driver")

Interval = Tuple[float, float]


class Trace:
    """The events of one trace file, or of an already parsed list."""

    def __init__(self, events: Sequence[dict]):
        self.events = [e for e in events if e.get("ph") == "X"]
        self._host = sorted((e for e in self.events if e.get("cat") in HOST_CATEGORIES),
                            key=lambda e: float(e["ts"]))
        self._host_starts = [float(e["ts"]) for e in self._host]

    @classmethod
    def load(cls, path: str) -> "Trace":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            return cls(json.load(f).get("traceEvents", []))

    def device(self) -> List[dict]:
        return [e for e in self.events if e.get("cat") in DEVICE_CATEGORIES]

    def kernels(self) -> List[dict]:
        return [e for e in self.events if e.get("cat") == "kernel"]

    def annotation(self, name: str, cat: str = "user_annotation") -> List[Interval]:
        """Intervals (us) of the named record_function spans: on the host
        (``user_annotation``) or as the device saw them
        (``gpu_user_annotation``)."""
        return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                for e in self.events if e.get("cat") == cat and e.get("name") == name]

    def window(self, name: str) -> Interval:
        spans = self.annotation(name)
        if not spans:
            raise ValueError(f"no {name!r} span in the trace")
        return min(s for s, _ in spans), max(e for _, e in spans)


def union(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The union of ``intervals`` clipped to [lo, hi], sorted and disjoint."""
    out: List[List[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The idle intervals of [lo, hi] between the disjoint sorted ``busy``."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def intervals(events: Sequence[dict]) -> List[Interval]:
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events]


def busy_seconds(trace: Trace, lo: float, hi: float) -> float:
    return sum(e - s for s, e in union(intervals(trace.device()), lo, hi)) * 1e-6


def host_label(trace: Trace, t: float) -> str:
    """The innermost host event that covers time ``t`` (us): the latest to
    start of those that cover it."""
    i = bisect_right(trace._host_starts, t)
    for e in reversed(trace._host[max(0, i - 20000):i]):
        if float(e["ts"]) + float(e.get("dur", 0.0)) >= t:
            return e["name"]
    return "host idle"


def longest_gaps(trace: Trace, lo: float, hi: float, top: int = 10) -> List[List]:
    """[[what the host was doing, seconds], ...] for the ``top`` longest idle
    gaps of the device in [lo, hi]; gaps with the same label are summed."""
    idle = gaps(union(intervals(trace.device()), lo, hi), lo, hi)
    idle.sort(key=lambda g: g[0] - g[1])
    by_label: Dict[str, float] = {}
    for s, e in idle[:200]:
        label = host_label(trace, (s + e) / 2)
        by_label[label] = by_label.get(label, 0.0) + (e - s) * 1e-6
    ranked = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v] for k, v in ranked]


def top_ops(trace: Trace, lo: float, hi: float, top: int = 10) -> List[List]:
    """[[device op name, seconds], ...], the ``top`` names by total time in [lo, hi]."""
    total: Dict[str, float] = {}
    for e in trace.device():
        s = float(e["ts"])
        if lo <= s <= hi:
            total[e["name"]] = total.get(e["name"], 0.0) + float(e.get("dur", 0.0)) * 1e-6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def kernel_time(trace: Trace, lo: float, hi: float, match) -> Tuple[float, int]:
    """(seconds, launches) of the kernels in [lo, hi] whose name ``match`` accepts."""
    secs, n = 0.0, 0
    for e in trace.kernels():
        if lo <= float(e["ts"]) <= hi and match(e["name"]):
            secs += float(e.get("dur", 0.0)) * 1e-6
            n += 1
    return secs, n


def kernels_in(trace: Trace, spans: Sequence[Interval]) -> int:
    """The kernels that start inside any of the disjoint ``spans`` (us)."""
    spans = sorted(spans)
    starts = [s for s, _ in spans]
    n = 0
    for e in trace.kernels():
        t = float(e["ts"])
        i = bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            n += 1
    return n
