"""Reading the program's own spans (facegen_torch/utils/profiling.py:span)
in the traced slice: the device's idle time split by layer, the kernels
of each replay of the captured step, and the host's and the device's time
under a span.

Every idle gap of the slice (lib/trace.py's ``gaps`` of the union of its
device intervals, so the gaps add up to ``readers.idle_pct``) goes to
one layer:

1. the part of a gap inside the device view of a ``step.replay`` span
   belongs to the replay (``replay``);
2. any other part goes by the work that ends the gap, the device op
   that starts there, through its launch call (the ``cuda_runtime`` or
   ``cuda_driver`` event of the same ``correlation``): from the launch
   on, to the layer of the innermost program span open on the host at
   the launch (``LAYERS``); before it, while the device waited for the
   host, to the layer of the innermost program span on the host at each
   instant. So a gap before work that was already queued goes to the
   layer that queued it, though the host runs tens of ms ahead by then;
3. what no program span covers is ``unattributed``: the harness's own
   code, the program outside its spans (a step's metrics copy), the end
   of the slice.

So the layers and the unattributed rest add up to the idle time. The
harness's spans (``bench.slice``, ``step.run_steps``, ``data.epoch_pool``,
``inference.*``) name no layer. Under Kineto a kernel, copy or fill
belongs to the innermost range open when it was launched, and a range's
device view (``gpu_user_annotation``) spans the work that belongs to it:
a replay's view is its graph's kernels. Each reader returns None where
the slice holds none of the spans it reads (a program without them),
never 0.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from benchmark.lib import trace as T
from benchmark.lib.readers import _slice

REPLAY = "step.replay"
# the program's spans by the layer a gap under them goes to
LAYERS = {
    "step.draw": "step", "step.replay": "step", "step.eager": "step",
    "loop.pools": "loop", "loop.summary": "loop", "loop.readback": "loop", "loop.save": "loop",
    "data.pool": "loop",
    "infer.generate": "infer", "infer.score": "infer", "infer.rank": "infer",
    "infer.nn.search": "infer", "infer.nn.readback": "infer",
}
GROUPS = ("replay", "step", "loop", "infer", "unattributed")
# the host's launch calls; a device op carries the same ``correlation``
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")

Span = Tuple[float, float, str]


def host_spans(trace: T.Trace, names, lo: float, hi: float) -> List[Span]:
    """(start, end, name) of the host ranges named in ``names`` that lie
    inside [lo, hi] (us), sorted by start, an enclosing range first."""
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
           for e in trace.events if e.get("cat") == "user_annotation" and e.get("name") in names]
    return sorted((s for s in out if s[0] >= lo and s[1] <= hi), key=lambda s: (s[0], -s[1]))


def device_views(trace: T.Trace, name: str, lo: float, hi: float) -> List[T.Interval]:
    """The device views (us) of the ``name`` spans inside [lo, hi], sorted."""
    return sorted((s, e) for s, e in trace.annotation(name, "gpu_user_annotation")
                  if s >= lo and e <= hi)


def innermost(spans: Sequence[Span]) -> Tuple[List[float], List[Optional[str]]]:
    """The innermost of ``spans`` as a step function of time: (times,
    names), where names[i] holds from times[i] to times[i + 1] (None: no
    span). Of two open spans the later to start is the inner one."""
    bounds = sorted([(s, 1, k) for k, (s, _, _) in enumerate(spans)]
                    + [(e, 0, k) for k, (_, e, _) in enumerate(spans)])
    times: List[float] = []
    names: List[Optional[str]] = []
    open_: List[int] = []
    for t, starts, k in bounds:
        if starts:
            open_.append(k)
        else:
            open_.remove(k)
        name = spans[open_[-1]][2] if open_ else None
        if times and times[-1] == t:
            names[-1] = name
        else:
            times.append(t)
            names.append(name)
    return times, names


def launch_times(trace: T.Trace) -> Dict[float, float]:
    """The host's launch time (us) of the device ops, by the op's start: of
    ops that start together, the earliest launch."""
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in trace.events
                if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    out: Dict[float, float] = {}
    for e in trace.device():
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is not None:
            start = float(e["ts"])
            out[start] = min(t, out.get(start, t))
    return out


def idle_split(outcome) -> Optional[Dict[str, float]]:
    """The slice's idle seconds by layer (``GROUPS``); None without a trace
    or a device track."""
    got = _slice(outcome)
    if got is None or not got[0].device():
        return None
    tr, (lo, hi) = got
    idle = T.gaps(T.union(T.intervals(tr.device()), lo, hi), lo, hi)
    views = T.union(device_views(tr, REPLAY, lo, hi), lo, hi)
    times, names = innermost(host_spans(tr, LAYERS, lo, hi))
    launches = launch_times(tr)
    split = dict.fromkeys(GROUPS, 0.0)

    def layer_at(t: float) -> str:
        i = bisect_right(times, t) - 1
        name = names[i] if i >= 0 else None
        return LAYERS[name] if name is not None else "unattributed"

    def by_host(s: float, e: float) -> None:
        i = bisect_right(times, s) - 1
        while s < e:
            end = min(times[i + 1], e) if i + 1 < len(times) else e
            name = names[i] if i >= 0 else None
            split[LAYERS[name] if name is not None else "unattributed"] += (end - s) * 1e-6
            s, i = end, i + 1

    def outside(s: float, e: float) -> None:
        launch = launches.get(e)
        if launch is None:
            by_host(s, e)
            return
        if launch > s:
            by_host(s, min(launch, e))
        if e > max(launch, s):
            split[layer_at(launch)] += (e - max(launch, s)) * 1e-6

    j = 0
    for s, e in idle:
        while j < len(views) and views[j][1] <= s:
            j += 1
        t, k = s, j
        while k < len(views) and views[k][0] < e:
            vs, ve = max(views[k][0], s), min(views[k][1], e)
            if vs > t:
                outside(t, vs)
            split["replay"] += (ve - vs) * 1e-6
            t = ve
            k += 1
        if e > t:
            outside(t, e)
    return split


def idle_share(outcome, group: str, present: Callable[[T.Trace, float, float], bool]
               ) -> Optional[float]:
    """The idle time ``idle_split`` gives ``group``, in % of the slice's wall
    time; None where ``present(trace, lo, hi)`` finds none of the spans the
    group reads in the slice."""
    got = _slice(outcome)
    if got is None or not present(got[0], *got[1]):
        return None
    split = idle_split(outcome)
    if split is None:
        return None
    lo, hi = got[1]
    return 100.0 * split[group] / ((hi - lo) * 1e-6)


def layer_share(outcome, layer: str) -> Optional[float]:
    """``idle_share`` of a layer of ``LAYERS``, present where the slice
    holds a host span of that layer."""
    names = {n for n, g in LAYERS.items() if g == layer}
    return idle_share(outcome, layer, lambda tr, lo, hi: bool(host_spans(tr, names, lo, hi)))


def replay_share(outcome) -> Optional[float]:
    """``idle_share`` inside the replays, present where the slice holds a
    replay's device view."""
    return idle_share(outcome, "replay",
                      lambda tr, lo, hi: bool(device_views(tr, REPLAY, lo, hi)))


def per_view(outcome, name: str, measure: Callable[[T.Trace, List[T.Interval]], float]
             ) -> Optional[float]:
    """``measure(trace, views)`` of the device views of the ``name`` spans
    in the slice, over their count."""
    got = _slice(outcome)
    if got is None:
        return None
    views = device_views(got[0], name, *got[1])
    return measure(got[0], views) / len(views) if views else None


def host_ms_per(outcome, name: str) -> Optional[float]:
    """The host's time in the ``name`` spans of the slice, in ms a span."""
    got = _slice(outcome)
    if got is None:
        return None
    spans = host_spans(got[0], {name}, *got[1])
    return sum(e - s for s, e, _ in spans) * 1e-3 / len(spans) if spans else None
