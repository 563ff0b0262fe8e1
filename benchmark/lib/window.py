"""The measured window and the traced slice, shared by the entries.

The window runs whole units of work (a chunk of epochs, an epoch, a
request), each ending in its results on the host, until ``seconds``
have passed; it ends at the last unit's end. The traced slice runs a
fixed number of units under torch.profiler inside a ``bench.slice``
span, ending in a synchronise, and is read back from its Chrome trace.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Callable, Tuple

import torch

from benchmark.lib import trace as T

SLICE = "bench.slice"
STEPS = "step.run_steps"  # the span the training entries put around the trainer's run_steps


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(unit: Callable[[], None], seconds: float) -> Tuple[int, float]:
    """(units run, the window's seconds)."""
    units, t0 = 0, time.perf_counter()
    while True:
        unit()
        units += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return units, elapsed


def run_traced(work: Callable[[], None], device,
               workdir: str) -> Tuple[T.Trace, Tuple[float, float]]:
    """Profile ``work`` (CPU and CUDA activity); returns the trace and the
    slice's interval (us)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(workdir, "slice.trace.json")
    with profile(activities=activities) as prof:
        with record_function(SLICE):
            work()
            synchronize(device)
    prof.export_chrome_trace(path)
    del prof
    trace = T.Trace.load(path)
    os.remove(path)
    return trace, trace.window(SLICE)


def breakdown(trace: T.Trace, window: Tuple[float, float]) -> dict:
    lo, hi = window
    return {"device_ops": T.top_ops(trace, lo, hi), "idle_gaps": T.longest_gaps(trace, lo, hi)}


def peak_memory(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def span(name: str, enabled: bool):
    """A record_function span around a call into a layer, in traced runs."""
    if not enabled:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield


def wrap(obj, attr: str, name: str) -> None:
    """Put a span named ``name`` around every call of ``obj.attr`` (on this
    instance only)."""
    fn = getattr(obj, attr)

    def spanned(*args, **kwargs):
        with span(name, True):
            return fn(*args, **kwargs)

    setattr(obj, attr, spanned)
