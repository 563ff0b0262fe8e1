"""Tracing, the per-op device table, the NaN debug mode and the metrics
log (counterpart of facegen/utils/profiling.py).

- ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a gzipped Chrome trace of the block (CPU and, where there is
  one, CUDA activity) under ``logdir``;
- ``span(name)``: a named range of the program at a layer boundary,
  recorded only while a profiler records;
- ``aggregate_trace`` / ``format_op_table``: the per-op device-time table
  of the newest such trace, facegen's summary and tables from the GPU's
  own tracks;
- ``enable_nan_debugging``: anomaly mode plus a forward check of every
  module's output, the counterpart of ``jax_debug_nans``;
- ``MetricsLogger``: one JSON line per epoch in ``<save>/metrics.jsonl``.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from typing import List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# the categories of the events torch's profiler puts on a GPU's tracks;
# cuda_runtime (the host's launch calls) and cpu_op are the host's
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_SUFFIX = ".pt.trace.json.gz"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block: CPU ops and, when CUDA is available,
    the device's kernels, copies and fills; on exit a gzipped Chrome trace
    ``<worker>.<ns>.pt.trace.json.gz`` is written under ``logdir``. The
    caller synchronises the device inside the block if its work must
    finish there."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir, use_gzip=True)):
        yield


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context for the range ``name`` of the program: while a torch
    profiler records (``trace`` above, or any ``torch.profiler.profile``),
    ``record_function(name)``; otherwise one shared no-op context, so the
    cost when nothing records is one read of the profiler's flag.

    The spans sit at the layer boundaries: ``step.draw``, ``step.replay``,
    ``step.eager`` (train/graph.py), ``loop.pools``, ``loop.summary``,
    ``loop.readback``, ``loop.save`` (train/loop.py), ``data.pool``
    (data/pipeline.py), ``infer.generate``, ``infer.score``, ``infer.rank``,
    ``infer.nn.search`` and ``infer.nn.readback`` (utils/infer.py),
    ``sg2.mapping``, ``sg2.synthesis`` (models/stylegan2.py) and
    ``sg2.fir`` (nn/style.py, each FIR resample of StyleGAN2's G and D). A
    span's parent is the span that encloses it on the host thread. In the trace each range has a host event (category
    ``user_annotation``) and a device view (``gpu_user_annotation``): the
    device work launched while it was the innermost range open, since
    Kineto gives a kernel, copy or fill to that range alone."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _newest_trace(logdir: str) -> str:
    paths = sorted(glob.glob(os.path.join(logdir, "*" + TRACE_SUFFIX)), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} under {logdir!r}")
    return paths[-1]


def _rate(amount: float, us: float, unit: float) -> Optional[float]:
    return amount / (us * 1e-6) / unit if amount and us else None


def aggregate_trace(logdir: str, top: int = 25, min_share: float = 0.0):
    """Per-op device-time table of the newest ``trace(logdir)`` capture.

    Keeps the complete events (ph "X") on the GPU's tracks, those of the
    categories in ``DEVICE_CATEGORIES`` (the host's ``cuda_runtime`` calls
    and CPU ops are left out), and sums their durations by name: by kernel
    for kernels, by copy or fill kind for the others.

    Returns facegen's summary: ``total_us``, ``device`` (the devices of
    the trace), ``ops`` (name, total_us, calls, category,
    share, tflops, gbps; sorted by time, cut to ``top`` rows of share >=
    ``min_share``) and ``categories``. ``tflops`` and ``gbps`` are None
    where the trace counts no flops or bytes (kernels: torch records
    neither; copies and fills carry their bytes).
    """
    with gzip.open(_newest_trace(logdir), "rb") as f:
        trace_json = json.load(f)
    events = trace_json.get("traceEvents", [])

    agg: dict = {}
    cats: dict = {}
    pids = set()
    total = 0.0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat not in DEVICE_CATEGORIES:
            continue
        dur = float(ev.get("dur", 0.0))
        args = ev.get("args", {})
        row = agg.setdefault(ev.get("name", "?"), [0.0, 0, cat, 0.0, 0.0])
        row[0] += dur
        row[1] += 1
        row[3] += float(args.get("flops", 0) or 0)
        row[4] += float(args.get("bytes", 0) or 0)
        crow = cats.setdefault(cat, [0.0, 0])
        crow[0] += dur
        crow[1] += 1
        total += dur
        pids.add(ev.get("pid"))
    ops = sorted(
        (
            {"name": k, "total_us": v[0], "calls": v[1], "category": v[2],
             "share": (v[0] / total if total else 0.0),
             "tflops": _rate(v[3], v[0], 1e12),
             "gbps": _rate(v[4], v[0], 1e9)}
            for k, v in agg.items()
        ),
        key=lambda r: -r["total_us"],
    )
    ops = [r for r in ops[:top] if r["share"] >= min_share]
    categories = sorted(
        (
            {"category": k, "total_us": v[0], "calls": v[1],
             "share": (v[0] / total if total else 0.0)}
            for k, v in cats.items()
        ),
        key=lambda r: -r["total_us"],
    )
    names = [p.get("name", "") for p in trace_json.get("deviceProperties", [])]
    if pids:
        device = ", ".join(n for n in names if n) or f"GPU track(s) {sorted(pids)}"
    else:
        device = "host (no device track)"
    return {"total_us": total, "device": device, "ops": ops, "categories": categories}


def _fmt_rate(value: Optional[float], spec: str) -> str:
    return "n/a" if value is None else format(value, spec)


def format_op_table(summary: dict) -> str:
    """Render an ``aggregate_trace`` summary as facegen's two markdown
    tables (by category, by op)."""
    lines = [
        f"device track(s): {summary['device']};"
        f" leaf-op time {summary['total_us'] / 1e3:.2f} ms",
        "",
        "| category | time (us) | calls | share |",
        "|---|---:|---:|---:|",
    ]
    for r in summary.get("categories", []):
        lines.append(
            f"| {r['category']} | {r['total_us']:.0f} | {r['calls']} |"
            f" {100 * r['share']:.1f}% |"
        )
    lines += [
        "",
        "| op | category | time (us) | calls | share | TFLOP/s | GB/s |",
        "|---|---|---:|---:|---:|---:|---:|",
    ]
    for r in summary["ops"]:
        name = r["name"].replace("|", "\\|")
        if len(name) > 48:
            name = name[:45] + "..."
        lines.append(
            f"| `{name}` | {r.get('category', '')} | {r['total_us']:.0f} |"
            f" {r['calls']} | {100 * r['share']:.1f}% |"
            f" {_fmt_rate(r.get('tflops'), '.1f')} | {_fmt_rate(r.get('gbps'), '.0f')} |"
        )
    return "\n".join(lines)


class _NanDebugging:
    """Global forward hooks that raise FloatingPointError on the first
    module output with a non-finite entry, naming the module by its path
    from the outermost module running (a stack of the modules whose
    forward is under way, pushed by a pre-hook)."""

    def __init__(self):
        self.stack: List = []
        mod = torch.nn.modules.module
        self.handles = [mod.register_module_forward_pre_hook(self._enter),
                        mod.register_module_forward_hook(self._exit, always_call=True)]

    def _enter(self, module, args):
        self.stack.append(module)

    def _path(self) -> str:
        parts = [type(self.stack[0]).__name__]
        for parent, child in zip(self.stack, self.stack[1:]):
            parts.append(next((n for n, c in parent.named_children() if c is child),
                              type(child).__name__))
        return "/".join(parts)

    def _exit(self, module, args, output):
        try:
            outs = output if isinstance(output, (tuple, list)) else (output,)
            for t in outs:
                if torch.is_tensor(t) and t.is_floating_point() and not bool(
                        torch.isfinite(t).all()):
                    raise FloatingPointError(
                        f"non-finite output of module {self._path()} "
                        f"({type(module).__name__}, shape {tuple(t.shape)}, {t.dtype})")
        finally:
            if self.stack and self.stack[-1] is module:
                self.stack.pop()

    def remove(self):
        for h in self.handles:
            h.remove()


_NAN_DEBUGGING: Optional[_NanDebugging] = None


def enable_nan_debugging(enable: bool = True) -> None:
    """The counterpart of ``jax_debug_nans``: autograd's anomaly mode with
    its NaN checks (a backward op that makes a NaN raises, with the
    forward's traceback) and a check of every module's forward output,
    which raises FloatingPointError naming the module. Both wait for the
    device at every check, so they cannot run under CUDA-graph capture.
    ``enable=False`` turns both off."""
    global _NAN_DEBUGGING
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
    if enable and _NAN_DEBUGGING is None:
        _NAN_DEBUGGING = _NanDebugging()
    elif not enable and _NAN_DEBUGGING is not None:
        _NAN_DEBUGGING.remove()
        _NAN_DEBUGGING = None


class MetricsLogger:
    def __init__(self, save_dir: str, name: str = "metrics.jsonl"):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, name)

    def log(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"time": time.time(), **record}) + "\n")

    def read_all(self):
        """Every row; a blank or torn line (a concurrent append) is skipped."""
        if not os.path.exists(self.path):
            return []

        def parse(line):
            try:
                return json.loads(line) if line.strip() else None
            except json.JSONDecodeError:
                return None

        with open(self.path) as f:
            return [r for r in map(parse, f) if r is not None]
