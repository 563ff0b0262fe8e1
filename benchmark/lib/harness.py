"""One run of one cell: find its pieces by name, run its entry, read its
per-layer metrics, check that no JAX was loaded, and make the result line.

Everything is found by the names in BENCHMARK.json:

- the cell (``workloads``): its ``config`` and ``traffic`` names;
- ``configs/<config>.json`` (the file ``configs[].file`` names): the
  sizes and flags the program runs with, and ``reference``, the module
  ``reference/<reference>.py`` that computes the same in plain PyTorch;
- ``traffic/<traffic>.json``: ``entry`` (``entries/<entry>.py``) and the
  parameters the entry's generator reads;
- ``metrics/<metric>.py`` for each per-layer metric that lists the cell.

An entry's ``run(cell)`` returns an ``Outcome``. A per-layer reader's
``read(outcome)`` returns a number, or None where it finds nothing to
read; the harness then leaves the metric out.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "facegen")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # the configuration's file
    traffic: dict           # the traffic mix's file
    seed: int
    seconds: float
    trace: bool
    device: str             # "cuda:0", or "cpu" in the benchmark's own tests
    started: float          # time.perf_counter() at the process's start
    workdir: str            # scratch for the program's logs and the trace


@dataclasses.dataclass
class Outcome:
    """What an entry hands back. ``metrics``: end-to-end values by name
    (untraced runs). ``checks``: each number compared, (value, limit);
    ``correct`` is that every value is within its limit. With a trace:
    ``trace`` (lib/trace.Trace), ``window`` its slice (us), and ``facts``,
    the counts the per-layer readers need."""

    metrics: Dict[str, float]
    checks: Dict[str, Tuple[float, float]]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: object = None
    window: Optional[Tuple[float, float]] = None
    facts: dict = dataclasses.field(default_factory=dict)
    breakdown: Optional[dict] = None
    notes: List[str] = dataclasses.field(default_factory=list)  # lines for standard error


def load_module(path: str, name: str):
    """Import the file at ``path`` as module ``name`` (file names such as
    metrics/device_idle_pct.train.py are not import paths)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config_file(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return read_json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return read_json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def entry_module(name: str, bench_dir: str = BENCH_DIR):
    return load_module(os.path.join(bench_dir, "entries", f"{name}.py"), f"bench_entry_{name}")


def reference_module(config: dict):
    import importlib

    return importlib.import_module(f"benchmark.reference.{config['reference']}")


def inputs(cell: Cell, use: str):
    """The benchmark's inputs for ``cell``, made on its device from its seed
    and handed alike to the program and the reference: (the reference
    module, the store, G's and D's leaf tables under the configuration's
    ``weights[use]``, G's and D's weights)."""
    import torch

    from benchmark.lib import faces, weights
    from benchmark.reference import common as C

    ref = reference_module(cell.config)
    dev = torch.device(cell.device)
    init = cell.config["weights"][use]
    g_leaves, d_leaves = ref.leaves("g", init), ref.leaves("d", init)
    store = faces.make_store(C.seeded_generator(dev, cell.seed, 1), cell.traffic["store_images"])
    g0 = weights.make(g_leaves, C.seeded_generator(dev, cell.seed, 2, 0))
    d0 = weights.make(d_leaves, C.seeded_generator(dev, cell.seed, 2, 1))
    return ref, store, g_leaves, d_leaves, g0, d0


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def read_per_layer(bench: dict, cell: str, outcome: Outcome,
                   bench_dir: str = BENCH_DIR) -> Dict[str, dict]:
    out = {}
    for m in cell_metrics(bench, cell, "per_layer"):
        reader = load_module(os.path.join(bench_dir, "metrics", f"{m['name']}.py"),
                             "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(outcome)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole (facegen_torch is not facegen)."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, started: float,
             device: str, workdir: str, root: str = ROOT, bench_dir: str = BENCH_DIR,
             traffic_overrides: Optional[dict] = None,
             flag_overrides: Optional[dict] = None) -> Tuple[dict, List[str]]:
    """Run the cell once; returns (the result line's object, the lines for
    standard error: the entry's notes, then each check). The overrides
    shrink a cell for the benchmark's own CPU tests."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    w = find_cell(bench, cell_name)
    config = config_file(bench, w["config"], root)
    config["flags"] = {**config["flags"], **(flag_overrides or {})}
    traffic = {**traffic_file(w["traffic"], bench_dir), **(traffic_overrides or {})}
    cell = Cell(cell_name, config, traffic, seed, seconds, trace, device, started, workdir)
    outcome: Outcome = entry_module(traffic["entry"], bench_dir).run(cell)

    if trace:
        metrics = read_per_layer(bench, cell_name, outcome, bench_dir)
    else:
        units = {m["name"]: m["unit"] for m in cell_metrics(bench, cell_name, "end_to_end")}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in outcome.metrics.items() if k in units}
    correct = all(v <= limit for v, limit in outcome.checks.values())
    device_info = {"platform": "gpu" if device.startswith("cuda") else "cpu",
                   "kind": _device_kind(device), "count": 1,
                   "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if trace:
        lo, hi = outcome.window
        from benchmark.lib import trace as T

        device_info["busy_s"] = T.busy_seconds(outcome.trace, lo, hi)
        device_info["window_s"] = (hi - lo) * 1e-6
    result = {"correct": bool(correct), "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics, "device": device_info}
    if trace and outcome.breakdown is not None:
        result["breakdown"] = outcome.breakdown
    result["checks"] = {k: {"value": float(v), "limit": float(limit)}
                        for k, (v, limit) in outcome.checks.items()}
    lines = list(outcome.notes) + [
        f"check {k}: {v!r} (limit {limit!r}) {'ok' if v <= limit else 'FAIL'}"
        for k, (v, limit) in outcome.checks.items()]
    return result, lines


def _device_kind(device: str) -> str:
    import torch

    if device.startswith("cuda"):
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"
