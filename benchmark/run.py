"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload gan32_train --seed 7 --seconds 20 --trace 0

From the root of a checkout: the cell's pieces are found by the names in
BENCHMARK.json (benchmark/lib/harness.py). With ``--trace 0`` the run
measures the cell's end-to-end metrics over a window of ``--seconds``;
with ``--trace 1`` it profiles a fixed slice of the same work and
reports the per-layer metrics. Either way it decides ``correct`` against
the plain reference, prints each number compared beside its limit as the
last lines of standard error, and one JSON object as the last line of
standard output. It exits without a result (and with another code than
0) when no CUDA card is visible or fewer than the cell asks for, and when
JAX or the JAX package was loaded. The program's build and kernel caches
live in fixed directories inside the checkout.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def _finite(x):
    """JSON has no NaN: a non-finite number is written as the largest float."""
    if isinstance(x, float) and not math.isfinite(x):
        return sys.float_info.max
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.lib import harness

    cell = harness.find_cell(harness.benchmark_json(ROOT), a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{a.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    workdir = tempfile.mkdtemp(prefix="bench-")
    try:
        result, lines = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace), STARTED,
                                         "cuda:0", workdir, ROOT)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
