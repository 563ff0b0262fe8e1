#!/usr/bin/env python3
"""Time the GAN sampler and training paths of two trees of the repo on
one CUDA GPU, in alternating turns, beside a probe of the host.

    python3 tools/compare_gan_paths.py OLD_ROOT NEW_ROOT [--rounds 1] [--out DIR]

Each argument is the root of a tree holding chip_smoke.py and
facegen_torch/, e.g. a parent commit unpacked with ``git archive HEAD
chip_smoke.py facegen_torch | tar -x -C logs_parent``. A turn is a fresh
process in one tree's root that probes the host (microseconds per launch
of a one-element CUDA add, nanoseconds per step of a Python loop), builds
the tree's kernels, writes the synthetic store and runs that tree's own
``chip_smoke.phase_main_path`` (``sample.main --runs 2 --neighbours``)
and ``chip_smoke.phase_training`` (``train.main`` at the default flags,
2 epochs and a resume), then probes the host again. A round is four
turns, old, new, new, old, so a host that drifts during the call drifts
for both trees. Each turn's output goes to
DIR/turn_{i}_{old,new}.log (default DIR: logs_compare_gan_paths); the
key numbers of every turn are printed as a table, and the medians per
tree last.
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys

CHILD = r"""
import tempfile, time
import torch
import chip_smoke as cs

def probe(label):
    x = torch.zeros(1, device="cuda")
    for _ in range(1000):
        x.add_(1)
    torch.cuda.synchronize()
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    launch_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    s = 0
    for i in range(2_000_000):
        s += i
    loop_ns = (time.perf_counter() - t0) / 2e6 * 1e9
    print(f"host probe {label}: {launch_us:.3f} us per launch, {loop_ns:.2f} ns per loop step")

probe("before")
cs.phase_build()
with tempfile.TemporaryDirectory() as tmp:
    store = cs.write_store(tmp)
    cs.phase_main_path(tmp, store)
    cs.phase_training(tmp, store)
probe("after")
"""

# (column, regex over a turn's output): the first group is the number
PATTERNS = [
    ("launch us before", r"host probe before: ([\d.]+) us per launch"),
    ("loop ns before", r"host probe before: [\d.]+ us per launch, ([\d.]+) ns"),
    ("sampler run s", r"main path: sample\.main took ([\d.]+) s"),
    ("G images/s", r"main path: generate_n\(1024\) ([\d.]+) images/s"),
    ("G device ms", r"main path: G call device time ([\d.]+) ms"),
    ("warm epoch images/s", r"training path: warm epoch \(2\) ([\d.]+) images/s"),
    ("stream ms/step", r"training path: ([\d.]+) ms per step on the stream"),
    ("device ms/step", r"training path: step profile .*?: ([\d.]+) ms of device time"),
    ("host wall ms/step", r"training path: step profile .*? in ([\d.]+) ms of host wall"),
    ("launch us after", r"host probe after: ([\d.]+) us per launch"),
]


def run_turn(root: str, log: str) -> dict:
    root = os.path.abspath(root)
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, env=env,
                          capture_output=True, text=True, timeout=900)
    with open(log, "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        sys.exit(f"turn in {root} failed ({proc.returncode}); see {log}:\n{proc.stderr[-3000:]}")
    row = {}
    for col, pattern in PATTERNS:
        m = re.search(pattern, proc.stdout)
        row[col] = float(m.group(1)) if m else float("nan")
    return row


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("old_root")
    p.add_argument("new_root")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--out", default="logs_compare_gan_paths",
                   help="directory for each turn's full output")
    a = p.parse_args()
    os.makedirs(a.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    rows = []
    order = ["old", "new", "new", "old"] * a.rounds
    for i, which in enumerate(order):
        root = a.old_root if which == "old" else a.new_root
        row = run_turn(root, os.path.join(a.out, f"turn_{i}_{which}.log"))
        rows.append((which, row))
        print(f"turn {i} {which}: " + "; ".join(f"{k} {v}" for k, v in row.items()), flush=True)
    cols = [c for c, _ in PATTERNS]
    print("| turn | tree | " + " | ".join(cols) + " |")
    print("|" + "---|" * (len(cols) + 2))
    for i, (which, row) in enumerate(rows):
        print(f"| {i} | {which} | " + " | ".join(f"{row[c]}" for c in cols) + " |")
    for which in ("old", "new"):
        med = {c: statistics.median(r[c] for w, r in rows if w == which) for c in cols}
        print(f"median {which}: " + "; ".join(f"{c} {v}" for c, v in med.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
