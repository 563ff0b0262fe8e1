"""The harness is driven by data: a configuration, a cell, an entry and a
per-layer metric added as new files, with new entries in BENCHMARK.json,
run with no edit to a file that is there. And the guards: no JAX and no
JAX package in the process, no result without a card."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import harness  # noqa: E402

DUMMY_ENTRY = '''
from benchmark.lib import harness
from benchmark.lib import trace as T


def run(cell):
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    tr = T.Trace([ev("user_annotation", "bench.slice", 0, 1000), ev("kernel", "k", 100, 400),
                  ev("gpu_user_annotation", "dummy.steps", 50, 600)])
    out = harness.Outcome({"dummy_rate": cell.traffic["rate"] * cell.config["flags"]["width"],
                           "setup_s": 1.0},
                          {"dummy_gap": (0.0, cell.config["limits"]["gap"])}, 3, 0, 0)
    if cell.trace:
        out.trace, out.window, out.facts = tr, (0.0, 1000.0), {"steps": 2}
        out.breakdown = {"device_ops": T.top_ops(tr, 0, 1000), "idle_gaps": []}
    return out
'''


def test_a_new_cell_runs_from_new_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}

    bench_path = tmp_path / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    b = tmp_path / "benchmark"
    (b / "configs" / "dummy_cfg.json").write_text(json.dumps(
        {"name": "dummy_cfg", "flags": {"width": 3}, "limits": {"gap": 0.5}}))
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps({"entry": "dummy", "rate": 7}))
    (b / "entries" / "dummy.py").write_text(DUMMY_ENTRY)
    (b / "metrics" / "dummy_kernels.one.py").write_text(
        "from benchmark.lib.readers import kernels_per_step\n\n\n"
        "def read(outcome):\n    return kernels_per_step(outcome, 'dummy.steps')\n")
    bench["configs"].append({"name": "dummy_cfg", "source": "https://example.org/dummy",
                             "file": "benchmark/configs/dummy_cfg.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_rate", "unit": "x/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["dummy_cell"]})
    bench["per_layer"].append({"name": "dummy_kernels.one", "unit": "kernels",
                               "better": "lower", "source": "device_trace", "layer": "device",
                               "moves": "dummy_rate", "workloads": ["dummy_cell"]})
    bench_path.write_text(json.dumps(bench))
    # nothing that was there changed, BENCHMARK.json aside
    for p, data in before.items():
        assert p == bench_path or p.read_bytes() == data, p

    common = dict(seed=1, seconds=0.1, started=time.perf_counter(), device="cpu",
                  workdir=str(tmp_path), root=str(tmp_path), bench_dir=str(b))
    result, lines = harness.run_cell("dummy_cell", trace=False, **common)
    assert result["correct"] and result["attempted"] == 3
    assert result["metrics"] == {"dummy_rate": {"value": 21.0, "unit": "x/s"},
                                 "setup_s": {"value": 1.0, "unit": "s"}}
    assert list(result)[-1] == "checks" and lines[-1].startswith("check dummy_gap")
    traced, _ = harness.run_cell("dummy_cell", trace=True, **common)
    assert traced["metrics"] == {"dummy_kernels.one": {"value": 0.5, "unit": "kernels"}}
    assert traced["device"]["busy_s"] == pytest.approx(400e-6)
    assert traced["device"]["window_s"] == pytest.approx(1000e-6)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert "facegen_torch" not in harness.FORBIDDEN
    for name in ("jax", "jaxlib.xla_client", "flax", "facegen", "facegen.models"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "facegen_torchx", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    found = harness.forbidden_modules()
    assert set(found) == {"jax", "jaxlib.xla_client", "flax", "facegen", "facegen.models"}


def test_a_cell_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from benchmark.lib import harness\n"
            "import tempfile\n"
            "with tempfile.TemporaryDirectory() as wd:\n"
            "    r, _ = harness.run_cell('gan32_sample', 3, 0.1, False, time.perf_counter(),\n"
            "        'cpu', wd, traffic_overrides={'store_images': 64, 'faces': 16,\n"
            "        'check_every': 4})\n"
            "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("only_benchmark", [False, True])
def test_no_result_without_a_card_or_the_program(tmp_path, only_benchmark):
    root = ROOT
    if only_benchmark:  # a directory that holds BENCHMARK.json and the paths alone
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
        shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
        root = tmp_path
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "gan32_train",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=root, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
