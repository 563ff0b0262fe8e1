"""The batch norm + PReLU readers (lib/norm.py: norm_kernels.train,
norm_ms.train, norm_ms.sample) against hand counts on hand-made traces:
the family's launches a replay, its device ms a step and a request, and
None where the trace holds no ``bn_prelu`` kernel (a parent commit)."""

import os
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.lib import trace as T  # noqa: E402
from benchmark.lib.harness import BENCH_DIR, Outcome, load_module  # noqa: E402

STATS = "void (anonymous namespace)::bn_prelu_stats<__nv_bfloat16>(...)"
APPLY = "void (anonymous namespace)::bn_prelu_apply<__nv_bfloat16>(...)"
REDUCE = "void (anonymous namespace)::bn_prelu_bwd_reduce<__nv_bfloat16>(...)"
DX = "void (anonymous namespace)::bn_prelu_bwd_dx<__nv_bfloat16>(...)"


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _reader(name):
    return load_module(os.path.join(BENCH_DIR, "metrics", f"{name}.py"),
                       "bench_metric_" + name.replace(".", "_"))


def _train_trace(with_family=True):
    """Two replays (device views 100-400 and 500-800) of 4 family kernels
    each (3 + 5 + 4 + 6 us), other kernels, and one family kernel outside
    the replays (a draw's, 900)."""
    events = [_ev("user_annotation", "bench.slice", 0, 1000)]
    for base in (100, 500):
        events += [_ev("user_annotation", "step.replay", base - 50, 10),
                   _ev("gpu_user_annotation", "step.replay", base, 300),
                   _ev("kernel", "igemm", base, 20)]
        for k, (name, dur) in enumerate(((STATS, 3), (APPLY, 5), (REDUCE, 4), (DX, 6))):
            events.append(_ev("kernel", name if with_family else "elementwise",
                              base + 30 + 40 * k, dur))
    events.append(_ev("kernel", APPLY if with_family else "elementwise", 900, 2))
    return T.Trace(events)


def _outcome(trace, **facts):
    return Outcome({}, {}, 1, 0, 0, trace=trace, window=(0.0, 1000.0), facts=facts)


def test_launches_a_replay_count_only_the_familys_kernels_inside_the_replays():
    assert _reader("norm_kernels.train").read(_outcome(_train_trace(), steps=2)) == 4.0


def test_device_ms_a_step_and_a_request():
    # (3 + 5 + 4 + 6) * 2 + 2 us over the slice
    assert _reader("norm_ms.train").read(_outcome(_train_trace(), steps=2)) == pytest.approx(
        38e-3 / 2)
    assert _reader("norm_ms.sample").read(_outcome(_train_trace(), requests=4)) == (
        pytest.approx(38e-3 / 4))


@pytest.mark.parametrize("name,facts", [("norm_kernels.train", {"steps": 2}),
                                        ("norm_ms.train", {"steps": 2}),
                                        ("norm_ms.sample", {"requests": 4})])
def test_none_without_the_family_or_without_a_trace(name, facts):
    reader = _reader(name)
    assert reader.read(_outcome(_train_trace(with_family=False), **facts)) is None
    assert reader.read(Outcome({}, {}, 1, 0, 0, facts=facts)) is None
