"""The readers of the program's spans (lib/spans.py, the metrics that use
it) against hand counts on hand-made traces: where each idle gap goes,
that the layers and the unattributed rest add up to the idle share, the
kernels of a replay, host and device times under a span, and None where
the spans are absent."""

import os
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.lib import readers, spans  # noqa: E402
from benchmark.lib import trace as T  # noqa: E402
from benchmark.lib.harness import BENCH_DIR, Outcome, load_module  # noqa: E402

TRAIN = ("replay_idle_pct.train", "step_idle_pct.train", "loop_idle_pct.train",
         "replay_kernels.train", "pool_ms.train")
SAMPLE = ("infer_idle_pct.sample", "g_host_ms.sample")


def _ev(cat, name, ts, dur, **args):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if args:
        ev["args"] = args
    return ev


def _host(name, ts, dur):
    return _ev("user_annotation", name, ts, dur)


def _kernel(ts, dur, name="k", corr=None):
    return _ev("kernel", name, ts, dur, **({} if corr is None else {"correlation": corr}))


def _launch(ts, corr, name="cudaLaunchKernel"):
    return _ev("cuda_runtime", name, ts, 1, correlation=corr)


def _reader(name):
    return load_module(os.path.join(BENCH_DIR, "metrics", f"{name}.py"),
                       "bench_metric_" + name.replace(".", "_"))


def _train_trace():
    """A slice of 1000 us: one step (a draw, a replay whose graph runs at
    40-100 while the host has gone on to a read-back), the pools with a
    nested pool under the harness's own span, a save, and idle time in no
    program span. Idle gaps: 0-12, 16-40, 50-55 and 70-80 (in the
    replay's view), 100-300, 310-320, 330-700, 710-990."""
    return T.Trace([
        _host("bench.slice", 0, 1000),
        _host("step.run_steps", 0, 150),
        _host("step.draw", 10, 10),
        _host("step.replay", 20, 10),
        _host("loop.readback", 60, 30),
        _host("loop.pools", 190, 210),
        _host("data.epoch_pool", 240, 120),
        _host("data.pool", 250, 100),
        _host("loop.save", 500, 100),
        _launch(11, 1), _launch(22, 2, "cudaGraphLaunch"), _launch(260, 3), _launch(270, 4),
        _launch(985, 5),
        _kernel(12, 4, "draw", corr=1),
        _ev("gpu_user_annotation", "step.replay", 40, 60),
        _kernel(40, 10, corr=2), _kernel(55, 15, corr=2), _kernel(80, 20, corr=2),
        _ev("gpu_user_annotation", "data.pool", 300, 30),
        _kernel(300, 10, corr=3), _kernel(320, 10, corr=4),
        _kernel(700, 10), _kernel(990, 10, corr=5),
    ])


def _outcome(trace, window=(0.0, 1000.0)):
    return Outcome({}, {}, 1, 0, 0, trace=trace, window=window)


def _us(split):
    return {k: round(v * 1e6, 6) for k, v in split.items()}


def test_idle_gaps_go_to_the_replay_then_by_the_launch_of_the_work_after_them():
    us = _us(spans.idle_split(_outcome(_train_trace())))
    # 50-55 and 70-80 lie in the replay's view while the host is in loop.readback
    assert us["replay"] == 15.0
    # 0-12: the host in step.draw from 10 and the launch at 11; 16-40: in
    # step.draw, then step.replay, whose graph launch at 22 the device waits on
    assert us["step"] == 2.0 + 24.0
    # 100-300: the host in loop.pools from 190 (data.epoch_pool is the
    # harness's), in data.pool from 250, its launch at 260; 310-320: launched
    # at 270 in data.pool, before the gap; 330-700 (no launch event): the pool
    # and the pools to 400, the save 500-600
    assert us["loop"] == 110.0 + 10.0 + 70.0 + 100.0
    # 0-10, 100-190, 400-500 and 600-700 under the harness alone; 710-990
    # before a launch at 985 in no program span
    assert us["unattributed"] == 10.0 + 90.0 + 200.0 + 280.0
    assert us["infer"] == 0.0


def test_a_gap_before_queued_work_goes_to_the_span_that_launched_it():
    # the host has gone on to a later step's draws while the device runs
    # what the epoch's summary queued
    tr = T.Trace([
        _host("bench.slice", 0, 100),
        _host("loop.summary", 0, 10),
        _host("step.draw", 20, 80),
        _launch(1, 1), _launch(5, 2), _launch(30, 3),
        _kernel(0, 30, corr=1), _kernel(50, 10, corr=2), _kernel(70, 30, corr=3),
    ])
    us = _us(spans.idle_split(_outcome(tr, (0.0, 100.0))))
    # 30-50: launched at 5 under loop.summary, though the host is in step.draw;
    # 60-70: launched at 30 under step.draw
    assert us["loop"] == 20.0 and us["step"] == 10.0 and us["unattributed"] == 0.0


def test_a_gap_under_nested_program_spans_goes_to_the_innermost():
    tr = T.Trace([
        _host("bench.slice", 0, 100),
        _host("loop.save", 0, 80),
        _host("infer.generate", 20, 30),
        _host("step.draw", 60, 10),
        _launch(52, 1), _launch(66, 2),
        _kernel(0, 10), _kernel(55, 5, corr=1), _kernel(72, 8, corr=2), _kernel(95, 5),
    ])
    times, names = spans.innermost(spans.host_spans(tr, spans.LAYERS, 0, 100))
    assert list(zip(times, names)) == [(0.0, "loop.save"), (20.0, "infer.generate"),
                                       (50.0, "loop.save"), (60.0, "step.draw"),
                                       (70.0, "loop.save"), (80.0, None)]
    us = _us(spans.idle_split(_outcome(tr, (0.0, 100.0))))
    # 10-55: 10-20 and 50-52 in loop.save, 20-50 in infer.generate, then the
    # launch at 52 in loop.save; 60-72: launched at 66 in step.draw; 80-95: none
    assert us["infer"] == 30.0 and us["loop"] == 15.0
    assert us["step"] == 12.0 and us["unattributed"] == 15.0


def test_a_gap_that_crosses_a_replays_view_is_split_at_its_edge():
    tr = T.Trace([
        _host("bench.slice", 0, 100),
        _host("loop.summary", 0, 100),
        _ev("gpu_user_annotation", "step.replay", 20, 25),
        _ev("gpu_user_annotation", "step.replay", 75, 5),
        _kernel(0, 10), _kernel(20, 10), _kernel(60, 10),
    ])
    # idle 10-20, 30-60 and 70-100; the views hold 30-45 and 75-80 of it
    split = spans.idle_split(_outcome(tr, (0.0, 100.0)))
    assert round(split["replay"] * 1e6, 6) == 15.0 + 5.0
    assert round(split["loop"] * 1e6, 6) == 10.0 + 15.0 + 5.0 + 20.0


def test_the_training_shares_and_the_rest_add_up_to_the_idle_share():
    out = _outcome(_train_trace())
    shares = {name: _reader(name).read(out) for name in TRAIN[:3]}
    assert shares["replay_idle_pct.train"] == pytest.approx(1.5)
    assert shares["step_idle_pct.train"] == pytest.approx(2.6)
    assert shares["loop_idle_pct.train"] == pytest.approx(29.0)
    rest = 100.0 * spans.idle_split(out)["unattributed"] / 1e-3
    assert sum(shares.values()) + rest == pytest.approx(readers.idle_pct(out))
    assert readers.idle_pct(out) == pytest.approx(91.1)
    assert sum(shares.values()) <= readers.idle_pct(out)


def test_replay_kernels_and_pool_times():
    out = _outcome(_train_trace())
    assert _reader("replay_kernels.train").read(out) == 3.0  # the draw's kernel lies outside
    assert _reader("pool_ms.train").read(out) == pytest.approx(0.030)


def test_sampler_readers_on_a_hand_trace():
    tr = T.Trace([
        _host("bench.slice", 0, 200),
        _host("inference.generate", 0, 60),   # the harness's span around the call
        _host("infer.generate", 5, 40),
        _host("inference.rank", 60, 40),
        _host("infer.score", 62, 20),
        _host("infer.rank", 85, 10),
        _host("infer.generate", 100, 30),
        _kernel(0, 5), _kernel(30, 20), _kernel(90, 5), _kernel(150, 50),
    ])
    out = _outcome(tr, (0.0, 200.0))
    # no launch events: each gap by the host's spans through it. 5-30 in
    # infer.generate; of 50-90, 62-82 in infer.score and 85-90 in infer.rank;
    # of 95-150, 100-130 in the second infer.generate: 80 us of 200
    assert _reader("infer_idle_pct.sample").read(out) == pytest.approx(40.0)
    assert _reader("g_host_ms.sample").read(out) == pytest.approx(0.035)  # (40 + 30) / 2


def test_each_reader_returns_none_without_its_spans():
    # the harness's spans and device work only, as a program without spans gives
    bare = T.Trace([
        _host("bench.slice", 0, 100), _host("step.run_steps", 0, 90),
        _host("inference.generate", 0, 50),
        _ev("gpu_user_annotation", "step.run_steps", 10, 70),
        _kernel(10, 20), _kernel(60, 20),
    ])
    for name in TRAIN + SAMPLE:
        reader = _reader(name)
        assert reader.read(_outcome(bare, (0.0, 100.0))) is None, name
        assert reader.read(Outcome({}, {}, 1, 0, 0)) is None, name
    # spans outside the slice do not count
    late = T.Trace(bare.events + [_host("step.draw", 150, 10), _host("data.pool", 170, 10)])
    assert _reader("step_idle_pct.train").read(_outcome(late, (0.0, 100.0))) is None
    assert _reader("loop_idle_pct.train").read(_outcome(late, (0.0, 100.0))) is None
