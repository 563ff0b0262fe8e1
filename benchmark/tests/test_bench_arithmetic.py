"""The benchmark's arithmetic against hand counts: FLOPs and bytes, the
window and percentile arithmetic, and the trace's union, gaps and labels."""

import math
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.lib import flops, readers, stats  # noqa: E402
from benchmark.lib import trace as T  # noqa: E402
from benchmark.lib.harness import Outcome  # noqa: E402
from benchmark.reference import c2f_gd_dc, g32_d32b  # noqa: E402


def test_upconv_bounds_match_the_kernel_table():
    # PERF.md's kernel table: upconv1 and upconv2 at N = 1024, bound by operations
    up1 = flops.upconv_launches(1024, 8, 128, 256)
    up2 = flops.upconv_launches(1024, 16, 256, 128)
    assert up1[0] * 1e3 == pytest.approx(0.1563, abs=5e-5)
    assert up2[0] * 1e3 == pytest.approx(0.6254, abs=5e-5)
    # at N = 32 dx and dW have the forward's operations
    assert all(t * 1e3 == pytest.approx(0.0049, abs=5e-5)
               for t in flops.upconv_launches(32, 8, 128, 256))
    assert flops.upconv_launches(32, 16, 256, 128)[0] * 1e3 == pytest.approx(0.0195, abs=5e-5)


def test_forward_flops_by_hand():
    # G32: fc 2*100*8192, upconv1 2*64*1024*1152, upconv2 2*256*512*2304, out 2*1024*3*1152
    g = 2 * 100 * 8192 + 2 * 64 * 1024 * 1152 + 2 * 256 * 512 * 2304 + 2 * 1024 * 3 * 1152
    assert flops.forward_flops(g32_d32b.G_LAYERS) == g
    assert g / 1e9 == pytest.approx(0.764, abs=1e-3)
    d = (2 * 1024 * 64 * 27 + 2 * 256 * 128 * 576 + 2 * 64 * 256 * 1152 + 2 * 16 * 512 * 2304
         + 2 * 2048 * 512 + 2 * 512 * 512 + 2 * 512)
    assert flops.forward_flops(g32_d32b.D_LAYERS) == d
    assert flops.forward_flops(c2f_gd_dc.G_LAYERS) / 1e9 == pytest.approx(2.25, abs=0.01)
    # a step: D iteration G(16) + 3 D(32); G iteration 3 G(32) + 2 D(32)
    assert flops.gan_step_flops(g, d, 32) == 16 * g + 96 * d + 96 * g + 64 * d
    assert flops.gan_step_flops(g, d, 32) / 1e9 == pytest.approx(105, abs=1.5)


def test_steps_and_update_bytes():
    assert flops.steps_per_epoch(1000, 32) == 63
    assert flops.steps_per_epoch(64, 32) == 4
    d, g = g32_d32b.leaves("d", "reference"), g32_d32b.leaves("g", "reference")
    assert flops.numel(s for _, s, _ in d) == 2_863_239
    assert flops.numel(s for _, s, _ in g) == 2_470_406
    # PERF.md's update table: D32b prep 12 + update 28 bytes a parameter; G32 8 + 28
    assert flops.update_bytes(d, True, 1.0) == 2_863_239 * 40
    assert flops.update_bytes(g, False, 5.0) == 2_470_406 * 36
    assert flops.update_bytes(g, False, 0.0) == 2_470_406 * 28
    assert flops.bound_s(0, 2_863_239 * 28) * 1e3 == pytest.approx(0.0239, abs=5e-5)


def test_percentile_and_rate():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)
    assert stats.percentile(list(range(101)), 95) == 95.0
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.rate(1000, 4.0) == 250.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _hand_trace():
    return T.Trace([
        _ev("user_annotation", "bench.slice", 0, 100),
        _ev("user_annotation", "step", 0, 60),
        _ev("gpu_user_annotation", "step", 8, 22),
        _ev("cpu_op", "aten::copy_", 70, 20),
        _ev("kernel", "UpconvFwd<bf16>", 10, 10),
        _ev("kernel", "fused_update", 15, 10),   # overlaps the first
        _ev("gpu_memcpy", "Memcpy DtoH", 40, 5),
        _ev("kernel", "reduce_splits<float>", 50, 4),
        _ev("kernel", "elementwise", 200, 10),   # outside the slice
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1},
    ])


def test_union_gaps_and_labels():
    tr = _hand_trace()
    assert tr.window("bench.slice") == (0.0, 100.0)
    busy = T.union(T.intervals(tr.device()), 0, 100)
    assert busy == [(10.0, 25.0), (40.0, 45.0), (50.0, 54.0)]
    assert T.gaps(busy, 0, 100) == [(0.0, 10.0), (25.0, 40.0), (45.0, 50.0), (54.0, 100.0)]
    assert T.busy_seconds(tr, 0, 100) == pytest.approx(24e-6)
    assert T.host_label(tr, 80) == "aten::copy_"
    assert T.host_label(tr, 30) == "step"
    assert T.host_label(tr, 95) == "bench.slice"
    gaps = T.longest_gaps(tr, 0, 100)
    assert gaps[0] == ["aten::copy_", pytest.approx(46e-6)]  # 54-100: the copy covers 77
    assert dict(gaps)["step"] == pytest.approx(30e-6)  # 0-10, 25-40, 45-50
    assert T.top_ops(tr, 0, 100)[0] == ["UpconvFwd<bf16>", pytest.approx(10e-6)]
    assert T.kernel_time(tr, 0, 100, readers.is_upconv) == (pytest.approx(14e-6), 2)


def test_readers_on_a_hand_trace():
    tr = _hand_trace()
    out = Outcome({}, {}, 1, 0, 0, trace=tr, window=(0.0, 100.0),
                  facts={"steps": 2, "model_flops": 989e12 * 50e-6, "upconv_bound_s": 7e-6,
                         "update_bound_s": 5e-6})
    assert readers.idle_pct(out) == pytest.approx(76.0)
    assert readers.kernels_per_step(out, "step") == 1.0  # two kernels in the step's span, two steps
    assert readers.mfu_pct(out) == pytest.approx(50.0)
    assert readers.roofline_pct(out, "upconv_bound_s", readers.is_upconv) == pytest.approx(50.0)
    assert readers.roofline_pct(out, "update_bound_s", readers.is_update) == pytest.approx(50.0)
    # nothing to read: no trace, or no kernel of the family
    assert readers.idle_pct(Outcome({}, {}, 1, 0, 0)) is None
    empty = Outcome({}, {}, 1, 0, 0, trace=T.Trace([_ev("user_annotation", "bench.slice", 0, 9)]),
                    window=(0.0, 9.0), facts={"upconv_bound_s": 1.0})
    assert readers.roofline_pct(empty, "upconv_bound_s", readers.is_upconv) is None
    assert readers.idle_pct(empty) is None
    assert not math.isnan(readers.idle_pct(out))
