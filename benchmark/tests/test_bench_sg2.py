"""The StyleGAN2 sampler cell (sg2f256_sample) on the CPU: its FLOP counts
against the hand counts, a small run through the harness (sound in fp32,
so correct; each fault planted under it, so not correct), the controls
small, and its four readers on hand-made traces."""

import os
import sys
import tempfile
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import control_sg2  # noqa: E402
from benchmark.lib import flops, harness, sg2_flops  # noqa: E402
from benchmark.lib.harness import BENCH_DIR, Outcome, load_module  # noqa: E402
from benchmark.lib import trace as T  # noqa: E402

CELL = "sg2f256_sample"
SMALL_FLAGS = {"resolution": 32, "channel_base": 512, "channel_max": 64, "z_dim": 64,
               "w_dim": 64, "mapping_layers": 2}
SMALL_TRAFFIC = {"store_images": 48, "faces": 12, "ranked": 4, "queries": 2, "warm": 1,
                 "traced_requests": 2, "check_every": 2, "w_avg_samples": 256}
FP32 = {"compute_dtype": "float32"}


def _flags():
    bench = harness.benchmark_json(str(ROOT))
    return harness.config_file(bench, "sg2f_ffhq256", str(ROOT))["flags"]


def test_flop_counts_match_the_hand_counts():
    flags = _flags()
    g, d = sg2_flops.g_layers(flags), sg2_flops.d_layers(flags)
    g_convs = sg2_flops.forward_flops([x for x in g if x[0] in ("conv", "upconv")])
    d_convs = sg2_flops.forward_flops([x for x in d if x[0] in ("conv", "skip")][:-1])
    assert abs(g_convs / 90.1e9 - 1) < 1e-3 and abs(d_convs / 92.9e9 - 1) < 1e-3
    # by hand: 2 x 9 x 512 x 512 over the 512-wide convs' positions, the rest layer by layer
    wide = 2 * 9 * 512 * 512
    g_hand = (wide * (16 + 64 + 256 + 1024 + 4096) + wide * (16 + 64 + 256 + 1024)
              + 2 * 9 * (512 * 256 * 64 ** 2 + 256 * 256 * 128 ** 2 + 256 * 128 * 128 ** 2
                         + 128 * 128 * 256 ** 2))
    d_hand = (2 * 9 * (128 * 128 * 256 ** 2 + 128 * 256 * 128 ** 2 + 256 * 256 * 128 ** 2
                       + 256 * 512 * 64 ** 2) + wide * (64 ** 2 + 32 ** 2 + 16 ** 2 + 8 ** 2)
              + wide * (32 ** 2 + 16 ** 2 + 8 ** 2 + 4 ** 2)
              + 2 * (128 * 256 * 128 ** 2 + 256 * 512 * 64 ** 2
                     + 512 * 512 * (32 ** 2 + 16 ** 2 + 8 ** 2 + 4 ** 2)))
    assert (g_convs, d_convs) == (g_hand, d_hand)
    request = 128 * (sg2_flops.forward_flops(g) + 2 * sg2_flops.forward_flops(d))
    assert 35.0e12 < request < 35.6e12
    # at 128 faces the 3x3 convs are bound by their FLOPs; the ToRGBs (3 outputs) by
    # their bytes, 1.03 ms of the 12.86
    bound = sg2_flops.bound_s(128, sg2_flops.synthesis_convs(flags))
    assert 1.10 < bound * flops.PEAK_BF16_FLOPS / (128 * g_convs) < 1.11


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def run(trace=False, seed=2**31 + 77, flags=None):
    with tempfile.TemporaryDirectory() as wd:
        return harness.run_cell(CELL, seed, 0.2, trace, time.perf_counter(), "cpu", wd,
                                root=str(ROOT), traffic_overrides=SMALL_TRAFFIC,
                                flag_overrides={**SMALL_FLAGS, **FP32, **(flags or {})})


def test_sound_run_is_correct():
    result, lines = run()
    assert result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"sample_faces_per_s", "sample_latency_p95_ms", "setup_s"}
    assert set(result["checks"]) == set(harness.config_file(
        harness.benchmark_json(str(ROOT)), "sg2f_ffhq256", str(ROOT))["limits"]["serve"])
    assert not harness.forbidden_modules()


def test_traced_run_on_the_cpu_reads_no_device_metric():
    result, lines = run(trace=True)
    assert result["correct"], lines
    assert result["metrics"] == {}  # no device track, so no device view of a span


def _altered_image(monkeypatch):
    from facegen_torch.utils import infer

    generate = infer.GanInference.generate

    def altered(self, noise):
        images = generate(self, noise)
        images[0] = 1.0 - images[0]
        return images

    monkeypatch.setattr(infer.GanInference, "generate", altered)


def _altered_neighbour(monkeypatch):
    from facegen_torch.utils import infer

    search = infer.nearest_neighbours

    def altered(queries, dataset, k=1):
        idx, dist = search(queries, dataset, k)
        idx[0, 0] = (idx[0, 0] + 1) % dataset.shape[0]
        return idx, dist

    monkeypatch.setattr(infer, "nearest_neighbours", altered)


def _regrouped_scores(monkeypatch):
    """D scores each face in a group of its own copies."""
    from facegen_torch.utils import infer

    score = infer.GanInference.score

    def alone(self, images):
        return torch.cat([score(self, images[i:i + 1].expand(4, *images.shape[1:]))[:1]
                          for i in range(images.shape[0])])

    monkeypatch.setattr(infer.GanInference, "score", alone)


def _no_noise(monkeypatch):
    from facegen_torch.nn import style

    monkeypatch.setattr(style.ModulatedConv2d, "shift", lambda self: self.bias[:, None, None])


def _no_demodulation(monkeypatch):
    from facegen_torch.nn import style

    monkeypatch.setattr(style, "demodulation", lambda weight, styles: torch.ones(
        styles.shape[0], weight.shape[0], device=styles.device))


def _no_mbstd(monkeypatch):
    from facegen_torch.nn import style

    monkeypatch.setattr(style.MinibatchStd, "forward", lambda self, x: torch.cat(
        [x, x.new_zeros(x.shape[0], self.channels, *x.shape[2:])], 1))


FAULTS = [_altered_image, _altered_neighbour, _regrouped_scores, _no_noise, _no_demodulation,
          _no_mbstd]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, lines = run()
    assert not result["correct"], lines


def _fails(numbers):
    limits = harness.config_file(harness.benchmark_json(str(ROOT)), "sg2f_ffhq256",
                                 str(ROOT))["limits"]["serve"]
    return [k for k, limit in limits.items() if not numbers[k] <= limit]


@pytest.mark.parametrize("control", control_sg2.CONTROLS)
def test_control_is_not_correct_small(control):
    numbers = control_sg2.readings(CELL, 2**31 + 5, "cpu", control,
                                   traffic_overrides=SMALL_TRAFFIC, flag_overrides=SMALL_FLAGS,
                                   requests=4)
    assert _fails(numbers), numbers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the controls at the cell's size run on a CUDA card")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("control", control_sg2.CONTROLS)
def test_control_is_not_correct_on_the_card(control, card):
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        numbers = control_sg2.readings(CELL, seed, card, control)
        assert _fails(numbers), (seed, control, numbers)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _reader(name):
    return load_module(os.path.join(BENCH_DIR, "metrics", f"{name}.py"),
                       "bench_metric_" + name.replace(".", "_"))


def _sample_trace(sg2=True):
    """A slice of 10,000 us, two requests: a G call (the synthesis's device
    view 1000-3000 us with 12 kernels, two FIR views of 100 us) and two D
    calls (4000-5000 and 6000-7500 us, a FIR view of 200 us in the first)
    each; without ``sg2`` the same with no sg2.* spans."""
    ev = [_ev("user_annotation", "bench.slice", 0, 10_000)]
    for r in (0, 10_000):
        if sg2:
            ev.append(_ev("gpu_user_annotation", "sg2.synthesis", r + 1000, 2000))
            ev += [_ev("gpu_user_annotation", "sg2.fir", r + t, 100) for t in (1500, 2500)]
            ev.append(_ev("gpu_user_annotation", "sg2.fir", r + 4200, 200))
        ev += [_ev("kernel", "k", r + 1000 + 150 * i, 100) for i in range(12)]
        ev += [_ev("gpu_user_annotation", "infer.score", r + 4000, 1000),
               _ev("gpu_user_annotation", "infer.score", r + 6000, 1500)]
    ev[0]["dur"] = 20_000
    return T.Trace(ev)


def test_readers_on_a_hand_trace():
    facts = {"requests": 2, "synthesis_bound_s": 2e-3, "d_bound_s": 3e-3}
    out = Outcome({}, {}, 2, 0, 0, trace=_sample_trace(), window=(0.0, 20_000.0), facts=facts)
    assert _reader("synthesis_roofline.sg2").read(out) == pytest.approx(100 * 2e-3 / 4e-3)
    assert _reader("d_roofline.sg2").read(out) == pytest.approx(100 * 3e-3 / 5e-3)
    assert _reader("fir_ms.sg2").read(out) == pytest.approx(0.4)
    assert _reader("g_kernels.sg2").read(out) == pytest.approx(12)
    other = Outcome({}, {}, 2, 0, 0, trace=_sample_trace(sg2=False), window=(0.0, 20_000.0),
                    facts=facts)
    for name in ("synthesis_roofline.sg2", "d_roofline.sg2", "fir_ms.sg2", "g_kernels.sg2"):
        assert _reader(name).read(other) is None
        assert _reader(name).read(Outcome({}, {}, 0, 0, 0)) is None
