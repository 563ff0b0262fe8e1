"""The program's spans (utils/profiling.py:span) on the CPU: nothing but a
flag read while no profiler records, and under ``profiling.trace`` each
span where its layer's work happens, as often as that work happens and
inside the span that encloses it on the host.

The card's side (one ``step.replay`` span a replay, its device view and
its kernels) is in test_torch_port_cuda.py. This file imports no JAX.
"""

import gzip
import json

import pytest
import torch

import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen_torch.config import C2FConfig, train_config_from_args
from facegen_torch.train.c2f import C2FTrainer
from facegen_torch.train.loop import Trainer
from facegen_torch.train.step import steps_per_epoch
from facegen_torch.utils import profiling
from facegen_torch.utils.infer import nearest_neighbours, prepare_nn_dataset

TINY = ["--syntheticData", "--scale", "16", "--grayscale", "--batchSize", "8", "--noiseDim", "8",
        "--N_epoch", "16", "--noplot", "--saveFreq", "1"]


def _trainer(tmp_path):
    trainer = Trainer(train_config_from_args(TINY + ["--save", str(tmp_path / "logs")]),
                      device="cpu", verbose=False)
    trainer.save = lambda: None  # the chunk still calls it, inside loop.save
    return trainer


def _request(trainer, seed: int = 0):
    """A sampler request on the trainer's nets, as the sampler makes it:
    generate, the best and the worst by D, the best's nearest neighbours."""
    inf = trainer.inf
    images = inf.generate(inf.noise(torch.Generator().manual_seed(seed), 16))
    best, _ = inf.rank(images, ascending=False, max_out=4)
    inf.rank(images, ascending=True, max_out=4)
    search = prepare_nn_dataset(trainer.source.range_pool(0, 32), "cpu")
    return nearest_neighbours(best[:2], search)


def _spans(logdir) -> list:
    """(name, start, end) of the host ranges in the newest trace under ``logdir``."""
    with gzip.open(profiling._newest_trace(str(logdir)), "rt") as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                  key=lambda s: (s[1], -s[2]))


def _count(spans, name):
    return sum(1 for s in spans if s[0] == name)


def _parent(spans, child):
    """The name of the innermost range that encloses ``child``, or None."""
    _, s, e = child
    around = [p for p in spans if p is not child and p[1] <= s and e <= p[2]]
    return min(around, key=lambda p: p[2] - p[1])[0] if around else None


def test_span_is_one_shared_no_op_unless_a_profiler_records():
    off = profiling.span("step.draw")
    assert off is profiling.span("loop.pools")
    with off, off:  # reentrant, as nested spans need
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = profiling.span("step.draw")
        assert isinstance(on, torch.profiler.record_function) and on is not off
    assert profiling.span("step.draw") is off


def test_no_record_function_call_while_no_profiler_records(tmp_path, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    trainer = _trainer(tmp_path)
    trainer.train_epochs_chunk(0, 2)
    _request(trainer)
    assert calls == []
    # the same work under a profiler reaches the patched call
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.train_epochs_chunk(2, 1)
        _request(trainer, 1)
    assert {"data.pool", "step.draw", "step.eager", "loop.readback", "infer.generate",
            "infer.nn.readback"} <= set(calls)


def test_a_traced_chunk_holds_each_span_once_per_unit_of_work(tmp_path):
    trainer = _trainer(tmp_path)
    epochs = 2
    steps = epochs * steps_per_epoch(trainer.cfg, trainer.pool_n)
    with profiling.trace(str(tmp_path / "trace")):
        trainer.train_epochs_chunk(0, epochs)
    spans = _spans(tmp_path / "trace")
    counts = {n: _count(spans, n) for n in ("data.pool", "loop.pools", "loop.summary",
                                            "loop.readback", "loop.save", "step.draw",
                                            "step.eager", "step.replay")}
    # the CPU route runs every step eagerly: no replay
    assert counts == {"data.pool": epochs, "loop.pools": 1, "loop.summary": epochs,
                      "loop.readback": 1, "loop.save": 1, "step.draw": steps,
                      "step.eager": steps, "step.replay": 0}
    for s in spans:
        if s[0] == "data.pool":
            assert _parent(spans, s) == "loop.pools"
        if s[0] == "step.draw":
            assert _parent(spans, s) == "step.eager"
    readback = next(s for s in spans if s[0] == "loop.readback")
    assert all(s[2] <= readback[1] for s in spans if s[0].startswith("step."))


def test_a_traced_sampler_request_nests_its_spans_as_the_sampler_calls_them(tmp_path):
    trainer = _trainer(tmp_path)
    with profiling.trace(str(tmp_path / "trace")):
        with torch.profiler.record_function("request"):
            _request(trainer)
    spans = [s for s in _spans(tmp_path / "trace")
             if s[0] == "request" or s[0].startswith("infer.")]
    assert [s[0] for s in spans] == [
        "request", "infer.generate",
        "infer.score", "infer.rank",  # best: D's scores, then the sort and the gather
        "infer.score", "infer.rank",  # worst
        "infer.nn.search", "infer.nn.readback"]
    # each lies directly in the request, none inside another
    assert all(_parent(spans, s) == "request" for s in spans[1:])
    assert all(a[2] <= b[1] for a, b in zip(spans[1:], spans[2:]))


def test_the_c2f_trainer_gets_the_step_and_pool_spans(tmp_path):
    cfg = C2FConfig(batch_size=8, n_epoch=12, fine_size=8, coarse_size=4, grayscale=True,
                    compute_dtype="float32", seed=3, val_size=16, parzen_samples=8,
                    synthetic_data=True, noplot=True, save=str(tmp_path / "logs")).validate()
    trainer = C2FTrainer(cfg, device="cpu", verbose=False)
    with profiling.trace(str(tmp_path / "trace")):
        trainer.train_epoch(0)
    spans = _spans(tmp_path / "trace")
    steps = steps_per_epoch(cfg, trainer.pool_n)
    assert _count(spans, "data.pool") == 1
    assert _count(spans, "step.draw") == _count(spans, "step.eager") == steps
    assert all(_parent(spans, s) == "step.eager" for s in spans if s[0] == "step.draw")


def test_aggregate_trace_sums_no_span_views(tmp_path):
    """The summary has no sum over the spans' device views, which nested
    spans would count twice; the table's header gives the leaf ops' time."""
    trainer = _trainer(tmp_path)
    with profiling.trace(str(tmp_path / "trace")):
        trainer.train_epochs_chunk(0, 1)
    summary = profiling.aggregate_trace(str(tmp_path / "trace"))
    assert "module_total_us" not in summary
    assert "module track" not in profiling.format_op_table(summary)


@pytest.mark.parametrize("name", ["step.draw", "infer.nn.search", "loop.readback"])
def test_span_names_the_range_it_records(name):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span(name):
            torch.ones(4).sum()
    assert name in {e.key for e in prof.key_averages()}
