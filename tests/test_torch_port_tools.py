"""The port's tooling against facegen's, on the CPU: the generator export
and its NumPy server, the profiler's per-op table, the metrics log, the
dashboard, the checkpoint inspector, and the trainer's trace_dir and
debug_nans.

Tolerances: the export's arrays, keys and metadata, the dashboard's
bodies and the inspector's leaf counts are equal; ``NumpyGenerator``
against the port's fp32 G within 1e-5 (rtol and atol), facegen's own
bound for its NumPy forward against its G (tests/test_export.py).
"""

import dataclasses
import glob
import gzip
import json
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen.config import TrainConfig as JaxTrainConfig
from facegen.export import export_generator as jax_export_generator
from facegen.models import gan as jax_gan
from facegen.utils.checkpoint import flatten_tree
from facegen.utils.grids import save_png as jax_save_png
from facegen.utils.viewer import serve as jax_serve
from facegen_torch import export
from facegen_torch.config import TrainConfig
from facegen_torch.models import gan
from facegen_torch.train.loop import Trainer, resolve_epochs_per_compile
from facegen_torch.utils import checkpoint as ckpt
from facegen_torch.utils import profiling, viewer
from facegen_torch.utils.grids import save_png
from facegen_torch.utils.infer import GanInference

TINY = dict(scale=16, grayscale=True, noise_dim=8, batch_size=8, n_epoch=24,
            synthetic_data=True, compute_dtype="float32", reference_init=False)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale,channels", [(32, 3), (16, 1)])
def test_export_equals_facegens_export_of_the_same_weights(tmp_path, scale, channels):
    _, _, bundle = jax_gan.init_gan(jax.random.key(scale), scale, channels, 100)
    arrays = {f"{root}/{k}": v for root in ("params_g", "state_g", "params_d", "state_d")
              for k, v in flatten_tree(bundle[root]).items()}
    g, _ = gan.init_gan(torch.Generator().manual_seed(0), scale, channels, 100)
    g.load_state_dict(ckpt.jax_to_torch(arrays)["g"], strict=True)
    ours = export.export_generator(g, str(tmp_path / "ours.npz"), scale, channels, 100)
    theirs = jax_export_generator(bundle, str(tmp_path / "theirs.npz"), scale, channels, 100)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "params/00_fc/w" in a.files and "state/04_batch_norm/mean" in a.files
        assert json.loads(str(a["__meta__"])) == json.loads(str(b["__meta__"]))
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _trained_like_g(scale, channels, noise_dim):
    """A port G with weights away from init's flat output (kernels x6,
    statistics moved)."""
    g, d = gan.init_gan(torch.Generator().manual_seed(3), scale, channels, noise_dim,
                        reference_init=False)
    with torch.no_grad():
        for name, t in g.state_dict().items():
            if name.endswith("weight") and t.dim() > 1:
                t.mul_(6.0)
            elif name.endswith(("running_mean", "running_var")):
                t.mul_(2.0).add_(0.05)
    return g, d


@pytest.mark.parametrize("scale,channels", [(32, 3), (16, 1)])
def test_numpy_generator_matches_the_ports_g(tmp_path, scale, channels):
    g, _ = _trained_like_g(scale, channels, 20)
    gen = export.NumpyGenerator(export.export_generator(g, str(tmp_path / "g.npz"), scale,
                                                        channels, 20))
    z = np.random.RandomState(1).uniform(-1, 1, (6, 20)).astype(np.float32)
    ours = gen(z)
    ref = GanInference(g, g, 20, compute_dtype=torch.float32).generate(torch.from_numpy(z))
    assert ours.shape == (6, scale, scale, channels)
    np.testing.assert_allclose(ours, ref.numpy(), rtol=1e-5, atol=1e-5)
    assert ref.std() > 0.05  # not init's flat 0.5


def test_export_cli_from_a_port_checkpoint(tmp_path, capsys):
    g, d = _trained_like_g(16, 3, 12)
    ckpt.save_gan(str(tmp_path / "logs"), "adversarial", g, d,
                  {"scale": 16, "grayscale": False, "noise_dim": 12, "noise_view": "nhwc"})
    out = str(tmp_path / "out" / "g.npz")
    export.main(["--save", str(tmp_path / "logs"), "--network", "adversarial", "--out", out])
    assert f"exported {out}" in capsys.readouterr().out
    gen = export.NumpyGenerator(out)
    assert (gen.scale, gen.channels, gen.noise_dim) == (16, 3, 12)
    z = np.random.RandomState(2).uniform(-1, 1, (3, 12)).astype(np.float32)
    ref = GanInference(g, d, 12, compute_dtype=torch.float32).generate(torch.from_numpy(z))
    np.testing.assert_allclose(gen(z), ref.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def _write_trace(logdir, name, events, devices=()):
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, name + profiling.TRACE_SUFFIX)
    with gzip.open(path, "wt") as f:
        json.dump({"schemaVersion": 1, "deviceProperties": [{"id": i, "name": n}
                                                             for i, n in enumerate(devices)],
                   "traceEvents": events}, f)
    return path


def test_aggregate_trace_keeps_the_gpu_tracks(tmp_path):
    """Kernels, copies and fills on the GPU's tracks enter the table; the
    host's runtime calls and CPU ops do not; kernels carry no rates,
    copies and fills their bytes' rate; the newest trace is read."""
    logdir = str(tmp_path)
    old = _write_trace(logdir, "host_1.1", [
        {"ph": "X", "cat": "kernel", "name": "stale", "pid": 0, "tid": 7, "ts": 0, "dur": 9}])
    os.utime(old, (1, 1))
    meta = [
        {"ph": "M", "name": "process_name", "pid": 4242, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
    ]
    fwd = "void UpconvFwd<__nv_bfloat16, 128>(UpconvParams)"
    events = meta + [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 4242, "tid": 4242, "ts": 0,
         "dur": 500},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 4242,
         "tid": 4242, "ts": 1, "dur": 7},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step", "pid": 0, "tid": 7, "ts": 0,
         "dur": 60},
        {"ph": "X", "cat": "kernel", "name": fwd, "pid": 0, "tid": 7, "ts": 10, "dur": 10,
         "args": {"device": 0, "stream": 7, "registers per thread": 168}},
        {"ph": "X", "cat": "kernel", "name": fwd, "pid": 0, "tid": 7, "ts": 30, "dur": 12.5},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm", "pid": 0, "tid": 7, "ts": 50,
         "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "pid": 0,
         "tid": 7, "ts": 90, "dur": 4, "args": {"bytes": 4000}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "tid": 7,
         "ts": 95, "dur": 0.5, "args": {"bytes": 1000}},
        {"ph": "i", "cat": "kernel", "name": "instant", "pid": 0, "tid": 7, "ts": 99},
    ]
    _write_trace(logdir, "host_1.2", events, devices=["NVIDIA H100 80GB HBM3"])
    s = profiling.aggregate_trace(logdir)
    assert s["device"] == "NVIDIA H100 80GB HBM3"
    assert s["total_us"] == 57.0 and s["module_total_us"] == 60.0
    rows = {r["name"]: r for r in s["ops"]}
    assert [r["name"] for r in s["ops"]] == ["sm90_xmma_gemm", fwd,
                                             "Memcpy HtoD (Pageable -> Device)",
                                             "Memset (Device)"]
    assert rows[fwd]["total_us"] == 22.5 and rows[fwd]["calls"] == 2
    assert rows[fwd]["category"] == "kernel" and rows[fwd]["share"] == 22.5 / 57.0
    assert rows[fwd]["tflops"] is None and rows[fwd]["gbps"] is None
    assert rows["Memcpy HtoD (Pageable -> Device)"]["gbps"] == pytest.approx(1.0)
    assert rows["Memset (Device)"]["gbps"] == pytest.approx(2.0)
    cats = {c["category"]: (c["total_us"], c["calls"]) for c in s["categories"]}
    assert cats == {"kernel": (52.5, 3), "gpu_memcpy": (4.0, 1), "gpu_memset": (0.5, 1)}
    assert [r["name"] for r in profiling.aggregate_trace(logdir, top=2)["ops"]] == [
        "sm90_xmma_gemm", fwd]
    assert len(profiling.aggregate_trace(logdir, min_share=0.1)["ops"]) == 2
    table = profiling.format_op_table(s)
    assert "| kernel | 52 | 3 | 92.1% |" in table
    assert "| n/a | n/a |" in table and "aten::mm" not in table and "stale" not in table


def test_trace_round_trip_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = glob.glob(os.path.join(logdir, "*" + profiling.TRACE_SUFFIX))
    with gzip.open(path, "rt") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    s = profiling.aggregate_trace(logdir)
    assert s["device"] == "host (no device track)"
    assert s["total_us"] == 0.0 and s["ops"] == [] and s["categories"] == []
    assert "leaf-op time 0.00 ms" in profiling.format_op_table(s)
    with pytest.raises(FileNotFoundError):
        profiling.aggregate_trace(str(tmp_path / "none"))


def test_metrics_logger_reads_back_its_rows(tmp_path):
    log = profiling.MetricsLogger(str(tmp_path / "run"))
    assert log.read_all() == []
    log.log({"epoch": 1, "loss": 0.5})
    log.log({"epoch": 2, "loss": 0.25})
    with open(log.path, "a") as f:
        f.write("\n{\"epoch\": 3, \"lo")  # a blank line and a torn append
    rows = log.read_all()
    assert [(r["epoch"], r["loss"]) for r in rows] == [(1, 0.5), (2, 0.25)]
    assert all("time" in r for r in rows)


# ---------------------------------------------------------------------------
# the dashboard and the checkpoint inspector
# ---------------------------------------------------------------------------


def test_viewer_serves_what_facegens_serves(tmp_path):
    base = str(tmp_path)
    profiling.MetricsLogger(base).log({"epoch": 1, "loss": 0.4})
    img = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    save_png(os.path.join(base, "viz", "samples_fixed.png"), img)
    jax_save_png(os.path.join(base, "viz", "netvis", "e0001_s00004", "00_fc.png"), img)
    servers = [viewer.serve(base, port=0, background=True), jax_serve(base, port=0,
                                                                       background=True)]
    try:
        def get(server, path):
            url = f"http://127.0.0.1:{server.server_address[1]}{path}"
            try:
                with urllib.request.urlopen(url, timeout=30) as r:
                    return r.status, r.headers["Content-Type"], r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.headers["Content-Type"], e.read()

        for path in ("/", "/metrics", "/img/samples_fixed.png",
                     "/img/netvis/e0001_s00004/00_fc.png", "/img/../metrics.jsonl",
                     "/img/missing.png"):
            ours, theirs = (get(s, path) for s in servers)
            assert ours == theirs, path
        status, _, page = get(servers[0], "/")
        assert status == 200 and b"samples_fixed.png" in page and b"&quot;epoch&quot;: 1" in page
        assert get(servers[0], "/img/missing.png")[0] == 404
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


def test_show_model_content_reads_a_port_checkpoint(tmp_path, capsys):
    from facegen.train.loop import Trainer as JaxTrainer

    import show_model_content

    kw = dict(TINY, noplot=True)
    Trainer(TrainConfig(save=str(tmp_path / "torch"), **kw), device="cpu",
            verbose=False).save()
    JaxTrainer(JaxTrainConfig(save=str(tmp_path / "jax"), **kw), verbose=False).save()
    out = {}
    for which in ("torch", "jax"):
        show_model_content.main(["--save", str(tmp_path / which), "--network", "adversarial"])
        out[which] = capsys.readouterr().out.splitlines()
    def leaves(lines):
        return lines[next(i for i, ln in enumerate(lines) if ln.startswith("arrays:")):]

    assert leaves(out["torch"]) == leaves(out["jax"])
    assert "epoch: 1" in out["torch"] and "  scale = 16" in out["torch"]
    assert any(ln.startswith("  params_g: ") for ln in out["torch"])


# ---------------------------------------------------------------------------
# the trainer's trace_dir and debug_nans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("epc,noplot,wvf", [(0, True, 0), (0, False, 0), (4, True, 0),
                                            (4, False, 2), (1, True, 0)])
def test_trace_dir_resolves_epochs_per_compile_like_facegen(tmp_path, capsys, epc, noplot,
                                                            wvf):
    from facegen.train.loop import Trainer as JaxTrainer

    kw = dict(TINY, epochs_per_compile=epc, noplot=noplot, weights_vis_freq=wvf,
              save=str(tmp_path), trace_dir=str(tmp_path / "trace"))
    ours_log = []
    ours = resolve_epochs_per_compile(TrainConfig(**kw), ours_log.append)
    capsys.readouterr()
    theirs = JaxTrainer(JaxTrainConfig(**kw), verbose=True).epochs_per_compile
    theirs_log = [ln for ln in capsys.readouterr().out.splitlines() if "epochsPerCompile" in ln]
    assert ours == theirs == 1
    assert ours_log == theirs_log
    assert any("--traceDir" in ln for ln in ours_log) == (epc > 1 and wvf == 0)


def test_trace_dir_traces_the_second_epoch_as_facegen_does(tmp_path):
    """Epoch index 1 runs whole under the profiler and, with
    --weightsVisFreq, dumps once after its last step, where facegen's
    traced epoch dumps; it trains what an untraced epoch trains."""
    from facegen.train.loop import Trainer as JaxTrainer

    kw = dict(TINY, noplot=True, weights_vis_freq=4)
    theirs = JaxTrainer(JaxTrainConfig(save=str(tmp_path / "jax"),
                                       trace_dir=str(tmp_path / "jax_trace"), **kw),
                        verbose=False)
    for i in range(2):
        theirs.train_epoch(i)
    cfg = TrainConfig(save=str(tmp_path / "torch"), trace_dir=str(tmp_path / "trace"), **kw)
    ours = Trainer(cfg, device="cpu", verbose=False)
    assert ours.epochs_per_compile == 1
    ours.train_epoch(0)
    assert not os.path.exists(cfg.trace_dir)
    ours.train_epoch(1)
    assert len(glob.glob(os.path.join(cfg.trace_dir, "*" + profiling.TRACE_SUFFIX))) == 1
    assert profiling.aggregate_trace(cfg.trace_dir)["device"] == "host (no device track)"

    def tree(root):
        base = os.path.join(root, "viz", "netvis")
        return sorted((os.path.relpath(d, base), sorted(f)) for d, _, f in os.walk(base))

    listing = tree(cfg.save)
    assert listing == tree(str(tmp_path / "jax"))
    assert [d for d, _ in listing if d.endswith("/g")] == [
        "e0001_s00004/g", "e0001_s00006/g", "e0003_s00006/g"]
    plain = Trainer(dataclasses.replace(cfg, trace_dir=None, save=str(tmp_path / "plain")),
                    device="cpu", verbose=False)
    plain.train_epoch(0)
    plain.train_epoch(1)
    for a, b in zip(ours.state.g.state_dict().values(), plain.state.g.state_dict().values()):
        assert torch.equal(a, b)


def test_debug_nans_raises_on_a_nan_weight_and_names_the_module(tmp_path):
    cfg = TrainConfig(save=str(tmp_path), noplot=True, debug_nans=True, **TINY)
    try:
        trainer = Trainer(cfg, device="cpu", verbose=False)
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        trainer.train_epoch(0)  # finite weights: the checks pass
        with torch.no_grad():
            trainer.state.g.get_submodule("00_fc").weight[0, 0] = float("nan")
        with pytest.raises(FloatingPointError, match=r"module Sequential/00_fc \(Dense"):
            trainer.train_epoch(1)
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
    g = gan.init_gan(torch.Generator().manual_seed(0), 16, 1, 8)[0]
    with torch.no_grad():
        g.get_submodule("00_fc").weight[0, 0] = float("nan")
        assert torch.isnan(g(torch.rand(2, 8))).any()  # off: nothing checks


def test_nan_debugging_checks_module_outputs_in_a_nest():
    inner = torch.nn.Sequential(torch.nn.Linear(3, 3), torch.nn.Linear(3, 3))
    outer = torch.nn.Sequential(torch.nn.ReLU(), torch.nn.ModuleDict({"blk": inner})["blk"])
    with torch.no_grad():
        inner[1].bias[1] = float("inf")
    profiling.enable_nan_debugging(True)
    try:
        with pytest.raises(FloatingPointError, match=r"module Sequential/1/1 \(Linear"):
            outer(torch.ones(2, 3))
        with torch.no_grad():
            inner[1].bias[1] = 0.0
        assert torch.isfinite(outer(torch.ones(2, 3))).all()  # the stack was unwound
    finally:
        profiling.enable_nan_debugging(False)
