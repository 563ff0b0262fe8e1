"""``correct`` has to fail where the timed path is wrong.

On the CPU, each cell runs small through the harness with the program in
fp32 (its sound runs then read near 0), once sound, which must come out
correct, and once with each fault the cell can have planted under it:
a step that leaves the state unchanged, half of the batch left out of the
loss (the mean over the rest), an answer altered where it is produced
(a face, a neighbour, a ranking, approxParzen's distance of a row).
(No cell spans chips, so none can leave out an exchange between them.)
The control, the reference in the precision below the configuration's,
must come out not correct on every cell: small on the CPU here, and at
the cell's own size on the card (``cuda`` marker).
"""

import json
import sys
import tempfile
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import control  # noqa: E402
from benchmark.lib import harness  # noqa: E402

SMALL = {
    "gan32_train": ({"store_images": 200}, {"n_epoch": 32, "epochs_per_compile": 1}),
    "c2f32_train": ({"store_images": 200},
                    {"n_epoch": 32, "val_size": 24, "parzen_samples": 6}),
    "gan32_sample": ({"store_images": 200, "faces": 32, "traced_requests": 2,
                      "check_every": 2}, {}),
}
FP32 = {"compute_dtype": "float32"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout whose BENCHMARK.json also names the cells held out of it
    (benchmark/held/*.json), so that their checks stay tested."""
    tmp = tmp_path_factory.mktemp("checkout")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for path in sorted((ROOT / "benchmark" / "held").glob("*.json")):
        held = json.loads(path.read_text())
        for key in ("configs", "workloads", "per_layer"):
            bench[key] += held[key]
        for metric in bench["end_to_end"] + bench["per_layer"]:
            metric.get("workloads", []).extend(held["also_in"].get(metric["name"], []))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp / "benchmark").symlink_to(ROOT / "benchmark")
    return str(tmp)


def run(cell, root, seed=2**31 + 77):
    traffic, flags = SMALL[cell]
    with tempfile.TemporaryDirectory() as wd:
        result, lines = harness.run_cell(cell, seed, 0.2, False, time.perf_counter(), "cpu", wd,
                                         root=root, traffic_overrides=traffic,
                                         flag_overrides={**flags, **FP32})
    return result, lines


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell, root):
    result, lines = run(cell, root)
    assert result["correct"], lines
    assert not harness.forbidden_modules()


def _unchanged_state(monkeypatch):
    from facegen_torch.ops import fused_update

    monkeypatch.setattr(fused_update, "update", lambda *args, **kwargs: None)


def _half_batch(monkeypatch):
    from facegen_torch.train import losses

    full = losses.bce_with_logits

    def half(logits, targets, rows=None):
        n = logits.shape[0] // 2
        return full(logits[:n], targets[:n], rows)

    monkeypatch.setattr(losses, "bce_with_logits", half)


def _altered_parzen_row(monkeypatch):
    from facegen_torch.train import c2f

    distances = c2f.parzen_distances

    def altered(g, cfg, pool, idx, noise):
        out = distances(g, cfg, pool, idx, noise)
        moved = idx.clone()
        moved[0] = (idx[0] + 1) % pool.size
        out[0] = distances(g, cfg, pool, moved, noise)[0]
        return out

    monkeypatch.setattr(c2f, "parzen_distances", altered)


def _altered_neighbour(monkeypatch):
    from facegen_torch.utils import infer

    search = infer.nearest_neighbours

    def altered(queries, dataset, k=1):
        idx, dist = search(queries, dataset, k)
        idx[0, 0] = (idx[0, 0] + 1) % dataset.shape[0]
        return idx, dist

    monkeypatch.setattr(infer, "nearest_neighbours", altered)


def _altered_image(monkeypatch):
    from facegen_torch.utils import infer

    generate = infer.GanInference.generate

    def altered(self, noise):
        images = generate(self, noise)
        images[0] = 1.0 - images[0]
        return images

    monkeypatch.setattr(infer.GanInference, "generate", altered)


def _half_ranked(monkeypatch):
    from facegen_torch.utils import infer

    score = infer.GanInference.score

    def half(self, images):
        s = score(self, images)
        n = s.shape[0] // 2
        return torch.cat([s[:n], s[:n]])[:s.shape[0]]

    monkeypatch.setattr(infer.GanInference, "score", half)


FAULTS = [("gan32_train", _unchanged_state), ("gan32_train", _half_batch),
          ("c2f32_train", _unchanged_state), ("c2f32_train", _half_batch),
          ("c2f32_train", _altered_parzen_row),
          ("gan32_sample", _altered_image), ("gan32_sample", _altered_neighbour),
          ("gan32_sample", _half_ranked)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch, root):
    fault(monkeypatch)
    result, lines = run(cell, root)
    assert not result["correct"], lines


def _limits(cell, root):
    bench = harness.benchmark_json(root)
    config = harness.config_file(bench, harness.find_cell(bench, cell)["config"], root)
    kind = "serve" if "sample" in harness.traffic_file(
        harness.find_cell(bench, cell)["traffic"])["entry"] else "train"
    return config["limits"][kind]


def _fails(cell, numbers, root):
    return [k for k, limit in _limits(cell, root).items() if not numbers[k] <= limit]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct_small(cell, root):
    traffic, flags = SMALL[cell]
    numbers = control.readings(cell, 2**31 + 5, "cpu", root, traffic_overrides=traffic,
                               flag_overrides=flags, requests=8)
    assert _fails(cell, numbers, root), numbers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control at the cells' sizes runs on a CUDA card")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct_on_the_card(cell, card, root):
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        numbers = control.readings(cell, seed, card, root)
        assert _fails(cell, numbers, root), (seed, numbers)
