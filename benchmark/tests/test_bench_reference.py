"""The plain references against the port, at small sizes on the CPU, in
fp32: the pools, the nets' forward passes, approxParzen; and the
references' own sources import nothing of the port."""

import ast
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import faces, weights  # noqa: E402
from benchmark.reference import c2f_gd_dc, common as C, g32_d32b  # noqa: E402


@pytest.fixture(scope="module")
def store():
    return faces.make_store(C.seeded_generator("cpu", 3, 1), 96)


def test_references_import_nothing_of_the_program():
    for path in sorted((ROOT / "benchmark" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("facegen_torch", "facegen", "jax"), (path, name)


def test_pools_match_the_port(store):
    from facegen_torch.data.c2f import make_triples
    from facegen_torch.data.pipeline import DataSource

    for holdout, scale in ((0, 32), (20, 32), (0, 16)):
        src = DataSource(scale, 3, torch.device("cpu"), store=store, holdout=holdout)
        got = src.epoch_pool(C.seeded_generator("cpu", 5, 10_000, 0), 40)
        want = C.epoch_pool(store, C.seeded_generator("cpu", 5, 10_000, 0), 40, scale, holdout)
        assert torch.equal(got, want)
    fine = DataSource(32, 3, torch.device("cpu"), store=store).range_pool(0, 20)
    assert torch.equal(fine, C.to_u8(C.resize(store[:20].float() / 255.0, 32)))
    port = make_triples(fine, 16)
    ref = c2f_gd_dc.triples(fine)
    assert torch.equal(port.coarse, ref[1]) and torch.equal(port.fine, ref[0])


def _load(module, leaves, seed):
    values = weights.make(leaves, C.seeded_generator("cpu", seed, 2))
    weights.load_into(module, leaves, values)
    return values


@pytest.mark.parametrize("init", ["reference", "he"])
def test_gan_nets_match_the_port(init):
    from facegen_torch.models import gan

    g, d = gan.init_gan(torch.Generator().manual_seed(0), 32, 3, 100, reference_init=False)
    gp = _load(g, g32_d32b.leaves("g", init), 1)
    dp = _load(d, g32_d32b.leaves("d", init), 2)
    z = C.noise(C.seeded_generator("cpu", 4), (8, 100))
    with torch.no_grad():
        images = g.eval()(z)
        assert torch.allclose(images, g32_d32b.generate(gp, z, False), atol=1e-5)
        assert torch.allclose(g.train()(z), g32_d32b.generate(gp, z, True), atol=1e-5)
        logits = d.eval()(images)
        assert torch.allclose(logits, g32_d32b.discriminate(dp, images), rtol=1e-4, atol=1e-6)


def test_c2f_nets_and_parzen_match_the_port(store):
    from facegen_torch.config import C2FConfig
    from facegen_torch.data.c2f import make_triples
    from facegen_torch.models import c2f
    from facegen_torch.train.c2f import parzen_distances

    g, d = c2f.init_c2f(torch.Generator().manual_seed(0), 32, 3)
    gp = _load(g, c2f_gd_dc.leaves("g"), 1)
    dp = _load(d, c2f_gd_dc.leaves("d"), 2)
    fine = C.to_u8(C.resize(store[:12].float() / 255.0, 32))
    pool = make_triples(fine, 16)
    coarse = pool.coarse.float() / 255.0
    z = C.noise(C.seeded_generator("cpu", 4), (12, 32, 32, 1))
    with torch.no_grad():
        diff = g.eval()((z, coarse))
        assert torch.allclose(diff, c2f_gd_dc.generate(gp, z, coarse), atol=1e-5)
        assert torch.allclose(d.eval()((diff, coarse)), c2f_gd_dc.discriminate(dp, diff, coarse),
                              rtol=1e-4, atol=1e-6)
    cfg = C2FConfig(compute_dtype="float32", parzen_samples=6)
    gen = C.seeded_generator("cpu", 9)
    idx = torch.randint(0, 12, (6,), generator=gen)
    noise = torch.rand(6, 4, 32, 32, 1, generator=gen) * 2.0 - 1.0
    got = parzen_distances(g, cfg, pool, idx, noise)
    want = c2f_gd_dc.parzen(gp, c2f_gd_dc.triples(fine), C.seeded_generator("cpu", 9), 6, 4,
                            block=4)
    assert torch.allclose(got, want, rtol=1e-5)
