"""The sampler as a closed loop with one client: request after request of
``sample.run_sampling``'s device path, without its PNG encoding.

A request: ``faces`` noise vectors drawn from the seed and the request's
index; ``GanInference.generate``; ``rank`` for the best and the worst
``ranked`` by D (two D passes, as the sampler makes them); the
``nearest_neighbours`` of the ``queries`` best over the store at the
net's scale, which ``prepare_nn_dataset`` prepared once in set-up; the
images, both rankings and the neighbours' indices read back to the host.
A request is timed from its start to its results on the host.

Set-up: the store, the weights (``weights.serve`` of the configuration)
from the seed, G and D, the search's rows, and ``warm`` requests.

``correct``, for a sample of the requests drawn from the seed, after the
window: the images against the reference's G on the same noise; the
scores the program gave its rankings against the reference's D on the
ranked images; how far the k-th image of a ranking lies below the
reference's k-th best of the request's images, in the reference logits'
standard deviations; and how much farther each neighbour found lies than
the nearest row of the reference's own search rows, as a share.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from benchmark.lib import checks, flops, harness, stats, weights
from benchmark.lib import window as W
from benchmark.reference import common as C

NOISE_WORD = 30_000


def request_noise(dev, seed: int, index: int, n: int, noise_dim: int) -> torch.Tensor:
    return C.noise(C.seeded_generator(dev, seed, NOISE_WORD, index), (n, noise_dim))


def sampled(seed: int, count: int, every: int):
    """The requests ``correct`` compares: one in ``every``, from an offset
    drawn from the seed, and the first."""
    offset = int(np.random.SeedSequence([seed, 31_000]).generate_state(1)[0]) % every
    return [0] + [i for i in range(offset, count, every) if i != 0]


def run(cell: harness.Cell) -> harness.Outcome:
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.models import gan
    from facegen_torch.utils.infer import GanInference, nearest_neighbours, prepare_nn_dataset

    ref, store, g_leaves, d_leaves, g0, d0 = harness.inputs(cell, "serve")
    dev = torch.device(cell.device)
    flags, tr, seed = cell.config["flags"], cell.traffic, cell.seed
    n, ranked, queries = tr["faces"], tr["ranked"], tr["queries"]
    noise_dim, scale = flags["noise_dim"], flags["scale"]
    log = open(os.path.join(cell.workdir, "program.log"), "w")
    with log, contextlib.redirect_stdout(log):
        g, d = gan.init_gan(torch.Generator().manual_seed(seed), scale, 3, noise_dim,
                            reference_init=False, device=dev)
        weights.load_into(g, g_leaves, g0)
        weights.load_into(d, d_leaves, d0)
        inf = GanInference(g, d, noise_dim, getattr(torch, flags["compute_dtype"]))
        rows = torch.cat([prepare_pool(store[s:s + 8192], scale, 3)
                          for s in range(0, store.shape[0], 8192)])
        search = prepare_nn_dataset(rows, dev)
        del rows

        kept, latencies = {}, []
        keep = set(sampled(seed, tr["max_requests"], tr["check_every"]))

        def request(i: int, spans: bool = False):
            t = time.perf_counter()
            z = request_noise(dev, seed, i, n, noise_dim)
            with W.span("inference.generate", spans):
                images = inf.generate(z)
            with W.span("inference.rank", spans):
                best, best_scores = inf.rank(images, ascending=False, max_out=ranked)
                worst, worst_scores = inf.rank(images, ascending=True, max_out=ranked)
            with W.span("inference.nearest_neighbours", spans):
                nn_idx, _ = nearest_neighbours(best[:queries], search)
            host = [x.cpu() for x in (images, best, best_scores, worst, worst_scores)]
            latencies.append(time.perf_counter() - t)
            if i in keep:
                kept[i] = (*host, torch.from_numpy(nn_idx[:, 0]))

        for i in range(tr["warm"]):  # indices past any the window reaches
            request(tr["max_requests"] + i)
        W.synchronize(dev)
        outcome = harness.Outcome({}, {}, 0, 0, 0)
        setup_s = time.perf_counter() - cell.started
        latencies.clear()
        count = 0

        def next_request(spans=False):
            nonlocal count
            if count >= tr["max_requests"]:
                raise RuntimeError(f"more than {tr['max_requests']} requests in the window")
            request(count, spans)
            count += 1

        if cell.trace:
            outcome.trace, outcome.window = W.run_traced(
                lambda: [next_request(True) for _ in range(tr["traced_requests"])], dev,
                cell.workdir)
            outcome.breakdown = W.breakdown(outcome.trace, outcome.window)
        else:
            _, window_s = W.run_window(next_request, cell.seconds)
            outcome.metrics = {"sample_faces_per_s": stats.rate(n * count, window_s),
                               "sample_latency_p95_ms": 1e3 * stats.percentile(latencies, 95),
                               "setup_s": setup_s}
        outcome.attempted, outcome.failed = count, 0
        outcome.memory_peak_bytes = W.peak_memory(dev)
        del inf, g, d, search
    W.free(dev)

    g_img, d_img = flops.forward_flops(ref.G_LAYERS), flops.forward_flops(ref.D_LAYERS)
    request_flops = n * g_img + 2 * n * d_img + 2 * queries * store.shape[0] * 3 * scale * scale
    fwd_bound = sum(flops.upconv_launches(n, h, cin, cout)[0] for h, cin, cout in ref.UPCONVS)
    outcome.facts = {"requests": count, "model_flops": count * request_flops,
                     "upconv_bound_s": count * fwd_bound}
    outcome.notes.append(f"requests compared: {sorted(k for k in kept if k < count)}")

    numbers = judge(ref, kept, count, store, g0, d0, seed, n, noise_dim, dev)
    outcome.checks, note = checks.compared(numbers, cell.config["limits"]["serve"])
    outcome.notes.append(note)
    return outcome


def judge(ref, kept: dict, count: int, store, g0, d0, seed: int, n: int, noise_dim: int,
          dev) -> dict:
    """The four numbers over the kept requests of the window's ``count``."""
    gaps = {"image_gap": 0.0, "score_gap": 0.0, "rank_gap": 0.0, "nn_gap": 0.0}
    with C.full_fp32(), torch.no_grad():
        search = ref.nn_dataset(store)
        sq = (search * search).sum(1)
        for i, (images, best, best_s, worst, worst_s, nn_idx) in sorted(kept.items()):
            if i >= count:
                continue
            z = request_noise(dev, seed, i, n, noise_dim)
            images = images.to(dev)
            expect = ref.generate(g0, z, False)
            gaps["image_gap"] = max(gaps["image_gap"], float((images - expect).abs().max()))
            logits = ref.discriminate(d0, images).reshape(-1).double()
            sd = float(logits.std())
            for ranking, scores, sign in ((best, best_s, 1.0), (worst, worst_s, -1.0)):
                got = ref.discriminate(d0, ranking.to(dev)).reshape(-1).double()
                gaps["score_gap"] = max(gaps["score_gap"], float(
                    (torch.sigmoid(got) - scores.to(dev).double()).abs().max()))
                want = torch.sort(sign * logits, descending=True).values[:got.shape[0]]
                gaps["rank_gap"] = max(gaps["rank_gap"], float((want - sign * got).max()) / sd)
            q = best[:nn_idx.shape[0]].to(dev).reshape(nn_idx.shape[0], -1).double()
            d2 = (q * q).sum(1, keepdim=True) - 2.0 * q @ search.T + sq[None, :]
            nearest = d2.min(1).values
            found = d2.gather(1, nn_idx.to(dev).long()[:, None])[:, 0]
            gaps["nn_gap"] = max(gaps["nn_gap"], float(((found - nearest) / nearest).max()))
    return gaps
