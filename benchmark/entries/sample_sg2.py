"""StyleGAN2's sampler as a closed loop with one client: request after
request of ``sample.run_sampling``'s device path on a StyleGAN2
checkpoint, without its PNG encoding.

A request: ``faces`` N(0, 1) latents drawn from the seed and the
request's index; ``GanInference.generate`` at the configuration's
truncation psi; ``rank`` for the best and the worst ``ranked`` by D (two
D passes over all the faces, as the sampler makes them); the
``nearest_neighbours`` of the ``queries`` best over the store at the
net's resolution, which ``prepare_nn_dataset`` prepared once in set-up;
the images, both rankings with their scores and the neighbours' indices
read back to the host, the 150 MB of images into page-locked buffers
allocated once, as a serving client keeps them (on the H100's host a
pageable copy took 44-82 ms of a ~250 ms request, and all of its
spread). A request is timed from its start to its results on the host.

Set-up: the store, the weights (the reference's leaf tables, D's
stddev inputs weighed by ``mbstd_input_std``), the const
noise maps and ``w_avg_samples`` latents from the seed, G and D, G's
``w_avg`` from those latents, the search's rows, and ``warm`` requests.

``correct``, for a sample of the requests drawn from the seed, after the
window, against the fp32 reference (``reference/<reference>.py``, its
own w_avg from the same latents):

- ``image_gap``: the largest |program - reference| of a face's pixel;
- ``score_gap``: the largest |program score - sigmoid(reference logit)|
  of a ranked face, the reference scoring the program's own images in
  the program's order, so with the same groups of 4 consecutive faces
  the program scored;
- ``rank_gap``: how far the k-th face of a ranking lies below the
  reference's k-th best logit of the request, in the reference logits'
  standard deviations;
- ``nn_gap``: how much farther each neighbour found lies than the
  nearest row of the reference's own search rows, as a share.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from benchmark.lib import checks, faces, harness, sg2_flops, stats, weights
from benchmark.lib import window as W
from benchmark.reference import common as C

LATENT_WORD = 30_000
REFERENCE_BLOCK = 32  # faces the reference computes at a time, a multiple of the stddev group
STORE_BLOCK = 1024


class Inputs(NamedTuple):
    ref: object
    arch: object
    store: torch.Tensor
    g_leaves: list
    d_leaves: list
    g0: list
    d0: list
    noise: list
    w_latents: torch.Tensor


def inputs(cell: harness.Cell) -> Inputs:
    """The benchmark's inputs for ``cell``, made on its device from its
    seed: the store, G's and D's weights under the reference's leaf
    tables, the const noise maps and the latents of w_avg."""
    ref = harness.reference_module(cell.config)
    flags, dev, seed = cell.config["flags"], torch.device(cell.device), cell.seed
    a = ref.arch(flags)
    store = faces.make_store(C.seeded_generator(dev, seed, 1), cell.traffic["store_images"])
    g_leaves = ref.leaves("g", a, flags["noise_strength"])
    d_leaves = ref.leaves("d", a)
    g0 = weights.make(g_leaves, C.seeded_generator(dev, seed, 2, 0))
    d0 = weights.make(d_leaves, C.seeded_generator(dev, seed, 2, 1))
    d0 = ref.weigh_stddev_inputs(d0, a, flags["mbstd_input_std"])
    gen = C.seeded_generator(dev, seed, 2, 2)
    noise = [torch.randn((r, r), generator=gen, device=dev) for _, r in ref.noise_names(a)]
    w_latents = torch.randn((cell.traffic["w_avg_samples"], a.z_dim), device=dev,
                            generator=C.seeded_generator(dev, seed, 2, 3))
    return Inputs(ref, a, store, g_leaves, d_leaves, g0, d0, noise, w_latents)


def request_latents(dev, seed: int, index: int, n: int, z_dim: int) -> torch.Tensor:
    return torch.randn((n, z_dim), device=dev,
                       generator=C.seeded_generator(dev, seed, LATENT_WORD, index))


def sampled(seed: int, count: int, every: int):
    """The requests ``correct`` compares: one in ``every``, from an offset
    drawn from the seed, and the first."""
    offset = int(np.random.SeedSequence([seed, 31_000]).generate_state(1)[0]) % every
    return [0] + [i for i in range(offset, count, every) if i != 0]


def program(cell: harness.Cell, inp: Inputs):
    """The program's G and D holding the inputs' weights, noise and w_avg."""
    from facegen_torch.models import stylegan2

    dev, flags = torch.device(cell.device), cell.config["flags"]
    cfg = stylegan2.StyleGAN2Config(**{f.name: flags[f.name]
                                       for f in dataclasses.fields(stylegan2.StyleGAN2Config)})
    g, d = stylegan2.create_stylegan2(
        cfg, generator=torch.Generator(device=dev).manual_seed(cell.seed), device=dev)
    weights.load_into(g, inp.g_leaves, inp.g0)
    weights.load_into(d, inp.d_leaves, inp.d0)
    buffers = dict(g.named_buffers())
    with torch.no_grad():
        for (name, _), value in zip(inp.ref.noise_names(inp.arch), inp.noise):
            buffers[name].copy_(value)
    g.set_w_avg(inp.w_latents)
    g.psi = flags["truncation_psi"]
    return g, d


def run(cell: harness.Cell) -> harness.Outcome:
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.models import stylegan2  # noqa: F401  (a program without it fails here)
    from facegen_torch.utils.infer import GanInference, nearest_neighbours, prepare_nn_dataset

    inp = inputs(cell)
    dev = torch.device(cell.device)
    flags, tr, seed = cell.config["flags"], cell.traffic, cell.seed
    n, ranked, queries = tr["faces"], tr["ranked"], tr["queries"]
    res, z_dim = flags["resolution"], flags["z_dim"]
    log = open(os.path.join(cell.workdir, "program.log"), "w")
    with log, contextlib.redirect_stdout(log):
        g, d = program(cell, inp)
        inf = GanInference(g, d, z_dim, getattr(torch, flags["compute_dtype"]))
        rows = torch.cat([prepare_pool(inp.store[s:s + STORE_BLOCK], res, flags["channels"])
                          for s in range(0, inp.store.shape[0], STORE_BLOCK)])
        search = prepare_nn_dataset(rows, dev)
        del rows

        kept, latencies, host = {}, [], []
        keep = set(sampled(seed, tr["max_requests"], tr["check_every"]))

        def request(i: int, spans: bool = False):
            t = time.perf_counter()
            z = request_latents(dev, seed, i, n, z_dim)
            with W.span("inference.generate", spans):
                images = inf.generate(z)
            with W.span("inference.rank", spans):
                best, best_scores = inf.rank(images, ascending=False, max_out=ranked)
                worst, worst_scores = inf.rank(images, ascending=True, max_out=ranked)
            with W.span("inference.nearest_neighbours", spans):
                nn_idx, _ = nearest_neighbours(best[:queries], search)
            outputs = (images, best, best_scores, worst, worst_scores)
            if not host:
                host.extend(torch.empty(x.shape, dtype=x.dtype, pin_memory=dev.type == "cuda")
                            for x in outputs)
            for h, x in zip(host, outputs):
                h.copy_(x, non_blocking=True)
            W.synchronize(dev)
            latencies.append(time.perf_counter() - t)
            if i in keep:
                kept[i] = (*(h.clone() for h in host), torch.from_numpy(nn_idx[:, 0]))

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

    g_img = sg2_flops.forward_flops(sg2_flops.g_layers(flags))
    d_img = sg2_flops.forward_flops(sg2_flops.d_layers(flags))
    pixels = flags["channels"] * res * res
    request_flops = n * g_img + 2 * n * d_img + 2 * queries * inp.store.shape[0] * pixels
    outcome.facts = {
        "requests": count, "model_flops": count * request_flops,
        "synthesis_bound_s": count * sg2_flops.bound_s(n, sg2_flops.synthesis_convs(flags)),
        "d_bound_s": count * 2 * sg2_flops.bound_s(n, sg2_flops.d_layers(flags))}
    outcome.notes.append(f"requests compared: {sorted(k for k in kept if k < count)}")

    numbers = judge(inp, {k: v for k, v in kept.items() if k < count}, seed, n,
                    flags["truncation_psi"], dev)
    outcome.checks, note = checks.compared(numbers, cell.config["limits"]["serve"])
    outcome.notes.append(note)
    return outcome


def positions(images: torch.Tensor, ranking: torch.Tensor) -> torch.Tensor:
    """The index in ``images`` of each face of ``ranking`` (exact copies);
    -1 where a face is not one of the images."""
    flat, ranked = images.reshape(images.shape[0], -1), ranking.reshape(ranking.shape[0], -1)
    probe = torch.linspace(1.0, 2.0, flat.shape[1], dtype=torch.float64, device=flat.device)
    sig, want = flat.double() @ probe, ranked.double() @ probe
    idx = (sig[None, :] - want[:, None]).abs().argmin(1)
    same = (flat[idx] == ranked).all(1)
    return torch.where(same, idx, torch.full_like(idx, -1))


def judge(inp: Inputs, kept: dict, seed: int, n: int, psi: float, dev) -> dict:
    """The numbers over the kept requests: ``kept[i]`` = (images, best,
    best scores, worst, worst scores, neighbour indices of the best), on
    the host."""
    ref, a = inp.ref, inp.arch
    gaps = dict.fromkeys(("image_gap", "score_gap", "rank_gap", "nn_gap"), 0.0)
    found, nn_queries = [], []
    with C.full_fp32(), torch.no_grad():
        w_avg = ref.w_average(inp.g0[:2 * a.mapping_layers], inp.w_latents, a)
        for i, (images, best, best_s, worst, worst_s, nn_idx) in sorted(kept.items()):
            z = request_latents(dev, seed, i, n, a.z_dim)
            images = images.to(dev)
            expect = ref.generate(inp.g0, inp.noise, w_avg, z, psi, a, block=REFERENCE_BLOCK)
            gaps["image_gap"] = max(gaps["image_gap"], float((images - expect).abs().max()))
            logits = ref.discriminate(inp.d0, images, a, block=REFERENCE_BLOCK).double()
            sd = float(logits.std())
            for ranking, scores, sign in ((best, best_s, 1.0), (worst, worst_s, -1.0)):
                idx = positions(images, ranking.to(dev))
                if bool((idx < 0).any()):
                    gaps["score_gap"] = gaps["rank_gap"] = float("inf")
                    continue
                got = logits[idx]
                gaps["score_gap"] = max(gaps["score_gap"], float(
                    (scores.to(dev).double() - torch.sigmoid(got)).abs().max()))
                want = torch.sort(sign * logits, descending=True).values[:got.shape[0]]
                gaps["rank_gap"] = max(gaps["rank_gap"], float((want - sign * got).max()) / sd)
            nn_queries.append(best[:nn_idx.shape[0]].reshape(nn_idx.shape[0], -1))
            found.append(nn_idx.long())
        if nn_queries:
            gaps["nn_gap"] = _nn_gap(ref, inp.store, a.resolution,
                                     torch.cat(nn_queries).to(dev).double(),
                                     torch.cat(found).to(dev))
    return gaps


def _nn_gap(ref, store, resolution: int, q: torch.Tensor, found: torch.Tensor) -> float:
    """max over the queries of (d2(found) - min d2) / min d2 over the
    reference's search rows, made STORE_BLOCK images at a time."""
    qq = (q * q).sum(1)
    nearest = torch.full_like(qq, float("inf"))
    at_found = torch.zeros_like(qq)
    for s in range(0, store.shape[0], STORE_BLOCK):
        rows = ref.search_rows(store[s:s + STORE_BLOCK], resolution)
        d2 = qq[:, None] - 2.0 * q @ rows.T + (rows * rows).sum(1)[None, :]
        nearest = torch.minimum(nearest, d2.min(1).values)
        inside = (found >= s) & (found < s + rows.shape[0])
        local = (found - s).clamp(0, rows.shape[0] - 1)
        at_found = torch.where(inside, d2.gather(1, local[:, None])[:, 0], at_found)
    return float(((at_found - nearest) / nearest).max())
