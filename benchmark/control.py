"""The control of ``correct``: the reference put in the program's place and
computed in the precision below the configuration's (bf16 -> fp8: every
conv's and linear layer's input, weight and output in e4m3, their
gradients in e5m2; the fp32 pool arithmetic -> bf16), judged by the same
numbers as a run. It must come out not correct.

    python3 benchmark/control.py --workload gan32_train --seeds 11 12 13
    python3 benchmark/control.py --workload gan32_train --seeds 11 12 13 --fault half_batch

prints one JSON line a seed with the readings, at the cell's own sizes on
cuda:0. ``--fault`` reads a training fault instead, the fp32 reference in
the program's place: ``half_batch``, its loss taken over the first half
of each batch; ``parzen_row`` (c2f), approxParzen's first row measured
against another row's image. The benchmark's runs do not run it;
benchmark/tests runs it small on the CPU. It imports nothing of the
program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import checks, harness  # noqa: E402
from benchmark.reference import common as C  # noqa: E402

FP8 = C.Precision("fp8")
FAULTS = ("none", "half_batch", "parzen_row")


def _half_bce(logits, targets):
    """The mean loss over the first half of the batch alone."""
    n = logits.reshape(-1).shape[0] // 2
    return _BCE(logits.reshape(-1)[:n], targets.reshape(-1)[:n])


_BCE = C.bce


def _cell_inputs(cell):
    use = "train" if "train" in cell.traffic["entry"] else "serve"
    ref, store, _, _, g0, d0 = harness.inputs(cell, use)
    return ref, store, g0, d0


def _parzen_row(ref, want: dict, g0, cell) -> torch.Tensor:
    """approxParzen with its first row measured against another
    validation row's fine image: one answer altered where it is made."""
    if "parzen" not in want:
        raise ValueError(f"{cell.name} runs no approxParzen")
    flags, dev = cell.config["flags"], g0[0].device
    _, _, val_fine, val_coarse = want["pools"]
    moved = ref.parzen(g0, (val_fine.roll(1, 0), val_coarse),
                       C.seeded_generator(dev, cell.seed, *ref.PARZEN_WORDS),
                       flags["parzen_samples"], flags["batch_size"])
    out = want["parzen"].clone()
    out[0] = moved[0]
    return out


def train(cell, fault: str = "none") -> Dict[str, float]:
    """The training numbers of the side put in the program's place: the
    fp8 reference with its pools in bf16; or, with a fault, the fp32
    reference with its loss over the first half of each batch
    (``half_batch``) or approxParzen's first row altered (``parzen_row``)."""
    ref, store, g0, d0 = _cell_inputs(cell)
    flags, lr = cell.config["flags"], cell.config["lr"]
    want = ref.expected(store, g0, d0, cell.seed, flags, lr)
    if fault == "half_batch":
        C.bce = _half_bce
        try:
            got = ref.expected(store, g0, d0, cell.seed, flags, lr)
        finally:
            C.bce = _BCE
    elif fault == "parzen_row":
        got = {**want, "parzen": _parzen_row(ref, want, g0, cell)}
    else:
        got = ref.expected(store, g0, d0, cell.seed, flags, lr, prec=FP8, pool_hold=C.bf16)
    print(checks.leaf_report(got, want, g0, d0), file=sys.stderr)
    return checks.training(got, want, g0, d0)


def sample_gan(cell, dev, requests: int = 1000) -> Dict[str, float]:
    """The requests a run of ``requests`` compares, served by the fp8
    reference: its faces, its rankings by its own scores, its search."""
    from benchmark.entries import sample_gan as E

    ref, store, g0, d0 = _cell_inputs(cell)
    tr, flags = cell.traffic, cell.config["flags"]
    n, ranked, queries = tr["faces"], tr["ranked"], tr["queries"]
    with torch.no_grad():
        search = FP8.q(ref.nn_dataset(store).float())
        sq = (search * search).sum(1)
        kept = {}
        for i in E.sampled(cell.seed, requests, tr["check_every"]):
            z = E.request_noise(dev, cell.seed, i, n, flags["noise_dim"])
            images = ref.generate(g0, z, False, FP8)
            scores = torch.sigmoid(ref.discriminate(d0, images, None, FP8).reshape(-1))
            best_o = torch.argsort(-scores, stable=True)[:ranked]
            worst_o = torch.argsort(scores, stable=True)[:ranked]
            q = FP8.q(images[best_o[:queries]].reshape(queries, -1))
            d2 = (q * q).sum(1, keepdim=True) - 2.0 * q @ search.T + sq[None, :]
            kept[i] = (images.cpu(), images[best_o].cpu(), scores[best_o].cpu(),
                       images[worst_o].cpu(), scores[worst_o].cpu(), d2.argmin(1).cpu())
    return E.judge(ref, kept, requests, store, g0, d0, cell.seed, n, flags["noise_dim"], dev)


def readings(workload: str, seed: int, device: str, root: str = ROOT, traffic_overrides=None,
             flag_overrides=None, requests: int = 1000, fault: str = "none") -> Dict[str, float]:
    """The control's numbers on ``workload`` for ``seed`` (with ``fault``,
    that training fault's); a sampler cell serves the requests a window of
    ``requests`` compares."""
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    bench = harness.benchmark_json(root)
    w = harness.find_cell(bench, workload)
    config = harness.config_file(bench, w["config"], root)
    config["flags"] = {**config["flags"], **(flag_overrides or {})}
    traffic = {**harness.traffic_file(w["traffic"]), **(traffic_overrides or {})}
    cell = harness.Cell(workload, config, traffic, seed, 0.0, False, device, 0.0, "")
    dev = torch.device(device)
    with C.full_fp32():
        if traffic["entry"] == "sample_gan":
            if fault != "none":
                raise ValueError("the sampler's faults are the tests' (benchmark/tests)")
            return sample_gan(cell, dev, requests)
        return train(cell, fault)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=FAULTS, default="none")
    a = p.parse_args(argv)
    for seed in a.seeds:
        print(json.dumps({"workload": a.workload, "seed": seed, "fault": a.fault,
                          "control": readings(a.workload, seed, "cuda:0", fault=a.fault)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
