"""The controls of ``correct`` on a StyleGAN2 sampler cell: the fp32
reference put in the program's place with one thing changed, judged by
the cell's own numbers (entries/sample_sg2.py:judge). Each must come out
not correct:

- ``fp8``: every conv's and linear layer's input, weight and output in
  float8 e4m3 (``common.Precision("fp8")``, the precision below the
  configuration's bf16), the search's rows and queries too;
- ``no_demodulation``: the modulated convs without demodulation;
- ``no_noise``: the const noise left out;
- ``no_mbstd``: D's minibatch stddev left out (zeros in its maps).

``program`` reads the program itself on the cell's request 0 (its lower
reading), with the set-up of a run.

    python3 benchmark/control_sg2.py --workload sg2f256_sample --seeds 11 12 --controls fp8 no_noise

prints one JSON line a seed and control, at the cell's own sizes on
cuda:0. The benchmark's runs do not run it; benchmark/tests runs it small
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.entries import sample_sg2 as E  # noqa: E402
from benchmark.lib import harness  # noqa: E402
from benchmark.reference import common as C  # noqa: E402

CONTROLS = ("fp8", "no_demodulation", "no_noise", "no_mbstd")


def _cell(workload: str, seed: int, device: str, root: str, traffic_overrides=None,
          flag_overrides=None) -> harness.Cell:
    bench = harness.benchmark_json(root)
    w = harness.find_cell(bench, workload)
    config = harness.config_file(bench, w["config"], root)
    config["flags"] = {**config["flags"], **(flag_overrides or {})}
    traffic = {**harness.traffic_file(w["traffic"]), **(traffic_overrides or {})}
    return harness.Cell(workload, config, traffic, seed, 0.0, False, device, time.perf_counter(),
                        "")


def served(cell: harness.Cell, inp: E.Inputs, control: str, requests) -> dict:
    """The kept outputs of ``requests`` as the reference serves them under
    ``control``: its faces, its rankings by its own scores, its search."""
    ref, a, tr, flags = inp.ref, inp.arch, cell.traffic, cell.config["flags"]
    dev = torch.device(cell.device)
    prec = C.Precision("fp8" if control == "fp8" else "fp32")
    gen_kw = {"prec": prec, "demodulate": control != "no_demodulation",
              "use_noise": control != "no_noise"}
    n, ranked, queries = tr["faces"], tr["ranked"], tr["queries"]
    kept = {}
    with C.full_fp32(), torch.no_grad():
        w_avg = ref.w_average(inp.g0[:2 * a.mapping_layers], inp.w_latents, a)
        rows = torch.cat([prec.q(ref.search_rows(inp.store[s:s + E.STORE_BLOCK],
                                                 a.resolution).float())
                          for s in range(0, inp.store.shape[0], E.STORE_BLOCK)])
        sq = (rows * rows).sum(1)
        for i in requests:
            z = E.request_latents(dev, cell.seed, i, n, a.z_dim)
            images = ref.generate(inp.g0, inp.noise, w_avg, z, flags["truncation_psi"], a,
                                  block=E.REFERENCE_BLOCK, **gen_kw)
            scores = torch.sigmoid(ref.discriminate(inp.d0, images, a, prec,
                                                    mbstd=control != "no_mbstd",
                                                    block=E.REFERENCE_BLOCK))
            best_o = torch.argsort(-scores, stable=True)[:ranked]
            worst_o = torch.argsort(scores, stable=True)[:ranked]
            q = prec.q(images[best_o[:queries]].reshape(queries, -1))
            d2 = (q * q).sum(1, keepdim=True) - 2.0 * q @ rows.T + sq[None, :]
            kept[i] = (images.cpu(), images[best_o].cpu(), scores[best_o].cpu(),
                       images[worst_o].cpu(), scores[worst_o].cpu(), d2.argmin(1).cpu())
    return kept


def readings(workload: str, seed: int, device: str, control: str, root: str = ROOT,
             traffic_overrides=None, flag_overrides=None, requests: int = 1) -> Dict[str, float]:
    """The numbers of ``control`` (or of the ``program``) on ``workload``
    for ``seed``: the requests a window of ``requests`` compares."""
    if control not in CONTROLS + ("program",):
        raise ValueError(f"control {control!r}: one of {CONTROLS + ('program',)}")
    cell = _cell(workload, seed, device, root, traffic_overrides, flag_overrides)
    if control == "program":
        with tempfile.TemporaryDirectory() as wd:
            result, _ = harness.run_cell(workload, seed, 0.0, False, time.perf_counter(), device,
                                         wd, root, traffic_overrides=traffic_overrides,
                                         flag_overrides=flag_overrides)
        return {k: v["value"] for k, v in result["checks"].items()}
    inp = E.inputs(cell)
    kept = served(cell, inp, control, E.sampled(seed, requests, cell.traffic["check_every"]))
    return E.judge(inp, kept, seed, cell.traffic["faces"], cell.config["flags"]["truncation_psi"],
                   torch.device(device))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", nargs="+", default=list(CONTROLS),
                   choices=CONTROLS + ("program",))
    a = p.parse_args(argv)
    for seed in a.seeds:
        for control in a.controls:
            t = time.perf_counter()
            numbers = readings(a.workload, seed, "cuda:0", control)
            print(json.dumps({"workload": a.workload, "seed": seed, "control": control,
                              "readings": numbers, "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
