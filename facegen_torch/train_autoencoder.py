"""The autoencoder trainer CLI of the port (counterpart of
train_autoencoder.py):

    python -m facegen_torch.train_autoencoder --syntheticData --epochs 2

facegen's flags and defaults for it: grayscale forced, --noiseDim 256
unless given, scale 32, batch 32, Adam 1e-3, L1 loss, one pool of
min(N_epoch, 16384) rows per run, fp32, on ``cuda:{--gpu}``; it exits
with an error without a GPU. Any scale the net admits runs. Launched as
processes of a group (parallel/multihost.py) it trains on the 2-D mesh
of --meshShape 'N' (N x 1) or 'DP,MP': the single-device program on the
global batch (facegen/train/ae_loop.py:142-167). ``main(argv,
device="cpu")`` is the tests' path; the command line has no such flag.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from facegen_torch.config import cli_device, train_arg_parser, train_config_from_args
from facegen_torch.train.ae_loop import AETrainer


def main(argv=None, device=None) -> AETrainer:
    from facegen_torch.parallel import maybe_initialize, training_mesh

    maybe_initialize(device_type="cuda" if device is None else torch.device(device).type)
    argv = list(sys.argv[1:] if argv is None else argv)
    # the reference AE's bottleneck default (train_autoencoder.lua:22)
    if not any(a.startswith("--noiseDim") for a in argv):
        argv += ["--noiseDim", "256"]
    cfg = train_config_from_args(argv)
    # the reference AE is 1-channel only (train_autoencoder.lua:56-57)
    cfg = dataclasses.replace(cfg, grayscale=True)
    try:  # --meshShape against the process group that is up, if any
        mesh = training_mesh(cfg.mesh_shape, device=device, exact=True)
    except ValueError as e:
        train_arg_parser().error(str(e))
    if mesh is None and device is None:
        device = cli_device(cfg.gpu, "autoencoder trainer")
    trainer = AETrainer(cfg, device=device, mesh=mesh)
    for _ in trainer.run():
        pass
    return trainer


if __name__ == "__main__":
    main()
