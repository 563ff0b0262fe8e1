"""The autoencoder trainer CLI of the port (counterpart of
train_autoencoder.py):

    python -m facegen_torch.train_autoencoder --syntheticData --epochs 2

facegen's flags and defaults for it: grayscale forced, --noiseDim 256
unless given, scale 32, batch 32, Adam 1e-3, L1 loss, one pool of
min(N_epoch, 16384) rows per run, fp32, on ``cuda:{--gpu}``; it exits
with an error without a GPU. Any scale the net admits runs. --meshShape
other than one device exits with a message that it is not ported.
``main(argv, device="cpu")`` is the tests' path; the command line has no
such flag.
"""

from __future__ import annotations

import dataclasses
import sys

from facegen_torch.config import (
    cli_device,
    data_axis,
    train_arg_parser,
    train_config_from_args,
)
from facegen_torch.train.ae_loop import AETrainer


def main(argv=None, device=None) -> AETrainer:
    argv = list(sys.argv[1:] if argv is None else argv)
    # the reference AE's bottleneck default (train_autoencoder.lua:22)
    if not any(a.startswith("--noiseDim") for a in argv):
        argv += ["--noiseDim", "256"]
    cfg = train_config_from_args(argv)
    if data_axis(cfg.mesh_shape) not in (1, -1):
        train_arg_parser().error(f"--meshShape {cfg.mesh_shape}: the autoencoder trainer's "
                                 f"multi-device training is not ported yet")
    # the reference AE is 1-channel only (train_autoencoder.lua:56-57)
    cfg = dataclasses.replace(cfg, grayscale=True)
    if device is None:
        device = cli_device(cfg.gpu, "autoencoder trainer")
    trainer = AETrainer(cfg, device=device)
    for _ in trainer.run():
        pass
    return trainer


if __name__ == "__main__":
    main()
