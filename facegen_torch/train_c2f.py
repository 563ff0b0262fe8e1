"""The c2f trainer CLI of the port (counterpart of train_c2f.py):

    python -m facegen_torch.train_c2f --syntheticData --epochs 2

facegen's flags and defaults (fine 32, coarse 16, colour, batch 32,
Adam, D_L1 1e-7, bf16 activations over fp32 parameters, 1000 examples
or 63 steps per epoch) on ``cuda:{--gpu}``; it exits with an error
without a GPU. Launched as processes of a group (parallel/multihost.py)
it trains on the 2-D mesh of --meshShape 'N' (N x 1) or 'DP,MP', the
single-device program on the global batch, as facegen's C2FTrainer
always runs on its GSPMD mesh (facegen/train/c2f.py:278-291).
--boundaryPad P widens the diff/coarse interface inside the step
(train/c2f.py). ``main(argv, device="cpu")`` is the
tests' path; the command line has no such flag.
"""

from __future__ import annotations

import torch

from facegen_torch.config import c2f_arg_parser, c2f_config_from_args, cli_device
from facegen_torch.train.c2f import C2FTrainer


def main(argv=None, device=None) -> C2FTrainer:
    from facegen_torch.parallel import maybe_initialize, training_mesh

    maybe_initialize(device_type="cuda" if device is None else torch.device(device).type)
    cfg = c2f_config_from_args(argv)
    try:  # --meshShape against the process group that is up, if any
        mesh = training_mesh(cfg.mesh_shape, device=device, exact=True)
    except ValueError as e:
        c2f_arg_parser().error(str(e))
    if mesh is None and device is None:
        device = cli_device(cfg.gpu, "c2f trainer")
    trainer = C2FTrainer(cfg, device=device, mesh=mesh)
    for _ in trainer.run():
        pass
    return trainer


if __name__ == "__main__":
    main()
