"""The c2f trainer CLI of the port (counterpart of train_c2f.py):

    python -m facegen_torch.train_c2f --syntheticData --epochs 2

facegen's flags and defaults (fine 32, coarse 16, colour, batch 32,
Adam, D_L1 1e-7, bf16 activations over fp32 parameters, 1000 examples
or 63 steps per epoch) on ``cuda:{--gpu}``; it exits with an error
without a GPU. --meshShape other than one device and --boundaryPad > 0
exit with a message that they are not ported. ``main(argv,
device="cpu")`` is the tests' path; the command line has no such flag.
"""

from __future__ import annotations

from facegen_torch.config import c2f_config_from_args, cli_device
from facegen_torch.train.c2f import C2FTrainer


def main(argv=None, device=None) -> C2FTrainer:
    cfg = c2f_config_from_args(argv)
    if device is None:
        device = cli_device(cfg.gpu, "c2f trainer")
    trainer = C2FTrainer(cfg, device=device)
    for _ in trainer.run():
        pass
    return trainer


if __name__ == "__main__":
    main()
