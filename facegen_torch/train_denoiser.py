"""The denoiser trainer CLI of the port (counterpart of train_denoiser.py):

    python -m facegen_torch.train_denoiser --syntheticData --epochs 2

facegen's flags and defaults for it: scale 16 unless given, colour
unless --grayscale, batch 32, Adam 1e-3, BCE, --AE_clamp 1, fp32, on
``cuda:{--gpu}``; it exits with an error without a GPU. It writes
``denoiser_{c}x{h}x{w}`` under --save, which the GAN trainer's --denoise
reads at the same scale and channels; --network resumes it. Any scale
above 4 runs. --meshShape other than one device exits with a message
that it is not ported. ``main(argv, device="cpu")`` is the tests' path;
the command line has no such flag.
"""

from __future__ import annotations

import sys

from facegen_torch.config import (
    cli_device,
    data_axis,
    train_arg_parser,
    train_config_from_args,
)
from facegen_torch.train.ae_loop import DenoiserTrainer


def main(argv=None, device=None) -> DenoiserTrainer:
    argv = list(sys.argv[1:] if argv is None else argv)
    # the reference denoiser's default scale (train_denoiser.lua:34)
    if not any(a.startswith("--scale") for a in argv):
        argv += ["--scale", "16"]
    cfg = train_config_from_args(argv)
    if data_axis(cfg.mesh_shape) not in (1, -1):
        train_arg_parser().error(f"--meshShape {cfg.mesh_shape}: the denoiser trainer's "
                                 f"multi-device training is not ported yet")
    if device is None:
        device = cli_device(cfg.gpu, "denoiser trainer")
    trainer = DenoiserTrainer(cfg, device=device)
    for _ in trainer.run():
        pass
    return trainer


if __name__ == "__main__":
    main()
