"""The denoiser trainer CLI of the port (counterpart of train_denoiser.py):

    python -m facegen_torch.train_denoiser --syntheticData --epochs 2

facegen's flags and defaults for it: scale 16 unless given, colour
unless --grayscale, batch 32, Adam 1e-3, BCE, --AE_clamp 1, fp32, on
``cuda:{--gpu}``; it exits with an error without a GPU. It writes
``denoiser_{c}x{h}x{w}`` under --save, which the GAN trainer's --denoise
reads at the same scale and channels; --network resumes it. Any scale
above 4 runs. Launched as processes of a group (parallel/multihost.py)
it trains on the 2-D mesh of --meshShape 'N' (N x 1) or 'DP,MP': the
single-device program on the global batch, the batch norms' statistics
the global batch's (facegen/train/ae_loop.py:332-360). ``main(argv,
device="cpu")`` is the tests' path; the command line has no such flag.
"""

from __future__ import annotations

import sys

import torch

from facegen_torch.config import cli_device, train_arg_parser, train_config_from_args
from facegen_torch.train.ae_loop import DenoiserTrainer


def main(argv=None, device=None) -> DenoiserTrainer:
    from facegen_torch.parallel import maybe_initialize, training_mesh

    maybe_initialize(device_type="cuda" if device is None else torch.device(device).type)
    argv = list(sys.argv[1:] if argv is None else argv)
    # the reference denoiser's default scale (train_denoiser.lua:34)
    if not any(a.startswith("--scale") for a in argv):
        argv += ["--scale", "16"]
    cfg = train_config_from_args(argv)
    try:  # --meshShape against the process group that is up, if any
        mesh = training_mesh(cfg.mesh_shape, device=device, exact=True)
    except ValueError as e:
        train_arg_parser().error(str(e))
    if mesh is None and device is None:
        device = cli_device(cfg.gpu, "denoiser trainer")
    trainer = DenoiserTrainer(cfg, device=device, mesh=mesh)
    for _ in trainer.run():
        pass
    return trainer


if __name__ == "__main__":
    main()
