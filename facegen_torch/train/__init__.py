"""GAN training: losses, metrics, optimizers, the train step and the
epoch loop. ``python -m facegen_torch.train`` runs the trainer CLI
(``main``, in train/loop.py). ``train/c2f.py`` holds the coarse-to-fine
refiner's step and trainer (CLI: ``python -m facegen_torch.train_c2f``),
``train/ae_loop.py`` the autoencoder's and the denoiser's (CLIs:
``python -m facegen_torch.train_autoencoder`` and ``train_denoiser``)."""


def main(argv=None, device=None):
    """The trainer CLI; see facegen_torch.train.loop.main."""
    from facegen_torch.train.loop import main as run

    return run(argv, device)
