"""GAN training: losses, metrics, optimizers, the train step and the
epoch loop. ``python -m facegen_torch.train`` runs the trainer CLI
(``main``, in train/loop.py)."""


def main(argv=None, device=None):
    """The trainer CLI; see facegen_torch.train.loop.main."""
    from facegen_torch.train.loop import main as run

    return run(argv, device)
