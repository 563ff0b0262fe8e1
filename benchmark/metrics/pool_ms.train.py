"""The device's time for an epoch's pool, ms: the device views of the
program's ``data.pool`` spans (gather, augmentation, resize) of the
traced slice over their count, one an epoch. Moves train_images_per_s."""

from benchmark.lib.spans import per_view


def read(outcome):
    return per_view(outcome, "data.pool", lambda _, views: sum(e - s for s, e in views) * 1e-3)
