"""Training-progress grids (counterpart of facegen/utils/viz.py).

The PNG form of nn_utils.visualizeProgress's display windows
(nn_utils.lua:131-204). Each call writes under ``out_dir``:

  samples_fixed.png  G on the run's fixed noise (train.lua:195)
  samples_denoised.png  the same through the denoiser, when one is given
  best50.png         the 50 of 300 random samples D scores highest
  worst50.png        the 50 it scores lowest (worst first)
  real100.png        100 images of the epoch's pool

One real image and one synthetic diagonal non-face are planted among the
300 (nn_utils.lua:182-183); a healthy D ranks the real one high and the
probe low, and the returned report gives both ranks.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from facegen_torch.utils.grids import save_grid
from facegen_torch.utils.infer import GanInference, sanity_image


def visualize_progress(inf: GanInference, fixed_noise: torch.Tensor, train_pool: torch.Tensor,
                       out_dir: str, generator: torch.Generator,
                       denoiser: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                       epoch: Optional[int] = None, window: int = 3) -> dict:
    """G and D run in eval mode (set here; the train step sets train mode
    again). ``window`` is the reference's display-window id (--window):
    ids other than 3 prefix the files with ``w{id}_``."""
    inf.g.eval()
    inf.d.eval()
    os.makedirs(out_dir, exist_ok=True)
    prefix = "" if window == 3 else f"w{window}_"

    def path(name):
        return os.path.join(out_dir, prefix + name)

    fixed = inf.generate(fixed_noise)
    save_grid(path("samples_fixed.png"), fixed.cpu().numpy())
    if denoiser is not None:
        save_grid(path("samples_denoised.png"), denoiser(fixed).cpu().numpy())
    randoms = inf.generate_n(generator, 300)
    randoms[298] = train_pool[0].to(randoms.device).float() / 255.0
    randoms[299] = sanity_image(randoms.shape[1], randoms.shape[-1], generator).to(randoms.device)
    scores = inf.score(randoms).cpu().numpy()
    order = np.argsort(-scores, kind="stable")
    imgs = randoms.cpu().numpy()
    save_grid(path("best50.png"), imgs[order[:50]])
    save_grid(path("worst50.png"), imgs[order[::-1][:50]])
    n_real = min(100, train_pool.shape[0])
    save_grid(path("real100.png"), train_pool[:n_real].cpu().numpy().astype(np.float32) / 255.0)
    rank_of = {int(i): r for r, i in enumerate(order)}
    report = {"real_probe_rank": rank_of[298], "synth_probe_rank": rank_of[299],
              "real_probe_score": float(scores[298]), "synth_probe_score": float(scores[299])}
    if epoch is not None:
        report["epoch"] = epoch
    return report
