"""Sampler CLI of the port (counterpart of facegen/sample.py).

    python -m facegen_torch.sample --save_base logs --neighbours --runs 2

Per run (sample.lua:79-112): generate 1024 images with G, save
``random1024_{run:04d}_base.png`` (32 per row) and
``random256_{run:04d}_base.png`` (a random 256, 16 per row); rank all
1024 with D and save the best, worst and a random 64 as 8-per-row grids
``best_/worst_/random_{run:04d}_base.png``; with --neighbours, find the
nearest training image of each of the 16 best and save the pairs as
``best_{run:04d}_neighbours_base.png``.

The CLI runs on ``cuda:{--gpu}`` and exits with an error without a GPU;
``run_sampling`` also takes a CPU device. Noise and permutations come
from a CPU ``torch.Generator`` seeded from --seed and the run index
(``run_generator``), so a run draws the same on every device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from facegen_torch.config import SampleConfig
from facegen_torch.models import gan
from facegen_torch.utils import checkpoint as ckpt
from facegen_torch.utils.grids import save_grid, save_png, to_grid
from facegen_torch.utils.infer import GanInference, nearest_neighbours, prepare_nn_dataset

CKPT_NAME = "adversarial"  # logs/adversarial.net in the reference
N_SAMPLES = 1024


def run_generator(seed: int, run: int) -> torch.Generator:
    """The CPU generator of run ``run``'s draws, seeded from (seed, run)."""
    state = np.random.SeedSequence([seed, run]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def load_models(cfg: SampleConfig, device):
    """G and D from the checkpoint, architecture from its own meta
    (sample.lua:247-274); returns (g, d, cfg with the resolved shapes)."""
    network = cfg.network or CKPT_NAME
    g, d, res = gan.restore_gan(
        network, default_dir=cfg.save, scale=cfg.scale, grayscale=cfg.grayscale,
        noise_dim=cfg.noise_dim, seed=cfg.seed, device=device,
    )
    if cfg.d_network:
        # --D_base: rank with a D from another checkpoint (sample.lua:255-257);
        # scale/grayscale are checked, noise_dim is not (D takes no noise)
        if ckpt.split_network_arg(cfg.d_network, cfg.save) != ckpt.split_network_arg(
                network, cfg.save):
            _, d, _ = gan.restore_gan(
                cfg.d_network, default_dir=cfg.save, scale=res["scale"],
                grayscale=res["grayscale"], seed=cfg.seed, device=device,
            )
    cfg = dataclasses.replace(cfg, scale=res["scale"], grayscale=res["grayscale"],
                              noise_dim=res["noise_dim"])
    return g, d, cfg


def neighbours_grid(best: np.ndarray, matches: np.ndarray) -> np.ndarray:
    """Interleave generated/neighbour pairs (sample.lua:156-168)."""
    paired = np.empty((2 * best.shape[0],) + best.shape[1:], best.dtype)
    paired[0::2] = best
    paired[1::2] = matches
    return to_grid(paired, nrow=8)


def load_dataset(cfg: SampleConfig, device) -> torch.Tensor:
    """Training images at the sampler's scale for the NN search, uint8 on
    ``device`` (sample.lua:135 loads the whole training set); 4096
    synthetic faces when the store does not exist."""
    from facegen_torch.data.lfw import default_store_path, load_store
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.data.synthetic import draw_synthetic_faces

    path = default_store_path(cfg.aws, cfg.dataset_dir)
    if os.path.exists(path):
        store = load_store(path)
        pools = []
        for s in range(0, store.shape[0], 8192):
            raw = torch.from_numpy(np.array(store[s : s + 8192])).to(device)
            pools.append(prepare_pool(raw, cfg.scale, cfg.channels))
        return torch.cat(pools)
    raw = draw_synthetic_faces(torch.Generator().manual_seed(0), 4096).to(device)
    return prepare_pool(raw, cfg.scale, cfg.channels)


def run_sampling(cfg: SampleConfig, dataset=None, device=None, noise=None,
                 verbose: bool = True):
    """Run the sampler; returns the written paths.

    dataset: optional (N, H, W, C) uint8 images at the model's scale for
    --neighbours (default: the store, see ``load_dataset``).
    device: default ``cuda:{cfg.gpu}``.
    noise: optional (runs, 1024, noise_dim) draws used in place of each
    run's own noise; the permutations are drawn either way.
    """
    if cfg.c2f or cfg.d_c2f_network:
        raise NotImplementedError("--c2f / --D_c2f32: c2f refinement is not ported yet")
    if cfg.mesh_shape:
        raise NotImplementedError("--meshShape: multi-device serving is not ported yet")
    device = torch.device(device if device is not None else f"cuda:{cfg.gpu}")
    g, d, cfg = load_models(cfg, device)
    inf = GanInference(g, d, cfg.noise_dim)
    os.makedirs(cfg.writeto, exist_ok=True)
    nn_dataset = None  # flattened once across runs
    outputs = []
    for run in range(1, cfg.runs + 1):
        gen = run_generator(cfg.seed, run)
        z = inf.noise(gen, N_SAMPLES)
        sub = torch.randperm(N_SAMPLES, generator=gen)[:256]
        rand64 = torch.randperm(N_SAMPLES, generator=gen)[:64]
        if noise is not None:
            z = torch.as_tensor(noise[run - 1])
        images = inf.generate(z)
        imgs_np = images.cpu().numpy()

        def p(name):
            return os.path.join(cfg.writeto, f"{name}_{run:04d}_base.png")

        outputs.append(save_grid(p("random1024"), imgs_np, nrow=32))
        outputs.append(save_grid(p("random256"), imgs_np[sub.numpy()], nrow=16))
        best, best_scores = inf.rank(images, ascending=False, max_out=64)
        worst, _ = inf.rank(images, ascending=True, max_out=64)
        best_np = best.cpu().numpy()
        outputs.append(save_grid(p("best"), best_np, nrow=8))
        outputs.append(save_grid(p("worst"), worst.cpu().numpy(), nrow=8))
        outputs.append(save_grid(p("random"), imgs_np[rand64.numpy()], nrow=8))

        if cfg.neighbours:
            if nn_dataset is None:
                if dataset is None:
                    dataset = load_dataset(cfg, device)
                elif not torch.is_tensor(dataset):
                    dataset = torch.as_tensor(np.asarray(dataset))
                nn_dataset = prepare_nn_dataset(dataset, device)
            idx, _ = nearest_neighbours(best[:16], nn_dataset)
            matches = dataset[torch.from_numpy(idx[:, 0]).to(dataset.device)].cpu().float()
            if dataset.dtype == torch.uint8:
                matches = matches / 255.0
            grid = neighbours_grid(best_np[:16], matches.numpy())
            outputs.append(save_png(
                os.path.join(cfg.writeto, f"best_{run:04d}_neighbours_base.png"), grid))
        if verbose:
            print(f"run {run}/{cfg.runs} done (best score {float(best_scores[0]):.3f})")
    return outputs


def main(argv=None):
    p = argparse.ArgumentParser(
        description="facegen_torch sampler on one CUDA GPU (reference: th sample.lua)")
    p.add_argument("--save_base", type=str, default="logs", dest="save")
    p.add_argument("--G_base", type=str, default="adversarial", dest="network")
    p.add_argument("--D_base", type=str, default=None, dest="d_network",
                   help="rank with a D from a different checkpoint than G's "
                        "(sample.lua:255-257); default: G's own checkpoint")
    p.add_argument("--neighbours", action="store_true")
    # shape flags default to None = use the checkpoint's stored config
    p.add_argument("--scale", type=int, default=None)
    p.add_argument("--grayscale", action="store_true", default=None)
    p.add_argument("--writeto", type=str, default="samples")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--noiseDim", type=int, default=None, dest="noise_dim")
    p.add_argument("--batchSize", type=int, default=16, dest="batch_size")
    p.add_argument("--aws", action="store_true")
    p.add_argument("--datasetDir", type=str, default=None, dest="dataset_dir",
                   help="packed store for --neighbours (default: dataset/lfw64.npy)")
    p.add_argument("--c2f", action="store_true", help="not ported yet")
    p.add_argument("--G_c2f32", type=str, default="adversarial_c2f_16_to_32",
                   dest="c2f_network", help="c2f checkpoint (with --c2f, not ported yet)")
    p.add_argument("--D_c2f32", type=str, default=None, dest="d_c2f_network",
                   help="not ported yet")
    p.add_argument("--save_c2f32", type=str, default="", dest="save_c2f",
                   help="c2f checkpoint dir (with --c2f, not ported yet)")
    p.add_argument("--c2f_tries", type=int, default=10,
                   help="candidate diffs per image (with --c2f, not ported yet)")
    p.add_argument("--meshShape", type=str, default="", dest="mesh_shape",
                   help="not ported yet: must stay empty (one GPU)")
    a = p.parse_args(argv)
    if a.c2f or a.d_c2f_network:
        p.error("--c2f / --D_c2f32: c2f refinement is not ported yet")
    if a.mesh_shape:
        p.error("--meshShape: multi-device serving is not ported yet")
    if not torch.cuda.is_available():
        p.error("no CUDA GPU: the sampler CLI runs on cuda:{--gpu} only")
    if not 0 <= a.gpu < torch.cuda.device_count():
        p.error(f"--gpu {a.gpu}: {torch.cuda.device_count()} CUDA device(s) visible")
    cfg = SampleConfig(
        save=a.save, network=a.network, batch_size=a.batch_size,
        noise_dim=a.noise_dim, scale=a.scale, grayscale=a.grayscale,
        seed=a.seed, gpu=a.gpu, runs=a.runs, neighbours=a.neighbours,
        writeto=a.writeto, aws=a.aws, dataset_dir=a.dataset_dir,
        d_network=a.d_network, c2f_network=a.c2f_network,
        save_c2f=a.save_c2f, c2f_tries=a.c2f_tries,
    )
    run_sampling(cfg, device=torch.device("cuda", a.gpu))
    print("Finished.")


if __name__ == "__main__":
    main()
