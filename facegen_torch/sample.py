"""Sampler CLI of the port (counterpart of facegen/sample.py).

    python -m facegen_torch.sample --save_base logs --neighbours --runs 2

Per run (sample.lua:79-112): generate 1024 images with G, save
``random1024_{run:04d}_base.png`` (32 per row) and
``random256_{run:04d}_base.png`` (a random 256, 16 per row); rank all
1024 with D and save the best, worst and a random 64 as 8-per-row grids
``best_/worst_/random_{run:04d}_base.png``; with --neighbours, find the
nearest training image of each of the 16 best and save the pairs as
``best_{run:04d}_neighbours_base.png``; with --c2f, refine the best,
worst and random 64 through a coarse-to-fine pair and save them as
``{best,worst,random}_{run:04d}_c2f_{fine}.png`` (sample.lua:102-110,
176-214).

The CLI runs on ``cuda:{--gpu}`` and exits with an error without a GPU;
``run_sampling`` also takes a CPU device. Noise and permutations come
from a CPU ``torch.Generator`` seeded from --seed and the run index
(``run_generator``), so a run draws the same on every device.

--meshShape 'DP' (or 'DP,1'; -1 = every visible card) serves data
parallel from one process, as facegen's sampler does over its local
devices (facegen/sample.py:83-94): G and D replicated on cuda:0 ..
cuda:DP-1, every request split over them and the NN search's rows
sharded (utils/infer.py); the grids are those of one device. 'DP,MP'
serves on DP x MP cards: DP replica groups of MP cards, each keeping the
large leaves as MP shards on its cards and gathering them onto its
first card for a call (facegen's gspmd_infer_jit, parallel/gspmd.py).

A StyleGAN2 checkpoint (models/stylegan2.py; ``--scale`` is its
resolution, 256 for config F) is served the same way, its 1024 faces in
G and D calls of ``stylegan2.SERVE_BATCH``, from N(0, 1) latents
truncated by --truncationPsi (default 1: none). It refuses --c2f (the
refiner takes G16's 16x16 faces) and a model axis (MP > 1: the leaf rule
shards facegen's nets' leaves); --meshShape DP serves it on replicas.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from facegen_torch.config import SampleConfig, mesh_axes
from facegen_torch.models import c2f, gan, stylegan2
from facegen_torch.nn.init import seeded_generator
from facegen_torch.utils import checkpoint as ckpt
from facegen_torch.utils.grids import save_grid, save_png, to_grid
from facegen_torch.utils.infer import GanInference, nearest_neighbours, prepare_nn_dataset

CKPT_NAME = "adversarial"  # logs/adversarial.net in the reference
N_SAMPLES = 1024


def run_generator(seed: int, run: int) -> torch.Generator:
    """The CPU generator of run ``run``'s draws, seeded from (seed, run)."""
    return seeded_generator("cpu", seed, run)


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


def load_c2f(cfg: SampleConfig, device):
    """The c2f G and D of --G_c2f32 (D of --D_c2f32 when given), from
    --save_c2f32 or --save_base; returns (g, d, resolved) with the c2f
    checkpoint's fine_size, coarse_size, grayscale and channels. A D of
    another fine size or channel count is refused with both values."""
    directory = cfg.save_c2f or cfg.save
    g, d, _, res = c2f.restore_c2f(cfg.c2f_network, default_dir=directory, seed=cfg.seed,
                                   device=device)
    if cfg.d_c2f_network and (ckpt.split_network_arg(cfg.d_c2f_network, directory)
                              != ckpt.split_network_arg(cfg.c2f_network, directory)):
        _, d, _, d_res = c2f.restore_c2f(cfg.d_c2f_network, default_dir=directory,
                                         seed=cfg.seed, device=device)
        for k in ("fine_size", "channels"):
            if d_res[k] != res[k]:
                raise ValueError(f"c2f D checkpoint {cfg.d_c2f_network!r} has {k}={d_res[k]} "
                                 f"but the c2f G checkpoint {cfg.c2f_network!r} has "
                                 f"{k}={res[k]}")
    return g, d, res


@contextlib.contextmanager
def full_fp32():
    """cuDNN convolutions and cuBLAS matmuls in full fp32, not TF32 (on
    by default for cuDNN), for the block; the previous settings after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@torch.no_grad()
@full_fp32()
def refine_c2f(g, d, fine_size: int, images: torch.Tensor, noise: torch.Tensor):
    """Coarse-to-fine refinement (sample.lua:176-214's c2f(),
    facegen/sample.py:198-235): upscale each image bilinearly to
    ``fine_size``, run G on each of its ``tries`` noise planes, keep the
    diff D scores highest and add it, clipped to [0, 1]. In fp32 with
    TF32 off (``full_fp32``), on G's device, G and D in eval mode.

    images: (N, h, w, C) floats in [0, 1]; noise: (N, tries, fine, fine,
    1) U(-1, 1). Returns (refined (N, fine, fine, C), D's logits (N, tries)).
    """
    device = next(g.parameters()).device
    n, c, tries, fs = images.shape[0], images.shape[-1], noise.shape[1], fine_size
    x = images.to(device, torch.float32).permute(0, 3, 1, 2)
    coarse = F.interpolate(x, size=(fs, fs), mode="bilinear", align_corners=False,
                           antialias=True).permute(0, 2, 3, 1)
    cond = coarse[:, None].expand(n, tries, fs, fs, c).reshape(n * tries, fs, fs, c)
    z = noise.to(device, torch.float32).reshape(n * tries, fs, fs, 1)
    diff = g.eval()((z, cond))
    scores = d.eval()((diff, cond)).float().reshape(n, tries)
    best = scores.argmax(dim=1)  # the highest D score (sample.lua:198-206)
    diff_best = diff.reshape(n, tries, fs, fs, c)[torch.arange(n, device=device), best]
    return torch.clamp(coarse + diff_best, 0.0, 1.0), scores


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


def serving_devices(mesh_shape) -> list:
    """The cards --meshShape 'DP' or 'DP,MP' serves on: cuda:0 ..
    cuda:DP*MP-1 (DP = -1: every visible card over MP). Raises ValueError
    for more cards than are visible."""
    dp, mp, _ = mesh_axes(mesh_shape)
    count = torch.cuda.device_count()
    n = (count // mp) * mp if dp == -1 else dp * mp
    if n > count or n == 0:
        flag = ",".join(str(v) for v in mesh_shape)
        raise ValueError(f"--meshShape {flag}: {count} CUDA device(s) visible")
    return [torch.device("cuda", i) for i in range(n)]


def run_sampling(cfg: SampleConfig, dataset=None, device=None, noise=None,
                 c2f_noise=None, verbose: bool = True, devices=None):
    """Run the sampler; returns the written paths.

    dataset: optional (N, H, W, C) uint8 images at the model's scale for
    --neighbours (default: the store, see ``load_dataset``).
    device: default ``cuda:{cfg.gpu}``.
    noise: optional (runs, 1024, noise_dim) draws used in place of each
    run's own noise; the permutations are drawn either way.
    c2f_noise: optional (runs, 3, 64, c2f_tries, fine, fine, 1) draws used
    in place of the refinement's noise of best, worst and random.
    devices: serve data parallel on these devices (``GanInference``'s),
    the first in place of ``device``, in replica groups of cfg.mesh_shape's
    model axis; default those of cfg.mesh_shape (``serving_devices``),
    none when it is empty.
    """
    if devices is None and cfg.mesh_shape:
        devices = serving_devices(cfg.mesh_shape)
    if devices is not None:
        device = devices[0]
    device = torch.device(device if device is not None else f"cuda:{cfg.gpu}")
    g, d, cfg = load_models(cfg, device)
    mp = mesh_axes(cfg.mesh_shape)[1] if cfg.mesh_shape else 1  # the cards of a replica group
    max_batch = None
    if stylegan2.is_stylegan2(g):
        checkpoint = cfg.network or CKPT_NAME
        if cfg.c2f:
            raise ValueError(f"--c2f refines G16's 16x16 faces through a c2f pair; "
                             f"{checkpoint!r} is a StyleGAN2 checkpoint at {cfg.scale}x"
                             f"{cfg.scale}, which --c2f cannot refine")
        if mp > 1:
            raise ValueError(f"--meshShape {','.join(map(str, cfg.mesh_shape))}: a model axis "
                             f"shards facegen's nets' leaves; {checkpoint!r} is a StyleGAN2 "
                             f"checkpoint, served on replicas only ('DP' or 'DP,1')")
        g.psi = cfg.truncation_psi
        max_batch = stylegan2.SERVE_BATCH
    elif cfg.truncation_psi != 1.0:
        raise ValueError(f"--truncationPsi {cfg.truncation_psi}: StyleGAN2 checkpoints only")
    inf = GanInference(g, d, cfg.noise_dim, devices=devices, mp=mp, max_batch=max_batch)
    c2f_nets = None
    if cfg.c2f:  # the refinement nets, loaded once (sample.lua:70)
        g_c2f, d_c2f, c2f_res = load_c2f(cfg, device)
        if c2f_res["channels"] != cfg.channels:
            raise ValueError(f"c2f checkpoint {cfg.c2f_network!r} has {c2f_res['channels']} "
                             f"channels but the base checkpoint has {cfg.channels}")
        c2f_nets = (g_c2f, d_c2f, c2f_res["fine_size"])
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

        if c2f_nets is not None:
            # the refined grids beside the base ones (sample.lua:102-108); the
            # noise comes from the run's generator after its base draws
            g_c2f, d_c2f, fs = c2f_nets
            for li, (label, imgs) in enumerate((("best", best), ("worst", worst),
                                                ("random", images[rand64.to(images.device)]))):
                z = torch.rand(imgs.shape[0], cfg.c2f_tries, fs, fs, 1, generator=gen) * 2 - 1
                if c2f_noise is not None:
                    z = torch.as_tensor(c2f_noise[run - 1][li])
                refined, _ = refine_c2f(g_c2f, d_c2f, fs, imgs, z)
                outputs.append(save_grid(
                    os.path.join(cfg.writeto, f"{label}_{run:04d}_c2f_{fs}.png"),
                    refined.cpu().numpy(), nrow=8))

        if cfg.neighbours:
            if nn_dataset is None:
                if dataset is None:
                    dataset = load_dataset(cfg, device)
                elif not torch.is_tensor(dataset):
                    dataset = torch.as_tensor(np.asarray(dataset))
                # the search's rows over the replica groups' first devices
                nn_dataset = prepare_nn_dataset(dataset, devices[::mp] if devices else device)
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
        description="facegen_torch sampler on CUDA GPUs (reference: th sample.lua)")
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
    p.add_argument("--c2f", action="store_true",
                   help="refine best/worst/random grids through a trained "
                        "coarse-to-fine GAN (sample.lua:102-110, :176-214)")
    p.add_argument("--G_c2f32", type=str, default="adversarial_c2f_16_to_32",
                   dest="c2f_network", help="c2f checkpoint name or dir/name")
    p.add_argument("--D_c2f32", type=str, default=None, dest="d_c2f_network",
                   help="refine with a c2f D from a different checkpoint "
                        "(sample.lua:266-269); default: the --G_c2f32 one")
    p.add_argument("--save_c2f32", type=str, default="", dest="save_c2f",
                   help="c2f checkpoint dir (default: --save_base)")
    p.add_argument("--c2f_tries", type=int, default=10,
                   help="candidate diffs per image, best D score wins (sample.lua:177)")
    p.add_argument("--meshShape", type=str, default="", dest="mesh_shape",
                   help="serve data parallel on 'DP' cards (or 'DP,1'; -1 = all visible) "
                        "from this process, or on DP groups of MP cards that shard the "
                        "large leaves ('DP,MP'); empty = --gpu alone")
    p.add_argument("--truncationPsi", type=float, default=1.0, dest="truncation_psi",
                   help="StyleGAN2 checkpoints: w = w_avg + psi (w - w_avg); 1 = none")
    a = p.parse_args(argv)
    try:
        mesh = tuple(int(v) for v in a.mesh_shape.split(",")) if a.mesh_shape else ()
    except ValueError:
        p.error(f"--meshShape {a.mesh_shape!r}: not a comma-separated list of ints")
    try:
        if mesh:  # a malformed shape exits here, with or without a GPU
            mesh_axes(mesh)
    except ValueError as e:
        p.error(str(e))
    if not torch.cuda.is_available():
        p.error("no CUDA GPU: the sampler CLI runs on cuda:{--gpu} only")
    if not 0 <= a.gpu < torch.cuda.device_count():
        p.error(f"--gpu {a.gpu}: {torch.cuda.device_count()} CUDA device(s) visible")
    try:
        devices = serving_devices(mesh) if mesh else None
    except ValueError as e:
        p.error(str(e))
    cfg = SampleConfig(
        save=a.save, network=a.network, batch_size=a.batch_size,
        noise_dim=a.noise_dim, scale=a.scale, grayscale=a.grayscale,
        seed=a.seed, gpu=a.gpu, runs=a.runs, neighbours=a.neighbours,
        writeto=a.writeto, aws=a.aws, dataset_dir=a.dataset_dir,
        d_network=a.d_network, c2f=a.c2f, c2f_network=a.c2f_network,
        d_c2f_network=a.d_c2f_network, save_c2f=a.save_c2f, c2f_tries=a.c2f_tries,
        mesh_shape=mesh, truncation_psi=a.truncation_psi,
    )
    run_sampling(cfg, device=torch.device("cuda", a.gpu), devices=devices)
    print("Finished.")


if __name__ == "__main__":
    main()
