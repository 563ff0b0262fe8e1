"""Inference helpers: generation, D scoring, ranking and the
nearest-neighbour search (counterpart of facegen/utils/infer.py).

Data-parallel serving (facegen's ``mesh`` argument, served by
``gspmd_infer_jit``, facegen/parallel/gspmd.py:219-245): with
``devices``, ``GanInference`` keeps one eval-mode replica of G and D on
each device, splits every request over them, wrap-padding a count that
does not divide (the first rows repeated, facegen's ``_wrap_pad``), and
gathers the results in order on the first device; the noise is drawn
once for the whole request. ``prepare_nn_dataset`` shards the dataset's
rows over the devices, padded with sentinel rows that never win, and
``nearest_neighbours`` merges each shard's top-k.

A net whose output for a row depends on other rows of its batch (D's
minibatch stddev in StyleGAN2, over groups of ``batch_group`` consecutive
rows) is split only at multiples of its group: over several devices the
request's rows must be a multiple of it, each device takes whole groups
and the wrap-padding adds whole groups. ``max_batch`` cuts each net call
on a device into calls of at most that many rows (a multiple of every
group), for nets whose activations at a request's size would not fit.

With ``mp`` > 1 (--meshShape 'DP,MP') the devices are DP replica groups of
MP devices each, ``devices[g * mp:(g + 1) * mp]``: group g keeps each
leaf that facegen's rule shards (parallel/gspmd.py:leaf_spec) as MP
shards, one on each of its devices, and gathers them onto its first for
every call (``gspmd.ShardedReplica``); requests split over the DP groups
and the search's rows shard over their first devices.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from facegen_torch.parallel.gspmd import ShardedReplica
from facegen_torch.utils.profiling import span


class GanInference:
    """Eval-mode G/D execution (dropout off, batch norm from running
    statistics, nn_utils.lua:207-222). Noise and activations are in
    ``compute_dtype`` (bf16 by default); parameters stay fp32 and are
    cast at use; D's sigmoid runs on fp32 logits. A G that declares
    ``fp32_latent`` (StyleGAN2's, whose mapping is fp32) takes the noise
    in fp32 and ``compute_dtype`` as its second argument; one that
    declares ``normal_latent`` draws N(0, 1) noise."""

    def __init__(self, g: nn.Module, d: nn.Module, noise_dim: int,
                 compute_dtype: torch.dtype = torch.bfloat16, devices: Optional[Sequence] = None,
                 mp: int = 1, max_batch: Optional[int] = None):
        self.g = g.eval()
        self.d = d.eval()
        self.noise_dim = noise_dim
        self.dtype = compute_dtype
        group = max(batch_group(g), batch_group(d))
        if max_batch is not None and max_batch % group:
            raise ValueError(f"max_batch {max_batch} is not a multiple of the nets' "
                             f"batch group {group}")
        self.max_batch = max_batch
        self.device = next(g.parameters()).device
        # a replica of G and of D per device, or per group of mp devices,
        # of a data-parallel request
        self.g_replicas, self.d_replicas = [self.g], [self.d]
        if devices is not None:
            devices = [torch.device(dev) for dev in devices]
            if len(devices) % mp:
                raise ValueError(f"{len(devices)} devices are not groups of {mp}")
            if mp > 1:
                groups = [devices[k:k + mp] for k in range(0, len(devices), mp)]
                self.g_replicas = [ShardedReplica(g, grp) for grp in groups]
                self.d_replicas = [ShardedReplica(d, grp) for grp in groups]
            else:
                self.g_replicas = [copy.deepcopy(g).to(dev).eval() for dev in devices]
                self.d_replicas = [copy.deepcopy(d).to(dev).eval() for dev in devices]
            self.device = devices[0]  # where the results gather
        self.request_devices = [next(net.parameters()).device if isinstance(net, nn.Module)
                                else net.device for net in self.g_replicas]

    def _input(self, net, x: torch.Tensor, device) -> torch.Tensor:
        return x.to(device, torch.float32 if getattr(net, "fp32_latent", False) else self.dtype)

    def _call(self, net, x: torch.Tensor) -> torch.Tensor:
        """``net`` on ``x``, in calls of at most ``max_batch`` rows."""
        args = (self.dtype,) if getattr(net, "fp32_latent", False) else ()
        if self.max_batch is None or x.shape[0] <= self.max_batch:
            return net(x, *args)
        return torch.cat([net(part, *args) for part in x.split(self.max_batch)])

    def _split(self, nets: List[nn.Module], x: torch.Tensor, name: str) -> torch.Tensor:
        """``nets[i]`` on the i-th of ``len(nets)`` equal parts of ``x``,
        wrap-padded, each part whole groups of the nets' ``batch_group``;
        the fp32 outputs in order on ``self.device``, cut back to
        ``len(x)``. The span ``name`` covers the nets' calls, and on one
        device neither the cast in nor the fp32 copy out."""
        if len(nets) == 1:
            x = self._input(nets[0], x, self.device)
            with span(name):
                y = self._call(nets[0], x)
            return y.float()
        n, k = x.shape[0], len(nets)
        group = max(batch_group(net) for net in nets)
        if n % group:
            raise ValueError(f"{n} rows over {k} devices: the net computes statistics over "
                             f"groups of {group} rows, so a request it splits must be a "
                             f"multiple of {group}")
        part = group * -(-n // (group * k))
        total = part * k
        padded = x.repeat((-(-total // n),) + (1,) * (x.dim() - 1))[:total]
        with span(name):
            parts = [self._call(net, self._input(net, chunk, dev))
                     for net, chunk, dev in zip(nets, padded.split(part), self.request_devices)]
        return torch.cat([p.float().to(self.device) for p in parts])[:n]

    def noise(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """U(-1, 1) noise (nn_utils.lua:35-39), or N(0, 1) for a G that
        declares ``normal_latent``, drawn on the generator's device."""
        if getattr(self.g, "normal_latent", False):
            return torch.randn(n, self.noise_dim, generator=generator, device=generator.device)
        u = torch.rand(n, self.noise_dim, generator=generator, device=generator.device)
        return u * 2.0 - 1.0

    @torch.no_grad()
    def generate(self, noise: torch.Tensor) -> torch.Tensor:
        """(n, noise_dim) -> (n, H, W, C) fp32 images in [0, 1]."""
        return self._split(self.g_replicas, noise, "infer.generate")

    def generate_n(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return self.generate(self.noise(generator, n))

    @torch.no_grad()
    def score(self, images: torch.Tensor) -> torch.Tensor:
        """(n, H, W, C) images -> (n,) D probabilities."""
        return torch.sigmoid(self._split(self.d_replicas, images, "infer.score")).reshape(-1)

    def rank(self, images: torch.Tensor, ascending: bool = False,
             max_out: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(images sorted by D score, scores); ascending=True puts the
        most fake-looking first (nn_utils.lua:90-118). Stable, like
        jnp.argsort, so ties keep facegen's order."""
        scores = self.score(images)
        with span("infer.rank"):
            order = torch.argsort(scores if ascending else -scores, stable=True)
            if max_out is not None:
                order = order[:max_out]
            return images[order], scores[order]


def batch_group(net) -> int:
    """The rows a net's output for one row depends on together (1: none)."""
    return getattr(net, "batch_group", 1)


def sanity_image(scale: int, channels: int, generator: torch.Generator) -> torch.Tensor:
    """The diagonal "non-face" probe D should reject (nn_utils.lua:157-169),
    (scale, scale, channels) fp32 on the generator's device: U(0, 0.5)
    background; on the first channel 1.0 on the main diagonal and 0.5 at
    every off-diagonal crossing of rows and columns 3, 7, 11, ... (the
    reference's 1-based multiples of 4)."""
    dev = generator.device
    img = torch.rand(scale, scale, channels, generator=generator, device=dev) * 0.5
    ii = torch.arange(scale, device=dev)
    lattice = ((ii[:, None] % 4 == 3) & (ii[None, :] % 4 == 3)
               & (ii[:, None] != ii[None, :]))
    img[..., 0] = torch.where(lattice, 0.5, img[..., 0])
    img[ii, ii, 0] = 1.0
    return img


SENTINEL = 1e6  # a padding row's value: ~3e15 squared distance from any [0, 1] image


def prepare_nn_dataset(dataset, device) -> Union[torch.Tensor, List[torch.Tensor]]:
    """(N, H, W, C) images -> (N, H*W*C) fp32 on ``device``, uint8 scaled
    to [0, 1]; done once for repeated queries. ``device`` a list of
    devices: a list of equal shards of the rows, one on each, the last
    ones padded with ``SENTINEL`` rows, which never enter a top-k
    (facegen/utils/infer.py:102-124)."""
    t = torch.as_tensor(np.asarray(dataset)) if not torch.is_tensor(dataset) else dataset
    if isinstance(device, (list, tuple)):
        flat = prepare_nn_dataset(t, "cpu")
        pad = -flat.shape[0] % len(device)
        flat = torch.cat([flat, flat.new_full((pad, flat.shape[1]), SENTINEL)])
        return [part.to(dev) for part, dev in zip(flat.chunk(len(device)), device)]
    flat = t.reshape(t.shape[0], -1).to(device)
    if flat.dtype == torch.uint8:
        return flat.float() / 255.0
    return flat.float()


def _top_k(q: torch.Tensor, df: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(squared distances, indices) of the k rows of ``df`` nearest each
    query: one |q|^2 - 2 q d^T + |d|^2 product and a top-k on df's device."""
    q = q.to(df.device)
    d2 = (q * q).sum(1, keepdim=True) - 2.0 * (q @ df.T) + (df * df).sum(1)[None, :]
    neg_top, idx = torch.topk(-d2.clamp_min(0.0), k, dim=1)
    return -neg_top, idx


def nearest_neighbours(queries: torch.Tensor, dataset, k: int = 1,
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """For each query image the k nearest dataset images by L2 distance,
    as (indices, distances). A product and a top-k on the device replace
    sample.lua:133-151's per-pair loop. ``dataset`` is a 2-D tensor from
    ``prepare_nn_dataset``, a list of its shards (each searched on its
    device, their top-k merged), or images to prepare on the queries'
    device."""
    q = queries if torch.is_tensor(queries) else torch.as_tensor(np.asarray(queries))
    if q.dtype == torch.uint8:
        q = q.float() / 255.0
    q = q.reshape(q.shape[0], -1).float()
    with span("infer.nn.search"):
        if isinstance(dataset, list):
            found = [_top_k(q, part, k) for part in dataset]
            offsets = np.cumsum([0] + [part.shape[0] for part in dataset[:-1]])
            d2 = torch.cat([d.to(q.device) for d, _ in found], dim=1)
            idx = torch.cat([i.to(q.device) + int(o) for (_, i), o in zip(found, offsets)],
                            dim=1)
            d2, pick = torch.topk(-d2, k, dim=1)
            d2, idx = -d2, idx.gather(1, pick)
        else:
            if not (torch.is_tensor(dataset) and dataset.dim() == 2):
                dataset = prepare_nn_dataset(dataset, q.device)
            d2, idx = _top_k(q, dataset, k)
    with span("infer.nn.readback"):
        return idx.cpu().numpy(), torch.sqrt(d2).cpu().numpy()
