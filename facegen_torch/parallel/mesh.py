"""The 1-D data mesh (counterpart of facegen/parallel/mesh.py).

facegen's data parallelism is local-batch: every device holds the
replicated state, draws half of its local batch from its own rows of
the epoch pool with its own random stream, uses its own batch's
statistics in batch norm, and the step averages the gradients, the
losses, the running statistics and the batch accuracy over the devices
(the gate decides on the global accuracy) and sums the confusion
matrix (facegen/train/step.py:296-310, 358-361). In the port a device is
a process of a ``torch.distributed`` group (parallel/multihost.py) and
the mesh is that group:

- ``replicate`` broadcasts rank 0's tensors: every rank builds the same
  weights from the seed and loads the same checkpoint, and the broadcast
  makes replication hold by construction;
- ``shard_pool`` keeps a rank's contiguous block of the epoch pool, the
  layout facegen's ``P('data')`` gives;
- facegen's shard_map factories (``make_parallel_step``, ``_epoch``,
  ``_multi_epoch``, ``_segment``) are the ``mesh`` argument of
  ``train/step.py:TrainStep``, ``train/graph.py:GraphedStep`` and
  ``train/loop.py:Trainer``.

``training_mesh`` routes ``--meshShape`` as facegen's trainers do
(facegen/train/loop.py:507-519): in the GAN trainer a bare 'N' is this
local-batch mesh and any 'DP,MP', 'DP,1' included, the 2-D mesh of
parallel/gspmd.py with the single-device program's semantics; the c2f,
autoencoder and denoiser trainers run every shape of more than one rank
on the 2-D mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from facegen_torch.config import mesh_axes
from facegen_torch.parallel.gspmd import mesh2d_from_shape, resolve_axes
from facegen_torch.parallel.multihost import rank_device


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in the data-parallel group (the default
    process group): ``rank`` of ``size`` ranks, each on its own
    ``device``."""

    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend()

    def all_reduce_sum_(self, t: torch.Tensor) -> None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)

    def warmup(self) -> None:
        """One all-reduce of a single element, waited for: the communicator
        exists after it (parallel/multihost.py:warmup_collectives)."""
        t = torch.ones(1, device=self.device)
        self.all_reduce_sum_(t)
        if int(t.item()) != self.size:
            raise RuntimeError(f"warm-up all-reduce gave {t.item()}, want {self.size}")


def _fmt(mesh_shape: Sequence[int]) -> str:
    return ",".join(str(v) for v in mesh_shape)


def resolve_mesh_shape(mesh_shape: Sequence[int], world_size: Optional[int]) -> int:
    """The number of ranks ``--meshShape`` asks for, given the size of the
    process group that is up (None: no group): -1 is the group's size, or
    one device without a group. Raises ValueError as ``mesh_axes`` does,
    for a size other than the group's, and for more than one device
    without a group, saying how to launch them (gspmd.resolve_axes)."""
    dp, mp = resolve_axes(mesh_shape, world_size)
    return dp * mp


def make_mesh(mesh_shape: Sequence[int] = (-1,), device=None) -> DataMesh:
    """The data mesh of the process group that is up (facegen's
    ``make_mesh``, :42-61): ``(-1,)`` is the whole group, ``(N,)`` must be
    its size. ``device``: this rank's device, by default
    ``cuda:(rank % device_count)``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"make_mesh({_fmt(mesh_shape)}): no process group is up "
                         f"(parallel/multihost.py:maybe_initialize)")
    if mesh_axes(mesh_shape)[2]:
        raise ValueError(f"make_mesh({_fmt(mesh_shape)}): a 2-D shape is a mesh of "
                         f"parallel/gspmd.py (mesh2d_from_shape)")
    size = resolve_mesh_shape(mesh_shape, dist.get_world_size())
    rank = dist.get_rank()
    device = torch.device(device) if device is not None else rank_device(rank)
    return DataMesh(rank, size, device)


# facegen's global_mesh (facegen/parallel/multihost.py:68-74): the data mesh over every rank
global_mesh = make_mesh


def training_mesh(mesh_shape: Sequence[int], device=None, exact: bool = False):
    """The mesh a trainer runs ``--meshShape`` on over the process group
    that is up: None without a group (a shape of more than one rank raises
    ValueError, saying how to launch); with one, a two-element shape is the
    2-D mesh (gspmd.Mesh2D) and a bare 'N' the local-batch ``DataMesh``, or
    with ``exact`` (the c2f, autoencoder and denoiser trainers) the (N, 1)
    mesh, and None in a group of one rank."""
    if not (dist.is_available() and dist.is_initialized()):
        resolve_axes(mesh_shape, None)
        return None
    if mesh_axes(mesh_shape)[2] or (exact and dist.get_world_size() > 1):
        return mesh2d_from_shape(mesh_shape, device=device)
    if exact:
        resolve_axes(mesh_shape, 1)
        return None
    return make_mesh(mesh_shape, device=device)


def placement(mesh, device, gpu: int) -> Tuple[torch.device, bool]:
    """(a trainer's device, whether it writes the logs, metrics,
    checkpoints and grids) on ``mesh`` (a ``DataMesh``, a gspmd.Mesh2D or
    None): the mesh's rank's device, which a given ``device`` must be, and
    rank 0 writes; without a mesh ``device``, by default ``cuda:{gpu}``."""
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device}, but the mesh's rank runs on {mesh.device}")
        device = mesh.device
    return (torch.device(device if device is not None else f"cuda:{gpu}"),
            mesh is None or mesh.rank == 0)


@torch.no_grad()
def replicate(tensors: Iterable[torch.Tensor], mesh: DataMesh) -> None:
    """Overwrite each tensor in place with rank 0's (facegen's
    ``replicate``, :64-75)."""
    for t in tensors:
        dist.broadcast(t, src=0)


def shard_pool(pool: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """This rank's rows of the epoch pool (facegen's ``shard_pool``,
    :78-90): of the first ``(P // n) * n`` rows, rank r keeps the block
    ``[r * P // n, (r + 1) * P // n)``."""
    per = pool.shape[0] // mesh.size
    if per == 0:
        raise ValueError(f"a pool of {pool.shape[0]} rows has none for each of {mesh.size} ranks")
    return pool[mesh.rank * per:(mesh.rank + 1) * per]
