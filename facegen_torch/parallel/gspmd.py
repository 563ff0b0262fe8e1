"""The 2-D ("data" x "model") mesh with exact single-device semantics
(counterpart of facegen/parallel/gspmd.py).

facegen's second parallel mode annotates the shardings of the state over
a ("data", "model") device mesh and lets GSPMD insert the collectives; the
compiled program is the single-device one: one random stream, batch-norm
statistics over the global batch, the same updates. The port runs one
process per device, joined by ``torch.distributed`` (parallel/multihost.py),
and writes the collectives itself:

- ``Mesh2D``: this rank's place in a (dp x mp) grid laid out as facegen's
  ``devices.reshape(dp, mp)``: rank ``i * mp + j`` is data row i, model
  column j. The **data group** (the ranks of column j) reduces the
  gradients, the batch-norm sums, the losses, the accuracy and the
  confusion counts; the **model group** (the ranks of row i) holds the
  shards of one leaf.
- **The step** (train/step.py, train/c2f.py, train/ae_loop.py): every rank
  draws the global batch's draws from the one epoch generator, with no
  rank folded in, and data row i takes rows ``[i c, min((i+1) c, B))``,
  c = ceil(B / dp), of every batch-shaped draw, as GSPMD pads an uneven
  sharding (``row_block``, ``Mesh2D.rows``; a D batch of real and fake
  halves takes those rows of each half, ``Mesh2D.pair_rows``). The last
  rows may be short or empty. A rank's share of a batch mean is the sum
  over its rows over B (zero on an empty row), so the data group's SUM of
  the gradients is the global batch's; batch norm in training mode
  normalises by the statistics of the global batch, over the global count
  (``nn/layers.py:SyncBatchNormFunction``).
  Each rank keeps the whole epoch pool, so the batch indices range over
  the true pool size, as facegen's ``draw_n`` does.
- **The state**: a leaf the rule shards (``leaf_spec``) is held by each
  rank of a model group as its 1/mp shard, and so are its optimizer
  moments (``ShardedParams``). The update is elementwise, so each rank
  updates its own shard (train/optim.py:penalised_update); the shards are
  then all-gathered over the model group into the module's parameter, the
  persistent work buffer the next forward reads. The model axis thus
  divides the memory of the parameters' masters and moments, not the
  FLOPs: the ranks of one data row compute the same rows with the same
  gathered weights.
- **Serving** (``ShardedReplica``, utils/infer.py): a replica group of mp
  devices keeps each sharded leaf as mp shards, one on each of its
  devices, and gathers them onto its first device for a call.

At dp = mp = 1 every collective is over one rank and the step is the
single-device step, bit for bit.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from facegen_torch.config import mesh_axes
from facegen_torch.parallel.multihost import rank_device

MIN_SHARD = 64  # facegen's min_shard: smaller dims stay replicated


def row_block(n: int, dp: int, i: int) -> Tuple[int, int]:
    """(start, stop) of data row i's rows of a batch of ``n`` over ``dp``
    data rows: blocks of c = ceil(n / dp) rows in order, as GSPMD pads an
    uneven sharding, so the last blocks may be short or empty."""
    c = -(-n // dp)
    start = min(i * c, n)
    return start, min(start + c, n)


def global_rows(mesh, batch: int) -> Optional[int]:
    """The count a step divides its loss sums by on ``mesh``: on a 2-D
    mesh of several data rows ``batch``, so that a rank's loss is its
    rows' share of the global batch's mean and the data group's SUM is
    that mean; None (a plain mean) on one data row or none."""
    return batch if isinstance(mesh, Mesh2D) and mesh.dp > 1 else None


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh2D:
    """This rank's place in a (dp x mp) mesh of ranks ``ranks`` (mesh order:
    ``ranks[i * mp + j]`` is data row i, model column j)."""

    dp: int
    mp: int
    rank: int                    # this process's rank in the process group
    ranks: Tuple[int, ...]       # the mesh's ranks in mesh order
    device: torch.device
    data_group: object           # ranks of this model column: the batch's reductions
    model_group: object          # ranks of this data row: the shards of a leaf

    @property
    def index(self) -> int:
        return self.ranks.index(self.rank)

    @property
    def i(self) -> int:
        """This rank's data row."""
        return self.index // self.mp

    @property
    def j(self) -> int:
        """This rank's model column."""
        return self.index % self.mp

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @property
    def backend(self) -> str:
        return dist.get_backend()

    def all_reduce_sum_(self, t: torch.Tensor) -> None:
        """SUM over the data group, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.data_group)

    def all_gather_(self, out: torch.Tensor, t: torch.Tensor) -> None:
        """``out`` (mp * t.numel(), contiguous) <- the model group's ``t`` in
        column order."""
        dist.all_gather(list(out.chunk(self.mp)), t, group=self.model_group)

    def row_count(self, n: int) -> int:
        """How many of a batch's ``n`` rows this data row holds."""
        start, stop = row_block(n, self.dp, self.i)
        return stop - start

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This data row's block of a batch-shaped tensor's rows (``row_block``)."""
        if self.dp == 1:
            return t
        start, stop = row_block(t.shape[0], self.dp, self.i)
        return t[start:stop]

    def pair_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This data row's rows of a batch that is two halves (D's real and
        fake images): its block of each half, in that order."""
        if self.dp == 1:
            return t
        half = t.shape[0] // 2
        return torch.cat([self.rows(t[:half]), self.rows(t[half:])])

    def warmup(self) -> None:
        """One all-reduce over the data group and one all-gather over the
        model group, waited for: their communicators exist after it (NCCL
        creates one at a group's first collective, which no CUDA-graph
        capture may hold)."""
        t = torch.ones(1, device=self.device)
        self.all_reduce_sum_(t)
        out = torch.empty(self.mp, device=self.device)
        self.all_gather_(out, torch.full((1,), float(self.j), device=self.device))
        if int(t.item()) != self.dp or out.tolist() != [float(k) for k in range(self.mp)]:
            raise RuntimeError(f"warm-up collectives gave {t.item()} and {out.tolist()}")


def _fmt(mesh_shape: Sequence[int]) -> str:
    return ",".join(str(v) for v in mesh_shape)


def _launch_message(n: int) -> str:
    return (f"no process group is up. The port trains on several devices with one process "
            f"per device: launch {n} processes with FACEGEN_COORDINATOR=host:port, "
            f"FACEGEN_NUM_PROCESSES={n} and FACEGEN_PROCESS_ID=0..{n - 1} "
            f"(parallel/multihost.py); a process never spans devices")


def resolve_axes(mesh_shape: Sequence[int], world_size: Optional[int]) -> Tuple[int, int]:
    """(dp, mp) of ``--meshShape`` 'DP' or 'DP,MP' (DP = -1: the group's size
    over MP) against a process group of ``world_size`` ranks (None: no group,
    one process). Raises ValueError unless dp * mp is the group's size,
    and without a group for more than one rank, saying how to launch."""
    dp, mp, _ = mesh_axes(mesh_shape)
    if world_size is None and (dp, mp) not in ((1, 1), (-1, 1)):
        n = dp * mp if dp > 0 else mp
        raise ValueError(f"--meshShape {_fmt(mesh_shape)}: {_launch_message(n)}")
    world = 1 if world_size is None else world_size
    if dp == -1:
        if world % mp:
            raise ValueError(f"--meshShape {_fmt(mesh_shape)}: a model axis of {mp} does not "
                             f"divide the {world} ranks of the process group")
        dp = world // mp
    if dp * mp != world:
        raise ValueError(f"--meshShape {_fmt(mesh_shape)} asks for {dp * mp} ranks, but the "
                         f"process group has {world}")
    return dp, mp


def make_mesh2d(dp: int, mp: int, ranks: Optional[Sequence[int]] = None,
                device=None) -> Optional[Mesh2D]:
    """The (dp x mp) mesh over ``ranks`` (default: the group's first dp * mp
    ranks), facegen's ``make_mesh2d`` (:53-67). Every rank of the process
    group calls it, since every rank creates every group, in one order; a
    rank outside the mesh gets None. ``device``: this rank's device, by
    default ``cuda:(rank % device_count)``."""
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh axes must be positive, got ({dp}, {mp})")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"make_mesh2d({dp}, {mp}): no process group is up "
                         f"(parallel/multihost.py:maybe_initialize)")
    world = dist.get_world_size()
    ranks = tuple(range(world))[:dp * mp] if ranks is None else tuple(ranks)
    if dp * mp > len(ranks) or dp * mp > world:
        raise ValueError(f"mesh ({dp}, {mp}) needs {dp * mp} ranks, have "
                         f"{min(len(ranks), world)}")
    if len(ranks) != dp * mp:
        raise ValueError(f"mesh ({dp}, {mp}) over {len(ranks)} ranks {list(ranks)}")
    grid = np.asarray(ranks).reshape(dp, mp)
    me = dist.get_rank()
    data_group = model_group = None
    for j in range(mp):
        group = dist.new_group([int(r) for r in grid[:, j]])
        if me in grid[:, j]:
            data_group = group
    for i in range(dp):
        group = dist.new_group([int(r) for r in grid[i]])
        if me in grid[i]:
            model_group = group
    if me not in ranks:
        return None
    device = torch.device(device) if device is not None else rank_device(me)
    return Mesh2D(dp, mp, me, ranks, device, data_group, model_group)


def ensure_mesh2d(mesh):
    """A 1-D data mesh (parallel/mesh.py:DataMesh) of N ranks as the (N, 1)
    mesh; a Mesh2D or None passes (facegen's ``ensure_mesh2d``, :70-77).
    Every rank of the group calls it."""
    if mesh is None or isinstance(mesh, Mesh2D):
        return mesh
    return make_mesh2d(mesh.size, 1, device=mesh.device)


def mesh2d_from_shape(mesh_shape: Sequence[int], device=None) -> Optional[Mesh2D]:
    """The mesh of ``--meshShape`` 'DP' or 'DP,MP' (-1: every rank) over the
    process group that is up; None without one when the shape asks for one
    rank (facegen's ``mesh2d_from_shape``, :80-89). Raises ValueError as
    ``resolve_axes`` does."""
    if not (dist.is_available() and dist.is_initialized()):
        resolve_axes(mesh_shape, None)
        return None
    dp, mp = resolve_axes(mesh_shape, dist.get_world_size())
    return make_mesh2d(dp, mp, device=device)


def hybrid_axes(world: int, ranks_per_host: int, ici_dp: int = -1,
                ici_mp: int = 1) -> Tuple[int, int]:
    """(dp, mp) of facegen's ``hybrid_mesh`` (facegen/parallel/multihost.py:
    81-110) over ``world`` ranks, ``ranks_per_host`` on each host: each host
    keeps its (ici_dp x ici_mp) layout and the hosts stack on the data
    axis, (hosts * ici_dp, ici_mp); ici_dp = -1 is a host's ranks over
    ici_mp."""
    if world % ranks_per_host:
        raise ValueError(f"{world} ranks are not hosts of {ranks_per_host}")
    if ici_dp == -1:
        ici_dp = ranks_per_host // ici_mp
    if ici_dp < 1 or ici_mp < 1 or ici_dp * ici_mp > ranks_per_host:
        raise ValueError(f"a host of {ranks_per_host} ranks has no ({ici_dp}, {ici_mp}) layout")
    return (world // ranks_per_host) * ici_dp, ici_mp


def hybrid_mesh(ici_dp: int = -1, ici_mp: int = 1, ranks_per_host: Optional[int] = None,
                device=None) -> Optional[Mesh2D]:
    """facegen's multi-host ("data", "model") mesh with the hosts on the
    outer data axis, as its fallback without a slice topology lays it
    out: the first (hosts * ici_dp) x ici_mp ranks, row-major. Ranks are
    numbered host by host (``FACEGEN_PROCESS_ID`` = host * ranks_per_host
    + local rank), so when a host's ranks fill its layout a model group
    never leaves its host and only the data group's all-reduce crosses
    hosts. ``ranks_per_host``: default this host's CUDA devices, or the
    whole group on the CPU."""
    world = dist.get_world_size()
    if ranks_per_host is None:
        ranks_per_host = torch.cuda.device_count() if torch.cuda.is_available() else world
    dp, mp = hybrid_axes(world, ranks_per_host, ici_dp, ici_mp)
    return make_mesh2d(dp, mp, device=device)


# -------------------------------------------------------------- the leaf rule
def leaf_spec(shape: Sequence[int], mp: int, min_shard: int = MIN_SHARD) -> Optional[int]:
    """facegen's ``_leaf_spec`` (:92-104) on a leaf of facegen's logical
    shape: the axis the model axis shards, or None (replicated). A dense
    kernel (fan_in, fan_out) shards its fan_out if mp divides it and it
    is at least ``min_shard``, else its fan_in under the same test; a conv
    kernel (K, K, Cin, Cout) its Cout; anything else is replicated."""
    shape = tuple(shape)
    if len(shape) == 2:
        if shape[1] % mp == 0 and shape[1] >= min_shard:
            return 1
        if shape[0] % mp == 0 and shape[0] >= min_shard:
            return 0
    elif len(shape) == 4 and shape[3] % mp == 0 and shape[3] >= min_shard:
        return 3
    return None


# facegen's axis -> the port's dim, for the layouts of utils/checkpoint.py:
# conv (Cout, Cin, K, K) is facegen's (K, K, Cin, Cout), dense (out, in) its (in, out)
_TORCH_DIM = {(4, 3): 0, (2, 1): 0, (2, 0): 1}


def torch_shard_dim(shape: Sequence[int], mp: int, min_shard: int = MIN_SHARD) -> Optional[int]:
    """The dim of a parameter of the port's layout that the rule shards,
    decided on facegen's logical shape of that leaf; None when replicated,
    and for every leaf at mp = 1."""
    if mp == 1:
        return None
    shape = tuple(shape)
    if len(shape) == 4:
        logical = (shape[2], shape[3], shape[1], shape[0])
    elif len(shape) == 2:
        logical = (shape[1], shape[0])
    else:
        return None
    axis = leaf_spec(logical, mp, min_shard)
    return None if axis is None else _TORCH_DIM[(len(shape), axis)]


def _split_view(t: torch.Tensor, dim: int, mp: int) -> torch.Tensor:
    """``t`` viewed as (mp, *shard shape): its mp shards along ``dim`` first."""
    shape = tuple(t.shape)
    return t.view(shape[:dim] + (mp, shape[dim] // mp) + shape[dim + 1:]).movedim(dim, 0)


def _shard_of(t: torch.Tensor, dim: Optional[int], mp: int, j: int) -> torch.Tensor:
    """Column j's shard of ``t`` along ``dim`` (a view); ``t`` when None."""
    return t if dim is None else _split_view(t, dim, mp)[j]


class ShardedParams:
    """The masters of a module's parameters on one rank of a mesh: a
    parameter the rule shards has its 1/mp shard here (a view into one
    flat buffer), any other is the module's parameter itself. The
    optimizer's state is made from ``masters``, so its moments have the
    shards' shapes.

    A sharded parameter is the rank's full work weight. Its storage is laid
    out with the sharded dim first (a view moves that dim back), so each
    column's shard is one contiguous block of it and the all-gather over
    the model group writes straight into the parameter: beside the work
    weights a rank keeps no staging buffer, only the masters and their
    moments, 1/mp of each sharded leaf."""

    def __init__(self, params: Sequence[nn.Parameter], mesh: Mesh2D):
        self.params, self.mesh = list(params), mesh
        self.dims = [torch_shard_dim(p.shape, mesh.mp) for p in self.params]
        sizes = [p.numel() // mesh.mp if d is not None else 0
                 for p, d in zip(self.params, self.dims)]
        self.flat = torch.empty(sum(sizes), device=self.params[0].device)
        self.masters: List[torch.Tensor] = []
        self.works: List[Tuple[torch.Tensor, torch.Tensor]] = []  # (work, master), flat
        offset = 0
        for p, d, n in zip(self.params, self.dims, sizes):
            if d is None:
                self.masters.append(p)
                continue
            work = p.detach().movedim(d, 0).contiguous()  # shard-major storage
            p.data = work.movedim(0, d)
            master = self.flat[offset:offset + n]
            offset += n
            self.works.append((work.view(-1), master))
            self.masters.append(master.view((work.shape[0] // mesh.mp,) + work.shape[1:])
                                .movedim(0, d))
        self.pull_()

    @property
    def sharded(self) -> bool:
        return bool(self.works)

    def shards(self, full: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's shard of each tensor of the parameters' shapes (views)."""
        return [_shard_of(t, d, self.mesh.mp, self.mesh.j) for t, d in zip(full, self.dims)]

    @torch.no_grad()
    def pull_(self) -> None:
        """Masters <- this rank's shards of the parameters (after a load)."""
        for work, master in self.works:
            master.copy_(work.chunk(self.mesh.mp)[self.mesh.j])

    def gather_(self) -> None:
        """Every sharded parameter <- its shards, all-gathered from the model
        group into its storage (one collective a leaf)."""
        for work, master in self.works:
            self.mesh.all_gather_(work, master)

    @torch.no_grad()
    def full(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Full tensors of the parameters' shapes from tensors of the
        masters' shapes (an optimizer moment): one all-gather over the model
        group a sharded leaf, into a new tensor; a replicated leaf's tensor
        is returned as it is. Every rank of the mesh calls it."""
        outs = []
        for t, d in zip(tensors, self.dims):
            if d is None:
                outs.append(t)
                continue
            shard = t.movedim(d, 0).contiguous()
            work = torch.empty((shard.shape[0] * self.mesh.mp,) + shard.shape[1:],
                               dtype=t.dtype, device=t.device)
            self.mesh.all_gather_(work.view(-1), shard.view(-1))
            outs.append(work.movedim(0, d))
        return outs

    def full_opt(self, opt: dict) -> dict:
        """An optimizer state of shard-shaped moments as full tensors."""
        return {k: self.full(v) if isinstance(v, list) else v for k, v in opt.items()}

    @torch.no_grad()
    def load_opt_(self, opt: dict, full: dict) -> None:
        """``opt`` (the masters' shapes) <- this rank's shards of ``full``."""
        for k, v in opt.items():
            if isinstance(v, list):
                for t, s in zip(v, self.shards(full[k])):
                    t.copy_(s)
            else:
                v.copy_(full[k])


def shard_params(modules: Dict[str, nn.Module], mesh: Mesh2D) -> Dict[str, ShardedParams]:
    """``ShardedParams`` of each named module's parameters on ``mesh``."""
    return {k: ShardedParams(list(m.parameters()), mesh) for k, m in modules.items()}


def gather_params(shards: Optional[Dict[str, ShardedParams]], opts: Dict[str, dict]
                  ) -> Dict[str, dict]:
    """The optimizer states ``opts`` (keyed as ``shards``) with full
    moments; as they are without shards."""
    if shards is None:
        return dict(opts)
    return {k: shards[k].full_opt(v) for k, v in opts.items()}


def _memory_order(t: torch.Tensor) -> List[int]:
    """``t``'s dims from the outermost in memory to the innermost."""
    return sorted(range(t.dim()), key=lambda d: (-t.stride(d), d))


def flat_all_reduce(mesh, buffers: Dict[str, torch.Tensor], key: str,
                    parts: Sequence[torch.Tensor],
                    like: Sequence[Optional[torch.Tensor]] = ()) -> List[torch.Tensor]:
    """``parts`` summed over ``mesh``'s data group in one SUM all-reduce of
    a flat fp32 buffer (``buffers[key]``, allocated at the first call so a
    CUDA graph's capture finds it in place); fp32 views of the buffer in
    the parts' shapes. The first ``len(like)`` parts are laid out in the
    buffer as their ``like`` tensor (a parameter, e.g. a sharded one's
    shard-major storage; None: row-major), and their views have its
    strides: the packing copy is the only one."""
    orders = [_memory_order(m) if m is not None else list(range(t.dim()))
              for t, m in zip(parts, like)]
    orders += [list(range(t.dim())) for t in parts[len(orders):]]
    sizes = [t.numel() for t in parts]
    flat = buffers.get(key)
    if flat is None:
        flat = buffers[key] = torch.empty(sum(sizes), device=parts[0].device)
    torch.cat([t.permute(o).reshape(-1).float() for t, o in zip(parts, orders)], out=flat)
    mesh.all_reduce_sum_(flat)
    outs = []
    for p, t, o in zip(flat.split(sizes), parts, orders):
        inverse = sorted(range(len(o)), key=o.__getitem__)
        outs.append(p.view([t.shape[d] for d in o]).permute(inverse))
    return outs


# -------------------------------------------------------------------- serving
class ShardedReplica:
    """A module served by a replica group of devices (facegen's
    ``gspmd_infer_jit``'s params on the leaf rule): it runs on
    ``devices[0]``, and each leaf the rule shards over ``len(devices)``
    lives between calls as one shard on each device, gathered onto the
    first for every call and released after it."""

    def __init__(self, module: nn.Module, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.module = copy.deepcopy(module).to(self.device).eval()
        mp = len(self.devices)
        self.leaves = []  # (parameter, dim, shards)
        for p in self.module.parameters():
            dim = torch_shard_dim(p.shape, mp)
            if dim is not None:
                shards = [s.to(dev, copy=True) for s, dev in zip(_split_view(p.data, dim, mp),
                                                                 self.devices)]
                self.leaves.append((p, dim, shards))
                p.data = torch.empty(0, device=self.device)

    @torch.no_grad()
    def __call__(self, x):
        for p, dim, shards in self.leaves:
            p.data = torch.cat([s.to(self.device) for s in shards], dim)
        try:
            return self.module(x)
        finally:
            for p, _, _ in self.leaves:
                p.data = torch.empty(0, device=self.device)
