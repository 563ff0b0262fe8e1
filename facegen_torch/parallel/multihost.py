"""Process-group entry points (counterpart of facegen/parallel/multihost.py).

facegen runs data parallel as one program over a mesh of devices: after
``jax.distributed.initialize`` every process sees every chip, and a
shard_map spans them. The port runs one process per device instead,
joined by ``torch.distributed``: NCCL between CUDA devices, gloo on the
CPU (the tests). Launching N processes is the opt-in, as in facegen:

    FACEGEN_COORDINATOR=host:port FACEGEN_NUM_PROCESSES=N \\
        FACEGEN_PROCESS_ID=r python -m facegen_torch.train --meshShape N

for r = 0 .. N-1; rank r trains on ``cuda:(r % device_count)``. A
process never spans devices.

- ``maybe_initialize`` is gated by the environment and a no-op without
  a coordinator, so every CLI calls it unconditionally and a
  single-device run is unchanged.
- ``warmup_collectives`` runs a tiny all-reduce before the first step. It
  makes NCCL build its communicator then, and not inside a CUDA-graph
  capture, which cannot create one.
- ``global_mesh`` (parallel/mesh.py) is the 1-D data mesh over every
  rank, and ``hybrid_mesh`` (parallel/gspmd.py) the 2-D mesh with the
  hosts on the data axis.
- facegen's ``global_put``, ``global_put_tree`` and ``shard_pool_global``
  (:144-180) assemble one global array from each process's rows. They
  have no counterpart here: each process already owns only its rows and
  its replica of the state (parallel/mesh.py).
"""

from __future__ import annotations

import os
import socket
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist


def _first(env: Mapping[str, str], *names: str) -> Optional[str]:
    return next((env[n] for n in names if env.get(n)), None)


def coordinator_settings(env: Mapping[str, str]) -> Optional[Tuple[str, int, int]]:
    """(host:port, number of processes, this process's id) from
    ``FACEGEN_COORDINATOR``, ``FACEGEN_NUM_PROCESSES`` and
    ``FACEGEN_PROCESS_ID``; JAX's ``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` are the fallbacks, as in
    facegen, and then torch's ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``
    and ``RANK``. None without a coordinator."""
    coord = _first(env, "FACEGEN_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
    if coord is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coord = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coord is None:
        return None
    nproc = int(_first(env, "FACEGEN_NUM_PROCESSES", "JAX_NUM_PROCESSES", "WORLD_SIZE") or 1)
    pid = int(_first(env, "FACEGEN_PROCESS_ID", "JAX_PROCESS_ID", "RANK") or 0)
    if not 0 <= pid < nproc:
        raise ValueError(f"process id {pid} is outside 0 .. {nproc - 1}")
    return coord, nproc, pid


def rank_device(rank: int, device_type: str = "cuda") -> torch.device:
    """The device of rank ``rank``: ``cuda:(rank % device_count)``, or the
    CPU when ``device_type`` is "cpu"."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA GPU: rank {rank} runs on a CUDA device")
    return torch.device("cuda", rank % torch.cuda.device_count())


def shared_cards(cards: List[str]) -> Dict[str, List[int]]:
    """The cards that more than one rank would use: card -> its ranks,
    from each rank's "host/device" string in rank order."""
    ranks: Dict[str, List[int]] = {}
    for r, card in enumerate(cards):
        ranks.setdefault(card, []).append(r)
    return {card: rs for card, rs in ranks.items() if len(rs) > 1}


def _check_one_rank_per_card(store, rank: int, world: int, device: torch.device) -> None:
    """NCCL refuses two ranks on one device (at their first collective, or
    by hanging): every rank publishes its card and every rank fails,
    naming the ranks, when two share one."""
    store.set(f"facegen/card/{rank}", f"{socket.gethostname()}/{device}")
    cards = [store.get(f"facegen/card/{r}").decode() for r in range(world)]
    shared = shared_cards(cards)
    if shared:
        raise RuntimeError(
            "under NCCL each rank needs a card of its own, but "
            + "; ".join(f"ranks {rs} would share {card}" for card, rs in shared.items())
            + f" (rank r uses cuda:(r % {torch.cuda.device_count()})): launch at most one "
            "rank per card")


def maybe_initialize(env: Optional[Mapping[str, str]] = None, device_type: str = "cuda",
                     backend: Optional[str] = None) -> bool:
    """Env-gated ``torch.distributed.init_process_group`` (facegen's
    ``maybe_initialize``, :40-65). Returns True when a process group is up
    (also when one already was), False for an ordinary single-process run.

    The backend is NCCL when the rank's device (``rank_device``) is a CUDA
    device and gloo on the CPU; a library caller may pass ``backend``
    (gloo for ranks that share a card). Under NCCL, ranks that would
    share a card fail with a message that says so."""
    if dist.is_initialized():
        return True
    settings = coordinator_settings(os.environ if env is None else env)
    if settings is None:
        return False
    coord, nproc, pid = settings
    device = rank_device(pid, device_type)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    host, port = coord.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), nproc, is_master=pid == 0)
    if backend == "nccl":
        _check_one_rank_per_card(store, pid, nproc, device)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=pid, world_size=nproc)
    return True


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def warmup_collectives(mesh) -> None:
    """Warm ``mesh``'s collectives (``DataMesh.warmup``: one all-reduce;
    ``Mesh2D.warmup``: one over each of its two groups), waited for: the
    communicators exist after it. Run it before the first step and before
    any CUDA-graph capture of a collective (train/graph.py)."""
    mesh.warmup()
