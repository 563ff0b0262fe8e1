"""The rank programs of tests/test_torch_port_parallel.py.

Each runs in a process of a 2-rank gloo group on the CPU, started with
``torch.multiprocessing`` by ``spawn``. This module imports neither JAX
nor facegen: the parent computes facegen's side and hands the ranks
their inputs as ``.npz`` files under a work directory, and each rank
writes its results there: a digest of its state's leaves under facegen's
checkpoint paths (``report``), and only where the parent compares
values, the leaves themselves. A rank's own checks are asserts, which
reach the parent as the spawned process's exception.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import shutil
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from facegen_torch.config import TrainConfig
from facegen_torch.models import gan
from facegen_torch.nn.init import seeded_generator
from facegen_torch.parallel import (
    DataMesh,
    Mesh2D,
    is_multiprocess,
    make_mesh,
    maybe_initialize,
    resolve_mesh_shape,
    shard_pool,
    training_mesh,
    warmup_collectives,
)
from facegen_torch.train import main as train_main
from facegen_torch.train.loop import Trainer
from facegen_torch.train.step import (
    DDraws,
    GDraws,
    StepDraws,
    TrainStep,
    draw_step,
    empty_draws,
    init_state,
)
from facegen_torch.utils import checkpoint as ckpt

WORLD = 2
SHARED_WAIT_S = 900.0  # how long a test worker waits for another to build a ranks run
# the Trainer cases: 4 steps of batch 8 per epoch, 16x16 gray
TINY = dict(scale=16, grayscale=True, noise_dim=8, batch_size=8, n_epoch=16,
            synthetic_data=True, noplot=True, compute_dtype="float32", reference_init=False)


def digest(arrays) -> dict:
    """sha256 of each leaf's dtype, shape and bytes: equal digests, equal
    states."""
    return {k: hashlib.sha256(f"{v.dtype}{v.shape}".encode() + np.ascontiguousarray(v).tobytes())
            .hexdigest() for k, v in arrays.items()}


def report(work: str, name: str, state, **meta) -> None:
    """Write ``<work>/<name>.json``: the digest of ``state``'s leaves and
    ``meta``."""
    with open(os.path.join(work, f"{name}.json"), "w") as f:
        json.dump({"digest": digest(ckpt.train_state_arrays(state)), **meta}, f)


def publish(work: str, name: str, obj) -> None:
    """Write ``<work>/<name>`` as JSON in one rename, so a rank that waits
    for it (``wait_for``) never reads it half written. The parent writes
    each program's JSON after the ``.npz`` files it names."""
    path = os.path.join(work, name)
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def abandon(work: str) -> None:
    """Tell the waiting ranks that the parent failed before its inputs."""
    open(os.path.join(work, "abandoned"), "w").close()


def wait_for(work: str, name: str, timeout: float = 600.0) -> str:
    """``<work>/<name>``, once the parent has written it: the ranks start
    while the parent still makes their inputs."""
    path, t0 = os.path.join(work, name), time.monotonic()
    while not os.path.exists(path):
        if os.path.exists(os.path.join(work, "abandoned")):
            raise RuntimeError(f"the parent failed before writing {name}")
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {name} after {timeout} s")
        time.sleep(0.05)
    return path


@contextlib.contextmanager
def run_once(tmp_path_factory, name: str, build, timeout: float = SHARED_WAIT_S):
    """Yields ``(work, side)``: ``build(work)`` run once per test session in
    the directory ``work``, returning ``side`` (picklable: numpy arrays,
    not JAX's). Under pytest-xdist the workers share the session's base
    directory (pytest-xdist's recipe for a session fixture): the first
    worker to take the file lock builds and pickles ``side`` beside the
    ranks' files, and the others wait for the lock, at most ``timeout``
    seconds, then read them. A failed build leaves its traceback, which
    every later caller raises at once. Each worker that uses ``work``
    holds a marker in ``<name>.users`` until the context ends; the last
    to leave removes ``work`` (several GB of states and checkpoints), so
    no worker removes what another may still read."""
    from filelock import FileLock, Timeout  # torch depends on filelock

    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    work, users = root / name, root / f"{name}.users"
    done, failed = work / "side.pkl", work / "failed.txt"
    lock = FileLock(str(root / f"{name}.lock"), timeout=timeout)
    marker = users / os.environ.get("PYTEST_XDIST_WORKER", "main")
    side = None
    try:
        with lock:
            users.mkdir(exist_ok=True)
            marker.touch()
            if failed.exists():
                raise RuntimeError(f"building {name} failed in another worker:\n"
                                   f"{failed.read_text()}")
            if not done.exists():
                work.mkdir(exist_ok=True)
                try:
                    side = build(str(work))
                except BaseException:
                    failed.write_text(traceback.format_exc())
                    raise
                with open(str(done) + ".tmp", "wb") as f:
                    pickle.dump(side, f)
                os.replace(str(done) + ".tmp", done)
    except Timeout:
        raise TimeoutError(f"waited {timeout} s for another worker to build {name} "
                           f"under {root}") from None
    if side is None:
        with open(done, "rb") as f:
            side = pickle.load(f)
    try:
        yield str(work), side
    finally:
        with lock:
            marker.unlink(missing_ok=True)
            if not any(users.iterdir()) and not failed.exists():
                shutil.rmtree(work, ignore_errors=True)


def spawn(work: str, programs, env=None, join: bool = True):
    """Start the 2 ranks on ``programs`` (names of ``PROGRAMS``) with a
    FileStore under ``work``, or, with ``env`` (one mapping per rank), by
    ``maybe_initialize`` from those environments. Returns the process
    context when not joined."""
    return torch.multiprocessing.spawn(_rank_main, args=(work, list(programs), env),
                                       nprocs=WORLD, join=join)


def _rank_main(rank: int, work: str, programs, env):
    torch.set_num_threads(2)
    if env is None:
        store = dist.FileStore(os.path.join(work, "filestore"), WORLD)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD)
    else:
        assert maybe_initialize(env[rank], device_type="cpu")
    try:
        for name in programs:
            PROGRAMS[name](rank, work)
    finally:
        dist.destroy_process_group()


def _draws(npz, prefix: str) -> StepDraws:
    def masks(p):
        return {k[len(p):]: torch.from_numpy(npz[k]) for k in npz.files if k.startswith(p)}

    d = DDraws(torch.from_numpy(npz[prefix + "d_idx"]), torch.from_numpy(npz[prefix + "d_noise"]),
               masks(prefix + "d_mask/"))
    g = GDraws(torch.from_numpy(npz[prefix + "g_noise"]), masks(prefix + "g_mask/"))
    return StepDraws((d,), (g,))


def _set_ring(state, value: float):
    state.accs.fill_(value)
    state.accs_n.fill_(state.accs.shape[0])


def steps(rank: int, work: str):
    """3 steps of each case's DP TrainStep on facegen's shard draws; the
    gate ring filled with 1s before the second (closed) and emptied
    before the third (open), as the parent does to facegen's state."""
    with open(wait_for(work, "steps.json")) as f:
        cases = json.load(f)
    for name, kw in cases.items():
        npz = np.load(os.path.join(work, f"{name}.npz"))
        cfg = TrainConfig(**kw).validate()
        g, d = gan.init_gan(torch.Generator().manual_seed(0), cfg.scale, cfg.channels,
                            cfg.noise_dim, reference_init=False)
        g.load_state_dict({k[2:]: torch.from_numpy(npz[k]) for k in npz.files
                           if k.startswith("g/")})
        d.load_state_dict({k[2:]: torch.from_numpy(npz[k]) for k in npz.files
                           if k.startswith("d/")})
        mesh = make_mesh((WORLD,), device="cpu")
        step = TrainStep(cfg, g, d, mesh)
        assert step.batch == cfg.batch_size // WORLD
        state = init_state(cfg, g, d)
        pool = shard_pool(torch.from_numpy(npz["pool"]), mesh)
        rows = []
        for i in range(3):
            if i > 0:
                _set_ring(state, 1.0 if i == 1 else 0.0)
            m = step(state, pool, _draws(npz, f"r{rank}/s{i}/"))
            rows.append([float(v) for v in m])
        report(work, f"{name}_rank{rank}", state, metrics=rows)
        if rank == 0:  # the values facegen's side is compared with
            ckpt.save(work, f"{name}_arrays", ckpt.train_state_arrays(state))


def gate(rank: int, work: str):
    """D_maxAcc 0 closes the gate on every rank: D does not move."""
    cfg = TrainConfig(**TINY, d_max_acc=0.0).validate()
    g, d = gan.init_gan(torch.Generator().manual_seed(1), cfg.scale, cfg.channels,
                        cfg.noise_dim, reference_init=False)
    mesh = make_mesh((-1,), device="cpu")
    step, state = TrainStep(cfg, g, d, mesh), init_state(cfg, g, d)
    before = ckpt.train_state_arrays(state)
    pool = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (32, 16, 16, 1), np.uint8))
    pool = shard_pool(pool, mesh)
    gen = seeded_generator("cpu", 3, rank)  # each rank draws its own batch
    draws = empty_draws(cfg, step.mask_specs, "cpu", step.batch)  # the local batch
    m = step(state, pool, draw_step(gen, cfg, pool.shape[0], step.mask_specs, out=draws))
    after = ckpt.train_state_arrays(state)
    assert float(m.gate_open) == 0.0 and int(state.not_trained_d) == 1
    assert int(state.trained_d) == 0 and int(state.confusion.sum()) == cfg.batch_size
    for k in before:
        if k.startswith(("params_d/", "opt_d/")):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert any(not np.array_equal(after[k], before[k]) for k in before
               if k.startswith("params_g/"))
    report(work, f"gate_rank{rank}", state)


def _trainer(rank: int, work: str, name: str, **kw) -> Trainer:
    """A world-2 Trainer of the TINY config saving under
    ``<work>/<name>/rank<r>``: rank 1's directory must stay absent."""
    cfg = TrainConfig(**{**TINY, **kw}, save=os.path.join(work, name, f"rank{rank}")).validate()
    return Trainer(cfg, mesh=make_mesh((WORLD,), device="cpu"), verbose=False)


def trainers(rank: int, work: str):
    """2 epochs each, and no checkpoint: single epochs, a chunk of 2
    (--epochsPerCompile 2) and segmented epochs (--weightsVisFreq 3); then
    a resume of the parent's world-1 checkpoint for one more epoch, which
    rank 0 saves."""
    for name, chunks, kw in (("single", (1, 1), dict(epochs_per_compile=1)),
                             ("chunk", (2,), dict(epochs_per_compile=2)),
                             ("segments", (1, 1), dict(weights_vis_freq=3))):
        tr = _trainer(rank, work, name, **kw)
        start = 0
        for n in chunks:
            tr.train_epochs_chunk(start, n)
            start += n
        report(work, f"{name}_rank{rank}", tr.state, readbacks=tr.readbacks,
               epochs_per_compile=tr.epochs_per_compile)
    wait_for(work, "world1.json")
    tr = _trainer(rank, work, "resumed", network=os.path.join(work, "world1", "adversarial"))
    report(work, f"resumed_start_rank{rank}", tr.state)
    stats = list(tr.run(1))
    assert np.isfinite(stats[0]["loss_d_mean"]) and tr.state.epoch == 3
    report(work, f"resumed_rank{rank}", tr.state)


def env_group(rank: int, work: str):
    """Checks inside a group that ``maybe_initialize`` brought up from the
    environment: the mesh, the warm-up, --meshShape against the group's
    size, and the trainer CLI's data-parallel run."""
    assert maybe_initialize({}) and is_multiprocess()  # already up: True, no second init
    mesh = make_mesh((-1,), device="cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (rank, WORLD, "gloo")
    warmup_collectives(mesh)
    assert resolve_mesh_shape((-1,), WORLD) == WORLD
    # 'DP,1' is the 2-D mesh, as facegen routes it (facegen/train/loop.py:507-519),
    # not this local-batch mesh, which a bare 'N' is
    assert isinstance(training_mesh((2, 1), device="cpu"), Mesh2D)
    assert isinstance(training_mesh((2,), device="cpu"), DataMesh)
    for shape in ((3,), (1,)):
        try:
            make_mesh(shape, device="cpu")
        except ValueError as e:
            assert f"asks for {shape[0]} ranks, but the process group has 2" in str(e), e
        else:
            raise AssertionError(f"make_mesh({shape}) in a group of 2")
    try:
        train_main(["--meshShape", "3"], device="cpu")
    except SystemExit:
        pass
    else:
        raise AssertionError("--meshShape 3 accepted in a group of 2")
    save = os.path.join(work, "cli", f"rank{rank}")
    argv = ["--scale", "16", "--grayscale", "--noiseDim", "8", "--batchSize", "8",
            "--N_epoch", "16", "--syntheticData", "--noplot", "--computeDtype", "float32",
            "--epochs", "1", "--meshShape", "2", "--save", save]
    tr = train_main(argv, device="cpu")
    assert tr.mesh.size == WORLD and tr.step.batch == 4 and tr.state.epoch == 2
    assert os.path.isdir(save) == (rank == 0)
    report(work, f"cli_rank{rank}", tr.state)


PROGRAMS = {"steps": steps, "gate": gate, "trainers": trainers, "env_group": env_group}
