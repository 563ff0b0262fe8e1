"""The port's data parallelism (facegen_torch/parallel/) against facegen's
1-D shard_map mode, on the CPU.

The ranks are two processes of a gloo group with one thread each,
started with torch.multiprocessing on the programs of
tests/torch_port_parallel_ranks.py, which import neither JAX nor
facegen. One module fixture starts them once, with a FileStore under its
work directory, for the steps, the gate and the trainer cases, and
computes facegen's side while they run; one test starts a pair through
``maybe_initialize`` from a TCP coordinator on a port it has just bound.

The steps: G32 + D32b colour at batch 8 and G16 + D16_d gray at batch
16, fp32, 3 steps against facegen.parallel.make_parallel_step on a
2-device mesh of the conftest's virtual CPU devices, the gate open,
closed (the ring filled with 1s) and open (emptied). Rank r gets
facegen's own draws for its shard, rebuilt from fold_in(rng, r) with
tests/test_torch_port_train_step.py's recipe at the local batch and the
16 local rows of the 32-row pool. Tolerances, as in that file: losses
rtol 1e-4; the parameters' change and Adam's moments 1e-3 relative l2
(G16 + D16_d's D change and D first moment: 5e-3, for the reason at
``CASES``); batch-norm statistics 1e-5 absolute; the ring, the counters
and the confusion matrix exactly (its sum is the global batch per
step); the two ranks' states bit-equal.

Serving: GanInference over devices ["cpu", "cpu"] against one device
within 1e-5 (the same fp32 convs at half the batch), and against
facegen's GanInference on make_mesh2d(2, 1) within 2e-4
(tests/test_torch_port_sampler.py's tolerance).
"""

import json
import os
import shutil
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_parallel_ranks as ranks
import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen.config import TrainConfig as JaxTrainConfig
from facegen.models import gan as jax_gan
from facegen.parallel import make_mesh as jax_make_mesh
from facegen.parallel import make_mesh2d, make_parallel_step
from facegen.parallel import replicate as jax_replicate
from facegen.parallel import shard_pool as jax_shard_pool
from facegen.train.step import init_state as jax_init_state
from facegen.utils import checkpoint as jax_ckpt
from facegen.utils.infer import GanInference as JaxInference
from facegen.utils.infer import nearest_neighbours as jax_nearest_neighbours
from facegen.utils.infer import prepare_nn_dataset as jax_prepare_nn_dataset
from facegen_torch import sample
from facegen_torch.config import SampleConfig, TrainConfig, train_config_from_args
from facegen_torch.models import gan
from facegen_torch.nn import dropout
from facegen_torch.parallel import make_mesh, maybe_initialize
from facegen_torch.parallel.multihost import coordinator_settings, shared_cards
from facegen_torch.train import main as train_main
from facegen_torch.train.loop import Trainer
from facegen_torch.utils import checkpoint as ckpt
from facegen_torch.utils.infer import GanInference, nearest_neighbours, prepare_nn_dataset

# name -> (scale, channels, global batch, the leaves held to a wider
# relative l2 than TOL). G16 + D16_d's D gradient is: its ~1M PReLU
# inputs per forward put some within fp32 rounding of the kink, where the
# two packages' sums round to either side and the derivative jumps from 1
# to the slope. On these draws the port reads 2.0e-3 against facegen on
# D's change and 1.4e-3 on D's first moment (every other leaf of both
# cases reads at most 5.4e-4), and 2.7e-5 on D's change once the weights
# move by one ulp (x3 then /3); the port's own fp32 gradient of D16_d's
# conv branch is 5e-3 from its fp64 one at batch 16 (one of conv3's
# 131072 PReLU inputs is 2.7e-8 from 0 and changes sign), which sets the
# wider limit. A wrong reduction (a sum for a mean, a statistic left
# unreduced, another shard's rows) moves these by O(1).
TOL = 1e-3  # the parameters' change and Adam's moments, relative l2
CASES = {"g32": (32, 3, 8, {}),
         "g16": (16, 1, 16, {"params_d/": 5e-3, "opt_d/0/mu/": 5e-3})}
NOISE_DIM = 16
POOL = 32
STAT_TOL = 1e-5
SERVE_TOL = 1e-5
JAX_TOL = 2e-4


def _step_kwargs(scale, channels, bs, wider):
    return dict(batch_size=bs, scale=scale, grayscale=channels == 1, noise_dim=NOISE_DIM,
                compute_dtype="float32", reference_init=False, g_l2=1e-3, d_max_acc=0.97)


def _jax_case(scale, channels, bs, wider):
    """facegen's nets with nonzero G biases (their exact gradient is 0
    behind batch norm), and the pool."""
    jg, jd, bundle = jax_gan.init_gan(jax.random.key(scale), scale, channels, NOISE_DIM,
                                      reference_init=False)
    bundle["params_g"] = jax.tree_util.tree_map_with_path(
        lambda p, a: jax.random.uniform(jax.random.key(a.size), a.shape, minval=-0.1,
                                        maxval=0.1) if p[-1].key == "b" else a,
        bundle["params_g"])
    pool = np.random.RandomState(7).randint(0, 256, (POOL, scale, scale, channels), np.uint8)
    return jg, jd, bundle, pool


def _masks(key, specs):
    """facegen's keep-masks: the dropout key folded with each index along
    the layer's name (facegen/nn/core.py:49-53,101-105)."""
    out = {}
    for name, (shape, rate) in specs.items():
        k = key
        for part in name.split("."):
            k = jax.random.fold_in(k, int(part[:2]))
        out[name] = np.array(jax.random.bernoulli(k, 1.0 - rate, shape))
    return out


def _shard_draws(rng, local_bs, specs):
    """One shard's draws of the step keyed ``rng`` (already folded with
    the shard's index), under the rank program's .npz names."""
    half = local_bs // 2
    k_idx, k_noise, _, k_drop = jax.random.split(jax.random.fold_in(rng, 0), 4)
    out = {"d_idx": np.array(jax.random.randint(k_idx, (half,), 0, POOL // ranks.WORLD),
                             np.int64),
           "d_noise": np.array(jax.random.uniform(k_noise, (half, NOISE_DIM), jnp.float32,
                                                  -1.0, 1.0))}
    out.update({f"d_mask/{k}": m for k, m in _masks(k_drop, specs).items()})
    k_noise, _, k_drop = jax.random.split(jax.random.fold_in(rng, 1000), 3)
    out["g_noise"] = np.array(jax.random.uniform(k_noise, (local_bs, NOISE_DIM), jnp.float32,
                                                 -1.0, 1.0))
    out.update({f"g_mask/{k}": m for k, m in _masks(k_drop, specs).items()})
    return out


def _step_inputs(work, name, scale, channels, bs, wider):
    """Write the ranks' .npz (weights, pool, every shard's draws); returns
    facegen's (nets, bundle, pool)."""
    jg, jd, bundle, pool = _jax_case(scale, channels, bs, wider)
    sds = ckpt.jax_to_torch(jax_ckpt.flatten_tree(bundle))
    _, d = gan.init_gan(torch.Generator().manual_seed(0), scale, channels, NOISE_DIM,
                        reference_init=False)
    specs = dropout.dropout_mask_specs(d, bs // ranks.WORLD, (scale, scale, channels))
    arrays = {f"{net}/{k}": t.numpy() for net in ("g", "d") for k, t in sds[net].items()}
    arrays["pool"] = pool
    for i in range(3):
        rng = jax.random.fold_in(jax.random.key(5), i)
        for r in range(ranks.WORLD):
            for k, v in _shard_draws(jax.random.fold_in(rng, r), bs // ranks.WORLD,
                                     specs).items():
                arrays[f"r{r}/s{i}/{k}"] = v
    np.savez(os.path.join(work, f"{name}.npz"), **arrays)
    return jg, jd, bundle, pool


def _jax_steps(jg, jd, bundle, pool, kw):
    """3 steps of make_parallel_step on a 2-device mesh: (start, end
    leaves under checkpoint paths, per-step metrics)."""
    jcfg = JaxTrainConfig(**kw).validate()
    mesh = jax_make_mesh((ranks.WORLD,))
    state = jax_init_state(jcfg, bundle)
    start = jax_ckpt.flatten_tree(state)
    state = jax_replicate(state, mesh)
    pool = jax_shard_pool(jnp.asarray(pool), mesh)
    step = make_parallel_step(jg, jd, jcfg, mesh)
    k = jcfg.accs_interval
    rows = []
    for i in range(3):
        if i > 0:  # a full ring of 1s closes the gate, an empty one opens it
            state = state._replace(accs=jnp.full((k,), 1.0 if i == 1 else 0.0, jnp.float32),
                                   accs_n=jnp.int32(k))
        state, m = step(state, jax.random.fold_in(jax.random.key(5), i), pool)
        rows.append([float(v) for v in m])
    return start, jax_ckpt.flatten_tree(jax.device_get(state)), rows


def _numpy(tree):
    """``tree`` with its JAX arrays as numpy arrays (picklable anywhere)."""
    return jax.tree.map(lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def _ranks_and_facegen(work):
    """The ranks' programs ("gate", "trainers", "steps") in one pair of
    processes, started first: they wait for each input as the parent
    writes it (``ranks.wait_for``); facegen's steps computed meanwhile.
    Returns facegen's side, with numpy arrays."""
    ctx = ranks.spawn(work, ["gate", "trainers", "steps"], join=False)
    try:
        inputs, kwargs = {}, {}
        for name, case in CASES.items():
            kwargs[name] = _step_kwargs(*case)
            inputs[name] = _step_inputs(work, name, *case)
        ranks.publish(work, "steps.json", kwargs)
        # a world-1 checkpoint for the ranks to resume (run() saves at its end)
        world1 = Trainer(TrainConfig(**ranks.TINY, save=os.path.join(work, "world1")),
                         device="cpu", verbose=False)
        list(world1.run(1))
        ranks.publish(work, "world1.json", {})
        jax_side = {name: _jax_steps(*inputs[name], kwargs[name]) for name in CASES}
    except BaseException:
        ranks.abandon(work)
        raise
    finally:
        while not ctx.join(timeout=600):
            pass
    return _numpy(jax_side)


@pytest.fixture(scope="session")
def ranks_run(tmp_path_factory):
    """(the ranks' work directory, facegen's side), built once per test
    session (``ranks.run_once``): under pytest-xdist the other workers read
    the first one's files, and the last worker to finish removes them
    (the ranks' states and checkpoints: ~0.9 GB)."""
    with ranks.run_once(tmp_path_factory, "ranks", _ranks_and_facegen) as run:
        yield run


def _assert_ranks_equal(work, name):
    """Both ranks' reports of ``name``: their states' digests equal;
    returns rank 0's report."""
    reports = []
    for r in range(ranks.WORLD):
        with open(os.path.join(work, f"{name}_rank{r}.json")) as f:
            reports.append(json.load(f))
    assert reports[0]["digest"] == reports[1]["digest"]
    return reports[0]


def _rel_l2(ours, theirs):
    num = sum(float(np.sum((o - t) ** 2)) for o, t in zip(ours, theirs))
    return (num / max(sum(float(np.sum(t ** 2)) for t in theirs), 1e-300)) ** 0.5


@pytest.mark.parametrize("name", list(CASES))
def test_three_steps_match_make_parallel_step(ranks_run, name):
    work, jax_side = ranks_run
    start, theirs, jrows = jax_side[name]
    wider = CASES[name][3]
    rows = _assert_ranks_equal(work, name)["metrics"]
    ours, _ = ckpt.load(work, f"{name}_arrays")
    assert ranks.digest(ours) == _assert_ranks_equal(work, name)["digest"]
    assert [r[3] for r in rows] == [r[3] for r in jrows] == [1.0, 0.0, 1.0]
    for r, jr in zip(rows, jrows):  # loss_d, loss_g, acc_d
        np.testing.assert_allclose(r[:3], jr[:3], rtol=1e-4)
    assert set(ours) == set(theirs)
    exact = [k for k in theirs if "/" not in k or k.endswith("/count")]
    for k in exact:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)
    assert int(ours["confusion"].sum()) == 3 * CASES[name][2]  # the global batch per step
    assert int(ours["opt_d/0/count"]) == 2 and int(ours["opt_g/0/count"]) == 3
    for prefix in ("params_g/", "params_d/"):
        keys = [k for k in theirs if k.startswith(prefix)]
        err = _rel_l2([ours[k] - start[k] for k in keys],
                      [np.asarray(theirs[k]) - start[k] for k in keys])
        assert err <= wider.get(prefix, TOL), (prefix, err)
    for prefix in ("opt_g/0/mu/", "opt_g/0/nu/", "opt_d/0/mu/", "opt_d/0/nu/"):
        keys = [k for k in theirs if k.startswith(prefix)]
        err = _rel_l2([ours[k] for k in keys], [np.asarray(theirs[k]) for k in keys])
        assert err <= wider.get(prefix, TOL), (prefix, err)
    for k in theirs:
        if k.startswith(("state_g/", "state_d/")):
            np.testing.assert_allclose(ours[k], np.asarray(theirs[k]), rtol=0, atol=STAT_TOL,
                                       err_msg=k)
        if k.startswith("state_g/"):
            assert not np.array_equal(ours[k], start[k]), k  # the statistics moved


def test_a_closed_gate_is_global(ranks_run):
    """D_maxAcc 0: D moved on neither rank (the rank program checks it),
    and the ranks' states are equal (tests/test_parallel.py:100-115)."""
    work, _ = ranks_run
    _assert_ranks_equal(work, "gate")


def _metrics_rows(save):
    with open(os.path.join(save, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        for k in ("time", "seconds", "images_per_sec"):
            r.pop(k)
    return rows


@pytest.mark.parametrize("mode", ["chunk", "segments"])
def test_chunks_and_segments_train_what_single_epochs_train(ranks_run, mode):
    """World 2, 2 epochs: a chunk (--epochsPerCompile 2) and segmented
    epochs (--weightsVisFreq 3, dumps after steps 3 and 4) train what
    single epochs train; rank 0 alone writes."""
    work, _ = ranks_run
    ours, single = _assert_ranks_equal(work, mode), _assert_ranks_equal(work, "single")
    assert ours["digest"] == single["digest"]
    for name in (mode, "single"):
        assert not os.path.exists(os.path.join(work, name, "rank1"))
    rows = _metrics_rows(os.path.join(work, "single", "rank0"))
    assert _metrics_rows(os.path.join(work, mode, "rank0")) == rows
    assert [r["epoch"] for r in rows] == [1, 2] and single["readbacks"] == 2
    if mode == "chunk":
        assert (ours["readbacks"], ours["epochs_per_compile"]) == (1, 2)
    else:
        dumps = sorted(os.listdir(os.path.join(work, mode, "rank0", "viz", "netvis")))
        assert dumps == [f"e{e:04d}_s{s:05d}" for e in (1, 2) for s in (3, 4)]


def test_checkpoints_resume_across_world_sizes(ranks_run):
    """A world-1 checkpoint resumes at world 2, and the world-2 run's
    checkpoint resumes at world 1 (tests/test_parallel.py:492)."""
    work, _ = ranks_run
    saved, _ = ckpt.load(os.path.join(work, "world1"), "adversarial")
    assert _assert_ranks_equal(work, "resumed_start")["digest"] == ranks.digest(saved)
    assert not os.path.exists(os.path.join(work, "resumed", "rank1"))
    back = Trainer(TrainConfig(**ranks.TINY, save=os.path.join(work, "world1_again"),
                               network=os.path.join(work, "resumed", "rank0", "adversarial")),
                   device="cpu", verbose=False)
    assert (ranks.digest(ckpt.train_state_arrays(back.state))
            == _assert_ranks_equal(work, "resumed")["digest"])
    stats = back.train_epoch(2)
    assert back.state.epoch == 4 and np.isfinite(stats["loss_d_mean"])


# ------------------------------------------------- process groups, --meshShape
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_maybe_initialize_brings_up_a_group_from_the_environment(tmp_path):
    """Rank 0 reads FACEGEN_*, rank 1 JAX's fallbacks; in the group: the
    mesh, the warm-up, --meshShape against its size and the trainer CLI
    (tests/torch_port_parallel_ranks.py:env_group)."""
    port = _free_port()
    env = [{"FACEGEN_COORDINATOR": f"127.0.0.1:{port}", "FACEGEN_NUM_PROCESSES": "2",
            "FACEGEN_PROCESS_ID": "0"},
           {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": "1"}]
    ranks.spawn(str(tmp_path), ["env_group"], env=env)
    _assert_ranks_equal(str(tmp_path), "cli")
    assert len(_metrics_rows(str(tmp_path / "cli" / "rank0"))) == 1
    shutil.rmtree(tmp_path / "cli")  # rank 0's checkpoint


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"FACEGEN_NUM_PROCESSES": "2", "FACEGEN_PROCESS_ID": "1"}, None),
    ({"FACEGEN_COORDINATOR": "h:1", "FACEGEN_NUM_PROCESSES": "4", "FACEGEN_PROCESS_ID": "2"},
     ("h:1", 4, 2)),
    ({"JAX_COORDINATOR_ADDRESS": "h:2", "JAX_NUM_PROCESSES": "3", "JAX_PROCESS_ID": "1"},
     ("h:2", 3, 1)),
    ({"FACEGEN_COORDINATOR": "h:3", "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1",
      "RANK": "0"}, ("h:3", 2, 1)),
    ({"MASTER_ADDR": "m", "MASTER_PORT": "5", "WORLD_SIZE": "2", "RANK": "1"}, ("m:5", 2, 1)),
    ({"FACEGEN_COORDINATOR": "h:4"}, ("h:4", 1, 0)),
])
def test_the_environment_gates_initialization(env, want):
    assert coordinator_settings(env) == want
    if want is None:  # an ordinary run: no group
        assert maybe_initialize(env) is False
        assert not torch.distributed.is_initialized()


def test_a_process_id_outside_the_group_is_refused():
    with pytest.raises(ValueError, match="outside 0 .. 1"):
        coordinator_settings({"FACEGEN_COORDINATOR": "h:1", "FACEGEN_NUM_PROCESSES": "2",
                              "FACEGEN_PROCESS_ID": "2"})


def test_ranks_sharing_a_card_are_named():
    assert shared_cards(["a/cuda:0", "a/cuda:1", "b/cuda:0"]) == {}
    assert shared_cards(["a/cuda:0", "a/cuda:1", "a/cuda:0"]) == {"a/cuda:0": [0, 2]}


@pytest.mark.parametrize("argv,message", [
    (["--meshShape", "2"], "launch 2 processes with FACEGEN_COORDINATOR"),
    (["--meshShape", "2,1"], "launch 2 processes with FACEGEN_COORDINATOR"),
    (["--meshShape", "4,2"], "launch 8 processes with FACEGEN_COORDINATOR"),
    (["--meshShape", "0"], "a positive size or -1"),
], ids=[  # the third's id is from when the 2-D mesh was refused
    "argv0-launch 2 processes with FACEGEN_COORDINATOR",
    "argv1-launch 2 processes with FACEGEN_COORDINATOR",
    "argv2-the 2-D mesh ('DP,MP' with MP > 1) is not ported yet", "argv3-a positive size or -1"])
def test_mesh_shape_without_a_group_says_how_to_launch(argv, message, capsys):
    with pytest.raises(SystemExit):
        train_main(argv, device="cpu")
    assert message in capsys.readouterr().err
    for shape in ("1", "-1", "1,1"):  # one device
        assert train_config_from_args(["--meshShape", shape]).mesh_shape in ((1,), (-1,),
                                                                            (1, 1))
    with pytest.raises(ValueError, match="no process group is up"):
        make_mesh((-1,))


# ------------------------------------------------------------------- serving
def _nets(scale=16, channels=1, seed=3):
    g, d = gan.init_gan(torch.Generator().manual_seed(seed), scale, channels, NOISE_DIM,
                        reference_init=False)
    return g, d


@pytest.mark.parametrize("n", [64, 301])
def test_two_replicas_serve_what_one_device_serves(n):
    g, d = _nets()
    one = GanInference(g, d, NOISE_DIM, torch.float32)
    two = GanInference(g, d, NOISE_DIM, torch.float32, devices=["cpu", "cpu"])
    assert len(two.g_replicas) == 2 and two.g_replicas[0] is not g
    noise = one.noise(torch.Generator().manual_seed(n), n)
    imgs, imgs2 = one.generate(noise), two.generate(noise)
    assert imgs2.shape == imgs.shape == (n, 16, 16, 1)
    np.testing.assert_allclose(imgs2.numpy(), imgs.numpy(), rtol=SERVE_TOL, atol=SERVE_TOL)
    np.testing.assert_allclose(two.score(imgs).numpy(), one.score(imgs).numpy(),
                               rtol=SERVE_TOL, atol=SERVE_TOL)


def test_two_replicas_serve_what_facegens_mesh_serves(tmp_path):
    """301 requests (wrap-padded on both sides) through facegen's
    GanInference on make_mesh2d(2, 1) and the port's over two devices."""
    _, _, bundle = jax_gan.init_gan(jax.random.key(0), 16, 1, NOISE_DIM, reference_init=False)
    bundle["state_g"] = jax.tree.map(lambda a: a * 2.0 + 0.05, bundle["state_g"])
    jax_ckpt.save(str(tmp_path), "adversarial", bundle,
                  meta={"config": {"scale": 16, "grayscale": True, "noise_dim": NOISE_DIM}})
    jg, jd, jbundle, _, _ = jax_gan.restore_gan("adversarial", default_dir=str(tmp_path))
    g, d, _ = gan.restore_gan("adversarial", default_dir=str(tmp_path), device="cpu")
    noise = np.random.RandomState(1).uniform(-1, 1, (301, NOISE_DIM)).astype(np.float32)
    jinf = JaxInference(jg, jd, NOISE_DIM, compute_dtype="float32", mesh=make_mesh2d(2, 1))
    j_imgs = jinf.generate(jbundle, jnp.asarray(noise))
    inf = GanInference(g, d, NOISE_DIM, torch.float32, devices=["cpu", "cpu"])
    imgs = inf.generate(torch.from_numpy(noise))
    np.testing.assert_allclose(imgs.numpy(), np.asarray(j_imgs), rtol=JAX_TOL, atol=JAX_TOL)
    np.testing.assert_allclose(inf.score(imgs).numpy(), np.asarray(jinf.score(jbundle, j_imgs)),
                               rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.parametrize("k", [1, 7])
def test_the_sharded_search_never_returns_a_sentinel(k):
    """13 rows over 2 devices: 7 each, the last a sentinel row; with k = 7
    the second shard's own top-k holds it, the merged top-k does not."""
    rs = np.random.RandomState(4)
    data = rs.randint(0, 256, (13, 8, 8, 1)).astype(np.uint8)
    queries = (data[[3, 9, 12]] / 255.0 + 0.001).astype(np.float32)
    shards = prepare_nn_dataset(data, ["cpu", "cpu"])
    assert [s.shape[0] for s in shards] == [7, 7] and float(shards[1][-1].min()) == 1e6
    idx, dist = nearest_neighbours(torch.from_numpy(queries), shards, k=k)
    assert idx.max() < 13 and list(idx[:, 0]) == [3, 9, 12]
    idx1, dist1 = nearest_neighbours(torch.from_numpy(queries), data, k=k)
    np.testing.assert_array_equal(idx, idx1)
    np.testing.assert_allclose(dist, dist1, rtol=1e-5, atol=1e-5)
    j_idx, _ = jax_nearest_neighbours(
        jnp.asarray(queries), jax_prepare_nn_dataset(data, mesh=make_mesh2d(2, 1)), k=k)
    np.testing.assert_array_equal(idx, j_idx)


def test_run_sampling_over_two_devices_writes_the_single_device_grids(tmp_path):
    g, d = _nets()
    ckpt.save_gan(str(tmp_path), "adversarial", g, d,
                  {"scale": 16, "grayscale": True, "noise_dim": NOISE_DIM, "noise_view": "nhwc"})
    data = np.random.RandomState(5).randint(0, 256, (41, 16, 16, 1)).astype(np.uint8)
    outs = {}
    for label, devices in (("one", None), ("two", ["cpu", "cpu"])):
        cfg = SampleConfig(save=str(tmp_path), neighbours=True,
                           writeto=str(tmp_path / label))
        outs[label] = sample.run_sampling(cfg, dataset=data, device="cpu", devices=devices,
                                          verbose=False)
    assert [os.path.basename(p) for p in outs["one"]] == [os.path.basename(p)
                                                          for p in outs["two"]]
    from PIL import Image

    for a, b in zip(outs["one"], outs["two"]):
        x, y = (np.asarray(Image.open(p), np.int16) for p in (a, b))
        assert x.shape == y.shape and np.abs(x - y).max() <= 1, a


def test_sampler_mesh_shape(monkeypatch, capsys):
    """'DP,MP' needs DP x MP visible cards; 'DP' needs DP."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="2 CUDA device"):
        sample.serving_devices((2, 2))
    assert sample.serving_devices((1, 2)) == sample.serving_devices((-1, 2)) == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    assert sample.serving_devices((-1,)) == sample.serving_devices((2, 1)) == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="2 CUDA device"):
        sample.serving_devices((3,))


def test_the_ranks_module_imports_neither_jax_nor_facegen():
    import subprocess
    import sys

    code = ("import sys, torch_port_parallel_ranks; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'facegen.'))"
            " or m == 'facegen']; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)),
         os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]))
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
