"""The update tail of every trainer's iteration (train/optim.py:
penalised_update, ops/fused_update.py) against facegen's, on the CPU.

The port's ``penalised_update`` and facegen's ``losses`` (penalty_loss,
add_penalty_grads, clamp_grads), the finite check of facegen's step
(facegen/train/step.py:319-323) and ``gated_update`` on optax take the
same numpy-seeded leaves: the shapes of G32's and D32b's parameters, each
dim cut to at most 6 (the nets' leaf counts and ranks, PReLU's (1,)
slopes included). Two iterations each; tolerance 1e-6 relative l2 over
the parameters and over each optimizer state, and 1e-6 relative on the
penalty (the same fp32 elementwise formulas; a wrong coefficient, order
of clamp and penalty, or bias correction is off by far more). A closed
gate leaves every tensor bit-equal. The CUDA kernels themselves run in
tests/test_torch_port_cuda.py on the card; here their CPU-side
companions: the launch plan of a long table, the layout check, and the
layouts the trainers' gradients come in (the 2-D mesh's shards too).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen.config import TrainConfig as JaxTrainConfig
from facegen.train import losses as jax_losses
from facegen.train.optim import gated_update as jax_gated_update
from facegen.train.optim import make_optimizer as jax_make_optimizer
from facegen_torch.config import TrainConfig
from facegen_torch.models import ae, c2f, gan
from facegen_torch.ops import fused_update
from facegen_torch.parallel import gspmd
from facegen_torch.train import optim

RTOL = 1e-6
OPTIMIZERS = {"adam": {}, "adagrad": {}, "sgd": {}, "sgd_momentum": {"d_sgd_momentum": 0.9}}


@functools.lru_cache(maxsize=None)
def _net_shapes(net):
    """The leaf shapes of G32 or D32b (colour), each dim cut to 6."""
    g, d = gan.init_gan(torch.Generator().manual_seed(0), 32, 3, 100)
    return tuple(tuple(min(n, 6) for n in p.shape)
                 for p in (g if net == "G32" else d).parameters())


def _leaves(seed, shapes, scale=1.0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*s) * scale).astype(np.float32) for s in shapes]


def _rel_l2(ours, theirs):
    ours = np.concatenate([np.asarray(o, np.float64).ravel() for o in ours])
    theirs = np.concatenate([np.asarray(t, np.float64).ravel() for t in theirs])
    return np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-300)


def _jax_iteration(tx, grads, opt, params, sign_coef, l1, l2, clamp, gate, guard):
    """facegen's iteration tail (facegen/train/step.py:301-325)."""
    penalty = jax_losses.penalty_loss(params, l1, l2)
    grads = jax_losses.clamp_grads(jax_losses.add_penalty_grads(grads, params, sign_coef, l2),
                                   clamp)
    gate = jnp.bool_(gate)
    if guard:
        gate = gate & jnp.all(jnp.stack([jnp.all(jnp.isfinite(g)) for g in grads]))
    params, opt = jax_gated_update(tx, grads, opt, params, gate)
    return params, opt, penalty, gate


def _run(method, net, coefs, gates, guard=False, nan_leaf=None, flags=None):
    """Two iterations of the port's penalised_update and facegen's tail on
    the same leaves: (port's params, state, penalties, gates; facegen's)."""
    sign_coef, l1, l2, clamp = coefs
    shapes = _net_shapes(net)
    params = _leaves(1, shapes, 0.1)
    flags = OPTIMIZERS[method] if flags is None else flags
    kind = "sgd" if method == "sgd_momentum" else method
    jtx = jax_make_optimizer(kind, JaxTrainConfig(**flags), "D")
    tx = optim.make_optimizer(kind, TrainConfig(**flags), "D")
    jp, jopt = params, jtx.init(params)
    tp = [torch.from_numpy(a.copy()) for a in params]
    topt = tx.init(tp)
    ours, theirs = [], []
    for it, gate in enumerate(gates):
        grads = _leaves(10 + it, shapes, 0.05)
        if nan_leaf is not None:
            grads[nan_leaf].flat[0] = np.nan
        jp, jopt, jpen, jgate = _jax_iteration(jtx, grads, jopt, jp, sign_coef, l1, l2, clamp,
                                               gate, guard)
        tgate = torch.tensor(gate)
        pen, applied = optim.penalised_update(tx, [torch.from_numpy(g) for g in grads], topt, tp,
                                              sign_coef, l1, l2, clamp, tgate, guard)
        ours.append((float(pen), bool(applied)))
        theirs.append((float(jpen), bool(jgate)))
    return tp, topt, ours, jp, jopt, theirs


def _state_leaves(method, topt):
    """The port's state in optax's leaf order (Adam: count, mu..., nu...)."""
    if method == "adam":
        return [topt["count"]] + topt["mu"] + topt["nu"]
    return fused_update._state_tensors(topt)


def _assert_match(method, tp, topt, ours, jp, jopt, theirs):
    assert _rel_l2([p.numpy() for p in tp], jp) <= RTOL
    jstate = jax.tree_util.tree_leaves(jopt)
    mine = _state_leaves(method, topt)
    assert len(mine) == len(jstate)
    for o, t in zip(mine, jstate):
        assert _rel_l2([o.numpy()], [t]) <= RTOL
    for (pen, gate), (jpen, jgate) in zip(ours, theirs):
        assert pen == pytest.approx(jpen, rel=RTOL, abs=1e-12)
        assert gate == jgate


# D's coefficients (D_L1, D_L1, D_L2, D_clamp) with a clamp that bites
D_COEFS = (1e-3, 1e-3, 1e-4, 0.05)


@pytest.mark.parametrize("net", ["G32", "D32b"])
@pytest.mark.parametrize("gate", ["open", "closed"])
@pytest.mark.parametrize("method", list(OPTIMIZERS))
def test_penalised_update_matches_facegen(method, gate, net):
    """The penalty, its gradient, the clamp and the gated update of each
    optimizer: the gate open on both iterations, or closed on the second."""
    gates = [True, gate == "open"]
    tp, topt, ours, jp, jopt, theirs = _run(method, net, D_COEFS, gates)
    _assert_match(method, tp, topt, ours, jp, jopt, theirs)
    if gate == "closed":  # bit-equal to the state after the first iteration
        tp1, topt1, *_ = _run(method, net, D_COEFS, [True])
        assert all(torch.equal(a, b) for a, b in zip(tp, tp1))
        assert all(torch.equal(a, b) for a, b in zip(fused_update._state_tensors(topt),
                                                      fused_update._state_tensors(topt1)))


@pytest.mark.parametrize("nan_leaf", [None, 0, 7, 14], ids=["finite", "leaf0", "leaf7",
                                                            "leaf14"])
def test_guard_nonfinite_closes_the_gate_as_facegen_does(nan_leaf):
    """guard_nonfinite on G32's leaves: a NaN in one leaf's gradient (which
    the clamp keeps) closes the gate, and Adam's state and count stay."""
    tp, topt, ours, jp, jopt, theirs = _run("adam", "G32", D_COEFS, [True, True], guard=True,
                                            nan_leaf=nan_leaf)
    _assert_match("adam", tp, topt, ours, jp, jopt, theirs)
    assert [gate for _, gate in ours] == [nan_leaf is None] * 2
    assert int(topt["count"]) == (2 if nan_leaf is None else 0)


@pytest.mark.parametrize("bug", [True, False], ids=["reference_bug", "fixed"])
def test_g_penalty_coefficients_match_facegen(bug):
    """G's iteration: the loss's penalty from (G_L1, G_L2), the gradient's
    sign term from G_L2 under the reference's bug (adversarial.lua:223),
    else from G_L1; G's clamp, no gate."""
    g_l1, g_l2, g_clamp = 2e-3, 5e-4, 5.0
    coefs = (g_l2 if bug else g_l1, g_l1, g_l2, g_clamp)
    tp, topt, ours, jp, jopt, theirs = _run("adam", "G32", coefs, [True, True])
    _assert_match("adam", tp, topt, ours, jp, jopt, theirs)


@pytest.mark.parametrize("numels,max_segments,want", [
    ([5, 1, 7], 64, [(0, 3)]),
    ([3] * 130, 64, [(0, 64), (64, 128), (128, 130)]),
    ([0, 4, 0, 0, 2, 0], 1, [(1, 2), (4, 5)]),
    ([0, 0], 64, []),
    ([1] * 64, 64, [(0, 64)]),
    ([1] * 65, 64, [(0, 64), (64, 65)]),
])
def test_a_long_table_takes_more_than_one_launch(numels, max_segments, want):
    """The launch plan: each launch at most ``max_segments`` non-empty
    leaves, in order, every non-empty leaf in exactly one."""
    spans = fused_update.segments(numels, max_segments)
    assert spans == want
    covered = [i for lo, hi in spans for i in range(lo, hi) if numels[i]]
    assert covered == [i for i, n in enumerate(numels) if n]


def _layout_case(case):
    base = torch.zeros(4, 6, 5)
    if case == "contiguous":
        return [base, torch.ones(4, 6, 5), torch.ones(4, 6, 5)], None
    if case == "permuted":  # a sharded master's layout
        p = torch.zeros(6, 4, 5).movedim(0, 1)
        return [p, torch.empty_like(p), torch.zeros_like(p)], None
    if case == "layouts_differ":
        return [base, torch.zeros(6, 4, 5).movedim(0, 1)], "dense layout"
    if case == "gaps":
        return [base[:, :3], torch.zeros(4, 3, 5)], "dense layout"
    if case == "fp64":
        return [base, base.double()], "fp32"
    if case == "shapes_differ":
        return [base, torch.zeros(4, 5, 6)], "shapes"
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["contiguous", "permuted", "layouts_differ", "gaps", "fp64",
                                  "shapes_differ"])
def test_the_layout_check(case):
    """A leaf's tensors must share one dense layout (any order of dims)
    and be fp32; the wrappers raise otherwise."""
    leaf, error = _layout_case(case)
    if error is None:
        fused_update.check_leaves("test", [leaf])
    else:
        with pytest.raises((ValueError, TypeError), match=error):
            fused_update.check_leaves("test", [leaf])


def _net_and_input(kind):
    gen = torch.Generator().manual_seed(3)
    if kind in ("G32", "D32b"):
        g, d = gan.init_gan(gen, 32, 3, 100)
        return (g, torch.rand(4, 100)) if kind == "G32" else (d, torch.rand(4, 32, 32, 3))
    if kind in ("c2f_G", "c2f_D"):
        g, d = c2f.init_c2f(gen, 32, 3)
        x = torch.rand(4, 32, 32, 3)
        return (g, (torch.rand(4, 32, 32, 1), x)) if kind == "c2f_G" else (d, (x, x))
    if kind == "AE":
        return ae.create_autoencoder(32, 1, 256, generator=gen), torch.rand(4, 32, 32, 1)
    return ae.init_denoiser(gen, 16, 3)[1], torch.rand(4, 16, 16, 3)


# the leaves whose gradients autograd gives in another layout than the
# parameter's: every conv weight (the NHWC convs' channels-last weight
# gradients, and G's upsample-convs' from the collapse's einsum)
OTHER_LAYOUTS = {
    "G32": ["03_upconv1.weight", "06_upconv2.weight", "09_conv_out.weight"],
    "D32b": ["00_conv64.weight", "04_conv128.weight", "08_conv256.weight", "12_conv512.weight"],
    "c2f_G": [f"body.0{i}_conv{i // 2 + 1}.weight" for i in (0, 2, 4, 6, 8)],
    "c2f_D": ["body.00_conv1.weight", "body.02_conv2.weight", "body.05_conv3.weight",
              "body.07_conv4.weight"],
    "AE": [],
    "denoiser_dec": ["00_conv1.weight", "03_conv2.weight"],
}


@pytest.mark.parametrize("kind", list(OTHER_LAYOUTS))
def test_the_trainers_gradients_come_in_their_parameters_layouts(kind):
    """Each net's gradients from autograd (on the CPU; the card tests check
    the card) share their parameters' dense layouts but for the conv
    weights', which ``in_layouts_of`` copies into their parameters'
    layouts, as ``penalised_update`` does before the kernels; the others
    it passes through as they are."""
    net, x = _net_and_input(kind)
    net.eval()  # no dropout masks needed; the layers' backward is the same
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(net(x).float().square().mean(), params)
    assert [n for n, p, g in zip(names, params, grads)
            if not fused_update.shares_layout(p, g)] == OTHER_LAYOUTS[kind]
    aligned = fused_update.in_layouts_of(params, grads)
    fused_update.check_leaves(kind, [(p.detach(), g) for p, g in zip(params, aligned)])
    for n, g, a in zip(names, grads, aligned):
        assert torch.equal(g, a) and (a is g) == (n not in OTHER_LAYOUTS[kind])


def test_the_2d_mesh_shards_come_in_their_masters_layouts():
    """On a 2-D mesh at MP = 2, D32b's gradients from autograd (the conv
    weights' channels-last) packed by flat_all_reduce in their parameters'
    layouts come out in them, so their shards share their masters' and
    Adam's moments' layouts with no copy; the unpacked gradients' conv
    shards do not."""
    net, x = _net_and_input("D32b")
    net.eval()
    params = list(net.parameters())
    natural = torch.autograd.grad(net(x).float().square().mean(), params)
    mesh = types.SimpleNamespace(mp=2, j=1, all_reduce_sum_=lambda t: None)
    shards = gspmd.ShardedParams(params, mesh)
    assert shards.sharded
    state = optim.adam(1e-3).init(shards.masters)
    grads = gspmd.flat_all_reduce(mesh, {}, "d", [*natural, torch.zeros(())], params)[:-1]
    assert all(torch.equal(a, b) for a, b in zip(grads, natural))
    assert all(fused_update.shares_layout(p, g) for p, g in zip(params, grads))
    fused_update.check_leaves("shards", list(zip(shards.masters, shards.shards(grads),
                                                 state["mu"], state["nu"])))
    with pytest.raises(ValueError, match="dense layout"):
        fused_update.check_leaves("shards", list(zip(shards.masters, shards.shards(natural))))
