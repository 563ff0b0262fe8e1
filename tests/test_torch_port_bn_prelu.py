"""G's batch norm + PReLU pair as one call (ops/bn_prelu.py) on the CPU.

The plain version of ``BatchNormPReLUFunction`` (``forward_reference`` and
``backward_reference``, the formulas the kernels of csrc/bn_prelu.cu run)
against the port's ``BatchNorm`` followed by ``PReLU`` under autograd, at
G32's two batch norms (16x16x256, 32x32x128) at N = 16 and 32 and G16's
(8x8x256, 16x16x128) at N = 32, bf16 and fp32, train and eval: the output
and the moved running statistics bit for bit (the same torch ops in the
same order), the gradients of the input, the weight, the bias and the
slope within what summing in another order gives (the plain version's
closed-form backward against autograd's chain). Then the structure that
decides the route (``nn/layers.py:Sequential``, ``fused_pair``): G's
pairs and no others, the same children, state_dict keys and checkpoint
leaves, and on the CPU every module's own forward. The kernels themselves
run in tests/test_torch_port_cuda.py on the card. This file imports no
JAX.
"""

from collections import OrderedDict

import pytest
import torch
from torch import nn

import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen_torch.models import ae, gan
from facegen_torch.nn import layers
from facegen_torch.nn.layers import BatchNorm, LeakyReLU, PReLU
from facegen_torch.ops import bn_prelu as bp
from facegen_torch.utils import checkpoint as ckpt

# (N, H, C): G32's two batch norms in the D phase (16) and G phase (32), G16's
SHAPES = [(n, h, c) for n in (16, 32) for h, c in ((16, 256), (32, 128))] + [
    (32, 8, 256), (32, 16, 128)]
# closed-form backward against autograd's chain: fp32 sums in another order;
# bf16 dx may move by one unit in the last place
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2**-7}


def _pair(c, seed):
    g = torch.Generator().manual_seed(seed)
    bn, pr = BatchNorm(c), PReLU()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.rand(c, generator=g) * 0.4 - 0.2)
        bn.running_mean.copy_(torch.rand(c, generator=g) - 0.5)
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
        pr.weight.copy_(torch.rand(1, generator=g) * 0.3 + 0.1)
    return bn, pr


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


@pytest.mark.parametrize("n,h,c", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("training", [True, False])
def test_plain_version_matches_batch_norm_then_prelu(n, h, c, dtype, training):
    g = torch.Generator().manual_seed(n * h + c)
    x0 = (torch.randn(n, h, h, c, generator=g) * 1.5 + torch.rand(c, generator=g) - 0.5).to(dtype)
    dy = torch.randn(n, h, h, c, generator=g).to(dtype)

    bn, pr = _pair(c, 1)
    bn.train(training)
    x = x0.clone().requires_grad_()
    want = pr(bn(x))
    want.backward(dy)
    want_grads = [x.grad, bn.weight.grad, bn.bias.grad, pr.weight.grad]
    want_running = [bn.running_mean.clone(), bn.running_var.clone()]

    bn, pr = _pair(c, 1)
    x = x0.clone().requires_grad_()
    got = bp.BatchNormPReLUFunction.apply(x, bn.weight, bn.bias, pr.weight, bn.running_mean,
                                          bn.running_var, training, bn.eps, bn.MOMENTUM)
    got.backward(dy)
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, want_running[0])
    assert torch.equal(bn.running_var, want_running[1])
    dx, dw, db, da = x.grad, bn.weight.grad, bn.bias.grad, pr.weight.grad
    assert dx.dtype == dtype and dw.shape == db.shape == (c,) and da.shape == (1,)
    tol = GRAD_TOL[dtype]
    assert float((dx.float() - want_grads[0].float()).abs().max()) <= (
        tol * float(want_grads[0].float().abs().max()))
    for ours, theirs in zip((dw, db, da), want_grads[1:]):
        assert _rel(ours, theirs) <= tol


def test_no_grad_forward_moves_the_running_statistics_and_saves_nothing():
    """The D phase's fakes: a train-mode forward under no_grad gives the
    Function's output and moves the running statistics, with no graph."""
    x = torch.randn(4, 8, 8, 16).bfloat16()
    bn, pr = _pair(16, 2)
    want = pr(bn.train()(x))
    bn2, pr2 = _pair(16, 2)
    with torch.no_grad():
        got = bp.bn_prelu(x, bn2.weight, bn2.bias, pr2.weight, bn2.running_mean,
                          bn2.running_var, True, bn2.eps, bn2.MOMENTUM)
    assert got.grad_fn is None and torch.equal(got, want.detach())
    assert torch.equal(bn2.running_mean, bn.running_mean)
    assert torch.equal(bn2.running_var, bn.running_var)


def _pairs(net):
    mods = list(net.children())
    return [(i, type(m).__name__) for i, (m, after) in enumerate(zip(mods, mods[1:] + [None]))
            if layers.fused_pair(m, after)]


@pytest.mark.parametrize("scale", [16, 32])
def test_g_pairs_its_two_batch_norms_and_nothing_else(scale):
    g, d = gan.init_gan(torch.Generator().manual_seed(0), scale, 3, 100, reference_init=False)
    assert isinstance(g, layers.Sequential) and isinstance(g, nn.Sequential)
    assert _pairs(g) == [(4, "BatchNorm"), (7, "BatchNorm")]
    assert _pairs(d) == []


def test_the_denoisers_batch_norms_and_a_meshs_are_not_paired():
    """The AE family's batch norms feed LeakyReLUs; the 2-D mesh's
    synchronised batch norm keeps its own path."""
    dec = ae.create_denoiser_decoder(16, 1, generator=torch.Generator().manual_seed(0))
    seqs = [seq for seq in dec.modules() if isinstance(seq, nn.Sequential)]
    followers = [type(after) for seq in seqs
                 for m, after in zip(list(seq.children()), list(seq.children())[1:])
                 if isinstance(m, BatchNorm)]
    assert followers and set(followers) == {LeakyReLU}
    assert not any(_pairs(seq) for seq in seqs)
    bn, pr = _pair(8, 3)
    assert layers.fused_pair(bn, pr)
    bn.mesh = object()  # nn/layers.py:set_batch_norm_mesh's synchronised batch norm
    assert bn.training and not layers.fused_pair(bn, pr)


def test_in_eval_a_meshs_batch_norms_are_paired():
    """In eval mode BatchNorm reads its running statistics whatever its
    mesh, so G's pairs on a 2-D mesh run as one call there too (the
    progress grids' G calls); in train mode they keep the synchronised
    path."""
    g, _ = gan.init_gan(torch.Generator().manual_seed(0), 32, 3, 100, reference_init=False)
    for m in g.modules():
        if isinstance(m, BatchNorm):
            m.mesh = object()
    g.train()
    assert _pairs(g) == []
    g.eval()
    assert _pairs(g) == [(4, "BatchNorm"), (7, "BatchNorm")]


def test_a_hooked_pair_runs_its_own_modules():
    """A forward hook asks for the batch norm's own output (utils/netvis.py)."""
    bn, pr = _pair(8, 4)
    handle = bn.register_forward_hook(lambda m, args, out: None)
    assert not layers.fused_pair(bn, pr)
    handle.remove()
    handle = pr.register_forward_pre_hook(lambda m, args: None)
    assert not layers.fused_pair(bn, pr)
    handle.remove()
    assert layers.fused_pair(bn, pr)


def test_on_the_cpu_every_module_runs_its_own_forward(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("bn_prelu called for a CPU tensor")

    monkeypatch.setattr(layers, "bn_prelu", refuse)
    g, _ = gan.init_gan(torch.Generator().manual_seed(0), 32, 3, 100, reference_init=False)
    noise = torch.rand(4, 100) * 2 - 1
    plain = nn.Sequential(OrderedDict(g.named_children()))
    for mode in (g.eval, g.train):
        mode()
        with torch.no_grad():
            assert torch.equal(g(noise), plain(noise))


@pytest.mark.parametrize("scale", [16, 32])
def test_state_dict_keys_and_checkpoint_leaves_are_unchanged(scale, tmp_path):
    g, d = gan.init_gan(torch.Generator().manual_seed(0), scale, 3, 100, reference_init=False)
    plain = nn.Sequential(OrderedDict(g.named_children()))
    assert list(g.state_dict()) == list(plain.state_dict())
    assert sorted(ckpt.torch_to_jax({"g": g.state_dict()})) == sorted(
        ckpt.torch_to_jax({"g": plain.state_dict()}))
    with torch.no_grad():
        for name, t in g.state_dict().items():
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(len(name))))
    ckpt.save_gan(str(tmp_path), "gan", g, d, {"scale": scale})
    g2, d2 = gan.init_gan(torch.Generator().manual_seed(1), scale, 3, 100, reference_init=False)
    ckpt.load_gan(str(tmp_path), "gan", g2, d2)
    assert isinstance(g2, layers.Sequential)
    for (k, a), (k2, b) in zip(g.state_dict().items(), g2.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
