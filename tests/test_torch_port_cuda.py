"""The port's CUDA kernels on the card. Every test marked ``cuda`` needs a
CUDA GPU and skips without one: a CUDA kernel has no CPU or interpret
mode. The file imports neither JAX nor facegen, so it runs where JAX is
absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

(--noconftest: tests/conftest.py sets JAX up for the JAX package's tests.)

Tolerances: fp32, 1e-4 (rtol and atol), both sides accumulating in fp32
with TF32 off; bf16, 2e-2 absolute plus 2^-8 relative, the same bf16
inputs with fp32 accumulation and then the output's bf16 rounding. The
backward kernels' fp32 dx and dW (of both types; bf16 inputs are exact
in fp32) are held to 1e-4 of the plain result's largest entry: their
sums run over 9*4*Cout or N*H*W products, whose rounding grows with the
terms, not with the entry they land in. The update's two kernels
(ops/fused_update.py) against their plain versions on the same card
tensors: gradients, parameters and optimizer states within 1e-6 relative
l2 (each product and sum rounded alone on both sides; powf and rsqrtf may
differ in the last bit), the sums of |p| and p^2 within 1e-5 relative
(fp64 partials against fp32 sums), counts exact; a closed gate, a second
launch and a graph's replay bit for bit.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from facegen_torch.models import gan
from facegen_torch.ops import _build
from facegen_torch.ops import bn_prelu as bp
from facegen_torch.ops import fused_update as fu
from facegen_torch.ops import upsample_conv as uc
from facegen_torch.utils.infer import GanInference

SHAPES = [(8, 16, 24, 5), (4, 8, 8, 3), (16, 32, 16, 5)]  # tests/test_upsample_conv.py:32
TOLS = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=2**-8, atol=2e-2)}


def _rel_l2(ours, ref):
    """||ours - ref|| / ||ref|| over lists of tensors, ``ours`` on any
    device and ``ref`` on the CPU."""
    num = sum(float(((o.detach().cpu() - r.detach()) ** 2).sum()) for o, r in zip(ours, ref))
    return (num / max(sum(float((r.detach() ** 2).sum()) for r in ref), 1e-300)) ** 0.5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout,k", [(n,) + s for s in SHAPES for n in (2, 3)]
                         + [(5, 8, 128, 256, 5), (3, 16, 256, 128, 5)]
                         # G32's upconv1 and upconv2 in the D and G phases of
                         # training and at the sampler's batch; G16's two layers
                         + [(n, h, cin, cout, 5) for n in (16, 32, 1024)
                            for h, cin, cout in ((8, 128, 256), (16, 256, 128))]
                         + [(n, h, cin, cout, 5) for n in (32, 1024)
                            for h, cin, cout in ((4, 128, 256), (8, 256, 128))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda_device, n, h, cin, cout, k, dtype):
    g = torch.Generator().manual_seed(n * h + cin)
    x = torch.randn(n, h, h, cin, generator=g)
    w = torch.randn(cout, cin, k, k, generator=g) / (k * k * cin) ** 0.5
    b = torch.randn(cout, generator=g)
    x, w, b = (t.to(cuda_device, dtype) for t in (x, w, b))
    wc = uc.collapse_weights(w)
    before = uc.KERNEL_LAUNCHES
    got = uc.upsample_conv(x, wc, b)
    torch.cuda.synchronize()
    assert uc.KERNEL_LAUNCHES == before + 1
    ref = uc.upsample_conv_reference(x.float(), wc.float(), b.float())
    torch.testing.assert_close(got.float(), ref, **TOLS[dtype])


@pytest.mark.cuda
def test_wrapper_rejects_tensors_on_two_devices(cuda_device):
    x = torch.zeros(2, 4, 4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="tensors on"):
        uc.upsample_conv(x, torch.zeros(72, 32), torch.zeros(8, device=cuda_device))


@pytest.mark.cuda
def test_g32_on_the_card_matches_the_cpu(cuda_device):
    g_cpu, d_cpu = gan.init_gan(torch.Generator().manual_seed(0), 32, 3, 100,
                                reference_init=False)
    g_gpu, d_gpu = gan.init_gan(torch.Generator().manual_seed(0), 32, 3, 100,
                                reference_init=False, device=cuda_device)
    noise = GanInference(g_cpu, d_cpu, 100).noise(torch.Generator().manual_seed(1), 64)
    before, bn_before = uc.KERNEL_LAUNCHES, bp.BN_PRELU_LAUNCHES
    for dtype in (torch.float32, torch.bfloat16):
        ours = GanInference(g_gpu, d_gpu, 100, compute_dtype=dtype).generate(noise)
        ref = GanInference(g_cpu, d_cpu, 100, compute_dtype=torch.float32).generate(noise)
        # images in [0, 1] after the sigmoid; fp32 drift ~1e-6, bf16 ~1e-3
        torch.testing.assert_close(ours.cpu(), ref, rtol=0,
                                   atol=1e-4 if dtype == torch.float32 else 3e-2)
    assert uc.KERNEL_LAUNCHES == before + 4  # two upsample-convs per G call
    assert bp.BN_PRELU_LAUNCHES == bn_before + 4  # one eval apply per batch norm


TRAIN_SHAPES = [(32, 8, 128, 256), (32, 16, 256, 128)]  # G32's upconv1, upconv2 at batch 32
G16_TRAIN_SHAPES = [(32, 4, 128, 256), (32, 8, 256, 128)]  # G16's at batch 32


def _norm_close(got, ref, tol=1e-4):
    err = float((got.float() - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), (err, float(ref.abs().max()))


# The bf16 dW's TMA path: tiles of 128 rows that hold two taps (Cin = 64,
# 192; at N = 16, 16x16, over 64 K steps), and a last K step past the last
# image (N = 3 at 4x4: 48 pixels)
DW_TMA_SHAPES = [(2, 8, 64, 64), (2, 8, 192, 64), (3, 4, 128, 256), (3, 4, 64, 64),
                 (16, 16, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout", [(n, h, cin, cout) for h, cin, cout, _ in SHAPES
                                          for n in (2, 3)] + TRAIN_SHAPES + G16_TRAIN_SHAPES
                         + DW_TMA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain_versions(cuda_device, n, h, cin, cout, dtype):
    g = torch.Generator().manual_seed(n * h + cout)
    x = torch.randn(n, h, h, cin, generator=g).to(cuda_device, dtype)
    dy = torch.randn(n, 2 * h, 2 * h, cout, generator=g).to(cuda_device, dtype)
    wc = (torch.randn(9 * cin, 4 * cout, generator=g) / (36 * cout) ** 0.5).to(cuda_device, dtype)
    before = (uc.DX_LAUNCHES, uc.DW_LAUNCHES)
    dx, dwc = uc.upsample_conv_dx(dy, wc), uc.upsample_conv_dw(x, dy)
    torch.cuda.synchronize()
    assert (uc.DX_LAUNCHES, uc.DW_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert dx.dtype == dtype and dwc.dtype == torch.float32
    ref_dx = uc.upsample_conv_dx_reference(dy.float(), wc.float())
    if dtype == torch.float32:
        _norm_close(dx, ref_dx)
    else:
        torch.testing.assert_close(dx.float(), ref_dx, **TOLS[dtype])
    _norm_close(dwc, uc.upsample_conv_dw_reference(x.float(), dy.float()))


# the local batches of G32's two layers on the (3, 1) mesh at batch 32
# (the D phase's halves 6, 6 and 4 rows a rank, the G phase's 11, 11 and
# 10) and at batch 4, where a rank holds none
UNEVEN_NS = (0, 4, 6, 10, 11)
G32_LAYERS = ((8, 128, 256), (16, 256, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("n", UNEVEN_NS)
@pytest.mark.parametrize("h,cin,cout", G32_LAYERS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_wrappers_at_the_uneven_meshs_local_batches(cuda_device, n, h, cin, cout, dtype):
    """The forward, dx and dW kernels against their plain versions at
    G32's layers and the (3, 1) mesh's local batches (M = N*H*W pixels,
    not a multiple of the M tile); at N = 0 the forward and dx return
    empty tensors and dW zeros, as the plain versions do, and nothing is
    launched or counted."""
    g = torch.Generator().manual_seed(n * h + cin)
    x = torch.randn(n, h, h, cin, generator=g).to(cuda_device, dtype)
    dy = torch.randn(n, 2 * h, 2 * h, cout, generator=g).to(cuda_device, dtype)
    w = (torch.randn(cout, cin, 5, 5, generator=g) / (25 * cin) ** 0.5).to(cuda_device, dtype)
    b = torch.randn(cout, generator=g).to(cuda_device, dtype)
    wc = uc.collapse_weights(w)
    before = (uc.KERNEL_LAUNCHES, uc.DX_LAUNCHES, uc.DW_LAUNCHES)
    y, dx, dwc = uc.upsample_conv(x, wc, b), uc.upsample_conv_dx(dy, wc), uc.upsample_conv_dw(x, dy)
    torch.cuda.synchronize()
    launched = int(n > 0)
    assert (uc.KERNEL_LAUNCHES, uc.DX_LAUNCHES, uc.DW_LAUNCHES) == tuple(
        v + launched for v in before)
    ref_y = uc.upsample_conv_reference(x.float(), wc.float(), b.float())
    ref_dx = uc.upsample_conv_dx_reference(dy.float(), wc.float())
    ref_dw = uc.upsample_conv_dw_reference(x.float(), dy.float())
    assert (y.shape, dx.shape, dwc.shape) == (ref_y.shape, ref_dx.shape, ref_dw.shape)
    if n == 0:
        assert ref_dw.abs().max() == 0 and dwc.abs().max() == 0
        return
    torch.testing.assert_close(y.float(), ref_y, **TOLS[dtype])
    if dtype == torch.float32:
        _norm_close(dx, ref_dx)
    else:
        torch.testing.assert_close(dx.float(), ref_dx, **TOLS[dtype])
    _norm_close(dwc, ref_dw)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout", TRAIN_SHAPES + [(3, 4, 128, 256), (2, 8, 16, 24)])
def test_bf16_dw_is_deterministic(cuda_device, n, h, cin, cout):
    """The stream-K dW sums each tile's pieces in a fixed order: two calls,
    and two replays of a CUDA graph of the call, give the same bits, and
    every launch leaves its tile counters at zero for the next."""
    g = torch.Generator().manual_seed(n + cin)
    x = torch.randn(n, h, h, cin, generator=g).to(cuda_device, torch.bfloat16)
    dy = torch.randn(n, 2 * h, 2 * h, cout, generator=g).to(cuda_device, torch.bfloat16)
    first, second = uc.upsample_conv_dw(x, dy), uc.upsample_conv_dw(x, dy)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = uc.upsample_conv_dw(x, dy)
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append(replayed.clone())
    torch.cuda.synchronize()
    for other in [second] + replays:
        assert torch.equal(first, other)
    _norm_close(first, uc.upsample_conv_dw_reference(x.float(), dy.float()))
    assert all(int(c.abs().sum()) == 0 for c in uc._DW_COUNTERS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout", [(2, 8, 16, 24)] + TRAIN_SHAPES)
def test_function_gradients_match_autograd_of_the_plain_forward(cuda_device, n, h, cin, cout):
    g = torch.Generator().manual_seed(h + cin)
    x = torch.randn(n, h, h, cin, generator=g).to(cuda_device)
    w = (torch.randn(cout, cin, 5, 5, generator=g) / (25 * cin) ** 0.5).to(cuda_device)
    b = torch.randn(cout, generator=g).to(cuda_device)
    dy = torch.randn(n, 2 * h, 2 * h, cout, generator=g).to(cuda_device)
    grads = []
    for fn in (uc.UpsampleConvFunction.apply, uc.upsample_conv_reference):
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        fn(xs, uc.collapse_weights(ws), bs).backward(dy)
        grads.append((xs.grad, ws.grad, bs.grad))
    for ours, ref in zip(*grads):
        _norm_close(ours, ref)


@pytest.mark.cuda
def test_g32_training_step_runs_the_three_kernels(cuda_device):
    """One bf16 G-phase pass of the default model: two launches of each
    upsample-conv kernel, four of the batch norm + PReLU kernels a pair,
    finite gradients for every G parameter."""
    g, d = gan.init_gan(torch.Generator().manual_seed(0), 32, 3, 100, device=cuda_device)
    g.train()
    noise = torch.rand(32, 100, device=cuda_device) * 2 - 1
    before = (uc.KERNEL_LAUNCHES, uc.DX_LAUNCHES, uc.DW_LAUNCHES)
    bn_before = bp.BN_PRELU_LAUNCHES
    d(g(noise.bfloat16())).float().sum().backward()
    torch.cuda.synchronize()
    assert (uc.KERNEL_LAUNCHES, uc.DX_LAUNCHES, uc.DW_LAUNCHES) == tuple(b + 2 for b in before)
    assert bp.BN_PRELU_LAUNCHES == bn_before + 8  # two pairs: 2 forward + 2 backward each
    for name, p in g.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


@pytest.mark.cuda
@pytest.mark.parametrize("source,kernel", [("upsample_conv", "UpconvFwd"),
                                           ("upsample_conv_bwd", "UpconvDx"),
                                           ("upsample_conv_bwd", "UpconvDw")])
def test_bf16_kernels_run_on_wgmma(cuda_device, source, kernel):
    """The bf16 forward, dx and dW kernels hold wgmma (HGMMA in SASS) in
    every instantiation of the mainloop."""
    counts = {k: c for k, c in _build.sass_counts(source, "HGMMA").items() if kernel in k}
    assert counts and all(c > 0 for c in counts.values()), counts


def test_facegen_torch_imports_without_jax():
    """The port's every module imports with jax blocked (the card's
    machine has no JAX): a None entry in sys.modules makes import fail."""
    root = Path(__file__).resolve().parents[1]
    modules = sorted(".".join(p.relative_to(root).with_suffix("").parts)
                     for p in (root / "facegen_torch").rglob("*.py") if p.name != "__main__.py")
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'facegen', 'optax'):\n"
            "    sys.modules[name] = None\n"
            f"import importlib\nfor m in {modules!r}:\n    importlib.import_module(m)\n"
            "print('imported', len(" + repr(modules) + "))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"imported {len(modules)}" in out.stdout
    assert len(modules) >= 25


def _c2f_nets(device, fine=32, channels=3):
    from facegen_torch.models import c2f

    return c2f.init_c2f(torch.Generator().manual_seed(4), fine, channels, device=device)


@pytest.mark.cuda
def test_c2f_nets_in_bf16_on_the_card_match_fp32_on_the_cpu(cuda_device):
    """G_d and D_c at fine 32, colour: the card's bf16 against the CPU's
    fp32, within 3e-2 of the largest entry (five bf16 convs in a row)."""
    (g_cpu, d_cpu), (g_gpu, d_gpu) = _c2f_nets("cpu"), _c2f_nets(cuda_device)
    gen = torch.Generator().manual_seed(5)
    noise = torch.rand(8, 32, 32, 1, generator=gen) * 2 - 1
    coarse = torch.rand(8, 32, 32, 3, generator=gen)
    with torch.no_grad():
        ref_diff = g_cpu((noise, coarse))
        ref_logits = d_cpu((ref_diff, coarse))
        args = (noise.to(cuda_device, torch.bfloat16), coarse.to(cuda_device, torch.bfloat16))
        diff = g_gpu(args)
        logits = d_gpu((ref_diff.to(cuda_device, torch.bfloat16), args[1]))
    assert diff.dtype == torch.bfloat16 and diff.shape == (8, 32, 32, 3)
    _norm_close(diff.float().cpu(), ref_diff, 3e-2)
    _norm_close(logits.float().cpu(), ref_logits, 3e-2)


@pytest.mark.cuda
def test_refine_c2f_on_the_card_matches_the_cpu(cuda_device):
    """The refinement as the sampler serves it, with cuDNN's TF32 on as
    torch has it by default (refine_c2f turns it off for its own convs):
    D's scores within 2e-4, and the same candidate and image wherever the
    top two scores differ by more."""
    from facegen_torch.sample import refine_c2f

    (g_cpu, d_cpu), (g_gpu, d_gpu) = _c2f_nets("cpu"), _c2f_nets(cuda_device)
    gen = torch.Generator().manual_seed(6)
    images = torch.rand(16, 16, 16, 3, generator=gen)
    noise = torch.rand(16, 4, 32, 32, 1, generator=gen) * 2 - 1
    ref, ref_scores = refine_c2f(g_cpu, d_cpu, 32, images, noise)
    torch.backends.cudnn.allow_tf32 = True
    try:
        ours, scores = refine_c2f(g_gpu, d_gpu, 32, images, noise)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    torch.testing.assert_close(scores.cpu(), ref_scores, rtol=2e-4, atol=2e-4)
    top2 = ref_scores.sort(dim=1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 4e-4
    assert bool((scores.cpu().argmax(1) == ref_scores.argmax(1))[clear].all())
    torch.testing.assert_close(ours.cpu()[clear], ref[clear], rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_c2f_step_in_fp32_on_the_card_matches_the_cpu(cuda_device):
    """One fp32 c2f step (fine 16, batch 8) on the same draws: Adam's
    moments within 1e-3 and the updates within 1e-2 relative l2 per
    network, the confusion and the counts equal."""
    from facegen_torch.config import C2FConfig
    from facegen_torch.data.c2f import make_triples
    from facegen_torch.train.c2f import C2FStep, draw_c2f_step, init_c2f_state

    cfg = C2FConfig(batch_size=8, fine_size=16, coarse_size=8, compute_dtype="float32",
                    g_l2=1e-3).validate()
    states = {}
    for dev in ("cpu", cuda_device):
        g, d = _c2f_nets(dev, fine=16)
        states[str(dev)] = (init_c2f_state(cfg, g, d), C2FStep(cfg, g, d),
                            [p.detach().cpu().clone() for p in (*g.parameters(), *d.parameters())])
    fine = torch.randint(0, 256, (32, 16, 16, 3), generator=torch.Generator().manual_seed(7),
                         dtype=torch.uint8)
    pool = make_triples(fine, 8)
    cpu_state, cpu_step, before = states["cpu"]
    draws = draw_c2f_step(torch.Generator().manual_seed(8), cfg, 32, cpu_step.mask_specs)
    cpu_step(cpu_state, pool, draws)
    gpu_state, gpu_step, _ = states[str(cuda_device)]
    move = lambda x: x.to(cuda_device) if torch.is_tensor(x) else {  # noqa: E731
        k: m.to(cuda_device) for k, m in x.items()}
    moved = type(draws)(*(tuple(type(it)(*map(move, it)) for it in part) for part in draws))
    gpu_step(gpu_state, type(pool)(*(t.to(cuda_device) for t in pool)), moved)

    for net in ("g", "d"):
        opt_gpu, opt_cpu = getattr(gpu_state, f"opt_{net}"), getattr(cpu_state, f"opt_{net}")
        assert int(opt_gpu["count"]) == int(opt_cpu["count"]) == 1
        for kind in ("mu", "nu"):
            assert _rel_l2(opt_gpu[kind], opt_cpu[kind]) <= 1e-3, (net, kind)
    after_gpu = [p.detach() for p in (*gpu_state.g.parameters(), *gpu_state.d.parameters())]
    after_cpu = [p.detach() for p in (*cpu_state.g.parameters(), *cpu_state.d.parameters())]
    assert _rel_l2([a.cpu() - b for a, b in zip(after_gpu, before)],
                  [a - b for a, b in zip(after_cpu, before)]) <= 1e-2
    assert torch.equal(gpu_state.confusion.cpu(), cpu_state.confusion)


def _move(x, device):
    return x.to(device) if torch.is_tensor(x) else {k: m.to(device) for k, m in x.items()}


def _ae_errs(gpu_net, gpu_opt, cpu_net, cpu_opt, before):
    """Relative l2 of a net's card step against its CPU step: Adam's
    moments, the parameters' change and the batch-norm statistics."""
    assert int(gpu_opt["count"]) == int(cpu_opt["count"]) == 1
    errs = {kind: _rel_l2(gpu_opt[kind], cpu_opt[kind]) for kind in ("mu", "nu")}
    errs["update"] = _rel_l2([p.cpu() - b for p, b in zip(gpu_net.parameters(), before)],
                             [p - b for p, b in zip(cpu_net.parameters(), before)])
    errs["stats"] = _rel_l2(list(gpu_net.buffers()), list(cpu_net.buffers()))
    return errs


@pytest.mark.cuda
def test_ae_step_in_fp32_on_the_card_matches_the_cpu(cuda_device):
    """One fp32 autoencoder step (scale 16, batch 8) on the same draws:
    the loss within 1e-5 relative; Adam's moments and the update within
    1e-3 relative l2."""
    from facegen_torch.config import TrainConfig
    from facegen_torch.models import ae
    from facegen_torch.nn.init import gaussian_overwrite
    from facegen_torch.train.ae_loop import AEStep, ae_epoch_draws
    from facegen_torch.train.optim import adam

    cfg = TrainConfig(batch_size=8, scale=16, grayscale=True, noise_dim=64).validate()

    def build(dev):
        gen = torch.Generator().manual_seed(9)
        model = ae.create_autoencoder(16, 1, 64, generator=gen, device=dev)
        gaussian_overwrite(model, gen)
        return model, adam(1e-3).init(list(model.parameters())), AEStep(cfg, model)

    (m_c, o_c, s_c), (m_g, o_g, s_g) = build("cpu"), build(cuda_device)
    before = [p.detach().clone() for p in m_c.parameters()]
    pool = torch.randint(0, 256, (32, 16, 16, 1), generator=torch.Generator().manual_seed(10),
                         dtype=torch.uint8)
    draws = ae_epoch_draws(torch.Generator().manual_seed(11), 8, 32, s_c.mask_specs)[0]
    loss_c = s_c(m_c, o_c, pool, draws)
    loss_g = s_g(m_g, o_g, pool.to(cuda_device),
                 type(draws)(*(_move(x, cuda_device) for x in draws)))
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=0)
    errs = _ae_errs(m_g, o_g, m_c, o_c, before)
    assert all(v <= 1e-3 for v in errs.values()), errs


@pytest.mark.cuda
def test_denoiser_step_in_fp32_on_the_card_matches_the_cpu(cuda_device):
    """One fp32 denoiser step (scale 8, colour, batch 8, --coefL1 1e-4,
    whose sign term makes the gradients of the biases in front of batch
    norms its own) on the same draws: the two BCEs within 1e-5 relative;
    per decoder, Adam's moments, the update and the batch-norm statistics
    within 1e-3 relative l2."""
    from facegen_torch.config import TrainConfig
    from facegen_torch.models import ae
    from facegen_torch.train.ae_loop import (
        DenoiserDraws,
        DenoiserState,
        DenoiserStep,
        denoiser_epoch_draws,
    )
    from facegen_torch.train.optim import adam

    cfg = TrainConfig(batch_size=8, scale=8, coef_l1=1e-4).validate()

    def build(dev):
        enc, dec1, dec2 = ae.init_denoiser(torch.Generator().manual_seed(12), 8, 3, device=dev)
        return (DenoiserState(enc, dec1, dec2, adam(1e-3).init(list(dec1.parameters())),
                              adam(1e-3).init(list(dec2.parameters()))),
                DenoiserStep(cfg, dec1))

    (st_c, s_c), (st_g, s_g) = build("cpu"), build(cuda_device)
    before = {k: [p.detach().clone() for p in getattr(st_c, k).parameters()]
              for k in ("dec1", "dec2")}
    pool = torch.randint(0, 256, (32, 8, 8, 3), generator=torch.Generator().manual_seed(13),
                         dtype=torch.uint8)
    draws = denoiser_epoch_draws(torch.Generator().manual_seed(14), 8, (8, 8, 3), 32,
                                 s_c.mask_specs)[0]
    loss_c = s_c(st_c, pool, draws)
    loss_g = s_g(st_g, pool.to(cuda_device),
                 DenoiserDraws(*(_move(x, cuda_device) for x in draws)))
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=0)
    for k, opt in (("dec1", "opt1"), ("dec2", "opt2")):
        errs = _ae_errs(getattr(st_g, k), getattr(st_g, opt), getattr(st_c, k),
                        getattr(st_c, opt), before[k])
        assert all(v <= 1e-3 for v in errs.values()), (k, errs)


@pytest.mark.cuda
def test_load_denoiser_fn_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """AE1's decoder as --denoise serves it, with cuDNN's TF32 on as torch
    has it by default (the denoiser turns it off for its own call): within
    1e-5 of the CPU's, fp32."""
    from facegen_torch.config import TrainConfig
    from facegen_torch.models import ae
    from facegen_torch.utils import checkpoint as ckpt

    _, dec1, dec2 = ae.init_denoiser(torch.Generator().manual_seed(15), 16, 3)
    with torch.no_grad():  # larger weights than the init's, so outputs vary per input
        for p in dec1.parameters():
            p.mul_(40.0)
        for b in dec1.buffers():
            b.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(16))
    ckpt.save_denoiser(str(tmp_path), ae.denoiser_ckpt_name(16, 3), dec1, dec2)
    cfg = TrainConfig(save=str(tmp_path), scale=16)
    images = torch.rand(64, 16, 16, 3, generator=torch.Generator().manual_seed(17))
    ref = ae.load_denoiser_fn(cfg, "cpu")(images)
    torch.backends.cudnn.allow_tf32 = True
    try:
        ours = ae.load_denoiser_fn(cfg, cuda_device)(images.to(cuda_device))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert ours.dtype == torch.float32 and float(ref.std()) > 1e-3
    torch.testing.assert_close(ours.cpu(), ref, rtol=1e-5, atol=1e-5)


def _gan_step(device, cfg, seed=5, mesh=None):
    """A G32 + D32b training state and step, the same on every call. G's
    biases are drawn nonzero: with --G_L2 1e-3 (and the reference's
    sign-term bug) the penalty then sets the gradients of the
    upsample-convs' biases, which feed batch norms and are otherwise
    rounding noise that Adam turns into a whole step of either sign
    (cuDNN's weight gradients need not sum in the same order twice)."""
    from facegen_torch.train.step import TrainStep, init_state

    g, d = gan.init_gan(torch.Generator().manual_seed(seed), cfg.scale, cfg.channels,
                        cfg.noise_dim, reference_init=False, device=device)
    bias_gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.rand(p.shape, generator=bias_gen) * 0.2 - 0.1)
    return init_state(cfg, g, d, mesh), TrainStep(cfg, g, d, mesh)


def _gan_pool(device, n=256):
    from facegen_torch.data.pipeline import prepare_pool
    from facegen_torch.data.synthetic import draw_synthetic_faces

    return prepare_pool(draw_synthetic_faces(torch.Generator().manual_seed(6), n), 32, 3).to(device)


def _eager_steps(state, step, pool, generator, n):
    from facegen_torch.train.step import draw_step

    for _ in range(n):
        step(state, pool, draw_step(generator, step.cfg, pool.shape[0], step.mask_specs))


def _assert_states_close(a, b, tol):
    """Parameters, statistics and Adam's moments within ``tol`` relative l2
    per network; counts, counters, ring and confusion equal."""
    for net in ("g", "d"):
        ours, ref = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        assert _rel_l2(list(ours.values()), [t.cpu() for t in ref.values()]) <= tol, net
        opt_a, opt_b = getattr(a, f"opt_{net}"), getattr(b, f"opt_{net}")
        assert torch.equal(opt_a["count"], opt_b["count"])
        for kind in ("mu", "nu"):
            assert _rel_l2(opt_a[kind], [t.cpu() for t in opt_b[kind]]) <= tol, (net, kind)
    for key in ("accs_n", "confusion", "trained_d", "not_trained_d"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key
    assert _rel_l2([a.accs], [b.accs.cpu()]) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_graphed_steps_match_eager_steps(cuda_device, dtype, tol):
    """3 steps through the CUDA graph (one eager warm-up, the capture, two
    replays) against 3 eager steps from the same state and draws: fp32
    (TF32 off) within 1e-5 relative l2, bf16 within 1e-3; counters equal."""
    from facegen_torch.config import TrainConfig
    from facegen_torch.train.graph import WARMUP_STEPS, GraphedStep

    cfg = TrainConfig(compute_dtype=dtype, reference_init=False, g_l2=1e-3).validate()
    pool = _gan_pool(cuda_device)
    eager, eager_step = _gan_step(cuda_device, cfg)
    graphed, graphed_step = _gan_step(cuda_device, cfg)
    _eager_steps(eager, eager_step, pool, torch.Generator(cuda_device).manual_seed(7), 3)
    runner = GraphedStep(graphed_step, graphed, pool.shape[0])
    runner.set_pool(pool)
    ms = runner.run(torch.Generator(cuda_device).manual_seed(7), 3)
    torch.cuda.synchronize()
    assert runner.graph is not None and runner.eager_steps == WARMUP_STEPS == 1
    assert ms.loss_d.shape == (3,) and bool(torch.isfinite(ms.loss_g).all())
    assert int(graphed.trained_d) + int(graphed.not_trained_d) == 3
    _assert_states_close(graphed, eager, tol)


@pytest.mark.cuda
def test_a_capture_survives_garbage_graphs(cuda_device):
    """Two graphed runners that became garbage, each holding its captured
    graph in a reference cycle, wait while a third captures; inside that
    capture the step runs a collection, as the interpreter may at any
    allocation. The capture collects first, so no graph is destroyed
    inside it (which CUDA refuses, and which spoils the capture)."""
    import gc

    from facegen_torch.config import TrainConfig
    from facegen_torch.train.graph import GraphedStep

    cfg = TrainConfig(compute_dtype="float32", reference_init=False).validate()
    pool = _gan_pool(cuda_device)
    state, step = _gan_step(cuda_device, cfg)
    d_iteration = step.d_iteration

    def collecting(*args):
        if torch.cuda.is_current_stream_capturing():
            gc.collect()
        return d_iteration(*args)

    step.d_iteration = collecting
    runner = GraphedStep(step, state, pool.shape[0])
    runner.set_pool(pool)
    gen = torch.Generator(cuda_device).manual_seed(7)
    runner.run(gen, 1)  # the eager warm-up: the next step captures
    for _ in range(2):
        old_state, old_step = _gan_step(cuda_device, cfg)
        old = GraphedStep(old_step, old_state, pool.shape[0])
        old.set_pool(pool)
        old.run(torch.Generator(cuda_device).manual_seed(8), 2)
        assert old.graph is not None
        old.cycle = old  # garbage to the cyclic collector only
        del old, old_state, old_step
    ms = runner.run(gen, 2)
    torch.cuda.synchronize()
    assert runner.graph is not None and bool(torch.isfinite(ms.loss_d).all())


@pytest.mark.cuda
def test_graphed_boundary_pad_steps_match_eager_ones(cuda_device):
    """--boundaryPad 8 at fp32 (TF32 off): 3 graphed steps against 3 eager
    ones within 1e-5 relative l2, the padded weights made from the live
    parameters in every replay (nothing cached: the third step's D reads
    the second's update); the capture launches the kernels as the
    unpadded step does (4, 2, 2, the update's 2 and 2, and the batch norm +
    PReLU's 12)."""
    from facegen_torch.config import TrainConfig
    from facegen_torch.train.graph import GraphedStep

    cfg = TrainConfig(compute_dtype="float32", reference_init=False, g_l2=1e-3,
                      boundary_pad=8).validate()
    pool = _gan_pool(cuda_device)
    eager, eager_step = _gan_step(cuda_device, cfg)
    graphed, graphed_step = _gan_step(cuda_device, cfg)
    assert graphed_step.pad.active and graphed_step.pad.pad == 5
    _eager_steps(eager, eager_step, pool, torch.Generator(cuda_device).manual_seed(7), 3)
    runner = GraphedStep(graphed_step, graphed, pool.shape[0])
    runner.set_pool(pool)
    runner.run(torch.Generator(cuda_device).manual_seed(7), 3)
    torch.cuda.synchronize()
    assert runner.launches_per_replay == {"KERNEL_LAUNCHES": 4, "DX_LAUNCHES": 2,
                                          "DW_LAUNCHES": 2, "PREP_LAUNCHES": 2,
                                          "UPDATE_LAUNCHES": 2, "BN_PRELU_LAUNCHES": 12}
    assert tuple(graphed.g.get_parameter("09_conv_out.weight").shape) == (3, 128, 3, 3)
    _assert_states_close(graphed, eager, 1e-5)


@pytest.mark.cuda
def test_graphed_guard_nonfinite_skips_a_poisoned_update(cuda_device):
    """guard_nonfinite in the graphed step: with every D weight NaN, no
    replay lands an update (D's gate closes, G's update is skipped), and
    not_trained_d counts each step."""
    from facegen_torch.config import TrainConfig
    from facegen_torch.train.graph import GraphedStep

    cfg = TrainConfig(compute_dtype="float32", reference_init=False,
                      guard_nonfinite=True).validate()
    pool = _gan_pool(cuda_device)
    state, step = _gan_step(cuda_device, cfg)
    with torch.no_grad():
        for p in state.d.parameters():
            p.fill_(float("nan"))
    before = [p.detach().clone() for p in state.g.parameters()]
    runner = GraphedStep(step, state, pool.shape[0])
    runner.set_pool(pool)
    runner.run(torch.Generator(cuda_device).manual_seed(7), 3)
    torch.cuda.synchronize()
    assert runner.graph is not None
    assert (int(state.trained_d), int(state.not_trained_d)) == (0, 3)
    assert all(torch.equal(p, q) for p, q in zip(state.g.parameters(), before))
    assert int(state.opt_g["count"]) == int(state.opt_d["count"]) == 0


@pytest.mark.cuda
def test_graphed_steps_equal_eager_steps_with_deterministic_cudnn(cuda_device):
    """At the setting where two eager runs differ when cuDNN chooses its
    algorithms freely (scheme init, zero G biases, --G_L2 0; fp32, TF32
    off), with cuDNN's deterministic algorithms 3 graphed steps equal 3
    eager steps bit for bit: the replay itself adds no difference."""
    from facegen_torch.config import TrainConfig
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.train.step import TrainStep, init_state

    cfg = TrainConfig(compute_dtype="float32", reference_init=False).validate()
    pool = _gan_pool(cuda_device)

    def build():
        g, d = gan.init_gan(torch.Generator().manual_seed(5), cfg.scale, cfg.channels,
                            cfg.noise_dim, reference_init=False, device=cuda_device)
        return init_state(cfg, g, d), TrainStep(cfg, g, d)

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager, eager_step = build()
        _eager_steps(eager, eager_step, pool, torch.Generator(cuda_device).manual_seed(7), 3)
        graphed, graphed_step = build()
        runner = GraphedStep(graphed_step, graphed, pool.shape[0])
        runner.set_pool(pool)
        runner.run(torch.Generator(cuda_device).manual_seed(7), 3)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = saved
    assert runner.graph is not None
    _assert_states_close(graphed, eager, 0.0)


@pytest.mark.cuda
def test_one_rank_nccl_graphed_step_equals_the_single_device_one(cuda_device):
    """A 1-rank NCCL group's data-parallel step, its all-reduces captured
    in the CUDA graph, against the single-device graphed step: 3 steps
    from one state on the same draws, fp32 (TF32 off) under cuDNN's
    deterministic algorithms, bit for bit."""
    import socket

    import torch.distributed as dist

    from facegen_torch.config import TrainConfig
    from facegen_torch.parallel import make_mesh, maybe_initialize
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.train.step import TrainStep

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert maybe_initialize({"FACEGEN_COORDINATOR": f"127.0.0.1:{port}",
                             "FACEGEN_NUM_PROCESSES": "1", "FACEGEN_PROCESS_ID": "0"})
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = make_mesh((-1,))
        assert (mesh.size, mesh.backend, mesh.device) == (1, "nccl", cuda_device)
        cfg = TrainConfig(compute_dtype="float32", reference_init=False, g_l2=1e-3).validate()
        pool = _gan_pool(cuda_device)
        states = []
        for dp in (False, True):
            state, _ = _gan_step(cuda_device, cfg)
            runner = GraphedStep(TrainStep(cfg, state.g, state.d, mesh if dp else None), state,
                                 pool.shape[0])
            runner.set_pool(pool)
            runner.run(torch.Generator(cuda_device).manual_seed(7), 3)
            assert runner.graph is not None
            states.append(state)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = saved
        dist.destroy_process_group()
    _assert_states_close(states[1], states[0], 0.0)


@pytest.mark.cuda
def test_2d_step_at_world_one_under_nccl_equals_the_single_device_one(cuda_device):
    """The 2-D mesh's step on ``make_mesh2d(1, 1)`` of a 1-rank NCCL group,
    its all-reduces and all-gathers captured in the CUDA graph, against the
    single-device graphed step: 3 steps from one state on the same draws,
    fp32 (TF32 off) under cuDNN's deterministic algorithms, bit for bit."""
    import socket

    import torch.distributed as dist

    from facegen_torch.config import TrainConfig
    from facegen_torch.parallel import make_mesh2d, maybe_initialize
    from facegen_torch.train.graph import GraphedStep

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert maybe_initialize({"FACEGEN_COORDINATOR": f"127.0.0.1:{port}",
                             "FACEGEN_NUM_PROCESSES": "1", "FACEGEN_PROCESS_ID": "0"})
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = make_mesh2d(1, 1)
        assert (mesh.dp, mesh.mp, mesh.backend, mesh.device) == (1, 1, "nccl", cuda_device)
        cfg = TrainConfig(compute_dtype="float32", reference_init=False, g_l2=1e-3).validate()
        pool = _gan_pool(cuda_device)
        states = []
        for two_d in (False, True):
            state, step = _gan_step(cuda_device, cfg, mesh=mesh if two_d else None)
            runner = GraphedStep(step, state, pool.shape[0])
            runner.set_pool(pool)
            runner.run(torch.Generator(cuda_device).manual_seed(7), 3)
            assert runner.graph is not None
            assert ("all-gathers over the 1x1 mesh" in runner.route) == two_d, runner.route
            states.append(state)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = saved
        dist.destroy_process_group()
    _assert_states_close(states[1], states[0], 0.0)


@pytest.mark.cuda
def test_synchronised_batch_norm_on_the_card_matches_the_cpu(cuda_device):
    """``SyncBatchNormFunction`` over a data group of two rows that hold
    the same batch (an all-reduce that doubles), fp32: the output, the
    running statistics and the gradients on the card against the CPU
    within 1e-5, the statistics' global count in the unbiased factor."""
    import types

    from facegen_torch.nn.layers import BatchNorm

    two_rows = types.SimpleNamespace(dp=2, all_reduce_sum_=lambda t: t.mul_(2.0))
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(6, 4, 4, 16, generator=gen) * 2.0 + 0.5
    dy = torch.randn(6, 4, 4, 16, generator=gen)
    results = []
    for device in ("cpu", cuda_device):
        bn = BatchNorm(16, device=device)
        with torch.no_grad():
            bn.weight.copy_(torch.rand(16, generator=torch.Generator().manual_seed(4)) + 0.5)
        bn.mesh = two_rows
        xs = x.clone().to(device).requires_grad_()
        y = bn.train()(xs)
        y.backward(dy.to(device))
        results.append([t.detach().cpu() for t in (y, bn.running_mean, bn.running_var, xs.grad,
                                                   bn.weight.grad, bn.bias.grad)])
    torch.cuda.synchronize()
    for ours, ref in zip(results[1], results[0]):
        torch.testing.assert_close(ours, ref, rtol=1e-5, atol=1e-5)
    n = 2 * 6 * 4 * 4  # the global count
    var = x.reshape(-1, 16).var(0, unbiased=False)
    torch.testing.assert_close(results[0][2], 0.9 + 0.1 * var * n / (n - 1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_graphed_draws_and_launch_counts(cuda_device):
    """The static draws hold draw_step's draws of the last step, and the
    kernel counters after a warm-up step and 4 replays read 5 eager steps'
    launches."""
    from facegen_torch.config import TrainConfig
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.train.step import draw_step

    cfg = TrainConfig().validate()
    pool = _gan_pool(cuda_device)
    state, step = _gan_step(cuda_device, cfg)
    counts = lambda: (uc.KERNEL_LAUNCHES, uc.DX_LAUNCHES, uc.DW_LAUNCHES,  # noqa: E731
                      fu.PREP_LAUNCHES, fu.UPDATE_LAUNCHES, bp.BN_PRELU_LAUNCHES)
    before = counts()
    _eager_steps(state, step, pool, torch.Generator(cuda_device).manual_seed(1), 1)
    per_step = tuple(b - a for a, b in zip(before, counts()))
    # the update's two kernels once per net; G's two batch norm + PReLU
    # pairs: 2 launches each in the D phase's no-grad forward, 2 + 2 in the
    # G phase's forward and backward
    assert per_step == (4, 2, 2, 2, 2, 12)
    runner = GraphedStep(step, state, pool.shape[0])
    runner.set_pool(pool)
    before = counts()
    runner.run(torch.Generator(cuda_device).manual_seed(2), 5)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, counts())) == tuple(5 * n for n in per_step)
    assert runner.launches_per_replay == dict(zip(("KERNEL_LAUNCHES", "DX_LAUNCHES",
                                                   "DW_LAUNCHES", "PREP_LAUNCHES",
                                                   "UPDATE_LAUNCHES", "BN_PRELU_LAUNCHES"),
                                                  per_step))
    gen = torch.Generator(cuda_device).manual_seed(2)
    for _ in range(5):
        want = draw_step(gen, cfg, pool.shape[0], step.mask_specs)
    for a, b in zip(want.d + want.g, runner.draws.d + runner.draws.g):
        for x, y in zip(a, b):
            if isinstance(x, dict):
                assert all(torch.equal(x[k], y[k]) for k in x)
            else:
                assert torch.equal(x, y)


@pytest.mark.cuda
def test_resume_then_graphed_steps_match_eager_steps(cuda_device, tmp_path):
    """A checkpoint loaded in place under a GraphedStep made before the
    load, then 3 graphed steps, against the same load and 3 eager steps
    (fp32, TF32 off, 1e-5)."""
    from facegen_torch.config import TrainConfig
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.utils import checkpoint as ckpt

    cfg = TrainConfig(compute_dtype="float32", reference_init=False, g_l2=1e-3).validate()
    pool = _gan_pool(cuda_device)
    first, first_step = _gan_step(cuda_device, cfg)
    _eager_steps(first, first_step, pool, torch.Generator(cuda_device).manual_seed(3), 2)
    ckpt.save_train_state(str(tmp_path), "adversarial", first)
    graphed, graphed_step = _gan_step(cuda_device, cfg, seed=9)
    runner = GraphedStep(graphed_step, graphed, pool.shape[0])
    ckpt.load_train_state(str(tmp_path), "adversarial", graphed)
    eager, eager_step = _gan_step(cuda_device, cfg, seed=9)
    ckpt.load_train_state(str(tmp_path), "adversarial", eager)
    runner.set_pool(pool)
    runner.run(torch.Generator(cuda_device).manual_seed(4), 3)
    _eager_steps(eager, eager_step, pool, torch.Generator(cuda_device).manual_seed(4), 3)
    torch.cuda.synchronize()
    assert int(graphed.opt_d["count"]) == 5
    _assert_states_close(graphed, eager, 1e-5)


@pytest.mark.cuda
def test_eval_forward_after_replays_sees_the_new_weights(cuda_device):
    """A replay writes G's weights in place: G's eval-mode forward after
    replays must give what a copy of G made after them gives (the grids and
    the activation dumps run between an epoch's replays)."""
    import copy

    from facegen_torch.config import TrainConfig
    from facegen_torch.train.graph import GraphedStep

    cfg = TrainConfig().validate()
    pool = _gan_pool(cuda_device)
    state, step = _gan_step(cuda_device, cfg)
    runner = GraphedStep(step, state, pool.shape[0])
    runner.set_pool(pool)
    gen = torch.Generator(cuda_device).manual_seed(3)
    noise = (torch.rand(8, 100, generator=torch.Generator().manual_seed(4)) * 2 - 1).to(cuda_device)
    inf = GanInference(state.g, state.d, 100)
    runner.run(gen, 3)  # a warm-up step, the capture, 2 replays
    state.g.eval()  # as visualize_progress sets it; the train step leaves G in train mode
    before = inf.generate(noise)
    runner.run(gen, 2)
    got = inf.generate(noise)
    want = GanInference(copy.deepcopy(state.g), state.d, 100).generate(noise)
    assert not torch.equal(got, before)
    assert torch.equal(got, want)


def _spread_gan(device, seed):
    """G32 + D32b away from init's flat output: G's and D's kernels x6 and
    x3, G's statistics moved (tests/test_torch_port_eval.py does the same
    to facegen's weights)."""
    g, d = gan.init_gan(torch.Generator().manual_seed(seed), 32, 3, 100, reference_init=False)
    with torch.no_grad():
        for net, factor in ((g, 6.0), (d, 3.0)):
            for name, t in net.state_dict().items():
                if name.endswith("weight") and t.dim() > 1:
                    t.mul_(factor)
                elif net is g and name.endswith(("running_mean", "running_var")):
                    t.mul_(2.0).add_(0.05)
    return g.to(device), d.to(device)


@pytest.mark.cuda
def test_parity_report_on_the_card_matches_the_cpu(cuda_device):
    """The fp32 parity report (TF32 off) of two full-width GANs on the same
    injected draws, card against CPU, within the CPU tests' tolerances; two
    G calls, four forward launches."""
    import numpy as np

    from facegen_torch.eval import parity

    n = 64
    gen = torch.Generator().manual_seed(8)
    draws = dict(noise_a=torch.rand(n, 100, generator=gen) * 2 - 1,
                 noise_b=torch.rand(n, 100, generator=gen) * 2 - 1,
                 real_perm=torch.randperm(128, generator=gen))
    train = _gan_pool("cpu", 128).numpy()
    reports = {}
    for device in (cuda_device, torch.device("cpu")):
        (g_a, d_a), (g_b, d_b) = _spread_gan(device, 0), _spread_gan(device, 1)
        before = uc.KERNEL_LAUNCHES
        reports[device.type] = parity.parity_report(g_a, d_a, g_b, d_b, train, n_samples=n,
                                                    compute_dtype=torch.float32, **draws)
        if device.type == "cuda":
            assert uc.KERNEL_LAUNCHES == before + 4
    assert reports["cuda"].keys() == reports["cpu"].keys()
    assert not parity.report_diffs(reports["cuda"], reports["cpu"], n)
    assert np.isfinite(reports["cuda"]["frechet_d_features"]["a_vs_b"])


@pytest.mark.cuda
def test_numpy_generator_matches_the_cards_g(cuda_device, tmp_path):
    """The exported G served by NumPy against the card's fp32 G, 1e-4."""
    import numpy as np

    from facegen_torch import export

    g, d = _spread_gan(cuda_device, 2)
    gen = export.NumpyGenerator(export.export_generator(g, str(tmp_path / "g.npz"), 32, 3, 100))
    z = np.random.RandomState(0).uniform(-1, 1, (16, 100)).astype(np.float32)
    ref = GanInference(g, d, 100, compute_dtype=torch.float32).generate(torch.from_numpy(z))
    np.testing.assert_allclose(gen(z), ref.cpu().numpy(), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_trace_of_graphed_replays_lists_the_three_kernels(cuda_device, tmp_path):
    """aggregate_trace of 3 replays of the graphed step at the default
    flags lists UpconvFwd, UpconvDx and UpconvDw at 3 x (4, 2, 2) calls."""
    from facegen_torch.config import TrainConfig
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.utils.profiling import aggregate_trace, trace

    cfg = TrainConfig().validate()
    pool = _gan_pool(cuda_device)
    state, step = _gan_step(cuda_device, cfg)
    runner = GraphedStep(step, state, pool.shape[0])
    runner.set_pool(pool)
    gen = torch.Generator(cuda_device).manual_seed(2)
    runner.run(gen, 2)  # the warm-up step and the capture
    with trace(str(tmp_path)):
        runner.run(gen, 3)
        torch.cuda.synchronize()
    summary = aggregate_trace(str(tmp_path), top=1 << 30)
    calls = {k: sum(r["calls"] for r in summary["ops"] if k.lower() in r["name"].lower())
             for k in ("UpconvFwd", "UpconvDx", "UpconvDw")}
    assert calls == {"UpconvFwd": 12, "UpconvDx": 6, "UpconvDw": 6}
    assert summary["total_us"] > 0 and summary["device"] != "host (no device track)"


@pytest.mark.cuda
def test_replay_spans_their_device_views_and_kernels(cuda_device, tmp_path):
    """Under the profiler the graphed GAN step gives one ``step.replay`` span
    (utils/profiling.py:span) and one ``step.draw`` a replay; each replay's
    device view starts no earlier than its host span, within 2 us (the
    trace's host and device events share one clock), and holds the same
    count of kernels on every replay, the upsample-conv's and the update's
    among them."""
    import gzip
    import json

    from facegen_torch.config import TrainConfig
    from facegen_torch.train.graph import GraphedStep
    from facegen_torch.utils.profiling import _newest_trace, trace

    cfg = TrainConfig().validate()
    pool = _gan_pool(cuda_device)
    state, step = _gan_step(cuda_device, cfg)
    runner = GraphedStep(step, state, pool.shape[0])
    runner.set_pool(pool)
    gen = torch.Generator(cuda_device).manual_seed(2)
    runner.run(gen, 2)  # the warm-up step and the capture
    replays = 5
    with trace(str(tmp_path)):
        runner.run(gen, replays)
        torch.cuda.synchronize()
    with gzip.open(_newest_trace(str(tmp_path)), "rt") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]

    def spans(cat, name):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in events if e.get("cat") == cat and e.get("name") == name)

    host = spans("user_annotation", "step.replay")
    views = spans("gpu_user_annotation", "step.replay")
    assert len(host) == len(views) == len(spans("user_annotation", "step.draw")) == replays
    for (hs, _), (vs, _) in zip(host, views):
        assert vs >= hs - 2.0, (hs, vs)
    starts = [float(e["ts"]) for e in events if e.get("cat") == "kernel"]
    counts = [sum(1 for t in starts if vs <= t <= ve) for vs, ve in views]
    assert len(set(counts)) == 1, counts
    assert counts[0] >= sum(runner.launches_per_replay.values()) > 0


# ------------------------------------------ the c2f, autoencoder and denoiser graphs
FAMILY = ("c2f", "autoencoder", "denoiser")
# a replay's launches: none of the upsample-conv kernels; the update's two
# kernels per net iteration (c2f: D and G; denoiser: its two decoders; the
# autoencoder: its one net, whose prep has work here only through
# --coefL1, as it has no clamp); no batch norm + PReLU launches (the
# autoencoder's and the denoiser's batch norms feed LeakyReLUs)
FAMILY_LAUNCHES = {
    kind: {"KERNEL_LAUNCHES": 0, "DX_LAUNCHES": 0, "DW_LAUNCHES": 0, "PREP_LAUNCHES": n,
           "UPDATE_LAUNCHES": n, "BN_PRELU_LAUNCHES": 0}
    for kind, n in (("c2f", 2), ("autoencoder", 1), ("denoiser", 2))}


def _family_trainer(kind, save, dtype="float32", **kw):
    """A c2f, autoencoder or denoiser trainer on cuda:0 at its CLI's
    defaults on synthetic data (--N_epoch 256), fp32 unless ``dtype`` (the
    c2f's); the c2f with --G_L2 1e-3 and the AE family with --coefL1 1e-4,
    which make the gradients of the biases that feed batch norms the
    penalty's instead of rounding noise that Adam turns into a step of
    either sign."""
    from facegen_torch.config import C2FConfig, TrainConfig
    from facegen_torch.train.ae_loop import AETrainer, DenoiserTrainer
    from facegen_torch.train.c2f import C2FTrainer

    dev, common = torch.device("cuda", 0), dict(synthetic_data=True, n_epoch=256, save=save)
    if kind == "c2f":
        return C2FTrainer(C2FConfig(compute_dtype=dtype, g_l2=1e-3, **common), device=dev,
                          verbose=False, **kw)
    if kind == "autoencoder":
        return AETrainer(TrainConfig(scale=32, grayscale=True, noise_dim=256, coef_l1=1e-4,
                                     **common), device=dev, verbose=False, **kw)
    return DenoiserTrainer(TrainConfig(scale=16, coef_l1=1e-4, **common), device=dev,
                           verbose=False, **kw)


def _family_steps(trainer, n=3, seed=7):
    """``n`` steps of ``trainer.run_steps`` on an epoch's pool and draws
    from ``seed``; their losses, (n, k) on the device."""
    from facegen_torch.data.c2f import make_triples
    from facegen_torch.train.c2f import C2FTrainer

    gen = torch.Generator(trainer.device).manual_seed(seed)
    if isinstance(trainer, C2FTrainer):
        pool = make_triples(trainer.source.epoch_pool(gen, trainer.pool_n),
                            trainer.cfg.coarse_size)
        return torch.stack(trainer.run_steps(pool, gen, n), 1)
    return trainer.run_steps(trainer.epoch_draws(gen)[:n]).reshape(n, -1)


def _family_state(trainer):
    """({group: tensors}: each net's parameters, batch-norm statistics and
    Adam moments; [the optimizer counts and the c2f's confusion matrix])."""
    from facegen_torch.train.ae_loop import AETrainer, DenoiserTrainer

    st = getattr(trainer, "state", None)
    if isinstance(trainer, AETrainer):
        nets, opts, exact = {"ae": trainer.model}, {"ae": trainer.opt}, []
    elif isinstance(trainer, DenoiserTrainer):
        nets, opts, exact = ({"dec1": st.dec1, "dec2": st.dec2},
                             {"dec1": st.opt1, "dec2": st.opt2}, [])
    else:
        nets, opts, exact = {"g": st.g, "d": st.d}, {"g": st.opt_g, "d": st.opt_d}, [st.confusion]
    groups = {}
    for k, net in nets.items():
        groups[f"{k} parameters"] = list(net.parameters())
        if list(net.buffers()):
            groups[f"{k} statistics"] = list(net.buffers())
        for kind in ("mu", "nu"):
            groups[f"{k} {kind}"] = opts[k][kind]
    return groups, [opt["count"] for opt in opts.values()] + exact


def _assert_family_close(a, b, losses_a, losses_b, tol):
    (ga, ea), (gb, eb) = _family_state(a), _family_state(b)
    for k in ga:
        assert _rel_l2(ga[k], [t.cpu() for t in gb[k]]) <= tol, k
    assert all(torch.equal(x, y) for x, y in zip(ea, eb))
    assert _rel_l2([losses_a], [losses_b.cpu()]) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype,tol", [("c2f", "float32", 1e-5), ("c2f", "bfloat16", 1e-3),
                                            ("autoencoder", "float32", 1e-5),
                                            ("denoiser", "float32", 1e-5)])
def test_family_graphed_steps_match_eager_steps(cuda_device, tmp_path, kind, dtype, tol):
    """3 steps through the trainer's CUDA graph (one eager warm-up, the
    capture, two replays) against 3 steps of the same trainer built with
    ``capture=False``, from the same state on the same pool and draws,
    under cuDNN's deterministic algorithms: fp32 (TF32 off) within 1e-5
    relative l2 over the parameters, the batch-norm statistics, Adam's
    moments and the losses, the c2f's bf16 within 1e-3; the counts equal;
    none of the upsample-conv kernels in the capture, the update's
    (FAMILY_LAUNCHES). (With cuDNN free to choose, the
    c2f's fp32 convs differ from run to run: two eager runs read 1.3e-3
    on an H100.)"""
    from facegen_torch.train.graph import WARMUP_STEPS

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager = _family_trainer(kind, str(tmp_path), dtype, capture=False)
        graphed = _family_trainer(kind, str(tmp_path), dtype)
        losses_e, losses_g = _family_steps(eager), _family_steps(graphed)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = saved
    runner = graphed.graphed
    assert runner.route == "one CUDA graph replay a step" and eager.graphed.graph is None
    assert runner.graph is not None and runner.eager_steps == WARMUP_STEPS
    assert runner.launches_per_replay == FAMILY_LAUNCHES[kind]
    assert bool(torch.isfinite(losses_g).all())
    _assert_family_close(graphed, eager, losses_g, losses_e, tol)


class _Collecting:
    """A trainer's step that runs a collection when it is called inside a
    capture, as the interpreter may at any allocation."""

    def __init__(self, step):
        self.step, self.mask_specs = step, step.mask_specs

    def __call__(self, *args):
        import gc

        if torch.cuda.is_current_stream_capturing():
            gc.collect()
        return self.step(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FAMILY)
def test_a_family_capture_survives_garbage_graphs(cuda_device, tmp_path, kind):
    """Two trainers of the kind that captured their step and became
    garbage (each holds its graph in a reference cycle: the trainer, its
    runner, the step closure) wait while a third captures, and a
    collection runs inside that capture; no graph is destroyed inside it."""
    trainer = _family_trainer(kind, str(tmp_path / "live"))
    trainer.step = _Collecting(trainer.step)
    _family_steps(trainer, 1)  # the eager warm-up: the next step captures
    for i in range(2):
        old = _family_trainer(kind, str(tmp_path / f"old{i}"))
        _family_steps(old, 2, seed=8)
        assert old.graphed.graph is not None
        del old
    losses = _family_steps(trainer, 2, seed=9)
    torch.cuda.synchronize()
    assert trainer.graphed.graph is not None and bool(torch.isfinite(losses).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FAMILY)
def test_family_on_a_1x1_nccl_mesh_equals_the_single_device_graph(cuda_device, tmp_path, kind):
    """The trainer on ``make_mesh2d(1, 1)`` of a 1-rank NCCL group, its
    all-reduces inside the CUDA graph, against the same trainer on one
    device: 3 graphed steps each in fp32 (TF32 off) under cuDNN's
    deterministic algorithms, bit for bit."""
    import socket

    import torch.distributed as dist

    from facegen_torch.parallel import make_mesh2d, maybe_initialize

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert maybe_initialize({"FACEGEN_COORDINATOR": f"127.0.0.1:{port}",
                             "FACEGEN_NUM_PROCESSES": "1", "FACEGEN_PROCESS_ID": "0"})
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = make_mesh2d(1, 1)
        one = _family_trainer(kind, str(tmp_path))
        two = _family_trainer(kind, str(tmp_path), mesh=mesh)
        losses_one, losses_two = _family_steps(one), _family_steps(two)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = saved
        dist.destroy_process_group()
    assert one.graphed.graph is not None and two.graphed.graph is not None
    assert "all-gathers over the 1x1 mesh inside it" in two.graphed.route
    assert torch.equal(losses_two, losses_one)
    _assert_family_close(two, one, losses_two, losses_one, 0.0)


# ------------------------------------------------ the update's two kernels
UPDATE_TOL = 1e-6
SUMS_RTOL = 1e-5
# the nets whose leaves the trainers update, full width: the GAN's at 32
# and 16 (G16 + D16_d), the c2f's, the autoencoder and a denoiser decoder
FUSED_NETS = ("G32", "D32b", "G16", "D16_d", "c2f_G", "c2f_D", "AE", "denoiser_dec")


def _fused_shapes(net):
    from facegen_torch.models import ae, c2f

    gen = torch.Generator().manual_seed(0)
    if net in ("G32", "D32b", "G16", "D16_d"):
        g, d = gan.init_gan(gen, 32 if net in ("G32", "D32b") else 16, 3, 100)
        module = g if net.startswith("G") else d
    elif net.startswith("c2f"):
        module = c2f.init_c2f(gen, 32, 3)[0 if net == "c2f_G" else 1]
    elif net == "AE":
        module = ae.create_autoencoder(32, 1, 256, generator=gen)
    else:
        module = ae.init_denoiser(gen, 16, 3)[1]
    return [tuple(p.shape) for p in module.parameters()]


def _fused_leaves(shapes, method, device, seed=0):
    """Parameters, gradients (a tenth beyond the clamp of 0.02) and an
    optimizer state three steps in, from a seed."""
    from facegen_torch.train import optim

    gen = torch.Generator().manual_seed(seed)
    params = [(torch.randn(s, generator=gen) * 0.05).to(device) for s in shapes]
    grads = [(torch.randn(s, generator=gen) * 0.012).to(device) for s in shapes]
    kind = "sgd" if method == "sgd_momentum" else method
    tx = optim.make_optimizer(kind, _optim_cfg(method), "D")
    state = tx.init(params)
    for key, v in state.items():
        if key == "count":
            v.fill_(3)
        else:
            for t in v:
                t.copy_((torch.rand(t.shape, generator=gen) * 1e-4).to(device))
    return tx, params, grads, state


def _optim_cfg(method):
    from facegen_torch.config import TrainConfig

    return TrainConfig(d_sgd_momentum=0.9 if method == "sgd_momentum" else 0.0)


def _copies(tensors):
    return [t.clone() for t in tensors]


def _state_copy(state):
    return {k: _copies(v) if isinstance(v, list) else v.clone() for k, v in state.items()}


def _state_list(state):
    from facegen_torch.ops.fused_update import _state_tensors

    return _state_tensors(state)


PREP_ARGS = dict(sign_coef=1e-3, linear_coef=1e-4, clamp=0.02, sums=True, count=True)


@pytest.mark.cuda
@pytest.mark.parametrize("net,method", [(n, "adam") for n in FUSED_NETS]
                         + [("D32b", m) for m in ("adagrad", "sgd", "sgd_momentum")])
def test_fused_update_kernels_match_their_plain_versions(cuda_device, net, method):
    """prep (penalty gradient, clamp, sums, finite count) and the gated
    update over all of a full-width net's leaves in one launch each,
    against their plain versions on copies of the same card tensors."""
    tx, params, grads, state = _fused_leaves(_fused_shapes(net), method, cuda_device)
    ref_grads, ref_stats = fu.prep_reference(params, _copies(grads), **PREP_ARGS)
    before = (fu.PREP_LAUNCHES, fu.UPDATE_LAUNCHES)
    out_grads, stats = fu.prep(params, grads, **PREP_ARGS)
    assert all(a is b for a, b in zip(out_grads, grads))  # in place
    assert _rel_l2(grads, [g.cpu() for g in ref_grads]) <= UPDATE_TOL
    stats, ref_stats = stats.cpu(), ref_stats.cpu()
    assert torch.allclose(stats[:2], ref_stats[:2], rtol=SUMS_RTOL, atol=0)
    assert stats[2] == ref_stats[2] == 0
    ref_params, ref_state = _copies(params), _state_copy(state)
    gate = torch.ones((), dtype=torch.bool, device=cuda_device)
    fu.update_reference(tx, _copies(grads), ref_state, ref_params, gate)
    fu.update(tx, grads, state, params, gate)
    torch.cuda.synchronize()
    assert (fu.PREP_LAUNCHES, fu.UPDATE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert _rel_l2(params, [p.cpu() for p in ref_params]) <= UPDATE_TOL
    for ours, ref in zip(_state_list(state), _state_list(ref_state)):
        if ours.dtype == torch.int32:
            assert int(ours) == int(ref) == 4
        else:
            assert _rel_l2([ours], [ref.cpu()]) <= UPDATE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["adam", "adagrad", "sgd", "sgd_momentum"])
def test_a_closed_gate_leaves_every_byte(cuda_device, method):
    """A closed device gate: the update kernel writes nothing, Adam's count
    included."""
    tx, params, grads, state = _fused_leaves(_fused_shapes("D32b"), method, cuda_device)
    want_p, want_s = _copies(params), _copies(_state_list(state))
    fu.update(tx, grads, state, params, torch.zeros((), dtype=torch.bool, device=cuda_device))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(params, want_p))
    assert all(torch.equal(a, b) for a, b in zip(_state_list(state), want_s))


@pytest.mark.cuda
def test_two_launches_are_bit_equal(cuda_device):
    """prep's sums (a last-block reduction in block order) and both
    kernels' outputs are the same bits on a second launch on the same
    inputs; the tickets are left at zero."""
    runs = []
    for _ in range(2):
        tx, params, grads, state = _fused_leaves(_fused_shapes("D32b"), "adam", cuda_device)
        _, stats = fu.prep(params, grads, **PREP_ARGS)
        fu.update(tx, grads, state, params, True)
        torch.cuda.synchronize()
        runs.append([stats, *grads, *params, *_state_list(state)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert not fu._TICKETS[cuda_device.index].any()


@pytest.mark.cuda
def test_a_table_longer_than_one_launch(cuda_device):
    """150 leaves of 1 to 5000 entries (and two empty ones): three launches
    of each kernel, the sums added over them, Adam's count advanced once,
    the results as the plain versions'."""
    rs = torch.Generator().manual_seed(3)
    sizes = [int(n) for n in torch.randint(1, 5001, (150,), generator=rs)]
    sizes[5] = sizes[77] = 0
    shapes = [(n,) for n in sizes]
    tx, params, grads, state = _fused_leaves(shapes, "adam", cuda_device, seed=4)
    ref_grads, ref_stats = fu.prep_reference(params, _copies(grads), **PREP_ARGS)
    ref_params, ref_state = _copies(params), _state_copy(state)
    fu.update_reference(tx, _copies(ref_grads), ref_state, ref_params, True)
    assert len(fu.segments(sizes, _build.load("fused_update").facegen_fused_max_segments())) == 3
    before = (fu.PREP_LAUNCHES, fu.UPDATE_LAUNCHES)
    _, stats = fu.prep(params, grads, **PREP_ARGS)
    fu.update(tx, grads, state, params, True)
    torch.cuda.synchronize()
    assert (fu.PREP_LAUNCHES, fu.UPDATE_LAUNCHES) == (before[0] + 3, before[1] + 3)
    assert _rel_l2(grads, [g.cpu() for g in ref_grads]) <= UPDATE_TOL
    assert torch.allclose(stats.cpu()[:2], ref_stats.cpu()[:2], rtol=SUMS_RTOL, atol=0)
    assert _rel_l2(params, [p.cpu() for p in ref_params]) <= UPDATE_TOL
    assert int(state["count"]) == int(ref_state["count"]) == 4
    for kind in ("mu", "nu"):
        assert _rel_l2(state[kind], [t.cpu() for t in ref_state[kind]]) <= UPDATE_TOL
    assert not fu._TICKETS[cuda_device.index].any()


@pytest.mark.cuda
def test_a_captured_penalised_update_replays_as_the_eager_calls(cuda_device):
    """penalised_update (guarded, with D's gate) captured in a CUDA graph
    once and replayed twice from a state equals two eager calls bit for
    bit: the tables, the workspace and the tickets are static, the
    moments and Adam's count written in place."""
    from facegen_torch.train.optim import penalised_update

    def fresh():
        return _fused_leaves(_fused_shapes("D32b"), "adam", cuda_device)

    gate = torch.ones((), dtype=torch.bool, device=cuda_device)
    tx, params, grads, state = fresh()
    eager = []
    for _ in range(2):
        g = _copies(grads)
        pen, applied = penalised_update(tx, g, state, params, 1e-3, 1e-3, 1e-4, 0.02, gate, True)
        eager.append((pen.clone(), applied.clone()))
    tx, params, grads, state = fresh()
    static = _copies(grads)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        pen, applied = penalised_update(tx, _copies(static), state, params, 1e-3, 1e-3, 1e-4,
                                        0.02, gate, True)
    replayed = []
    for _ in range(2):
        graph.replay()
        replayed.append((pen.clone(), applied.clone()))
    torch.cuda.synchronize()
    want_tx, want_params, want_grads, want_state = fresh()
    for _ in range(2):
        penalised_update(want_tx, _copies(want_grads), want_state, want_params, 1e-3, 1e-3,
                         1e-4, 0.02, gate, True)
    assert all(torch.equal(a, b) for a, b in zip(params, want_params))
    assert all(torch.equal(a, b) for a, b in zip(_state_list(state), _state_list(want_state)))
    for (p1, g1), (p2, g2) in zip(replayed, eager):
        assert torch.equal(p1, p2) and torch.equal(g1, g2) and bool(g1)


@pytest.mark.cuda
@pytest.mark.parametrize("nan_leaf", [None, 3], ids=["finite", "nan"])
def test_penalised_update_on_the_card_matches_the_cpu(cuda_device, nan_leaf):
    """The whole tail (G's coefficients with the reference's bug, G's
    clamp, the finite check) on G32's leaves: the card's kernels against
    the CPU's plain composition, within the update's tolerance; a NaN
    gradient closes the gate on both."""
    from facegen_torch.train.optim import penalised_update

    shapes = _fused_shapes("G32")
    runs = []
    for device in ("cpu", cuda_device):
        tx, params, grads, state = _fused_leaves(shapes, "adam", device)
        if nan_leaf is not None:
            grads[nan_leaf].view(-1)[0] = float("nan")
        pen, applied = penalised_update(tx, grads, state, params, 5e-4, 2e-3, 5e-4, 5.0, True,
                                        True)
        runs.append((float(pen), bool(applied), params, state))
    (pen_c, gate_c, p_c, s_c), (pen_g, gate_g, p_g, s_g) = runs
    assert gate_c == gate_g == (nan_leaf is None)
    assert pen_g == pytest.approx(pen_c, rel=SUMS_RTOL)
    assert _rel_l2(p_g, p_c) <= UPDATE_TOL
    assert int(s_g["count"]) == int(s_c["count"])
    for kind in ("mu", "nu"):
        assert _rel_l2(s_g[kind], s_c[kind]) <= UPDATE_TOL


# ------------------------------------------ the batch norm + PReLU kernels
# G32's and G16's batch norms (16x16x256, 32x32x128; 8x8x256, 16x16x128)
BN_LAYERS = [(16, 256), (32, 128), (8, 256), (16, 128)]


def _bn_inputs(n, h, c, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed + n * h + c)
    x = torch.randn(n, h, h, c, generator=g) * 1.5 + torch.rand(c, generator=g) - 0.5
    params = [torch.rand(c, generator=g) + 0.5, torch.rand(c, generator=g) * 0.4 - 0.2,
              torch.rand(1, generator=g) * 0.3 + 0.1, torch.rand(c, generator=g) - 0.5,
              torch.rand(c, generator=g) + 0.5]
    dy = torch.randn(n, h, h, c, generator=g)
    return x.to(device, dtype), dy.to(device, dtype), [p.to(device) for p in params]


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 32, 1024])
@pytest.mark.parametrize("h,c", BN_LAYERS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("training", [True, False])
def test_bn_prelu_kernels_match_the_plain_version(cuda_device, n, h, c, dtype, training):
    """The four kernels (csrc/bn_prelu.cu) against ``forward_reference`` and
    ``backward_reference`` on the same card tensors, at every main-path
    shape: in eval the output bit for bit, and bit for bit against
    BatchNorm then PReLU called as modules; in train the batch's mean and
    rstd and the moved running statistics within 1e-5 relative l2 (fp64
    block merges against torch's reductions), the output within the
    rounding a last-bit change of the statistics can flip; the gradients
    from the kernel's own saved statistics: dx within 2^-7 (bf16) or 1e-4
    (fp32) of its largest entry, the weight's and bias's within 1e-4
    relative l2, the slope's within one bf16 rounding (sums in another
    order). The launches: 2 (train) or 1 (eval) forward, 2 backward."""
    x, dy, (w, b, a, rm, rv) = _bn_inputs(n, h, c, dtype, cuda_device)
    k_rm, k_rv, r_rm, r_rv = rm.clone(), rv.clone(), rm.clone(), rv.clone()
    before = bp.BN_PRELU_LAUNCHES
    y, mean, scale = bp.forward(x, w, b, a, k_rm, k_rv, training, 1e-5, 0.1)
    assert bp.BN_PRELU_LAUNCHES == before + (2 if training else 1)
    ry, rmean, rscale = bp.forward_reference(x, w, b, a, r_rm, r_rv, training, 1e-5, 0.1)
    if training:
        assert _rel(mean, rmean) < 1e-5 and _rel(scale, rscale) < 1e-5
        assert _rel(k_rm, r_rm) < 1e-5 and _rel(k_rv, r_rv) < 1e-5
        # a flipped rounding moves an entry by one unit in the last place
        torch.testing.assert_close(y.float(), ry.float(), atol=TOLS[dtype]["atol"],
                                   rtol=2**-7 if dtype == torch.bfloat16 else 1e-4)
    else:
        from facegen_torch.nn.layers import BatchNorm, PReLU

        bn, pr = BatchNorm(c, device=cuda_device).eval(), PReLU(device=cuda_device)
        with torch.no_grad():
            for t, v in ((bn.weight, w), (bn.bias, b), (pr.weight, a), (bn.running_mean, rm),
                         (bn.running_var, rv)):
                t.copy_(v)
            assert torch.equal(y, ry) and torch.equal(y, pr(bn(x)))
        assert torch.equal(k_rm, rm) and torch.equal(k_rv, rv)
    before = bp.BN_PRELU_LAUNCHES
    got = bp.backward(dy, x, mean, scale, training, 1e-5, w, b, a)
    assert bp.BN_PRELU_LAUNCHES == before + 2
    dx, dw, db, da = got
    rdx, rdw, rdb, rda = bp.backward_reference(dy, x, mean, scale, training, 1e-5, w, b, a)
    dx_tol = 2**-7 if dtype == torch.bfloat16 else 1e-4
    assert float((dx.float() - rdx.float()).abs().max()) <= dx_tol * float(rdx.float().abs().max())
    assert _rel(dw, rdw) < 1e-4 and _rel(db, rdb) < 1e-4
    assert _rel(da, rda) < (2**-7 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", BN_LAYERS[:2])
def test_bn_prelu_replays_give_the_same_bits(cuda_device, h, c):
    """A train-mode forward and backward captured in a CUDA graph: a replay
    equals the eager call bit for bit (statistics, output, gradients,
    running statistics), and two more replays repeat its statistics and
    gradients: the block-order merges use no atomics on the values."""
    x, dy, (w, b, a, rm, rv) = _bn_inputs(32, h, c, torch.bfloat16, cuda_device, seed=5)
    outs = {}

    def body(key):
        y, mean, scale = bp.forward(x, w, b, a, rm, rv, True, 1e-5, 0.1)
        outs[key] = (y, mean, scale) + bp.backward(dy, x, mean, scale, True, 1e-5, w, b, a)

    rm0, rv0 = rm.clone(), rv.clone()
    body("eager")
    eager = [t.clone() for t in outs["eager"]] + [rm.clone(), rv.clone()]
    rm.copy_(rm0)
    rv.copy_(rv0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body("graph")
    rm.copy_(rm0)
    rv.copy_(rv0)
    graph.replay()
    torch.cuda.synchronize()
    first = [t.clone() for t in outs["graph"]] + [rm.clone(), rv.clone()]
    assert all(torch.equal(p, q) for p, q in zip(first, eager))
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(outs["graph"], first[:-2]))


@pytest.mark.cuda
def test_bn_prelu_refuses_what_the_kernels_do_not_take(cuda_device):
    """A channel count that is no divisor of the block or does not fill the
    16-byte loads, an fp16 input, and a per-channel tensor of another
    length raise; nothing falls back."""
    x, _, (w, b, a, rm, rv) = _bn_inputs(2, 4, 24, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="channels"):
        bp.forward(x, w, b, a, rm, rv, True, 1e-5, 0.1)
    x, _, (w, b, a, rm, rv) = _bn_inputs(2, 4, 16, torch.bfloat16, cuda_device)
    with pytest.raises(TypeError, match="activations"):
        bp.forward(x.half(), w, b, a, rm, rv, True, 1e-5, 0.1)
    with pytest.raises(ValueError, match="per-channel"):
        bp.forward(x, w[:8], b, a, rm, rv, True, 1e-5, 0.1)
