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
terms, not with the entry they land in.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from facegen_torch.models import gan
from facegen_torch.ops import _build
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
    before = uc.KERNEL_LAUNCHES
    for dtype in (torch.float32, torch.bfloat16):
        ours = GanInference(g_gpu, d_gpu, 100, compute_dtype=dtype).generate(noise)
        ref = GanInference(g_cpu, d_cpu, 100, compute_dtype=torch.float32).generate(noise)
        # images in [0, 1] after the sigmoid; fp32 drift ~1e-6, bf16 ~1e-3
        torch.testing.assert_close(ours.cpu(), ref, rtol=0,
                                   atol=1e-4 if dtype == torch.float32 else 3e-2)
    assert uc.KERNEL_LAUNCHES == before + 4  # two upsample-convs per G call


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
    kernel, finite gradients for every G parameter."""
    g, d = gan.init_gan(torch.Generator().manual_seed(0), 32, 3, 100, device=cuda_device)
    g.train()
    noise = torch.rand(32, 100, device=cuda_device) * 2 - 1
    before = (uc.KERNEL_LAUNCHES, uc.DX_LAUNCHES, uc.DW_LAUNCHES)
    d(g(noise.bfloat16())).float().sum().backward()
    torch.cuda.synchronize()
    assert (uc.KERNEL_LAUNCHES, uc.DX_LAUNCHES, uc.DW_LAUNCHES) == tuple(b + 2 for b in before)
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


def _gan_step(device, cfg, seed=5):
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
    return init_state(cfg, g, d), TrainStep(cfg, g, d)


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
    counts = lambda: (uc.KERNEL_LAUNCHES, uc.DX_LAUNCHES, uc.DW_LAUNCHES)  # noqa: E731
    before = counts()
    _eager_steps(state, step, pool, torch.Generator(cuda_device).manual_seed(1), 1)
    per_step = tuple(b - a for a, b in zip(before, counts()))
    assert per_step == (4, 2, 2)
    runner = GraphedStep(step, state, pool.shape[0])
    runner.set_pool(pool)
    before = counts()
    runner.run(torch.Generator(cuda_device).manual_seed(2), 5)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, counts())) == tuple(5 * n for n in per_step)
    assert runner.launches_per_replay == dict(zip(("KERNEL_LAUNCHES", "DX_LAUNCHES",
                                                   "DW_LAUNCHES"), per_step))
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
