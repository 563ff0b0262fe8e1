"""The port's CUDA kernel on the card. Every test here needs a CUDA GPU
and skips without one: a CUDA kernel has no CPU or interpret mode. The
file imports neither JAX nor facegen, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

(--noconftest: tests/conftest.py sets JAX up for the JAX package's tests.)

Tolerances: fp32, 1e-4 (rtol and atol), both sides accumulating in fp32
with TF32 off; bf16, 2e-2 absolute plus 2^-8 relative, the same bf16
inputs with fp32 accumulation and then the output's bf16 rounding.
"""

import pytest
import torch

from facegen_torch.models import gan
from facegen_torch.ops import upsample_conv as uc
from facegen_torch.utils.infer import GanInference

SHAPES = [(8, 16, 24, 5), (4, 8, 8, 3), (16, 32, 16, 5)]  # tests/test_upsample_conv.py:32
TOLS = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=2**-8, atol=2e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout,k", [(n,) + s for s in SHAPES for n in (2, 3)]
                         + [(5, 8, 128, 256, 5), (3, 16, 256, 128, 5)])
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
