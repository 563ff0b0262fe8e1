"""facegen_torch.ops.upsample_conv against facegen's JAX op and its
Pallas kernel (in interpret mode), and the CUDA kernel's wrapper.

Same numpy inputs into both packages, fp32 on the CPU. Tolerance 2e-4
(rtol and atol): both sides sum the same 9*Cin products in fp32 in
different orders, which measures at ~1e-5 here; 2e-4 still fails on any
layout or phase-order mistake, whose errors are O(1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facegen.ops import upsample_conv as jax_uc
from facegen.ops.pallas.upsample_conv import upsample_conv_pallas
from facegen_torch.nn.layers import UpsampleConv
from facegen_torch.ops import _build
from facegen_torch.ops import upsample_conv as uc

TOL = 2e-4
SHAPES = [(8, 16, 24, 5), (4, 8, 8, 3), (16, 32, 16, 5)]  # tests/test_upsample_conv.py:32


def _inputs(h, cin, cout, k, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, h, h, cin).astype(np.float32)
    w = (rs.randn(k, k, cin, cout) * 0.1).astype(np.float32)  # HWIO, as facegen
    b = rs.randn(cout).astype(np.float32)
    return x, w, b


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("h,cin,cout,k", SHAPES)
def test_collapse_weights_matches_jax(h, cin, cout, k):
    _, w, _ = _inputs(h, cin, cout, k)
    ours = uc.collapse_weights(_oihw(w)).numpy()
    theirs = np.asarray(jax_uc.collapse_weights(jnp.asarray(w)))  # (3, 3, Cin, 4*Cout)
    np.testing.assert_allclose(ours, theirs.reshape(9 * cin, 4 * cout), rtol=TOL, atol=TOL)


def test_depth_to_space_matches_jax():
    y = np.random.RandomState(1).randn(2, 3, 5, 4 * 6).astype(np.float32)
    ours = uc.depth_to_space(torch.from_numpy(y)).numpy()
    # a pure permutation: exact
    np.testing.assert_array_equal(ours, np.asarray(jax_uc.depth_to_space(jnp.asarray(y))))


def test_depth_to_space_phase_order():
    # phase block a*2+b lands at output pixel (2i+a, 2j+b)
    y = torch.zeros(1, 2, 2, 4)
    y[0, 0, 0] = torch.tensor([1.0, 2.0, 3.0, 4.0])
    out = uc.depth_to_space(y)[0, :2, :2, 0]
    assert out.tolist() == [[1.0, 2.0], [3.0, 4.0]]


@pytest.mark.parametrize("h,cin,cout,k", SHAPES)
def test_reference_matches_jax_phase_conv_and_pallas(h, cin, cout, k):
    x, w, b = _inputs(h, cin, cout, k)
    ours = uc.upsample_conv_reference(
        torch.from_numpy(x), uc.collapse_weights(_oihw(w)), torch.from_numpy(b)).numpy()
    xla = np.asarray(jax_uc.upsample_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    pallas = np.asarray(upsample_conv_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    assert ours.shape == (2, 2 * h, 2 * h, cout)
    np.testing.assert_allclose(ours, xla, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours, pallas, rtol=TOL, atol=TOL)


def test_cpu_tensor_takes_the_plain_path():
    x, w, b = _inputs(4, 8, 8, 5)
    args = (torch.from_numpy(x), uc.collapse_weights(_oihw(w)), torch.from_numpy(b))
    before = uc.KERNEL_LAUNCHES
    got = uc.upsample_conv(*args)
    assert uc.KERNEL_LAUNCHES == before
    torch.testing.assert_close(got, uc.upsample_conv_reference(*args), rtol=0, atol=0)


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(2, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        uc.upsample_conv(x, torch.empty(72, 32, device="meta"), torch.empty(8, device="meta"))


def test_layer_caches_the_collapsed_weight_until_the_weight_changes():
    """The collapsed weight is computed on every call, so it follows every
    in-place write to the weight (an optimizer step, a load, a graph
    replay) at once."""
    layer = UpsampleConv(8, 8, 5, generator=torch.Generator().manual_seed(0)).eval()
    wc = layer.collapsed_weight(torch.float32)
    assert torch.equal(layer.collapsed_weight(torch.float32), wc)
    with torch.no_grad():
        layer.weight.mul_(2.0)
    wc2 = layer.collapsed_weight(torch.float32)
    assert wc2 is not wc
    torch.testing.assert_close(wc2, 2.0 * wc)
    x = torch.randn(2, 4, 4, 8, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(layer(x), uc.upsample_conv_reference(x, wc2, layer.bias))


@pytest.mark.parametrize("kernel", [1, 4, 7])
def test_kernels_without_the_3x3_collapse_are_rejected(kernel):
    with pytest.raises(ValueError):
        UpsampleConv(8, 8, kernel, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("case", ["dtype", "cin", "cout", "wc_shape", "contiguous", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros(2, 4, 4, 16)
    wc = torch.zeros(9 * 16, 4 * 8)
    b = torch.zeros(8)
    if case == "dtype":
        x, wc, b = x.half(), wc.half(), b.half()
    elif case == "cin":
        x, wc = torch.zeros(2, 4, 4, 12), torch.zeros(9 * 12, 4 * 8)
    elif case == "cout":
        wc, b = torch.zeros(9 * 16, 4 * 6), torch.zeros(6)
    elif case == "wc_shape":
        wc = torch.zeros(4 * 8, 9 * 16)
    elif case == "contiguous":
        x = torch.zeros(2, 16, 4, 4).permute(0, 2, 3, 1)
    elif case == "rank":
        x = torch.zeros(2, 4, 16)
    with pytest.raises((ValueError, TypeError)):
        uc._check(x, wc, b)
    uc._check(torch.zeros(2, 4, 4, 16), torch.zeros(9 * 16, 4 * 8), torch.zeros(8))


def test_build_raises_where_nvcc_is_missing(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("upsample_conv")
    assert not (tmp_path / "build").exists()


def test_build_digest_covers_the_headers(tmp_path, monkeypatch):
    """A source's library path changes when a csrc/*.cuh header changes,
    so an edited header never loads a stale library (no nvcc needed)."""
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = _build._paths("k")[1]
    assert _build._paths("k")[1] == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = _build._paths("k")[1]
    assert second != first and second.parent == tmp_path / "build"
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _build._paths("k")[1] not in (first, second)
