"""The upsample-conv's gradients in facegen_torch against facegen's.

The plain versions of the dx and dW kernels against facegen's Pallas
kernels (upsample_conv_dx_pallas, upsample_conv_dw_pallas, in interpret
mode) and against the transpose of facegen's XLA phase conv
(jax.linear_transpose of facegen.ops.upsample_conv.upsample_conv), at the
three odd shapes of tests/test_upsample_conv.py:32. Same numpy inputs,
fp32 on the CPU, tolerance 1e-4 relative to each output's largest
magnitude (both sides sum the same products in other orders; a layout or
phase error is O(1) of it). The autograd Function passes torch's
gradcheck in fp64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen.ops import upsample_conv as jax_uc
from facegen.ops.pallas.upsample_conv import (
    space_to_depth as jax_space_to_depth,
    upsample_conv_dw_pallas,
    upsample_conv_dx_pallas,
)
from facegen_torch.nn.layers import UpsampleConv
from facegen_torch.ops import upsample_conv as uc

SHAPES = [(8, 16, 24, 5), (4, 8, 8, 3), (16, 32, 16, 5)]  # tests/test_upsample_conv.py:32
TOL = 1e-4


def _inputs(h, cin, cout, k, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, h, h, cin).astype(np.float32)
    w = (rs.randn(k, k, cin, cout) * 0.1).astype(np.float32)  # HWIO, as facegen
    b = rs.randn(cout).astype(np.float32)
    dy = rs.randn(2, 2 * h, 2 * h, cout).astype(np.float32)
    return x, w, b, dy


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _uncollapse(dwc, kernel):
    """dWc (9*Cin, 4*Cout) -> the HWIO weight gradient, the transpose of
    collapse_weights (facegen/ops/pallas/upsample_conv.py:226-231); the
    port gets it from autograd of the collapse's einsum."""
    cin, cout = dwc.shape[0] // 9, dwc.shape[1] // 4
    c = torch.from_numpy(uc._collapse_matrix(kernel))
    return torch.einsum("aku,blv,uviabo->klio", c, c, dwc.reshape(3, 3, cin, 2, 2, cout))


def _close(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL * np.abs(theirs).max())


def _jax_transpose(x, w, b, dy):
    """(dx, dW) of facegen's XLA phase conv at cotangent dy."""
    _, vjp = jax.vjp(lambda x_, w_: jax_uc.upsample_conv(x_, w_, jnp.asarray(b)),
                     jnp.asarray(x), jnp.asarray(w))
    dx_vjp, dw_vjp = vjp(jnp.asarray(dy))
    dx_t = jax.linear_transpose(
        lambda x_: jax_uc.upsample_conv(x_, jnp.asarray(w), jnp.zeros_like(jnp.asarray(b))),
        jnp.asarray(x))(jnp.asarray(dy))[0]
    np.testing.assert_allclose(np.asarray(dx_t), np.asarray(dx_vjp), rtol=1e-5, atol=1e-5)
    return dx_t, dw_vjp


@pytest.mark.parametrize("h,cin,cout,k", SHAPES)
def test_dx_plain_version_matches_pallas_and_the_transpose(h, cin, cout, k):
    x, w, b, dy = _inputs(h, cin, cout, k)
    ours = uc.upsample_conv_dx(torch.from_numpy(dy), uc.collapse_weights(_oihw(w))).numpy()
    _close(ours, upsample_conv_dx_pallas(jnp.asarray(dy), jnp.asarray(w), interpret=True))
    _close(ours, _jax_transpose(x, w, b, dy)[0])


@pytest.mark.parametrize("h,cin,cout,k", SHAPES)
def test_dw_plain_version_matches_pallas_and_the_transpose(h, cin, cout, k):
    x, w, b, dy = _inputs(h, cin, cout, k)
    dwc = uc.upsample_conv_dw(torch.from_numpy(x), torch.from_numpy(dy))
    assert dwc.dtype == torch.float32 and tuple(dwc.shape) == (9 * cin, 4 * cout)
    ours = _uncollapse(dwc, k).numpy()
    _close(ours, upsample_conv_dw_pallas(jnp.asarray(x), jnp.asarray(dy), kernel=k,
                                         interpret=True))
    _close(ours, _jax_transpose(x, w, b, dy)[1])


def test_space_to_depth_matches_jax_and_inverts_depth_to_space():
    y = np.random.RandomState(1).randn(2, 6, 10, 5).astype(np.float32)
    ours = uc.space_to_depth(torch.from_numpy(y))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_space_to_depth(jnp.asarray(y))))
    assert torch.equal(uc.depth_to_space(ours), torch.from_numpy(y))


def test_function_passes_gradcheck_in_fp64():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 4, 8, generator=g, dtype=torch.float64, requires_grad=True)
    wc = uc.collapse_weights(torch.randn(8, 8, 5, 5, generator=g, dtype=torch.float64) * 0.1)
    wc = wc.detach().requires_grad_()
    b = torch.randn(8, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(uc.UpsampleConvFunction.apply, (x, wc, b))


@pytest.mark.parametrize("h,cin,cout,k", SHAPES)
def test_an_empty_batch_gives_empty_outputs_and_zero_weight_gradients(h, cin, cout, k):
    """N = 0 (a data row of a 2-D mesh that holds none of a batch's rows):
    the plain versions give an empty forward and dx, and zero dWc and db."""
    _, w, b, _ = _inputs(h, cin, cout, k)
    x = torch.zeros(0, h, h, cin, requires_grad=True)
    wc = uc.collapse_weights(_oihw(w)).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = uc.UpsampleConvFunction.apply(x, wc, bt)
    assert tuple(y.shape) == (0, 2 * h, 2 * h, cout)
    y.backward(torch.zeros_like(y))
    assert tuple(x.grad.shape) == (0, h, h, cin)
    assert wc.grad.abs().max() == 0 and bt.grad.abs().max() == 0
    dy = torch.zeros(0, 2 * h, 2 * h, cout)
    assert tuple(uc.upsample_conv_dx(dy, wc.detach()).shape) == (0, h, h, cin)


def test_function_skips_dx_when_the_input_needs_no_gradient(monkeypatch):
    calls = []
    monkeypatch.setattr(uc, "upsample_conv_dx", lambda *a: calls.append(a))
    x, w, b, dy = _inputs(4, 8, 8, 5)
    wc = uc.collapse_weights(_oihw(w)).requires_grad_()
    y = uc.UpsampleConvFunction.apply(torch.from_numpy(x), wc, torch.from_numpy(b))
    y.backward(torch.from_numpy(dy))
    assert calls == [] and wc.grad is not None


@pytest.mark.parametrize("h,cin,cout,k", SHAPES)
def test_layer_trains_through_the_function_like_facegen(h, cin, cout, k):
    """UpsampleConv's parameter and input gradients (the collapse's
    einsum un-collapses dWc under autograd; db is the port's own sum)
    against jax.grad of facegen's op."""
    x, w, b, dy = _inputs(h, cin, cout, k, seed=3)
    layer = UpsampleConv(cin, cout, k, generator=torch.Generator().manual_seed(0)).train()
    with torch.no_grad():
        layer.weight.copy_(_oihw(w))
        layer.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_()
    (layer(xt) * torch.from_numpy(dy)).sum().backward()

    def loss(x_, w_, b_):
        return jnp.sum(jax_uc.upsample_conv(x_, w_, b_) * jnp.asarray(dy))

    gx, gw, gb = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                                    jnp.asarray(b))
    _close(xt.grad.numpy(), gx)
    _close(layer.weight.grad.numpy().transpose(2, 3, 1, 0), gw)
    _close(layer.bias.grad.numpy(), gb)


def test_cpu_tensors_take_the_plain_paths_and_count_no_launch():
    x, w, b, dy = _inputs(4, 8, 8, 5)
    wc = uc.collapse_weights(_oihw(w))
    before = (uc.DX_LAUNCHES, uc.DW_LAUNCHES)
    dx = uc.upsample_conv_dx(torch.from_numpy(dy), wc)
    dwc = uc.upsample_conv_dw(torch.from_numpy(x), torch.from_numpy(dy))
    assert (uc.DX_LAUNCHES, uc.DW_LAUNCHES) == before
    assert torch.equal(dx, uc.upsample_conv_dx_reference(torch.from_numpy(dy), wc))
    assert torch.equal(dwc, uc.upsample_conv_dw_reference(torch.from_numpy(x),
                                                          torch.from_numpy(dy)))


def test_other_devices_raise_instead_of_falling_back():
    dy = torch.empty(2, 8, 8, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        uc.upsample_conv_dx(dy, torch.empty(72, 32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        uc.upsample_conv_dw(torch.empty(2, 4, 4, 8, device="meta"), dy)


@pytest.mark.parametrize("case", ["dtype", "cin", "cout", "wc_shape", "dy_shape", "contiguous"])
def test_backward_wrappers_reject_what_the_kernels_do_not_take(case):
    x, dy, wc = torch.zeros(2, 4, 4, 16), torch.zeros(2, 8, 8, 8), torch.zeros(9 * 16, 4 * 8)
    which = "dw"
    if case == "dtype":
        x, dy = x.double(), dy.double()
    elif case == "cin":
        x = torch.zeros(2, 4, 4, 12)
    elif case == "cout":
        which, dy, wc = "dx", torch.zeros(2, 8, 8, 6), torch.zeros(9 * 16, 4 * 6)
    elif case == "wc_shape":
        which, wc = "dx", torch.zeros(9 * 16, 4 * 16)
    elif case == "dy_shape":
        dy = torch.zeros(2, 6, 8, 8)
    elif case == "contiguous":
        x = torch.zeros(2, 16, 4, 4).permute(0, 2, 3, 1)
    with pytest.raises((ValueError, TypeError)):
        uc._check_bwd(which, *((dy, wc) if which == "dx" else (x, dy)))
    uc._check_bwd("dx", torch.zeros(2, 8, 8, 8), torch.zeros(9 * 16, 4 * 8))
    uc._check_bwd("dw", torch.zeros(2, 4, 4, 16), torch.zeros(2, 8, 8, 8))
