"""facegen_torch layers and models against facegen's, in eval and train mode.

The JAX modules are initialised, their params carried into the port with
``jax_to_torch`` (the checkpoint converter), and both run the same numpy
inputs in fp32 on the CPU. Tolerance 2e-4 (rtol and atol): the fp32
drift of the phase conv's reassociation measured in
tests/test_torch_parity.py:8-14 is ~1e-5; a layout error is O(1e-2) or
more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facegen.models import gan as jax_gan
from facegen.nn import Ctx, init as jax_init, layers as JL, sequential as jax_sequential
from facegen.nn.core import param_count
from facegen.utils.checkpoint import flatten_tree
from facegen_torch.models import gan
from facegen_torch.nn import dropout
from facegen_torch.nn import init as winit
from facegen_torch.nn import layers as L
from facegen_torch.utils.checkpoint import jax_to_torch

TOL = 2e-4


def _perturb_bn(state):
    """Non-trivial running statistics, as a trained net has."""
    return jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.05 if str(p[-1].key) == "mean" else a * 1.7, state)


def _scale_weights(params, factor=3.0):
    """Larger weights than the init's, so outputs differ per input and a
    wrong layout cannot hide under the sigmoid's flat 0.5."""
    return jax.tree_util.tree_map_with_path(
        lambda p, a: a * factor if str(p[-1].key) == "w" else a, params)


def _carry(params, state):
    """JAX params/state -> the port's state_dict via the checkpoint converter."""
    return jax_to_torch(flatten_tree({"params_g": params, "state_g": state}))["g"]


def _run_jax(module, params, state, x):
    y, _ = module.apply(params, state, jnp.asarray(x), Ctx(None, False))
    return np.asarray(y)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# (name, JAX layer, port layer factory, per-example input shape)
LAYER_CASES = [
    ("dense", JL.dense(24, name="fc"), lambda: L.Dense(40, 24, generator=_gen()), (40,)),
    ("conv3", JL.conv2d(16, 3, name="conv"),
     lambda: L.Conv2d(8, 16, 3, generator=_gen()), (6, 6, 8)),
    ("conv5_stride2", JL.conv2d(16, 5, stride=2, name="conv"),
     lambda: L.Conv2d(8, 16, 5, stride=2, generator=_gen()), (7, 7, 8)),
    ("upconv5", JL.upsample_conv(16, 5, name="upconv"),
     lambda: L.UpsampleConv(8, 16, 5, generator=_gen()), (4, 4, 8)),
    ("upconv3", JL.upsample_conv(8, 3, name="upconv"),
     lambda: L.UpsampleConv(16, 8, 3, generator=_gen()), (5, 5, 16)),
    ("prelu", JL.prelu(), lambda: L.PReLU(), (5, 5, 8)),
    ("batch_norm", JL.batch_norm(), lambda: L.BatchNorm(8), (5, 5, 8)),
    ("avg_pool", JL.avg_pool(2), lambda: L.AvgPool(2), (6, 6, 8)),
    ("flatten", JL.flatten(), lambda: L.Flatten(), (3, 4, 5)),
    ("reshape", JL.reshape((2, 3, 4)), lambda: L.Reshape((2, 3, 4)), (24,)),
    ("sigmoid", JL.sigmoid(), lambda: L.Sigmoid(), (5, 5, 8)),
    ("dropout", JL.dropout(0.5), lambda: L.Dropout(0.5), (5, 5, 8)),
    ("spatial_dropout", JL.spatial_dropout(0.2), lambda: L.SpatialDropout(0.2), (5, 5, 8)),
]


@pytest.mark.parametrize("name,jax_layer,make", [c[:3] for c in LAYER_CASES],
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_jax(name, jax_layer, make):
    in_shape = dict((c[0], c[3]) for c in LAYER_CASES)[name]
    jm = jax_sequential(jax_layer)
    params, state, _ = jm.init(jax.random.key(0), in_shape)
    # random slopes / gammas, so a transposed or misnamed leaf shows
    params = jax_init.gaussian_overwrite(params, jax.random.key(1), w_std=0.5, b_std=0.3)
    state = _perturb_bn(state)
    port = L.sequential((jax_layer.name, make())).eval()
    port.load_state_dict(_carry(params, state), strict=True)
    x = np.random.RandomState(2).randn(3, *in_shape).astype(np.float32)
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, _run_jax(jm, params, state, x), rtol=TOL, atol=TOL)


# (name, JAX layer, port layer, per-example input shape) in train mode
TRAIN_CASES = [
    ("batch_norm", JL.batch_norm(), lambda: L.BatchNorm(8), (5, 5, 8)),
    ("dropout", JL.dropout(0.5), lambda: L.Dropout(0.5), (40,)),
    ("spatial_dropout", JL.spatial_dropout(0.2), lambda: L.SpatialDropout(0.2), (5, 5, 8)),
    ("upconv5", JL.upsample_conv(16, 5, name="upconv"),
     lambda: L.UpsampleConv(8, 16, 5, generator=_gen()), (4, 4, 8)),
]


@pytest.mark.parametrize("name,jax_layer,make", [c[:3] for c in TRAIN_CASES],
                         ids=[c[0] for c in TRAIN_CASES])
def test_train_mode_matches_jax(name, jax_layer, make):
    """Train mode: batch norm from the batch's statistics, with the running
    update (momentum 0.1, unbiased variance); dropout with facegen's own
    mask draw (the key folded with the layer's index) injected into the
    port; the upsample-conv through its autograd Function."""
    in_shape = dict((c[0], c[3]) for c in TRAIN_CASES)[name]
    jm = jax_sequential(jax_layer)
    params, state, _ = jm.init(jax.random.key(0), in_shape)
    params = jax_init.gaussian_overwrite(params, jax.random.key(1), w_std=0.5, b_std=0.3)
    state = _perturb_bn(state)
    x = np.random.RandomState(2).randn(3, *in_shape).astype(np.float32) + 0.5
    key = jax.random.key(4)
    theirs, new_state = jm.apply(params, state, jnp.asarray(x), Ctx(key, True))
    port = L.sequential((jax_layer.name, make())).train()
    port.load_state_dict(_carry(params, state), strict=True)
    drops = dropout.dropout_layers(port)
    if drops:
        (layer_name, layer), = drops.items()
        keep = 1.0 - layer.rate
        shape = layer.mask_shape(x.shape)
        mask = jax.random.bernoulli(jax.random.fold_in(key, 0), keep, shape)
        dropout.set_dropout_masks(port, {layer_name: torch.from_numpy(np.array(mask))})
    xt = torch.from_numpy(x).requires_grad_()
    ours = port(xt)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=TOL, atol=TOL)
    for key_, t in _carry(params, new_state).items():  # running statistics after the step
        np.testing.assert_allclose(port.state_dict()[key_].numpy(), t.numpy(),
                                   rtol=TOL, atol=TOL, err_msg=key_)
    if drops:
        assert layer.mask is None  # an injected mask is used once
    ours.sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()


@pytest.mark.parametrize("layer", [L.Dropout(0.5), L.SpatialDropout(0.2)],
                         ids=["dropout", "spatial_dropout"])
def test_dropout_without_a_mask_draws_from_its_generator(layer):
    x = torch.ones(64, 3, 3, 16)
    layer.train()
    outs = []
    for _ in range(2):
        layer.generator = torch.Generator().manual_seed(3)
        outs.append(layer(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    kept = outs[0] != 0
    assert torch.equal(outs[0][kept], torch.full_like(outs[0][kept], 1 / (1 - layer.rate)))
    assert abs(float(kept.float().mean()) - (1 - layer.rate)) < 0.05
    if isinstance(layer, L.SpatialDropout):  # whole channels
        assert torch.equal(kept, kept[:, :1, :1, :].expand_as(kept))
    assert torch.equal(layer.eval()(x), x)


@pytest.mark.parametrize("scale,channels,noise_view", [
    (16, 1, "nhwc"), (16, 1, "nchw"), (32, 3, "nhwc"), (32, 3, "nchw"),
])
def test_g_matches_jax(scale, channels, noise_view):
    noise_dim = 16
    jg = jax_gan.create_g(scale, channels, noise_dim, noise_view=noise_view)
    params, state, _ = jg.init(jax.random.key(scale), (noise_dim,))
    params, state = _scale_weights(params), _perturb_bn(state)
    g = gan.create_g(scale, channels, noise_dim, noise_view=noise_view, generator=_gen())
    g.load_state_dict(_carry(params, state), strict=True)
    z = np.random.RandomState(3).uniform(-1, 1, (4, noise_dim)).astype(np.float32)
    with torch.no_grad():
        ours = g(torch.from_numpy(z)).numpy()
    theirs = _run_jax(jg, params, state, z)
    assert ours.shape == (4, scale, scale, channels)
    assert theirs.std() > 1e-2
    np.testing.assert_allclose(ours, theirs, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("scale,channels", [(32, 3), (16, 1)])  # D32b, D16_d
def test_d_matches_jax(scale, channels):
    jd = jax_gan.create_d(scale, channels)
    params, state, _ = jd.init(jax.random.key(5), (scale, scale, channels))
    params = _scale_weights(params)
    d = gan.create_d(scale, channels, generator=_gen())
    d.load_state_dict(_carry(params, state), strict=True)
    x = np.random.RandomState(4).uniform(0, 1, (4, scale, scale, channels)).astype(np.float32)
    with torch.no_grad():
        ours = d(torch.from_numpy(x)).numpy()
    theirs = _run_jax(jd, params, state, x)
    assert ours.shape == (4, 1) and theirs.std() > 1e-3
    np.testing.assert_allclose(ours, theirs, rtol=TOL, atol=TOL)


# the reference's unused variants: (name, facegen factory, port factory, scale, channels)
VARIANT_CASES = [
    ("d16", jax_gan.create_d16, gan.create_d16, 16, 3),
    ("d16_b", jax_gan.create_d16_b, gan.create_d16_b, 16, 1),
    ("d16_c", jax_gan.create_d16_c, gan.create_d16_c, 16, 3),
    ("d32", jax_gan.create_d32, gan.create_d32, 32, 1),
    ("g_flat", lambda s, c: jax_gan.create_g_flat(s, c, 8),
     lambda s, c, **kw: gan.create_g_flat(s, c, 8, **kw), 16, 3),
]


@pytest.mark.parametrize("name,jax_create,create,scale,channels", VARIANT_CASES,
                         ids=[c[0] for c in VARIANT_CASES])
def test_unused_variant_matches_jax(name, jax_create, create, scale, channels):
    """Eval-mode forward and parameter count of each variant no CLI reaches."""
    in_shape = (8,) if name == "g_flat" else (scale, scale, channels)
    jm = jax_create(scale, channels)
    params, state, _ = jm.init(jax.random.key(6), in_shape)
    params = _scale_weights(params)
    port = create(scale, channels, generator=_gen())
    port.load_state_dict(_carry(params, state), strict=True)
    x = np.random.RandomState(7).uniform(-1, 1, (3,) + in_shape).astype(np.float32)
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    theirs = _run_jax(jm, params, state, x)
    assert ours.shape == ((3, scale, scale, channels) if name == "g_flat" else (3, 1))
    assert theirs.std() > 1e-3
    np.testing.assert_allclose(ours, theirs, rtol=TOL, atol=TOL)
    assert sum(p.numel() for p in port.parameters()) == param_count(params)


@pytest.mark.parametrize("scale,channels", [(32, 1), (32, 3), (16, 1)])
def test_param_counts_match_jax(scale, channels):
    jg, jd, bundle = jax_gan.init_gan(jax.random.key(0), scale, channels, 100)
    g, d = gan.init_gan(_gen(), scale, channels, 100)
    assert sum(p.numel() for p in g.parameters()) == param_count(bundle["params_g"])
    assert sum(p.numel() for p in d.parameters()) == param_count(bundle["params_d"])
    if (scale, channels) == (32, 1):  # docs/PARITY.md row 5
        assert param_count(bundle["params_g"]) == 2_468_100
        assert param_count(bundle["params_d"]) == 2_862_087


@pytest.mark.parametrize("scheme", sorted(winit.SCHEMES))
def test_init_schemes_match_jax(scheme):
    for fan_in, fan_out in [(100, 8192), (3200, 6400), (1152, 27)]:
        assert winit.SCHEMES[scheme](fan_in, fan_out) == jax_init.SCHEMES[scheme](fan_in, fan_out)


def test_scheme_init_bounds_and_zero_biases():
    g, d = gan.init_gan(_gen(), 32, 3, 100, reference_init=False)
    bound = winit.heuristic(128 * 25, 256 * 25)
    w = g.get_submodule("03_upconv1").weight.detach()
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert all(float(p.detach().abs().max()) == 0
               for n, p in g.named_parameters() if n.endswith("bias"))
    # D keeps torch's reset: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), biases too
    b = d.get_submodule("00_conv64").bias.detach()
    assert 0 < float(b.abs().max()) <= 1 / np.sqrt(3 * 9)


@torch.no_grad()
def test_gaussian_overwrite_hits_slopes_and_gammas():
    g, d = gan.init_gan(_gen(), 32, 3, 100, reference_init=True)
    w = g.get_submodule("06_upconv2").weight
    assert abs(float(w.std()) - 0.005) < 2e-4
    assert abs(float(g.get_submodule("00_fc").bias.std()) - 0.001) < 1e-4
    # the reference's quirk: PReLU slopes and BN gammas are N(0, 0.005^2) too
    assert float(g.get_submodule("04_batch_norm").weight.abs().max()) < 0.05
    assert float(g.get_submodule("02_prelu").weight.abs().max()) < 0.05
    assert float(d.get_submodule("23_fc_out").weight.abs().max()) < 0.05
    # buffers are not parameters: running statistics keep their init
    assert float(g.get_submodule("04_batch_norm").running_var.min()) == 1.0
