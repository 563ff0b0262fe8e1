"""facegen_torch layers and models against facegen's, eval mode.

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


@pytest.mark.parametrize("layer", [
    lambda: L.BatchNorm(4), lambda: L.Dropout(0.5), lambda: L.SpatialDropout(0.2),
    lambda: L.UpsampleConv(8, 8, 5, generator=_gen()),
])
def test_train_mode_raises_instead_of_running_eval(layer):
    m = layer().train()
    with pytest.raises(NotImplementedError, match="train mode"):
        m(torch.zeros(2, 4, 4, 8 if isinstance(m, L.UpsampleConv) else 4))


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
