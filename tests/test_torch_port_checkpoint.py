"""Checkpoints cross between facegen and facegen_torch bit for bit.

A JAX ``ckpt.save`` of a full training GanState loads into the port,
and a port-written checkpoint loads strictly through facegen's
restore_gan. The conversions are transposes and renames of fp32
arrays, so both directions are compared with exact equality.
"""

import os

import jax
import numpy as np
import pytest
import torch

import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)
from facegen.config import TrainConfig
from facegen.models import gan as jax_gan
from facegen.train.step import init_state
from facegen.utils import checkpoint as jax_ckpt
from facegen_torch.models import gan
from facegen_torch.utils import checkpoint as ckpt


def _jax_checkpoint(tmp_path, scale, grayscale, noise_dim, noise_view="nhwc"):
    cfg = TrainConfig(batch_size=8, scale=scale, grayscale=grayscale, noise_dim=noise_dim,
                      save=str(tmp_path), noise_view=noise_view).validate()
    _, _, bundle = jax_gan.init_gan(jax.random.key(3), scale, cfg.channels, noise_dim,
                                    reference_init=False, noise_view=noise_view)
    # non-trivial running statistics
    bundle["state_g"] = jax.tree.map(lambda a: a * 1.5 + 0.1, bundle["state_g"])
    state = init_state(cfg, bundle)
    jax_ckpt.save(str(tmp_path), "adversarial", state,
                  meta={**jax_ckpt.config_meta(cfg), "epoch": 3})
    return jax_ckpt.flatten_tree(bundle)


@pytest.mark.parametrize("scale,grayscale,noise_view", [
    (32, False, "nhwc"), (16, True, "nchw"),
])
def test_jax_checkpoint_loads_into_port_bit_for_bit(tmp_path, scale, grayscale, noise_view):
    leaves = _jax_checkpoint(tmp_path, scale, grayscale, 20, noise_view)
    g, d, res = gan.restore_gan("adversarial", default_dir=str(tmp_path))
    assert res == {"scale": scale, "grayscale": grayscale, "noise_dim": 20,
                   "channels": 1 if grayscale else 3, "noise_view": noise_view}
    back = ckpt.torch_to_jax({"g": g.state_dict(), "d": d.state_dict()})
    # every G/D leaf of the GanState, and nothing else (opt_*, accs, ...)
    assert set(back) == set(leaves)
    for key, arr in leaves.items():
        assert back[key].dtype == arr.dtype and np.array_equal(back[key], arr), key
    # layouts: HWIO -> OIHW conv, (in, out) -> (out, in) dense
    np.testing.assert_array_equal(
        g.get_submodule("03_upconv1").weight.detach().numpy(),
        leaves["params_g/03_upconv1/w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        g.get_submodule("00_fc").weight.detach().numpy(), leaves["params_g/00_fc/w"].T)


@pytest.mark.parametrize("scale,grayscale", [(32, False), (16, True)])
def test_port_checkpoint_loads_strictly_through_jax_restore(tmp_path, scale, grayscale):
    channels = 1 if grayscale else 3
    g, d = gan.init_gan(torch.Generator().manual_seed(4), scale, channels, 20)
    config = {"scale": scale, "grayscale": grayscale, "noise_dim": 20, "noise_view": "nhwc"}
    ckpt.save_gan(str(tmp_path), "adversarial", g, d, config)
    _, _, bundle, meta, res = jax_gan.restore_gan("adversarial", default_dir=str(tmp_path))
    assert res["scale"] == scale and res["grayscale"] == grayscale and res["noise_dim"] == 20
    assert meta["version"] == jax_ckpt.FORMAT_VERSION
    ours = ckpt.torch_to_jax({"g": g.state_dict(), "d": d.state_dict()})
    theirs = jax_ckpt.flatten_tree(bundle)
    assert set(ours) == set(theirs)
    for key in theirs:
        assert np.array_equal(np.asarray(theirs[key]), ours[key]), key


def test_conversion_round_trips_nested_d16_keys():
    g, d = gan.init_gan(torch.Generator().manual_seed(5), 16, 1, 8)
    sds = {"g": g.state_dict(), "d": d.state_dict()}
    arrays = ckpt.torch_to_jax(sds)
    assert "params_d/00_branches/00_conv_branch/07_conv4/w" in arrays
    assert "state_g/04_batch_norm/var" in arrays and "params_g/02_prelu/a" in arrays
    back = ckpt.jax_to_torch(arrays)
    for net in ("g", "d"):
        assert back[net].keys() == sds[net].keys()
        for k, t in sds[net].items():
            assert torch.equal(back[net][k], t), k


def test_save_rotates_the_previous_checkpoint(tmp_path):
    g, d = gan.init_gan(torch.Generator().manual_seed(6), 16, 1, 8)
    config = {"scale": 16, "grayscale": True, "noise_dim": 8, "noise_view": "nhwc"}
    ckpt.save_gan(str(tmp_path), "net", g, d, config)
    first = ckpt.load(str(tmp_path), "net")[0]
    with torch.no_grad():
        g.get_submodule("00_fc").weight.add_(1.0)
    ckpt.save_gan(str(tmp_path), "net", g, d, config)
    old = ckpt.load(str(tmp_path), "net.old")[0]
    new = ckpt.load(str(tmp_path), "net")[0]
    assert np.array_equal(old["params_g/00_fc/w"], first["params_g/00_fc/w"])
    assert np.array_equal(new["params_g/00_fc/w"], first["params_g/00_fc/w"] + 1.0)
    assert not os.path.exists(os.path.join(str(tmp_path), "net.tmp"))


def test_restore_rejects_contradicting_overrides(tmp_path):
    g, d = gan.init_gan(torch.Generator().manual_seed(7), 16, 1, 8)
    ckpt.save_gan(str(tmp_path), "adversarial", g, d,
                  {"scale": 16, "grayscale": True, "noise_dim": 8, "noise_view": "nhwc"})
    with pytest.raises(ValueError, match="scale=16"):
        gan.restore_gan("adversarial", default_dir=str(tmp_path), scale=32)
    assert ckpt.split_network_arg(os.path.join(str(tmp_path), "adversarial.net")) == (
        str(tmp_path), "adversarial")
