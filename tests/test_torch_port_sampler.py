"""The port's sampler slice as a whole against facegen's, on the CPU.

Tolerances, each with its reason:
- G images and D scores, fp32: 2e-4 (rtol and atol), the fp32
  reassociation drift of the convs (~1e-5 measured) with margin;
- D-rank order and nearest-neighbour indices: equal;
- prepare_pool: within 1 uint8 step, since both round x*255+0.5 after a
  resize whose fp32 sums differ in the last bits;
- synthetic_faces fed JAX's own draws: within 1 uint8 step, and equal
  in all but a few pixels in 10^4: exp and sigmoid differ in the last
  ulp between the two libraries, which moves a value across a rounding
  boundary now and then.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facegen.data.pipeline import prepare_pool as jax_prepare_pool
from facegen.data.synthetic import synthetic_faces as jax_synthetic_faces
from facegen.models import gan as jax_gan
from facegen.utils import checkpoint as jax_ckpt
from facegen.utils.grids import save_png as jax_save_png
from facegen.utils.infer import GanInference as JaxInference
from facegen.utils.infer import nearest_neighbours as jax_nearest_neighbours
from facegen_torch import sample
from facegen_torch.config import SampleConfig
from facegen_torch.data.pipeline import prepare_pool
from facegen_torch.data.synthetic import synthetic_faces
from facegen_torch.models import gan
from facegen_torch.utils import checkpoint as ckpt
from facegen_torch.utils.grids import save_png
from facegen_torch.utils.infer import GanInference, nearest_neighbours

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
SAMPLER_FILES = {  # tests/test_loop_and_tools.py:332-335
    "random1024_0001_base.png", "random256_0001_base.png",
    "best_0001_base.png", "worst_0001_base.png", "random_0001_base.png",
    "best_0001_neighbours_base.png",
}


def test_gan_inference_matches_jax_on_one_checkpoint(tmp_path):
    _, _, bundle = jax_gan.init_gan(jax.random.key(0), 32, 3, 100, reference_init=False)
    # larger weights (G x6, D x3) and real running statistics: at init G's
    # output is a flat 0.5 and D's scores nearly tie, which would hide a
    # wrong layout and leave the rank order to rounding
    for net, factor in (("params_g", 6.0), ("params_d", 3.0)):
        bundle[net] = jax.tree_util.tree_map_with_path(
            lambda p, a, f=factor: a * f if str(p[-1].key) == "w" else a, bundle[net])
    bundle["state_g"] = jax.tree.map(lambda a: a * 2.0 + 0.05, bundle["state_g"])
    jax_ckpt.save(str(tmp_path), "adversarial", bundle,
                  meta={"config": {"scale": 32, "grayscale": False, "noise_dim": 100}})
    jg, jd, jbundle, _, _ = jax_gan.restore_gan("adversarial", default_dir=str(tmp_path))
    g, d, _ = gan.restore_gan("adversarial", default_dir=str(tmp_path), device="cpu")
    noise = np.random.RandomState(1).uniform(-1, 1, (12, 100)).astype(np.float32)

    jinf = JaxInference(jg, jd, 100, compute_dtype="float32")
    j_imgs = jinf.generate(jbundle, jnp.asarray(noise))
    j_scores = np.asarray(jinf.score(jbundle, j_imgs))
    inf = GanInference(g, d, 100, compute_dtype=torch.float32)
    imgs = inf.generate(torch.from_numpy(noise))
    scores = inf.score(imgs).numpy()

    np.testing.assert_allclose(imgs.numpy(), np.asarray(j_imgs), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(scores, j_scores, rtol=TOL, atol=TOL)
    # the rank order is only defined where scores are farther apart than
    # the tolerance; this input is chosen so they all are
    assert np.diff(np.sort(j_scores)).min() > 2 * TOL
    j_best, j_best_scores = jinf.rank(jbundle, j_imgs, ascending=False, max_out=8)
    best, best_scores = inf.rank(imgs, ascending=False, max_out=8)
    np.testing.assert_array_equal(np.argsort(-scores, kind="stable"),
                                  np.argsort(-j_scores, kind="stable"))
    np.testing.assert_allclose(best.numpy(), np.asarray(j_best), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(best_scores.numpy(), np.asarray(j_best_scores),
                               rtol=TOL, atol=TOL)


def test_nearest_neighbours_indices_equal_jax():
    rs = np.random.RandomState(2)
    data = rs.randint(0, 256, (300, 8, 8, 3)).astype(np.uint8)
    queries = np.clip(data[[5, 99, 250]] / 255.0 + rs.normal(0, 0.05, (3, 8, 8, 3)), 0, 1)
    queries = queries.astype(np.float32)
    j_idx, j_dist = jax_nearest_neighbours(jnp.asarray(queries), data, k=4)
    idx, dist = nearest_neighbours(torch.from_numpy(queries), data, k=4)
    np.testing.assert_array_equal(idx, j_idx)
    assert list(idx[:, 0]) == [5, 99, 250]
    np.testing.assert_allclose(dist, j_dist, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("scale,channels", [(32, 3), (16, 1), (32, 1)])
def test_prepare_pool_within_one_step_of_jax(scale, channels):
    faces = np.asarray(jax_synthetic_faces(jax.random.key(0), 8))
    noisy = np.random.RandomState(3).randint(0, 256, (8, 64, 64, 3)).astype(np.uint8)
    raw = np.concatenate([faces, noisy])
    theirs = np.asarray(jax_prepare_pool(jnp.asarray(raw), jax.random.key(0), scale,
                                         channels, augment=False)).astype(int)
    ours = prepare_pool(torch.from_numpy(raw), scale, channels).numpy().astype(int)
    assert ours.shape == theirs.shape == (16, scale, scale, channels)
    assert np.abs(ours - theirs).max() <= 1


def test_synthetic_faces_equal_jax_given_its_draws():
    n, key = 6, jax.random.key(4)
    # facegen/data/synthetic.py:31-39,69: per image 7 uniforms and a normal
    # field, each from its own key
    uniforms, noise = [], []
    for k in jax.random.split(jax.random.split(key, 10)[0], n):
        kk = jax.random.split(k, 8)
        uniforms.append([jax.random.uniform(kk[i], ()) for i in range(7)])
        noise.append(jax.random.normal(kk[7], (64, 64, 3)))
    ours = synthetic_faces(torch.from_numpy(np.asarray(uniforms, np.float32)),
                           torch.from_numpy(np.asarray(noise, np.float32)))
    ours = ours.numpy().astype(int)
    theirs = np.asarray(jax_synthetic_faces(key, n)).astype(int)
    assert np.abs(ours - theirs).max() <= 1
    assert (ours != theirs).mean() < 1e-4


@pytest.mark.parametrize("shape", [(7, 5), (7, 5, 1), (6, 9, 3)])
def test_png_writer_decodes_like_jax_png(tmp_path, shape):
    from PIL import Image

    img = np.random.RandomState(5).uniform(0, 1, shape).astype(np.float32)
    ours = np.asarray(Image.open(save_png(str(tmp_path / "ours.png"), img)))
    theirs = np.asarray(Image.open(jax_save_png(str(tmp_path / "theirs.png"), img)))
    np.testing.assert_array_equal(ours, theirs)


def _port_checkpoint(save_dir):
    g, d = gan.init_gan(torch.Generator().manual_seed(8), 16, 1, 16, reference_init=False)
    ckpt.save_gan(save_dir, "adversarial", g, d,
                  {"scale": 16, "grayscale": True, "noise_dim": 16, "noise_view": "nhwc"})
    return g, d


def test_run_sampling_on_cpu_writes_the_sampler_file_set(tmp_path):
    from PIL import Image

    g, d = _port_checkpoint(str(tmp_path / "logs"))
    cfg = SampleConfig(save=str(tmp_path / "logs"), writeto=str(tmp_path / "samples"),
                       runs=1, neighbours=True, seed=2)
    dataset = np.random.RandomState(6).randint(0, 256, (64, 16, 16, 1)).astype(np.uint8)
    noise = np.random.RandomState(7).uniform(-1, 1, (1, 1024, 16)).astype(np.float32)
    outputs = sample.run_sampling(cfg, dataset=dataset, device="cpu", noise=noise,
                                  verbose=False)
    assert {os.path.basename(o) for o in outputs} == SAMPLER_FILES
    grid = np.asarray(Image.open(tmp_path / "samples" / "random1024_0001_base.png"))
    assert grid.shape == (32 * 17 + 1, 32 * 17 + 1)
    # the injected noise is what G ran on (bf16, the sampler's dtype)
    first = GanInference(g, d, 16).generate(torch.from_numpy(noise[0, :1]))[0, :, :, 0]
    expected = np.clip(first.numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(grid[1:17, 1:17], expected)


def test_d_base_ranks_with_another_checkpoints_d(tmp_path):
    save = str(tmp_path / "logs")
    g, _ = _port_checkpoint(save)
    _, d_other = gan.init_gan(torch.Generator().manual_seed(9), 16, 1, 16)
    ckpt.save_gan(save, "other", g, d_other,
                  {"scale": 16, "grayscale": True, "noise_dim": 16, "noise_view": "nhwc"})
    cfg = SampleConfig(save=save, d_network="other")
    g_loaded, d_loaded, resolved = sample.load_models(cfg, "cpu")
    assert (resolved.scale, resolved.grayscale, resolved.noise_dim) == (16, True, 16)
    for k, t in d_other.state_dict().items():
        assert torch.equal(d_loaded.state_dict()[k], t), k
    for k, t in g.state_dict().items():
        assert torch.equal(g_loaded.state_dict()[k], t), k
    # a D of another geometry is refused with both values spelled out
    g32, d32 = gan.init_gan(torch.Generator().manual_seed(10), 32, 1, 16)
    ckpt.save_gan(save, "d32", g32, d32,
                  {"scale": 32, "grayscale": True, "noise_dim": 16, "noise_view": "nhwc"})
    with pytest.raises(ValueError, match="scale=32"):
        sample.load_models(SampleConfig(save=save, d_network="d32"), "cpu")


@pytest.mark.parametrize("argv,message", [
    (["--meshShape", "2"], "not ported yet"),
])
def test_cli_rejects_unported_flags(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        sample.main(argv)
    assert e.value.code != 0 and message in capsys.readouterr().err


def test_cli_needs_a_gpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        sample.main([])
    assert e.value.code != 0 and "no CUDA GPU" in capsys.readouterr().err


def test_port_imports_no_jax_and_no_facegen():
    code = (
        "import sys, torch\n"
        "import facegen_torch.sample\n"
        "from facegen_torch.models import gan\n"
        "from facegen_torch.utils.infer import GanInference\n"
        "g, d = gan.init_gan(torch.Generator().manual_seed(0), 16, 1, 8)\n"
        "inf = GanInference(g, d, 8, compute_dtype=torch.float32)\n"
        "imgs = inf.generate_n(torch.Generator().manual_seed(1), 4)\n"
        "assert imgs.shape == (4, 16, 16, 1) and inf.score(imgs).shape == (4,)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'facegen'))\n"
        "assert not bad, bad\n"
        "print('no jax')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "no jax"


def test_port_sources_import_no_jax_and_no_facegen():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|facegen)\b(?!_)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "facegen_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path
