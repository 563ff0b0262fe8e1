"""StyleGAN2 config F in the port (models/stylegan2.py, nn/style.py) against
the plain reference the benchmark judges it by
(benchmark/reference/sg2f_ffhq256.py), on the CPU in fp32 at a small
size: resolution 32, channel_base 512, channel_max 64, z and w 64, a
mapping of 2 layers, on seeded weights with const noise of strength 0.1.

Tolerances, each with its reason:
- images in [0, 1] and D's logits: 1e-4 absolute (logits also 1e-4
  relative), the fp32 drift between the port's non-fused modulated conv
  and the reference's grouped one, and the two FIR forms (~1e-6
  measured);
- the FIR: 1e-6, two fp32 matrix products against a sum of 16 shifted
  copies;
- leaving demodulation, the noise or the minibatch stddev out of the
  port must move its outputs by more than 100 times those tolerances.

Neither this file nor what it imports of the port imports JAX or facegen.
"""

import ast
import json
import os
import sys

import pytest
import torch

import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.lib import weights  # noqa: E402
from benchmark.reference import common as C  # noqa: E402
from benchmark.reference import sg2f_ffhq256 as R  # noqa: E402
from facegen_torch import sample  # noqa: E402
from facegen_torch.config import SampleConfig  # noqa: E402
from facegen_torch.models import gan, stylegan2  # noqa: E402
from facegen_torch.nn import style  # noqa: E402
from facegen_torch.utils import checkpoint as ckpt  # noqa: E402
from facegen_torch.utils.infer import GanInference  # noqa: E402

SMALL = dict(resolution=32, z_dim=64, w_dim=64, mapping_layers=2, channel_base=512,
             channel_max=64)
CFG = stylegan2.StyleGAN2Config(**SMALL)
ARCH = R.Arch(**SMALL)
PSI, STRENGTH, TOL = 0.7, 0.1, 1e-4


class Pair:
    """The port's G and D and the reference's inputs, from one seed."""

    def __init__(self, seed: int = 3):
        self.g, self.d = stylegan2.create_stylegan2(CFG, generator=torch.Generator().manual_seed(0))
        self.gp = weights.make(R.leaves("g", ARCH, STRENGTH), C.seeded_generator("cpu", seed, 0))
        self.dp = weights.make(R.leaves("d", ARCH), C.seeded_generator("cpu", seed, 1))
        weights.load_into(self.g, R.leaves("g", ARCH, STRENGTH), self.gp)
        weights.load_into(self.d, R.leaves("d", ARCH), self.dp)
        gen = C.seeded_generator("cpu", seed, 2)
        self.noise = [torch.randn((r, r), generator=gen) for _, r in R.noise_names(ARCH)]
        buffers = dict(self.g.named_buffers())
        with torch.no_grad():
            for (name, _), t in zip(R.noise_names(ARCH), self.noise):
                buffers[name].copy_(t)
        self.w_latents = torch.randn((500, 64), generator=C.seeded_generator("cpu", seed, 3))
        self.g.set_w_avg(self.w_latents)
        self.g.psi = PSI

    def reference_images(self, z, **kw):
        w_avg = R.w_average(self.gp[:4], self.w_latents, ARCH)
        return R.generate(self.gp, self.noise, w_avg, z, PSI, ARCH, **kw)


@pytest.fixture(scope="module")
def pair():
    return Pair()


def latents(n, seed=5):
    return torch.randn((n, 64), generator=torch.Generator().manual_seed(seed))


@torch.no_grad()
def test_generator_matches_the_reference(pair):
    z = latents(8)
    got = pair.g(z, torch.float32)
    want = pair.reference_images(z)
    assert got.shape == (8, 32, 32, 3)
    assert float(((want > 0) & (want < 1)).float().mean()) > 0.5  # most pixels unclamped
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
    assert torch.allclose(pair.g.mapping.w_avg, R.w_average(pair.gp[:4], pair.w_latents, ARCH),
                          atol=1e-5)


@torch.no_grad()
@pytest.mark.parametrize("n", [4, 8, 12])
def test_discriminator_matches_the_reference_in_groups_of_four(pair, n):
    images = pair.reference_images(latents(n, seed=n))
    got = pair.d(images).reshape(-1)
    torch.testing.assert_close(got, R.discriminate(pair.dp, images, ARCH, block=4),
                               atol=TOL, rtol=TOL)
    # a face's logit depends on its group of 4 consecutive faces alone
    swapped = images.clone()
    swapped[[0, 1]] = images[[1, 0]]
    torch.testing.assert_close(pair.d(swapped).reshape(-1)[2:], got[2:], atol=1e-6, rtol=1e-6)
    if n > 4:
        moved = images.clone()
        moved[[0, 4]] = images[[4, 0]]
        assert not torch.allclose(pair.d(moved).reshape(-1)[[1, 2, 3]], got[[1, 2, 3]],
                                  atol=1e-4)


def _direct_upfirdn(x, f, up, down, pad0, pad1, gain):
    """Zero-insert, pad, a sum of the 16 taps' shifted copies, decimate."""
    n, c, h, w = x.shape
    z = torch.zeros(n, c, h * up, w * up)
    z[:, :, ::up, ::up] = x
    z = torch.nn.functional.pad(z, [pad0, pad1, pad0, pad1])
    k = f.shape[0]
    out_h, out_w = z.shape[2] - k + 1, z.shape[3] - k + 1
    y = torch.zeros(n, c, out_h, out_w)
    for i in range(k):
        for j in range(k):
            y += gain * f[k - 1 - i, k - 1 - j] * z[:, :, i:i + out_h, j:j + out_w]
    return y[:, :, ::down, ::down]


@pytest.mark.parametrize("up,down,pad,gain,size", [
    (2, 1, (2, 1), 4.0, 8),   # ToRGB's image upsampling
    (1, 1, (1, 1), 4.0, 17),  # after the up-conv's transposed conv (2H + 1)
    (1, 2, (1, 1), 1.0, 16),  # D's 1x1 skip
    (1, 1, (2, 2), 1.0, 16),  # before D's stride-2 3x3 conv
])
def test_fir_resampling_against_its_direct_definition(up, down, pad, gain, size):
    x = torch.randn((2, 3, size, size), generator=torch.Generator().manual_seed(1))
    taps = torch.tensor([1.0, 3.0, 3.0, 1.0])
    want = _direct_upfirdn(x, taps.outer(taps) / 64, up, down, pad[0], pad[1], gain)
    m = style.resample_matrix(size, up, down, pad, gain)
    for layout in (torch.contiguous_format, torch.channels_last):
        got = style.resample2d(x.contiguous(memory_format=layout), m)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(want, R.upfirdn2d(x, R.fir("cpu"), up, down, pad[0], pad[1], gain),
                               atol=1e-6, rtol=1e-6)
    assert want.shape[-1] == (2 * size if up == 2 else size // 2 if down == 2 else
                              size + pad[0] + pad[1] - 3)


@torch.no_grad()
def test_checkpoint_round_trip_through_restore_gan(pair, tmp_path):
    ckpt.save_stylegan2(str(tmp_path), "sg2", pair.g, pair.d)
    meta = json.loads((tmp_path / "sg2" / "meta.json").read_text())["config"]
    assert meta["arch"] == "stylegan2" and meta["scale"] == 32 and meta["noise_dim"] == 64
    g, d, res = gan.restore_gan(str(tmp_path / "sg2"))
    assert res["arch"] == "stylegan2" and res["scale"] == 32 and res["channels"] == 3
    g.psi = PSI
    z = latents(4)
    assert torch.equal(g(z, torch.float32), pair.g(z, torch.float32))
    images = pair.g(z, torch.float32)
    assert torch.equal(d(images), pair.d(images))
    assert torch.equal(g.mapping.w_avg, pair.g.mapping.w_avg)
    with pytest.raises(ValueError, match="scale"):
        gan.restore_gan(str(tmp_path / "sg2"), scale=64)


@torch.no_grad()
def test_rank_matches_the_reference(pair):
    inf = GanInference(pair.g, pair.d, 64, torch.float32)
    images = inf.generate(latents(16, seed=9))
    best, best_scores = inf.rank(images, ascending=False, max_out=6)
    logits = R.discriminate(pair.dp, images, ARCH, block=8)
    order = torch.argsort(-logits, stable=True)[:6]
    assert torch.equal(best, images[order])
    torch.testing.assert_close(best_scores, torch.sigmoid(logits[order]), atol=TOL, rtol=0)
    normal = GanInference(pair.g, pair.d, 64).noise(torch.Generator().manual_seed(0), 2000)
    assert normal.std() > 0.9  # N(0, 1) latents, not U(-1, 1)


@torch.no_grad()
def test_split_over_two_devices_keeps_the_stddev_groups(pair):
    images = pair.reference_images(latents(12, seed=4))
    one = GanInference(pair.g, pair.d, 64, torch.float32)
    two = GanInference(pair.g, pair.d, 64, torch.float32, devices=["cpu", "cpu"])
    torch.testing.assert_close(two.score(images), one.score(images), atol=1e-6, rtol=0)
    torch.testing.assert_close(two.generate(latents(6)), one.generate(latents(6)), atol=1e-6,
                               rtol=0)
    with pytest.raises(ValueError, match="multiple of 4"):
        two.score(images[:10])
    chunked = GanInference(pair.g, pair.d, 64, torch.float32, max_batch=4)
    torch.testing.assert_close(chunked.score(images), one.score(images), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="multiple"):
        GanInference(pair.g, pair.d, 64, max_batch=6)


@pytest.fixture(scope="module")
def sg2_checkpoint(tmp_path_factory):
    save = tmp_path_factory.mktemp("sg2")
    stylegan2.main(["--save", str(save), "--network", "sg2", "--seed", "2", "--resolution", "32",
                    "--channelBase", "512", "--channelMax", "64", "--zDim", "64",
                    "--mappingLayers", "2"])
    return str(save)


def test_sampler_cli_serves_stylegan2(sg2_checkpoint, tmp_path):
    store = torch.randint(0, 256, (40, 32, 32, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0))
    cfg = SampleConfig(save=sg2_checkpoint, network="sg2", neighbours=True, scale=32,
                       writeto=str(tmp_path / "out"), truncation_psi=0.7)
    paths = sample.run_sampling(cfg, dataset=store, device="cpu", verbose=False)
    names = sorted(os.path.basename(p) for p in paths)
    assert names == sorted(["random1024_0001_base.png", "random256_0001_base.png",
                            "best_0001_base.png", "worst_0001_base.png", "random_0001_base.png",
                            "best_0001_neighbours_base.png"])
    from PIL import Image

    with Image.open(tmp_path / "out" / "random1024_0001_base.png") as im:
        assert im.size[0] >= 32 * 32 and im.size[1] >= 32 * 32


@pytest.mark.parametrize("flag", ["c2f", "model_axis", "truncation_on_g32"])
def test_sampler_refusals(sg2_checkpoint, tmp_path, flag):
    if flag == "c2f":
        cfg = SampleConfig(save=sg2_checkpoint, network="sg2", c2f=True)
        devices, match = None, "--c2f"
    elif flag == "model_axis":
        cfg = SampleConfig(save=sg2_checkpoint, network="sg2", mesh_shape=(1, 2))
        devices, match = ["cpu", "cpu"], "replicas only"
    else:
        g, d = gan.init_gan(torch.Generator().manual_seed(0), 32, 3, 100)
        ckpt.save_gan(str(tmp_path), "g32", g, d, {"scale": 32, "grayscale": False,
                                                     "noise_dim": 100})
        cfg = SampleConfig(save=str(tmp_path), network="g32", truncation_psi=0.5)
        devices, match = None, "StyleGAN2 checkpoints only"
    cfg = SampleConfig(**{**cfg.__dict__, "writeto": str(tmp_path / "out")})
    with pytest.raises(ValueError, match=match):
        sample.run_sampling(cfg, device="cpu", devices=devices, verbose=False)


def _no_demodulation(monkeypatch):
    monkeypatch.setattr(style, "demodulation", lambda weight, styles: torch.ones(
        styles.shape[0], weight.shape[0]))


def _no_noise(monkeypatch):
    monkeypatch.setattr(style.ModulatedConv2d, "shift", lambda self: self.bias[:, None, None])


def _no_minibatch_std(monkeypatch):
    monkeypatch.setattr(style.MinibatchStd, "forward", lambda self, x: torch.cat(
        [x, x.new_zeros(x.shape[0], self.channels, *x.shape[2:])], 1))


@torch.no_grad()
@pytest.mark.parametrize("fault", [_no_demodulation, _no_noise, _no_minibatch_std],
                         ids=["demodulation", "noise", "minibatch_std"])
def test_leaving_a_mechanism_out_of_the_port_fails_the_comparison(pair, fault, monkeypatch):
    z = latents(8)
    want_images = pair.reference_images(z)
    want_logits = R.discriminate(pair.dp, want_images, ARCH, block=8)
    fault(monkeypatch)
    images = pair.g(z, torch.float32)
    logits = pair.d(want_images).reshape(-1)
    gap = max(float((images - want_images).abs().max()), float((logits - want_logits).abs().max()))
    assert gap > 100 * TOL, gap


def test_configuration_holds_config_f_and_its_parameter_counts():
    cfg = json.loads(open(os.path.join(REPO, "benchmark", "configs", "sg2f_ffhq256.json")).read())
    flags, published = cfg["flags"], cfg["published"]
    assert (flags["z_dim"], flags["w_dim"], flags["mapping_layers"]) == (512, 512, 8)
    assert (flags["channel_base"], flags["channel_max"]) == (32768, 512)
    assert flags["lr_multiplier"] == 0.01
    assert (flags["mbstd_group"], flags["mbstd_channels"], flags["resolution"]) == (4, 1, 256)
    assert cfg["reduced"] == []
    port = stylegan2.StyleGAN2Config(**{k: flags[k] for k in ("resolution", "channel_base",
                                                                "channel_max")})
    assert port.num_ws == published["num_ws"] == 14
    assert {str(r): port.width(r) for r in port.resolutions} == published["widths"]
    assert published["widths"] == {"4": 512, "8": 512, "16": 512, "32": 512, "64": 512,
                                   "128": 256, "256": 128}
    # hand count: the mapping, per conv the style (w -> Cin, + bias), weight, noise
    # strength and bias, per ToRGB the style, weight and bias; D's blocks and epilogue
    widths = {int(r): c for r, c in published["widths"].items()}
    g = 8 * (512 * 512 + 512) + 512 * 16
    for r, c in widths.items():
        convs = [(c, c)] if r == 4 else [(widths[r // 2], c), (c, c)]
        g += sum(512 * cin + cin + 9 * cin * cout + 1 + cout for cin, cout in convs)
        g += 512 * c + c + 3 * c + 3
    d = 3 * 128 + 128 + (512 * 513 * 9 + 512) + (8192 * 512 + 512) + (512 + 1)
    for r in (256, 128, 64, 32, 16, 8):
        tmp, out = widths[r], widths[r // 2]
        d += (9 * tmp * tmp + tmp) + (9 * tmp * out + out) + tmp * out
    assert (g, d) == (cfg["parameters"]["g"], cfg["parameters"]["d"]) == (
        R.parameter_count("g"), R.parameter_count("d"))
    assert abs(g - 30.0e6) < 0.05e6
    small_g, small_d = stylegan2.create_stylegan2(CFG, generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in small_g.parameters()) == R.parameter_count("g", ARCH)
    assert sum(p.numel() for p in small_d.parameters()) == R.parameter_count("d", ARCH)


def test_the_new_files_import_neither_jax_nor_facegen():
    files = [os.path.join(REPO, "facegen_torch", "nn", "style.py"),
             os.path.join(REPO, "facegen_torch", "models", "stylegan2.py"),
             os.path.join(REPO, "benchmark", "reference", "sg2f_ffhq256.py")]
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "facegen"), (path, name)
