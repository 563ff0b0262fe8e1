"""Plain reference of the sg2f_ffhq256 configuration: StyleGAN2 config F
(Karras et al. 2020, arXiv:1912.04958) at 256x256, after
stylegan2-ada-pytorch's training/networks.py at ``--cfg stylegan2``: the
mapping, the truncation, the skip synthesis network and the resnet
discriminator, in fp32 (TF32 off: ``common.full_fp32``) or, with
``Precision("fp8")``, the control's arithmetic. The widths are an
``Arch``, so the same file runs at a small size.

Parameters are lists of fp32 tensors in the order of the leaf tables
below (the program's module order: a module's own parameters before its
children's); the const noise maps are a list in
``noise_names`` order; images are NHWC in [0, 1] on both ends, as the
program's are.

- Mapping: z * rsqrt(mean(z^2) + 1e-8), then ``mapping_layers`` layers
  x @ (W * 0.01 / sqrt(in)).T + b * 0.01, leaky ReLU(0.2) x sqrt(2)
  (stored W ~ N(0, 1) / 0.01). Truncation w_avg + psi (w - w_avg), with
  w_avg the mean of the mapping over the latents it is given.
- Synthesis: a 4x4 const; per layer the style s = A w + b_A (A x
  1/sqrt(w_dim), b_A init 1); the modulated conv in its fused form: the
  per-sample weight W s, demodulated by rsqrt(sum (W s)^2 + 1e-8) over
  (Cin, kh, kw), run as a grouped conv (groups = samples); an up layer
  is the grouped transposed conv of stride 2 and the FIR (pad 1, gain
  4); then + noise x strength, + bias, leaky ReLU x sqrt(2). ToRGB: the
  style x 1/sqrt(Cin), a modulated 1x1 conv without demodulation, +
  bias; the image is the sum of every ToRGB, each earlier one upsampled
  by the FIR (zero-insert, pad 2 and 1, gain 4).
- Discriminator: (x * 2 - 1), FromRGB 1x1 + leaky ReLU; per block
  r = 256 .. 8: conv0 3x3, conv1 = FIR (pad 2) then 3x3 stride 2, skip =
  FIR (pad 1) decimated by 2 then 1x1 without bias; out = (skip + conv1)
  x sqrt(1/2) (the leaky ReLUs' sqrt(2) kept); epilogue: minibatch
  stddev, 3x3 conv, linear to 512 from the (C, 4, 4) map, linear to 1.
  Weights N(0, 1) x 1/sqrt(fan_in), biases 0.
- ``upfirdn2d`` is the direct definition: zero-insert, pad, correlate
  with the flipped FIR, keep every ``down``-th row and column.

Departures from networks.py, each also in the program:
- minibatch stddev groups are ``mbstd_group`` consecutive faces (faces
  4k .. 4k + 3); networks.py groups faces i, i + N/4, i + N/2, i + 3N/4.
  Over a shuffled batch the statistic is the same kind; consecutive
  groups let a request split at any multiple of 4 score alike, and the
  reference computes in blocks of faces that are multiples of 4 from 0;
- no ``conv_clamp`` (TF config F's fp32 has none); stylegan2-ada-pytorch
  clamps at 256 where it runs fp16;
- the sampler's [0, 1] images: G's output (x + 1) / 2 clamped to
  [0, 1], as generate.py writes images, and D's input mapped back to
  [-1, 1];
- the noise is the const mode of generate.py (``noise_mode='const'``),
  one fixed N(0, 1) map per layer, its strength set by the configuration.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import common as C

GAIN = math.sqrt(2.0)
SLOPE = 0.2


@dataclasses.dataclass(frozen=True)
class Arch:
    resolution: int = 256
    channels: int = 3
    z_dim: int = 512
    w_dim: int = 512
    mapping_layers: int = 8
    lr_multiplier: float = 0.01
    channel_base: int = 32768
    channel_max: int = 512
    mbstd_group: int = 4
    mbstd_channels: int = 1

    def width(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def resolutions(self) -> List[int]:
        return [2 ** i for i in range(2, int(math.log2(self.resolution)) + 1)]


FULL = Arch()


def arch(flags: dict) -> Arch:
    """The ``Arch`` a configuration's flags name."""
    return Arch(**{f.name: flags[f.name] for f in dataclasses.fields(Arch) if f.name in flags})


def _layer(prefix, cin, cout, k, w_dim):
    return [(f"{prefix}.weight", (cout, cin, k, k)), (f"{prefix}.noise_strength", ()),
            (f"{prefix}.bias", (cout,)), (f"{prefix}.affine.weight", (cin, w_dim)),
            (f"{prefix}.affine.bias", (cin,))]


def _torgb(prefix, cin, cout, w_dim):
    return [(f"{prefix}.weight", (cout, cin, 1, 1)), (f"{prefix}.bias", (cout,)),
            (f"{prefix}.affine.weight", (cin, w_dim)), (f"{prefix}.affine.bias", (cin,))]


def g_shapes(a: Arch = FULL):
    out = []
    for i in range(a.mapping_layers):
        out += [(f"mapping.fc{i}.weight", (a.w_dim, a.z_dim if i == 0 else a.w_dim)),
                (f"mapping.fc{i}.bias", (a.w_dim,))]
    for res in a.resolutions:
        b, c = f"synthesis.b{res}", a.width(res)
        if res == 4:
            out.append((f"{b}.const", (c, 4, 4)))
        else:
            out += _layer(f"{b}.conv0", a.width(res // 2), c, 3, a.w_dim)
        out += _layer(f"{b}.conv1", c, c, 3, a.w_dim) + _torgb(f"{b}.torgb", c, a.channels,
                                                              a.w_dim)
    return out


def d_shapes(a: Arch = FULL):
    out = []
    for res in reversed(a.resolutions[1:]):
        b, tmp, cout = f"b{res}", a.width(res), a.width(res // 2)
        if res == a.resolution:
            out += [(f"{b}.fromrgb.weight", (tmp, a.channels, 1, 1)), (f"{b}.fromrgb.bias", (tmp,))]
        out += [(f"{b}.conv0.weight", (tmp, tmp, 3, 3)), (f"{b}.conv0.bias", (tmp,)),
                (f"{b}.conv1.weight", (cout, tmp, 3, 3)), (f"{b}.conv1.bias", (cout,)),
                (f"{b}.skip.weight", (cout, tmp, 1, 1))]
    c = a.width(4)
    return out + [("b4.conv.weight", (c, c + a.mbstd_channels, 3, 3)), ("b4.conv.bias", (c,)),
                  ("b4.fc.weight", (c, c * 16)), ("b4.fc.bias", (c,)),
                  ("b4.out.weight", (1, c)), ("b4.out.bias", (1,))]


def noise_names(a: Arch = FULL):
    """(buffer name, resolution) of the const noise maps, in synthesis order."""
    out = []
    for res in a.resolutions:
        for conv in ((1,) if res == 4 else (0, 1)):
            out.append((f"synthesis.b{res}.conv{conv}.noise_const", res))
    return out


def leaves(net: str, a: Arch = FULL, noise_strength: float = 0.1):
    """The weight table of ``net`` ("g" or "d"): networks.py's init (every
    weight and the const N(0, 1), the mapping's N(0, 1) / lr multiplier,
    biases 0, the styles' biases 1), every noise strength
    ``noise_strength`` (networks.py starts it at 0, which turns the noise
    off)."""
    out = []
    for name, shape in (g_shapes(a) if net == "g" else d_shapes(a)):
        if name.endswith("noise_strength"):
            rule = ("const", noise_strength)
        elif name.endswith("affine.bias"):
            rule = ("const", 1.0)
        elif name.endswith(".bias"):
            rule = ("const", 0.0)
        elif name.startswith("mapping."):
            rule = ("normal", 1.0 / a.lr_multiplier)
        else:
            rule = ("normal", 1.0)
        out.append((name, shape, rule))
    return out


def weigh_stddev_inputs(d: List[torch.Tensor], a: Arch, std: float) -> List[torch.Tensor]:
    """D's leaves with the epilogue conv's weights on the stddev maps
    multiplied by ``std``. Drawn N(0, 1) like the others, those maps are
    ``mbstd_channels`` of Cin + 1 inputs and move a logit by less than
    bf16 rounding does; at std sqrt(Cin) they carry as much of the
    conv's input as the Cin feature maps together."""
    i = [name for name, _ in d_shapes(a)].index("b4.conv.weight")
    w = d[i].clone()
    w[:, a.width(4):] *= std
    return d[:i] + [w] + d[i + 1:]


def parameter_count(net: str, a: Arch = FULL) -> int:
    return sum(math.prod(shape) for _, shape in (g_shapes(a) if net == "g" else d_shapes(a)))


def fir(device, taps: Sequence[float] = (1.0, 3.0, 3.0, 1.0)) -> torch.Tensor:
    f = torch.tensor(taps, device=device)
    f = f[:, None] * f[None, :]
    return f / f.sum()


def upfirdn2d(x: torch.Tensor, f: torch.Tensor, up: int = 1, down: int = 1, pad0: int = 0,
              pad1: int = 0, gain: float = 1.0) -> torch.Tensor:
    """NCHW: insert ``up - 1`` zeros after every pixel on both axes, pad
    ``pad0`` before and ``pad1`` after, correlate each channel with the
    flipped ``f`` x ``gain``, keep every ``down``-th row and column."""
    n, c, h, w = x.shape
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1]).reshape(n, c, h * up, w * up)
    x = F.pad(x, [pad0, pad1, pad0, pad1])
    k = (f * gain).flip([0, 1])[None, None].repeat(c, 1, 1, 1)
    x = F.conv2d(x, k, groups=c)
    return x[:, :, ::down, ::down]


def _lrelu(x):
    return F.leaky_relu(x, SLOPE) * GAIN


def _linear(x, w, b, gain, bias_gain, prec):
    return prec.q(F.linear(prec.q(x), prec.q(w * gain), b * bias_gain))


def mapping(p: Sequence[torch.Tensor], z: torch.Tensor, a: Arch = FULL,
            prec: C.Precision = C.FP32) -> torch.Tensor:
    """(N, z_dim) -> (N, w_dim)."""
    x = z.float()
    x = x / torch.sqrt((x * x).mean(1, keepdim=True) + 1e-8)
    for i in range(a.mapping_layers):
        w, b = p[2 * i], p[2 * i + 1]
        x = _lrelu(_linear(x, w, b, a.lr_multiplier / math.sqrt(w.shape[1]), a.lr_multiplier,
                           prec))
    return x


def w_average(p: Sequence[torch.Tensor], z: torch.Tensor, a: Arch = FULL) -> torch.Tensor:
    return mapping(p, z, a).mean(0)


def _modconv(x, weight, styles, prec, demodulate=True, up=1):
    """The fused modulated conv: per-sample weights, one grouped conv."""
    n, cin, h, w = x.shape
    cout, k = weight.shape[0], weight.shape[-1]
    wt = weight[None] * styles[:, None, :, None, None]
    if demodulate:
        wt = wt / torch.sqrt((wt * wt).sum((2, 3, 4)) + 1e-8)[:, :, None, None, None]
    x, wt = prec.q(x).reshape(1, n * cin, h, w), prec.q(wt)
    if up == 1:
        y = F.conv2d(x, wt.reshape(n * cout, cin, k, k), padding=k // 2, groups=n)
    else:
        y = F.conv_transpose2d(x, wt.transpose(1, 2).reshape(n * cin, cout, k, k), stride=up,
                               groups=n)
    return prec.q(y).reshape(n, cout, y.shape[2], y.shape[3])


def _synthesis(p, noise, w, a, prec, demodulate, use_noise):
    """(N, w_dim) w (every layer's) -> (N, C, H, W) images in about [-1, 1]."""
    f = fir(w.device)
    it, nz = iter(p), iter(noise)
    x = img = None
    for res in a.resolutions:
        if res == 4:
            const = next(it)
            x = const[None].expand(w.shape[0], -1, -1, -1)
        for up in ((1,) if res == 4 else (2, 1)):
            weight, strength, bias, aw, ab = (next(it) for _ in range(5))
            styles = _linear(w, aw, ab, 1.0 / math.sqrt(w.shape[1]), 1.0, prec)
            x = _modconv(x, weight, styles, prec, demodulate, up)
            if up == 2:
                x = upfirdn2d(x, f, pad0=1, pad1=1, gain=4.0)
            n_map = next(nz)
            if use_noise:
                x = x + n_map * strength
            x = _lrelu(x + bias[None, :, None, None])
        weight, bias, aw, ab = (next(it) for _ in range(4))
        styles = _linear(w, aw, ab, 1.0 / math.sqrt(w.shape[1]), 1.0, prec) / math.sqrt(
            weight.shape[1])
        y = _modconv(x, weight, styles, prec, demodulate=False) + bias[None, :, None, None]
        img = y if img is None else upfirdn2d(img, f, up=2, pad0=2, pad1=1, gain=4.0) + y
    return img


def generate(p: Sequence[torch.Tensor], noise: Sequence[torch.Tensor], w_avg: torch.Tensor,
             z: torch.Tensor, psi: float, a: Arch = FULL, prec: C.Precision = C.FP32,
             demodulate: bool = True, use_noise: bool = True, block: int = 32) -> torch.Tensor:
    """(N, z_dim) latents -> (N, H, W, C) images in [0, 1], ``block`` faces at a time."""
    n_map = 2 * a.mapping_layers
    out = []
    for s in range(0, z.shape[0], block):
        w = mapping(p[:n_map], z[s:s + block], a, prec)
        w = w_avg + psi * (w - w_avg)
        img = _synthesis(p[n_map:], noise, w, a, prec, demodulate, use_noise)
        out.append(((img + 1.0) / 2.0).clamp(0.0, 1.0).permute(0, 2, 3, 1))
    return torch.cat(out)


def _conv(x, w, b, prec, stride=1, padding=0):
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    y = F.conv2d(prec.q(x), prec.q(w / math.sqrt(fan_in)), None, stride, padding)
    y = prec.q(y)
    return y if b is None else y + b[None, :, None, None]


def minibatch_std(x: torch.Tensor, group: int, channels: int) -> torch.Tensor:
    """x with ``channels`` maps appended: per group of ``group`` consecutive
    faces and per slice of the channels, the mean over the slice and the
    pixels of sqrt(var over the group + 1e-8)."""
    n, c, h, w = x.shape
    g = min(group, n)
    y = x.reshape(n // g, g, c, h, w)
    sd = torch.sqrt(((y - y.mean(1, keepdim=True)) ** 2).mean(1) + 1e-8)
    stat = sd.reshape(n // g, channels, -1).mean(2)
    stat = stat[:, None, :, None, None].expand(n // g, g, channels, h, w).reshape(n, channels, h, w)
    return torch.cat([x, stat], 1)


def _discriminate(p, images, a, prec, mbstd):
    f = fir(images.device)
    x = images.permute(0, 3, 1, 2).float() * 2.0 - 1.0
    it = iter(p)
    for res in reversed(a.resolutions[1:]):
        if res == a.resolution:
            x = _lrelu(_conv(x, next(it), next(it), prec))
        w0, b0, w1, b1, ws = (next(it) for _ in range(5))
        skip = _conv(upfirdn2d(x, f, down=2, pad0=1, pad1=1), ws, None, prec)
        x = _lrelu(_conv(x, w0, b0, prec, padding=1))
        x = _lrelu(_conv(upfirdn2d(x, f, pad0=2, pad1=2), w1, b1, prec, stride=2))
        x = (skip + x) * math.sqrt(0.5)
    cw, cb, fw, fb, ow, ob = it
    if mbstd:
        x = minibatch_std(x, a.mbstd_group, a.mbstd_channels)
    else:  # the control: the stddev maps left out (zeros in their place)
        x = torch.cat([x, x.new_zeros(x.shape[0], a.mbstd_channels, 4, 4)], 1)
    x = _lrelu(_conv(x, cw, cb, prec, padding=1)).reshape(x.shape[0], -1)
    x = _lrelu(_linear(x, fw, fb, 1.0 / math.sqrt(fw.shape[1]), 1.0, prec))
    return _linear(x, ow, ob, 1.0 / math.sqrt(ow.shape[1]), 1.0, prec).reshape(-1)


def discriminate(p: Sequence[torch.Tensor], images: torch.Tensor, a: Arch = FULL,
                 prec: C.Precision = C.FP32, mbstd: bool = True, block: int = 32) -> torch.Tensor:
    """(N, H, W, C) images in [0, 1] -> (N,) logits, ``block`` faces (a
    multiple of the stddev group) at a time from face 0, so every group of
    consecutive faces is scored whole."""
    if block % a.mbstd_group:
        raise ValueError(f"block {block}: a multiple of the group {a.mbstd_group}")
    return torch.cat([_discriminate(p, images[s:s + block], a, prec, mbstd)
                      for s in range(0, images.shape[0], block)])


def search_rows(store: torch.Tensor, resolution: int) -> torch.Tensor:
    """Store images (N, 64, 64, 3) uint8 at ``resolution`` as (N, H*W*C)
    fp64 rows in [0, 1]."""
    rows = C.to_u8(C.resize(store.float() / 255.0, resolution))
    return rows.reshape(store.shape[0], -1).double() / 255.0
