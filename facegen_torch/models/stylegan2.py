"""StyleGAN2 (Karras et al. 2020, config F) as a net pair the sampler serves.

The equations are stylegan2-ada-pytorch's training/networks.py at
``--cfg stylegan2`` (map=8, mbstd=4, fmaps=1: channel_base 32768,
channel_max 512):

- ``Mapping``: z normalised by its second moment, ``mapping_layers``
  ``EqualLinear`` layers of ``w_dim`` with leaky ReLU and lr multiplier
  0.01; ``w_avg`` (a buffer) for the truncation w_avg + psi (w - w_avg).
- ``Synthesis`` (the skip generator): a learned 4x4 const, then a block
  per resolution 4 .. ``resolution``: the first a modulated 3x3 conv, the
  others an up-conv (transposed conv + FIR) and a 3x3 conv, each with
  const noise; every block's ``ToRGB`` adds to the image, which is
  upsampled through the FIR between blocks (fp32). ``num_ws`` = 2
  log2(resolution) - 2 styles, one per conv and one for the last ToRGB,
  each block's ToRGB sharing the next block's first w.
- ``Discriminator`` (resnet): FromRGB 1x1 at the top resolution, then a
  block per resolution ``resolution`` .. 8: 3x3 conv, 3x3 conv with
  FIR-blurred stride-2 downsampling, a 1x1 skip downsampled the same way
  without bias, the two joined at sqrt(1/2) each; the epilogue at 4x4:
  minibatch stddev (``mbstd_group``, ``mbstd_channels``), a 3x3 conv, a
  linear layer from the flattened (C, 4, 4) map and a linear layer to
  one logit.

Channels at resolution r: min(channel_base // r, channel_max). State
dict keys follow networks.py (``synthesis.b4.conv1.affine.weight``,
``b256.skip.weight``).

The port's wrappers: ``Generator`` maps (N, z_dim) latents to (N, H, W,
C) images in [0, 1], (x + 1) / 2 clamped as networks' generate.py writes
them, with its ``psi``; the mapping, the truncation and the styles run
in fp32 on the fp32 latents, the synthesis in the dtype the caller
asks for. ``Discriminator`` maps [0, 1] NHWC images to [-1, 1] and
returns (N, 1) logits. The spans ``sg2.mapping`` and ``sg2.synthesis``
cover G's two halves, ``sg2.fir`` each FIR resample (nn/style.py).

    python -m facegen_torch.models.stylegan2 --save logs --network sg2f256 --seed 1

writes a checkpoint of seeded random weights (networks.py's init, noise
strengths ``--noiseStrength``, ``w_avg`` the mean mapping of 10,000
seeded latents) that ``restore_gan`` and the sampler load.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from facegen_torch.nn.style import (
    EqualConv2d,
    EqualLinear,
    MinibatchStd,
    ModulatedConv2d,
    ToRGB,
    randn,
    resample2d,
    resample_matrix,
)
from facegen_torch.utils.profiling import span

ARCH = "stylegan2"
SERVE_BATCH = 128  # faces a sampler call takes (about 20 GB of activations at 256x256)
W_AVG_SAMPLES = 10_000


@dataclasses.dataclass(frozen=True)
class StyleGAN2Config:
    """The architecture's numbers, stored in a checkpoint's meta.json."""

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

    def __post_init__(self):
        log2 = math.log2(self.resolution)
        if self.resolution < 8 or log2 != int(log2):
            raise ValueError(f"resolution {self.resolution}: a power of 2 from 8")

    def width(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def resolutions(self) -> List[int]:
        return [2 ** i for i in range(2, int(math.log2(self.resolution)) + 1)]

    @property
    def num_ws(self) -> int:
        return 2 * len(self.resolutions)

    def meta(self) -> dict:
        """meta.json's "config": the numbers, ``arch`` and the sampler's keys."""
        return {"arch": ARCH, "scale": self.resolution, "grayscale": self.channels == 1,
                "noise_dim": self.z_dim, **dataclasses.asdict(self)}

    @classmethod
    def from_meta(cls, stored: dict) -> "StyleGAN2Config":
        return cls(**{f.name: stored[f.name] for f in dataclasses.fields(cls) if f.name in stored})


class Mapping(nn.Module):
    def __init__(self, cfg: StyleGAN2Config, *, generator: torch.Generator, device=None):
        super().__init__()
        for i in range(cfg.mapping_layers):
            self.add_module(f"fc{i}", EqualLinear(cfg.z_dim if i == 0 else cfg.w_dim, cfg.w_dim,
                                                  lrelu=True, lr_multiplier=cfg.lr_multiplier,
                                                  generator=generator, device=device))
        self.register_buffer("w_avg", torch.zeros(cfg.w_dim, device=device))

    def forward(self, z: torch.Tensor, psi: float = 1.0) -> torch.Tensor:
        """(N, z_dim) -> (N, w_dim) w in fp32, truncated toward ``w_avg`` by ``psi``."""
        x = z.float()
        x = x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)
        for fc in self.children():
            x = fc(x)
        return x if psi == 1.0 else torch.lerp(self.w_avg, x, psi)


class SynthesisBlock(nn.Module):
    def __init__(self, cfg: StyleGAN2Config, res: int, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        out = cfg.width(res)
        if res == 4:
            self.const = nn.Parameter(randn((out, 4, 4), generator, device))
        else:
            self.conv0 = ModulatedConv2d(cfg.width(res // 2), out, cfg.w_dim, res, up=2, **kw)
        self.conv1 = ModulatedConv2d(out, out, cfg.w_dim, res, **kw)
        self.torgb = ToRGB(out, cfg.channels, cfg.w_dim, **kw)
        if res > 4:  # the image's x2 upsampling through the FIR
            self.register_buffer("fir", resample_matrix(res // 2, up=2, pad=(2, 1), gain=4.0,
                                                        device=device), persistent=False)

    @property
    def num_conv(self) -> int:
        return 1 if hasattr(self, "const") else 2

    def forward(self, x, img, ws, dtype: torch.dtype):
        """ws: (N, num_conv + 1, w_dim), the last for ToRGB; the first
        block starts from its const in ``dtype``."""
        if hasattr(self, "const"):
            x = self.const.to(dtype)[None].expand(ws.shape[0], -1, -1, -1)
            x = self.conv1(x.contiguous(memory_format=torch.channels_last), ws[:, 0])
        else:
            x = self.conv1(self.conv0(x, ws[:, 0]), ws[:, 1])
        y = self.torgb(x, ws[:, -1])
        img = y if img is None else resample2d(img, self.fir) + y
        return x, img


class Synthesis(nn.Module):
    def __init__(self, cfg: StyleGAN2Config, *, generator: torch.Generator, device=None):
        super().__init__()
        for res in cfg.resolutions:
            self.add_module(f"b{res}", SynthesisBlock(cfg, res, generator=generator,
                                                      device=device))

    def forward(self, ws: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(N, num_ws, w_dim) -> (N, C, H, W) fp32 images in about [-1, 1]."""
        x, img, i = None, None, 0
        for block in self.children():
            x, img = block(x, img, ws[:, i:i + block.num_conv + 1], dtype)
            i += block.num_conv
        return img


class Generator(nn.Module):
    """z (N, z_dim) -> (N, H, W, C) images in [0, 1]. ``psi`` is the
    truncation the sampler serves with (1: none). The latents are N(0, 1)
    (``normal_latent``) and reach the mapping in fp32 (``fp32_latent``):
    ``forward(z, dtype)`` runs the synthesis in ``dtype``."""

    normal_latent = True
    fp32_latent = True

    def __init__(self, cfg: StyleGAN2Config, *, generator: torch.Generator, device=None):
        super().__init__()
        self.cfg = cfg
        self.mapping = Mapping(cfg, generator=generator, device=device)
        self.synthesis = Synthesis(cfg, generator=generator, device=device)
        self.psi = 1.0

    def forward(self, z: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        with span("sg2.mapping"):
            w = self.mapping(z, self.psi)
        with span("sg2.synthesis"):
            ws = w[:, None].expand(-1, self.cfg.num_ws, -1)
            img = self.synthesis(ws, dtype or z.dtype)
            return ((img + 1.0) * 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)

    @torch.no_grad()
    def set_w_avg(self, z: torch.Tensor) -> None:
        """``w_avg`` <- the mean of the untruncated mapping over ``z``, in fp32."""
        self.mapping.w_avg.copy_(self.mapping(z, 1.0).mean(dim=0))


class DiscriminatorBlock(nn.Module):
    def __init__(self, cfg: StyleGAN2Config, res: int, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        tmp, out = cfg.width(res), cfg.width(res // 2)
        if res == cfg.resolution:
            self.fromrgb = EqualConv2d(cfg.channels, tmp, 1, **kw)
        self.conv0 = EqualConv2d(tmp, tmp, 3, **kw)
        self.conv1 = EqualConv2d(tmp, out, 3, down=2, resolution=res, **kw)
        self.skip = EqualConv2d(tmp, out, 1, bias=False, lrelu=False, down=2, resolution=res, **kw)

    def forward(self, x):
        if hasattr(self, "fromrgb"):
            x = self.fromrgb(x)
        y = self.skip(x, gain=math.sqrt(0.5))
        return y + self.conv1(self.conv0(x), gain=math.sqrt(0.5))


class Epilogue(nn.Module):
    def __init__(self, cfg: StyleGAN2Config, *, generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        c = cfg.width(4)
        self.mbstd = MinibatchStd(cfg.mbstd_group, cfg.mbstd_channels)
        self.conv = EqualConv2d(c + cfg.mbstd_channels, c, 3, **kw)
        self.fc = EqualLinear(c * 16, c, lrelu=True, **kw)
        self.out = EqualLinear(c, 1, **kw)

    def forward(self, x):
        x = self.conv(self.mbstd(x))
        return self.out(self.fc(x.flatten(1)))


class Discriminator(nn.Module):
    """(N, H, W, C) images in [0, 1] -> (N, 1) logits. A logit depends on
    the other faces of its group of ``batch_group`` consecutive faces
    (minibatch stddev), so a batch is split only at multiples of it."""

    def __init__(self, cfg: StyleGAN2Config, *, generator: torch.Generator, device=None):
        super().__init__()
        for res in reversed(cfg.resolutions[1:]):
            self.add_module(f"b{res}", DiscriminatorBlock(cfg, res, generator=generator,
                                                          device=device))
        self.b4 = Epilogue(cfg, generator=generator, device=device)
        self.batch_group = cfg.mbstd_group

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2) * 2.0 - 1.0
        for block in self.children():
            x = block(x)
        return x


def create_stylegan2(cfg: StyleGAN2Config, *, generator: torch.Generator,
                     device=None) -> Tuple[Generator, Discriminator]:
    """G and D with networks.py's init (weights N(0, 1), the mapping's N(0,
    1) / lr multiplier, biases 0, the styles' biases 1, noise strengths 0,
    const input and const noise N(0, 1)), drawn from ``generator``, in eval mode."""
    g = Generator(cfg, generator=generator, device=device)
    d = Discriminator(cfg, generator=generator, device=device)
    return g.eval(), d.eval()


def init_stylegan2(cfg: StyleGAN2Config, generator: torch.Generator, device=None,
                   noise_strength: float = 0.0) -> Tuple[Generator, Discriminator]:
    """``create_stylegan2``, every noise strength set to ``noise_strength``,
    and ``w_avg`` from W_AVG_SAMPLES latents of ``generator``."""
    g, d = create_stylegan2(cfg, generator=generator, device=device)
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, ModulatedConv2d):
                m.noise_strength.fill_(noise_strength)
    g.set_w_avg(randn((W_AVG_SAMPLES, cfg.z_dim), generator, device))
    return g, d


def is_stylegan2(net: nn.Module) -> bool:
    return isinstance(net, (Generator, Discriminator))


def main(argv=None) -> str:
    from facegen_torch.utils import checkpoint as ckpt

    p = argparse.ArgumentParser(description="a StyleGAN2 checkpoint of seeded random weights")
    p.add_argument("--save", type=str, default="logs")
    p.add_argument("--network", type=str, default="stylegan2")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--channelBase", type=int, default=32768, dest="channel_base")
    p.add_argument("--channelMax", type=int, default=512, dest="channel_max")
    p.add_argument("--zDim", type=int, default=512, dest="z_dim")
    p.add_argument("--mappingLayers", type=int, default=8, dest="mapping_layers")
    p.add_argument("--noiseStrength", type=float, default=0.1, dest="noise_strength")
    a = p.parse_args(argv)
    cfg = StyleGAN2Config(resolution=a.resolution, z_dim=a.z_dim, w_dim=a.z_dim,
                          mapping_layers=a.mapping_layers, channel_base=a.channel_base,
                          channel_max=a.channel_max)
    g, d = init_stylegan2(cfg, torch.Generator().manual_seed(a.seed),
                          noise_strength=a.noise_strength)
    path = ckpt.save_stylegan2(a.save, a.network, g, d)
    print(f"wrote {path}: G {sum(t.numel() for t in g.parameters()):,} and D "
          f"{sum(t.numel() for t in d.parameters()):,} parameters")
    return path


if __name__ == "__main__":
    main()
