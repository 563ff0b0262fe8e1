"""Autoencoder and denoiser models (counterpart of facegen/models/ae.py).

- ``create_autoencoder``: the flat grayscale autoencoder of
  train_autoencoder.lua:79-92: flatten -> 512 ReLU -> noiseDim tanh ->
  dropout 0.5 -> 256 ReLU -> input_sz sigmoid -> image.
- The two-stage denoiser of train_denoiser.lua:83-117: AE1 = a
  white-noise encoder (``create_denoiser_encoder``) and a decoder of two
  [3x3 VALID conv to 8 + batch norm + LeakyReLU(1/3)], dropout 0.2,
  Linear 8*(s-4)^2 -> 2048 + batch norm + LeakyReLU, dropout, Linear ->
  input_sz sigmoid (``create_denoiser_decoder``); AE2 = a second decoder
  of the same shape, applied to AE1's output.

Children are named ``{index:02d}_{name}`` like facegen's tree keys
(``01_enc1``, ``08_fc1``), so a state_dict key maps onto facegen's leaf,
and a dropout layer's module name (``06_dropout``) is the index facegen
folds into the decoder's key for it. ``Flatten`` flattens in facegen's
(H, W, C) order: ``fc1``'s (8*(s-4)^2, 2048) weight reads the conv
output as facegen lays it out. Factories return modules in eval mode.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from facegen_torch.nn.init import gaussian_overwrite
from facegen_torch.nn.layers import (
    BatchNorm,
    Conv2d,
    Dense,
    Dropout,
    Flatten,
    LeakyReLU,
    ReLU,
    Reshape,
    Sigmoid,
    Tanh,
    WhiteNoise,
    sequential,
)

DENOISER_CKPT_FMT = "denoiser_{c}x{h}x{w}"  # logs/denoiser_CxHxW.net in the reference
AE_CKPT_NAME = "autoencoder"


def create_autoencoder(scale: int, channels: int, noise_dim: int = 256, *,
                       generator: torch.Generator, device=None) -> nn.Sequential:
    """(N, s, s, C) images in [0, 1] -> their reconstructions; torch's
    default reset drawn from ``generator``."""
    input_sz = scale * scale * channels
    kw = dict(generator=generator, device=device)
    return sequential(
        ("flatten", Flatten()),
        ("enc1", Dense(input_sz, 512, **kw)),
        ("relu", ReLU()),
        ("enc2", Dense(512, noise_dim, **kw)),
        ("tanh", Tanh()),
        ("dropout", Dropout(0.5)),
        ("dec1", Dense(noise_dim, 256, **kw)),
        ("relu", ReLU()),
        ("dec2", Dense(256, input_sz, **kw)),
        ("sigmoid", Sigmoid()),
        ("reshape", Reshape((scale, scale, channels))),
    ).eval()


def create_denoiser_encoder() -> nn.Sequential:
    """AE1's encoder: white noise N(0, 0.1^2) in train mode."""
    return sequential(("white_noise", WhiteNoise(0.0, 0.1))).eval()


def create_denoiser_decoder(scale: int, channels: int, *, generator: torch.Generator,
                            device=None) -> nn.Sequential:
    """(N, s, s, C) -> (N, s, s, C) in [0, 1]; scale > 4."""
    if scale <= 4:
        raise ValueError(f"scale {scale}: the denoiser's two 3x3 VALID convs need scale > 4")
    kw = dict(generator=generator, device=device)
    inner = (scale - 4) * (scale - 4) * 8
    return sequential(
        ("conv1", Conv2d(channels, 8, 3, padding="VALID", **kw)),
        ("batch_norm", BatchNorm(8, device=device)),
        ("leaky_relu", LeakyReLU(1.0 / 3.0)),
        ("conv2", Conv2d(8, 8, 3, padding="VALID", **kw)),
        ("batch_norm", BatchNorm(8, device=device)),
        ("leaky_relu", LeakyReLU(1.0 / 3.0)),
        ("dropout", Dropout(0.2)),
        ("flatten", Flatten()),
        ("fc1", Dense(inner, 2048, **kw)),
        ("batch_norm", BatchNorm(2048, device=device)),
        ("leaky_relu", LeakyReLU(1.0 / 3.0)),
        ("dropout", Dropout(0.2)),
        ("fc_out", Dense(2048, scale * scale * channels, **kw)),
        ("sigmoid", Sigmoid()),
        ("reshape", Reshape((scale, scale, channels))),
    ).eval()


def init_denoiser(generator: torch.Generator, scale: int, channels: int, device=None
                  ) -> Tuple[nn.Sequential, nn.Sequential, nn.Sequential]:
    """(encoder, AE1's decoder, AE2's decoder), both decoders with the
    reference's gaussian overwrite (train_denoiser.lua:108-109), all
    drawn from ``generator``."""
    enc = create_denoiser_encoder()
    dec1 = create_denoiser_decoder(scale, channels, generator=generator, device=device)
    dec2 = create_denoiser_decoder(scale, channels, generator=generator, device=device)
    for dec in (dec1, dec2):
        gaussian_overwrite(dec, generator)
    return enc, dec1, dec2


def set_white_noise(model: nn.Module, draw: torch.Tensor) -> None:
    """Inject the standard-normal draw of the next train-mode forward of
    the model's one WhiteNoise layer."""
    (layer,) = [m for m in model.modules() if isinstance(m, WhiteNoise)]
    layer.draw = draw


def denoiser_ckpt_name(scale: int, channels: int) -> str:
    return DENOISER_CKPT_FMT.format(c=channels, h=scale, w=scale)


def load_denoiser_fn(cfg, device) -> Callable[[torch.Tensor], torch.Tensor]:
    """Load ``<cfg.save>/denoiser_{c}x{h}x{w}/`` and return an image ->
    image function that runs AE1's decoder alone, as train.lua's
    ``--denoise`` does (train.lua:101-110): eval mode, fp32, with TF32
    off (``sample.full_fp32``). A missing checkpoint raises."""
    from facegen_torch.sample import full_fp32
    from facegen_torch.utils import checkpoint as ckpt

    name = denoiser_ckpt_name(cfg.scale, cfg.channels)
    if not ckpt.exists(cfg.save, name):
        raise FileNotFoundError(
            f"--denoise: no denoiser checkpoint {name!r} under {cfg.save!r}; train one with "
            f"`python -m facegen_torch.train_denoiser --scale {cfg.scale}"
            f"{' --grayscale' if cfg.channels == 1 else ''} --save {cfg.save}`")
    _, dec1, dec2 = init_denoiser(torch.Generator().manual_seed(0), cfg.scale, cfg.channels,
                                  device=device)
    ckpt.load_denoiser(cfg.save, name, dec1, dec2)
    dec1.eval()

    @torch.no_grad()
    def denoise(images: torch.Tensor) -> torch.Tensor:
        with full_fp32():
            return dec1(images.to(device, torch.float32))

    return denoise
