"""The image restoration line: four distortions and the restoration model.

Port of generative_audio_tpu/models/image_restoration.py (reference
nppc/restoration.py): Denoising (noise of `noise_std`, optionally clipped
to [0, 1]), gen_mask + Inpainting (mask == 1 marks the missing region,
filled with `fill`; project = x * mask), Colorization (the channel mean;
project removes the channel mean), SuperResolution (average pool by
`factor`; naive_restore is the nearest upsample; project removes the
pooled-and-upsampled part, the JAX package's repair of the reference's
unbound `x_proj`), pad_to_multiple (the JAX package's general symmetric pad,
not the reference's `height % s`), ImageRestorationWrapper
(naive_restore(x) + project(net((x - offset) / scale) * scale)),
ImageRestorationConfig, build_restoration_net with the reference's fixed
widths, and ImageRestorationModel (data module + distortion + wrapped net).

The distortions and the wrapper are nn.Modules, so that `.to(device)` moves
the inpainting mask with the net. Randomness comes from an explicit
torch.Generator on the tensor's device (the JAX functions take a PRNG key);
`global_rows` (first row, global batch size) draws a rank's rows of the
global batch's noise (parallel.distributed.draw_rows).
Colorization.distort collapses the channel axis, and
ImageRestorationModel.distort adds it back, as the JAX model does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from generative_audio_torch.nn.image_nets import ImageUNet, ResCNN, ResUNet
from generative_audio_torch.parallel.distributed import draw_rows

__all__ = ["Denoising", "Inpainting", "Colorization", "SuperResolution",
           "gen_mask", "make_distortion", "ImageRestorationWrapper",
           "ImageRestorationModel", "ImageRestorationConfig",
           "build_restoration_net", "pad_to_multiple", "unpad_from_multiple"]


def _randn(x: torch.Tensor, generator: Optional[torch.Generator],
           global_rows: Optional[Tuple[int, int]]) -> torch.Tensor:
    """N(0, 1) noise of x's shape; with global_rows = (first row, global
    batch size) the global batch's draw at x's rows, so that the noise does
    not depend on how many ranks share the batch."""
    return draw_rows(lambda shape: torch.randn(
        shape, generator=generator, device=x.device, dtype=x.dtype),
        x.shape, global_rows)


class Denoising(nn.Module):
    """Additive Gaussian noise of `noise_std`, optionally clipped to [0, 1]
    (reference :277)."""

    def __init__(self, noise_std: float, clip_noise: bool = False):
        super().__init__()
        self.noise_std = noise_std
        self.clip_noise = clip_noise

    def distort(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                global_rows: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
        noise = _randn(x, generator, global_rows)
        x_distorted = x + noise * self.noise_std
        if self.clip_noise:
            x_distorted = x_distorted.clamp(0.0, 1.0)
        return x_distorted

    def naive_restore(self, x):
        return x

    def project(self, x):
        return x


def gen_mask(shape: Tuple[int, ...], top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """1 inside rows top..bottom and columns left..right, inclusive
    (reference :304)."""
    mask = torch.zeros(shape, dtype=torch.float32)
    mask[..., top:bottom + 1, left:right + 1] = 1.0
    return mask


class Inpainting(nn.Module):
    """The known region kept and the masked region filled (reference :310);
    mask == 1 marks the MISSING region."""

    def __init__(self, mask: torch.Tensor, fill: float = 0.0):
        super().__init__()
        self.register_buffer("mask", torch.as_tensor(mask, dtype=torch.float32),
                             persistent=False)
        self.fill = fill

    def distort(self, x: torch.Tensor, generator=None,
                global_rows=None) -> torch.Tensor:
        return x * (1 - self.mask) + self.fill * self.mask

    def naive_restore(self, x):
        return x

    def project(self, x):
        return x * self.mask


class Colorization(nn.Module):
    """Grayscale by the channel mean (reference :336)."""

    def distort(self, x: torch.Tensor, generator=None,
                global_rows=None) -> torch.Tensor:
        return x.mean(dim=1)

    def naive_restore(self, x):
        return (x[:, None] if x.ndim == 3 else x).repeat_interleave(3, dim=1)

    def project(self, x):
        return x - x.mean(dim=1, keepdim=True)


class SuperResolution(nn.Module):
    """Average-pool downscale by `factor` (reference :353-382); project
    removes the pooled-then-upsampled part, so the net adds only detail."""

    def __init__(self, factor: int, noise_std: float = 0.0):
        super().__init__()
        self.factor = factor
        self.noise_std = noise_std

    def _avg_pool(self, x):
        return F.avg_pool2d(x, self.factor)

    def _nearest_up(self, x):
        return x.repeat_interleave(self.factor, dim=-2).repeat_interleave(
            self.factor, dim=-1)

    def distort(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                global_rows: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
        x = self._avg_pool(x)
        if self.noise_std > 0 and generator is not None:
            x = x + _randn(x, generator, global_rows) * self.noise_std
        return x

    def naive_restore(self, x):
        return self._nearest_up(x)

    def project(self, x):
        if self.noise_std == 0:
            x = x - self._nearest_up(self._avg_pool(x))
        return x


def make_distortion(distortion_type: str, x_shape: Tuple[int, ...],
                    fill: float = 0.0) -> nn.Module:
    """RestorationModel's dispatch (reference :80-106)."""
    if distortion_type == "denoising_1":
        return Denoising(noise_std=1.0, clip_noise=True)
    if distortion_type == "inpainting_1":
        return Inpainting(gen_mask(x_shape, 0, x_shape[-2] - 9, 0,
                                   x_shape[-1]), fill=fill)
    if distortion_type == "inpainting_2":
        return Inpainting(gen_mask(x_shape, 80, 149, 40, 214), fill=fill)
    if distortion_type == "colorization_1":
        return Colorization()
    if distortion_type == "super_resolution_1":
        return SuperResolution(factor=4)
    raise ValueError(f"Unsupported distortion_type: {distortion_type!r}")


def pad_to_multiple(x: torch.Tensor, base: Optional[int]):
    """Symmetric zero pad of [B, C, H, W] so that H and W divide `base`:
    (padded, pads), pads None where nothing was padded, else (top, bottom,
    left, right)."""
    if base is None:
        return x, None
    h, w = x.shape[-2:]
    ph, pw = (-h) % base, (-w) % base
    if ph == 0 and pw == 0:
        return x, None
    pads = (ph // 2, ph - ph // 2, pw // 2, pw - pw // 2)
    return F.pad(x, (pads[2], pads[3], pads[0], pads[1])), pads


def unpad_from_multiple(x: torch.Tensor, pads) -> torch.Tensor:
    if pads is None:
        return x
    t, b, l, r = pads
    return x[..., t:x.shape[-2] - b, l:x.shape[-1] - r]


class ImageRestorationWrapper(nn.Module):
    """restored = naive_restore(x) + project(net((x - offset) / scale) *
    scale), the net's input padded to `pad_base_size` (reference
    RestorationWrapper :225-270)."""

    def __init__(self, net: nn.Module, distortion: nn.Module,
                 offset: Optional[float] = None, scale: Optional[float] = None,
                 pad_base_size: Optional[int] = None):
        super().__init__()
        self.net = net
        self.distortion = distortion
        self.offset = offset
        self.scale = scale
        self.pad_base_size = pad_base_size

    def _normalize_pad(self, x):
        if self.offset is not None:
            x = x - self.offset
        if self.scale is not None:
            x = x / self.scale
        return pad_to_multiple(x, self.pad_base_size)

    def forward(self, x_distorted: torch.Tensor) -> torch.Tensor:
        x, pads = self._normalize_pad(x_distorted)
        x_restored = unpad_from_multiple(self.net(x), pads)
        if self.scale is not None:
            x_restored = x_restored * self.scale
        return (self.distortion.naive_restore(x_distorted)
                + self.distortion.project(x_restored))


@dataclasses.dataclass(frozen=True)
class ImageRestorationConfig:
    """The reference RestorationModel's constructor arguments (:23-48)."""
    dataset: str = "mnist"
    distortion_type: str = "denoising_1"
    net_type: str = "unet"
    img_size: Optional[int] = None
    loss_type: str = "mse"
    lr: float = 1e-4
    weight_decay: float = 0.0
    random_seed: int = 42


def build_restoration_net(net_type: str, in_channels: int, out_channels: int,
                          upscale_factor: int = 1) -> nn.Module:
    """The restoration net with the reference's widths (:120-159)."""
    if net_type == "unet":
        return ImageUNet(
            in_channels=in_channels, out_channels=out_channels,
            channels_list=(32, 64, 128), bottleneck_channels=256,
            downsample_list=(False, True, True), n_blocks=1,
            n_blocks_bottleneck=2, min_channels_decoder=64,
            upscale_factor=upscale_factor)
    if net_type == "res_unet":
        return ResUNet(
            in_channels=in_channels, out_channels=out_channels,
            channels_list=(64, 64, 128, 128, 256, 256),
            bottleneck_channels=512,
            downsample_list=(False, True, True, True, True, True),
            attn_list=(False, False, False, False, True, False),
            n_blocks=2, n_groups=8, attn_heads=1, min_channels_decoder=1,
            upscale_factor=upscale_factor)
    if net_type == "res_cnn":
        return ResCNN(in_channels=in_channels, out_channels=out_channels,
                      hidden_channels=64, n_blocks=16,
                      upscale_factor=upscale_factor)
    raise ValueError(f"Unsupported net_type: {net_type!r}")


class ImageRestorationModel:
    """Data module + distortion + wrapped net (reference RestorationModel
    :22). `wrapper` is the nn.Module that trains; it is built on the CPU
    with torch's default initialisers, and `to(device)` moves it."""

    def __init__(self, config: ImageRestorationConfig, data_module=None):
        from generative_audio_torch.data.image_data import make_data_module
        self.config = config
        self.data_module = data_module or make_data_module(
            config.dataset, img_size=config.img_size)
        self.x_shape = tuple(self.data_module.shape)        # (C, H, W)
        self.distortion = make_distortion(config.distortion_type,
                                          self.x_shape,
                                          fill=self.data_module.mean)
        x_distorted = self.distort(torch.zeros((1,) + self.x_shape))
        self.x_distorted_shape = tuple(x_distorted.shape[1:])
        self.upscale_factor = self.x_shape[-1] // self.x_distorted_shape[-1]
        self.base_net = build_restoration_net(
            config.net_type, self.x_distorted_shape[0], self.x_shape[0],
            self.upscale_factor)
        self.wrapper = ImageRestorationWrapper(
            self.base_net, self.distortion, offset=self.data_module.mean,
            scale=self.data_module.std,
            pad_base_size=self.base_net.max_scale_factor)

    def to(self, device) -> "ImageRestorationModel":
        self.wrapper.to(device)
        return self

    def distort(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                global_rows: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
        x_distorted = self.distortion.distort(x, generator, global_rows)
        if x_distorted.ndim == 3:    # colorization collapses the channels
            x_distorted = x_distorted[:, None]
        return x_distorted

    def restore(self, x_distorted: torch.Tensor) -> torch.Tensor:
        return self.wrapper(x_distorted)
