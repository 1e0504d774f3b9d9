"""Image NPPC: the PC-direction wrapper and the model over a frozen
restoration model.

Port of generative_audio_tpu/models/image_nppc.py (reference nppc/nppc.py):
build_pc_net with the reference's widths, ImagePCWrapper (both inputs
normalised; the distorted image through the `res_cnn` pre-net or, without
one, a nearest upsample to the restored image's size; concatenated with the
restored image, padded to the net's scale multiple; the net's output
unflattened into n_dirs directions, each through the distortion's
`project`, then real Gram-Schmidt through ops.gram_schmidt),
ImageNPPCConfig and ImageNPPCModel. The wrapper's modules are `net` and
`pre_net` (None without a pre-net).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from generative_audio_torch.models.image_restoration import (
    ImageRestorationModel, pad_to_multiple, unpad_from_multiple)
from generative_audio_torch.nn.image_nets import ImageUNet, ResCNN, ResUNet
from generative_audio_torch.ops.gram_schmidt import gram_schmidt

__all__ = ["ImagePCWrapper", "ImageNPPCConfig", "ImageNPPCModel",
           "build_pc_net"]


def build_pc_net(net_type: str, in_channels: int,
                 out_channels: int) -> nn.Module:
    """The PC net with the reference's widths (nppc.py:92-129)."""
    if net_type == "unet":
        return ImageUNet(
            in_channels=in_channels, out_channels=out_channels,
            channels_list=(32, 64, 128), bottleneck_channels=256,
            downsample_list=(False, True, True), n_blocks=1,
            n_blocks_bottleneck=2, min_channels_decoder=64)
    if net_type == "res_unet":
        return ResUNet(
            in_channels=in_channels, out_channels=out_channels,
            channels_list=(64, 64, 128, 128, 256, 256),
            bottleneck_channels=512,
            downsample_list=(False, True, True, True, True, True),
            attn_list=(False, False, False, False, True, False),
            n_blocks=2, n_groups=8, attn_heads=1)
    raise ValueError(f"Unsupported net_type: {net_type!r}")


class ImagePCWrapper(nn.Module):
    """w_mat = gram_schmidt(project(unflatten(net(cat(pre(x_distorted),
    x_restored))))) (reference PCWrapper, nppc.py:208-285): [B, n_dirs, C,
    H, W]."""

    def __init__(self, net: nn.Module, n_dirs: int,
                 pre_net: Optional[nn.Module] = None,
                 offset: Optional[float] = None,
                 scale: Optional[float] = None,
                 project_func: Optional[Callable] = None,
                 pad_base_size: Optional[int] = None,
                 pre_pad_base_size: Optional[int] = None,
                 pre_upscale: int = 1):
        super().__init__()
        self.net = net
        self.pre_net = pre_net
        self.n_dirs = n_dirs
        self.offset = offset
        self.scale = scale
        self.project_func = project_func
        self.pad_base_size = pad_base_size
        self.pre_pad_base_size = pre_pad_base_size
        self.pre_upscale = pre_upscale   # the nearest upsample without pre_net

    def _norm(self, x):
        if self.offset is not None:
            x = x - self.offset
        if self.scale is not None:
            x = x / self.scale
        return x

    def _features(self, x_distorted, x_restored):
        x_distorted = self._norm(x_distorted)
        x_restored = self._norm(x_restored)
        if self.pre_net is None:
            x = x_distorted
            if self.pre_upscale != 1:
                x = x.repeat_interleave(self.pre_upscale, dim=-2
                                        ).repeat_interleave(self.pre_upscale,
                                                            dim=-1)
        else:
            x_p, pads = pad_to_multiple(x_distorted, self.pre_pad_base_size)
            x = unpad_from_multiple(self.pre_net(x_p), pads)
        x = torch.cat([x, x_restored], dim=1)
        return pad_to_multiple(x, self.pad_base_size)

    def forward(self, x_distorted: torch.Tensor,
                x_restored: torch.Tensor) -> torch.Tensor:
        x, pads = self._features(x_distorted, x_restored)
        w_mat = self.net(x)
        if self.scale is not None:
            w_mat = w_mat * self.scale
        w_mat = unpad_from_multiple(w_mat, pads)
        b = w_mat.shape[0]
        w_mat = w_mat.reshape(b, self.n_dirs, -1, *w_mat.shape[2:])
        if self.project_func is not None:
            flat = self.project_func(w_mat.flatten(0, 1))
            w_mat = flat.reshape((b, self.n_dirs) + flat.shape[1:])
        shape = w_mat.shape
        return gram_schmidt(w_mat.reshape(b, self.n_dirs, -1)).reshape(shape)


@dataclasses.dataclass(frozen=True)
class ImageNPPCConfig:
    """The reference NPPCModel's constructor arguments (nppc.py:23-47)."""
    net_type: str = "unet"
    pre_net_type: str = "none"
    n_dirs: int = 5
    lr: float = 1e-4
    second_moment_loss_lambda: float = 1e-1
    second_moment_loss_grace: int = 200
    weight_decay: float = 0.0
    random_seed: int = 42


class ImageNPPCModel:
    """The PC wrapper over a frozen restoration model (nppc.py:21-186).
    `wrapper` is the nn.Module that trains, built on the CPU; `to(device)`
    moves it."""

    def __init__(self, config: ImageNPPCConfig,
                 restoration_model: ImageRestorationModel):
        self.config = config
        self.n_dirs = config.n_dirs
        self.restoration_model = restoration_model
        self.data_module = restoration_model.data_module
        self.x_shape = restoration_model.x_shape
        self.x_distorted_shape = restoration_model.x_distorted_shape
        upscale = self.x_shape[-1] // self.x_distorted_shape[-1]
        if config.pre_net_type == "none":
            pre_net = None
            pre_out_channels = self.x_distorted_shape[0]
        elif config.pre_net_type == "res_cnn":
            pre_out_channels = 64
            pre_net = ResCNN(in_channels=self.x_distorted_shape[0],
                             out_channels=pre_out_channels,
                             hidden_channels=64, n_blocks=16,
                             upscale_factor=upscale)
        else:
            raise ValueError(
                f"Unsupported pre_net_type: {config.pre_net_type!r}")
        net = build_pc_net(config.net_type, pre_out_channels + self.x_shape[0],
                           self.x_shape[0] * config.n_dirs)
        self.wrapper = ImagePCWrapper(
            net, config.n_dirs, pre_net=pre_net,
            offset=self.data_module.mean, scale=self.data_module.std,
            project_func=restoration_model.distortion.project,
            pad_base_size=net.max_scale_factor,
            pre_pad_base_size=(pre_net.max_scale_factor
                               if pre_net is not None else None),
            pre_upscale=upscale if pre_net is None else 1)

    def to(self, device) -> "ImageNPPCModel":
        self.wrapper.to(device)
        return self

    def get_dirs(self, x_distorted: torch.Tensor,
                 x_restored: torch.Tensor) -> torch.Tensor:
        """[B, n_dirs, C, H, W] PC directions."""
        return self.wrapper(x_distorted, x_restored)
