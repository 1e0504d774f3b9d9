"""The inpainting line's UNets and RestorationWrapper.

Port of generative_audio_tpu/nn/unet.py:32-228 (reference
nppc_audio/inpainting/networks/unet.py and tmp_utils.py), NCHW, with the
reference's state-dict names (generative_audio_tpu/utils/torch_convert.py:
182-221): `inc.conv.{0,1,3,4}`, `down{i}.mpconv.1.conv.*`,
`up{i}.conv.conv.*`, `outc.conv`; UNet2's blocks are `enc{i}` / `dec{i}`
with `conv` and `bn`, the JAX module's names.

On the card the UNets keep their activations channels-last (NHWC in
memory, as the JAX modules transpose to NHWC); the public tensors are
[B, C, F, T], contiguous. cuDNN's TF32 convolutions take NHWC without a
layout copy of the activations, and the bilinear upsample has an NHWC
kernel: in NCHW a UNet step spent a tenth of its device time on cuDNN's
layout copies and a fifth in torch's NCHW bilinear kernel, which loops
over B x C inside each thread. On the CPU they stay NCHW.

As in the JAX modules, `train` and `mc_dropout` are forward arguments; the
module's own train()/eval() mode is never read:
  * train=True: BatchNorm normalises with the batch statistics and updates
    its running statistics as flax does, with momentum 0.9 and the BIASED
    batch variance (torch.nn.BatchNorm2d would take the unbiased one);
    dropout is on.
  * train=False: BatchNorm on its running statistics; dropout only when
    mc_dropout=True (the reference's eval-time enable_dropout).
Dropout is elementwise, as flax's nn.Dropout, scaled by 1/(1-p), and its
masks come from `generator`: a torch.Generator, None for torch's default
generator, or a sequence of P of them for P MC-dropout passes stacked along
the batch. Then each draws the masks of its own 1/P slice, and each
convolution runs slice by slice: cuDNN picks its algorithm by the batch, and
a pass must give the same samples bit for bit whether it runs alone or
stacked with others (everything else of the UNet is per sample).

Under DistributedDataParallel (parallel/mesh.data_parallel) a batch is one
rank's rows of a global batch: `global_rows` = (first row, global batch
size) makes each mask the global batch's mask at those rows, and
sync_batch_norm puts the BatchNorms on the global batch's statistics, so
that a step does not depend on the number of ranks.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed
import torch.nn.functional as F
from torch import nn

from generative_audio_torch.parallel.distributed import (
    all_reduce_sum, draw_rows)

__all__ = ["UNet", "UNet2", "RestorationWrapper", "UNetConfig",
           "resize_align_corners", "batch_norm", "sync_batch_norm",
           "dropout"]

Generators = Union[torch.Generator, Sequence[torch.Generator], None]


def resize_align_corners(x: torch.Tensor, new_hw: Tuple[int, int]
                         ) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] with align_corners=True."""
    return F.interpolate(x, size=tuple(new_hw), mode="bilinear",
                         align_corners=True)


class UNetConfig:
    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 dropout: float = 0.0):
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.dropout = dropout


def sync_batch_norm(module: nn.Module, group) -> nn.Module:
    """Every BatchNorm2d of `module` takes its training statistics over the
    global batch of `group`'s ranks (batch_norm); None takes them over this
    process's batch again."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.process_group = group
    return module


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, train: bool,
               momentum: float = 0.9) -> torch.Tensor:
    """flax nn.BatchNorm(momentum, epsilon=1e-5) on bn's parameters and
    buffers. In training the running variance takes the biased batch
    variance: F.batch_norm updates it with the unbiased one, v_u, so the
    update is taken back by (1 - momentum) * v_u / n (n values a channel),
    where (1 - momentum) * v_u = running_var_new - momentum *
    running_var_old.

    Where sync_batch_norm gave bn a process group of more than one rank,
    training normalises with the statistics of the global batch, as the
    JAX mesh step does: the count, the sum and then the centred sum of
    squares a channel are summed over the ranks, with their gradient."""
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    group = getattr(bn, "process_group", None)
    if group is not None and torch.distributed.get_world_size(group) > 1:
        return _global_batch_norm(bn, x, group, momentum)
    # autograd keeps the variance tensor it was given: update a copy
    new_var = bn.running_var.clone()
    out = F.batch_norm(x, bn.running_mean, new_var, bn.weight, bn.bias, True,
                       1.0 - momentum, bn.eps)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        bn.running_var.copy_(new_var - (new_var - momentum * bn.running_var)
                             / n)
        bn.num_batches_tracked.add_(1)
    return out


def _global_batch_norm(bn, x, group, momentum):
    """batch_norm in training over the global batch of `group`: two passes
    (the mean, then the centred squares), each one all-reduce."""
    dims = (0, 2, 3)
    c = x.shape[1]
    count = torch.full((1,), x.numel() // c, dtype=torch.float32,
                       device=x.device)
    sums = all_reduce_sum(torch.cat([x.float().sum(dims), count]), group)
    n = sums[c]
    mean = sums[:c] / n
    centred = x.float() - mean.view(1, c, 1, 1)
    var = all_reduce_sum(centred.square().sum(dims), group) / n
    out = centred * torch.rsqrt(var + bn.eps).view(1, c, 1, 1)
    out = out * bn.weight.view(1, c, 1, 1) + bn.bias.view(1, c, 1, 1)
    with torch.no_grad():
        bn.running_mean.mul_(momentum).add_(mean.detach(),
                                            alpha=1.0 - momentum)
        bn.running_var.mul_(momentum).add_(var.detach(), alpha=1.0 - momentum)
        bn.num_batches_tracked.add_(1)
    return out.to(x.dtype)


def _parts(generator: Generators) -> int:
    """The passes stacked along the batch: 1 unless a sequence of
    generators is given."""
    return (1 if generator is None or isinstance(generator, torch.Generator)
            else len(generator))


def _layout(x: torch.Tensor) -> torch.Tensor:
    """x channels-last on the card, NCHW-contiguous on the CPU."""
    return x.contiguous(memory_format=torch.channels_last if x.is_cuda
                        else torch.contiguous_format)


def _conv(conv: nn.Conv2d, x: torch.Tensor, parts: int) -> torch.Tensor:
    """conv(x), slice by slice of `parts` equal slices of the batch, in the
    device's layout: a 1-channel input is NCHW and channels-last at once,
    and cuDNN then answers in NCHW."""
    if parts == 1:
        return _layout(conv(x))
    return torch.cat([_layout(conv(s)) for s in x.chunk(parts)])


def _uniform(like: torch.Tensor, generator: Optional[torch.Generator],
             global_rows: Optional[Tuple[int, int]]) -> torch.Tensor:
    """U[0, 1) of like's shape; with global_rows drawn at the global batch's
    shape, in like's memory layout, and sliced to its rows."""
    if global_rows is None:
        return torch.empty_like(like).uniform_(generator=generator)
    layout = (torch.channels_last if like.ndim == 4
              and like.is_contiguous(memory_format=torch.channels_last)
              and not like.is_contiguous() else torch.contiguous_format)
    return draw_rows(
        lambda shape: torch.empty(shape, dtype=like.dtype, device=like.device,
                                  memory_format=layout
                                  ).uniform_(generator=generator),
        like.shape, global_rows)


def dropout(x: torch.Tensor, p: float, generator: Generators,
            global_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Elementwise dropout: keep with probability 1 - p, kept values / (1-p).
    A sequence of generators draws one mask per equal slice of the batch.
    global_rows = (first row, global batch size) draws each mask at the
    global batch's shape and keeps this batch's rows of it (one slice's rows
    per generator), so that the masks do not depend on how many ranks
    share the batch (parallel.distributed.draw_rows)."""
    keep = 1.0 - p
    parts = _parts(generator)
    if parts == 1:
        if not (generator is None or isinstance(generator, torch.Generator)):
            generator = generator[0]
        u = _uniform(x, generator, global_rows)
    else:
        if x.shape[0] % parts:
            raise ValueError(f"batch {x.shape[0]} is not {parts} equal "
                             f"slices, one per generator")
        u = torch.cat([_uniform(s, g, global_rows)
                       for s, g in zip(x.chunk(parts), generator)])
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class DoubleConv(nn.Module):
    """(conv3x3 -> BN -> LeakyReLU(0.2)) x2 [-> dropout]. `conv` holds the
    reference's Sequential (indices 0, 1, 3, 4 carry the weights)."""

    def __init__(self, in_ch: int, out_ch: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.conv = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 3, padding=1), nn.BatchNorm2d(out_ch),
            nn.LeakyReLU(0.2), nn.Conv2d(out_ch, out_ch, 3, padding=1),
            nn.BatchNorm2d(out_ch), nn.LeakyReLU(0.2))

    def forward(self, x, train: bool = True, mc_dropout: bool = False,
                generator: Generators = None, parts: int = 1,
                global_rows: Optional[Tuple[int, int]] = None):
        c = self.conv
        for conv, bn in ((c[0], c[1]), (c[3], c[4])):
            x = F.leaky_relu(batch_norm(bn, _conv(conv, x, parts), train),
                             0.2)
        if self.dropout and (train or mc_dropout):
            x = dropout(x, self.dropout, generator, global_rows)
        return x


class Down(nn.Module):
    """maxpool(2) + DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int, dropout: float = 0.0):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2),
                                    DoubleConv(in_ch, out_ch, dropout))

    def forward(self, x, train: bool = True, mc_dropout: bool = False,
                generator: Generators = None, parts: int = 1,
                global_rows: Optional[Tuple[int, int]] = None):
        return self.mpconv[1](F.max_pool2d(x, 2), train, mc_dropout,
                              generator, parts, global_rows)


class Up(nn.Module):
    """bilinear x2 (align_corners=True) -> pad to the skip -> concat
    [skip, x] -> DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int, dropout: float = 0.0):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch, dropout)

    def forward(self, x1, x2, train: bool = True, mc_dropout: bool = False,
                generator: Generators = None, parts: int = 1,
                global_rows: Optional[Tuple[int, int]] = None):
        x1 = resize_align_corners(x1, (x1.shape[2] * 2, x1.shape[3] * 2))
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2, x1], dim=1), train, mc_dropout,
                         generator, parts, global_rows)


class _OutConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x, parts: int = 1):
        return _conv(self.conv, x, parts)


class UNet(nn.Module):
    """The inpainting UNet: 4 down, 4 up, 64 -> 512 channels, dropout(p) in
    down3, down4, up1 and up2. [B, C, F, T] -> [B, out_channels, F, T]."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.inc = DoubleConv(in_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512, dropout)
        self.down4 = Down(512, 512, dropout)
        self.up1 = Up(1024, 256, dropout)
        self.up2 = Up(512, 128, dropout)
        self.up3 = Up(256, 64)
        self.up4 = Up(128, 64)
        self.outc = _OutConv(64, out_channels)

    def forward(self, x: torch.Tensor, train: bool = True,
                mc_dropout: bool = False, generator: Generators = None,
                global_rows: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
        """global_rows: the rows' place in a global batch split over ranks,
        for the dropout masks (dropout)."""
        parts = _parts(generator)
        md = (train, mc_dropout, generator, parts, global_rows)
        plain = (train, False, None, parts)
        x1 = self.inc(_layout(x), *plain)
        x2 = self.down1(x1, *plain)
        x3 = self.down2(x2, *plain)
        x4 = self.down3(x3, *md)
        x5 = self.down4(x4, *md)
        y = self.up1(x5, x4, *md)
        y = self.up2(y, x3, *md)
        y = self.up3(y, x2, *plain)
        y = self.up4(y, x1, *plain)
        return self.outc(y, parts).contiguous()


class _EncoderBlock(nn.Module):
    """conv (stride 2, same padding) -> BN -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=2,
                              padding=kernel // 2)
        self.bn = nn.BatchNorm2d(out_ch)

    def forward(self, x, train: bool = True):
        return F.relu(batch_norm(self.bn, self.conv(x), train))


class _DecoderBlock(nn.Module):
    """nearest x2 -> concat [x, skip] -> conv -> BN [-> LeakyReLU(0.2)]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 final: bool = False):
        super().__init__()
        self.final = final
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2)
        self.bn = nn.BatchNorm2d(out_ch)

    def forward(self, x, skip, train: bool = True):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = batch_norm(self.bn, self.conv(torch.cat([x, skip], dim=1)), train)
        return x if self.final else F.leaky_relu(x, 0.2)


class UNet2(nn.Module):
    """The stride-2 encoder UNet of the SpeechInpainting paper. It has no
    dropout: mc_dropout, generator and global_rows are taken and change
    nothing, so that
    RestorationWrapper can hold it."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1):
        super().__init__()
        self.enc1 = _EncoderBlock(in_channels, 16, 7)
        self.enc2 = _EncoderBlock(16, 32, 5)
        self.enc3 = _EncoderBlock(32, 64, 5)
        self.enc4 = _EncoderBlock(64, 128, 3)
        self.enc5 = _EncoderBlock(128, 128, 3)
        self.enc6 = _EncoderBlock(128, 128, 3)
        self.dec6 = _DecoderBlock(256, 128, 3)
        self.dec5 = _DecoderBlock(256, 128, 3)
        self.dec4 = _DecoderBlock(192, 64, 3)
        self.dec3 = _DecoderBlock(96, 32, 3)
        self.dec2 = _DecoderBlock(48, 16, 3)
        self.dec1 = _DecoderBlock(16 + in_channels, out_channels, 3,
                                  final=True)

    def forward(self, x: torch.Tensor, train: bool = True,
                mc_dropout: bool = False, generator: Generators = None,
                global_rows: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
        x = _layout(x)
        e1 = self.enc1(x, train)
        e2 = self.enc2(e1, train)
        e3 = self.enc3(e2, train)
        e4 = self.enc4(e3, train)
        e5 = self.enc5(e4, train)
        e6 = self.enc6(e5, train)
        d = self.dec6(e6, e5, train)
        d = self.dec5(d, e4, train)
        d = self.dec4(d, e3, train)
        d = self.dec3(d, e2, train)
        d = self.dec2(d, e1, train)
        return self.dec1(d, x, train).contiguous()


class RestorationWrapper(nn.Module):
    """The net's prediction pasted into the masked (mask == 0) region only;
    the known region keeps the input's first channel. Its parameters are
    under `net.`."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x_in: torch.Tensor, mask: torch.Tensor,
                train: bool = True, mc_dropout: bool = False,
                generator: Optional[Generators] = None,
                global_rows: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
        x = self.net(x_in, train=train, mc_dropout=mc_dropout,
                     generator=generator, global_rows=global_rows)
        mask_b = mask.expand((mask.shape[0], x.shape[1]) + mask.shape[2:])
        known = x_in[:, :1].expand(x.shape) if x_in.shape[1] > 1 else x_in
        return known * mask_b + x * (1 - mask_b)
