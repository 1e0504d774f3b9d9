"""FullSubNet+, the speech-enhancement model of the serving and training paths.

Port of generative_audio_tpu/models/fullsubnet_plus.py:37-173: pad look_ahead
frames -> per-stream (mag/real/imag) norm + channel attention (TSSE, SE,
CBAM or ECA; with subband_num > 1 over the folded stream, see `attend`) ->
three full-band TCN towers -> band_unfold of the tower outputs and of the attended
magnitude -> concat -> norm -> drop_band (B > 1) -> sub-band 2-layer LSTM
over B*F rows -> [B, 2, F, T] compressed cRM, cropped by look_ahead.

MultiDirectionFullSubNetPlus (generative_audio_tpu/models/fullsubnet_plus.py:
176-270) is the denoising-NPPC head on the same skeleton: six streams (the
noisy and the enhanced mag, real and imag), each tower over the two
attended streams side by side (2F channels), and 2 * n_directions outputs.
It takes the same fold for subband_num > 1, which the JAX head has not (its
attention there gets F channels where it was built for F // s + 1).

Parameter names are the reference checkpoint's, so a reference FullSubNet+
state_dict loads with `load_state_dict`, and utils/convert.py carries the
JAX package's params across.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from generative_audio_torch.nn.attention import make_channel_attention
from generative_audio_torch.nn.recurrent import SequenceModel
from generative_audio_torch.ops.norms import get_norm
from generative_audio_torch.ops.subband import band_unfold, drop_band
from generative_audio_torch.utils.device import resolve_device

__all__ = ["FullSubNetPlusConfig", "FullSubNetPlus",
           "MultiDirectionConfig", "MultiDirectionFullSubNetPlus", "attend"]


@dataclasses.dataclass(frozen=True)
class FullSubNetPlusConfig:
    """The reference's FullSubNet+ configuration (fullsubnet_plus.py:18-42)."""
    num_freqs: int = 257
    look_ahead: int = 2
    sequence_model: str = "LSTM"
    sb_num_neighbors: int = 15
    fb_num_neighbors: int = 0
    fb_output_activate_function: str = "ReLU"
    sb_output_activate_function: Optional[str] = None
    fb_model_hidden_size: int = 512
    sb_model_hidden_size: int = 384
    channel_attention_model: str = "TSSE"
    norm_type: str = "offline_laplace_norm"
    num_groups_in_drop_band: int = 1
    output_size: int = 2
    subband_num: int = 1
    kersize: Sequence[int] = (3, 5, 10)

    @property
    def num_channels(self) -> int:
        if self.subband_num == 1:
            return self.num_freqs
        return self.num_freqs // self.subband_num + 1


def attend(y: torch.Tensor, attention: nn.Module,
           subband_num: int) -> torch.Tensor:
    """Channel attention over a normed [B, 1, F, T] stream -> [B, F, T].

    With subband_num s > 1 the stream is folded first
    (generative_audio_tpu/models/fullsubnet_plus.py:94-110): the bins
    f - 1 - pad .. f - 2 are appended in reverse (the last bin is left
    out), pad = s - F % s (s, not 0, when s divides F, as in the
    reference), each s neighbouring bins become one channel of T * s
    frames, [B, (F + pad) / s, T * s]; after the attention the fold is
    undone and the pad cropped."""
    b, ch, f, t = y.shape
    if subband_num == 1:
        return attention(y.reshape(b, ch * f, t))
    pad = subband_num - f % subband_num
    y = torch.cat([y, y[:, :, -1 - pad:-1].flip(2)], dim=2)
    y = attention(y.reshape(b, (f + pad) // subband_num, t * subband_num))
    return y.reshape(b, ch * (f + pad), t)[:, :f]


class FullSubNetPlus(nn.Module):
    """[B, 1, F, T] mag, real, imag -> [B, output_size, F, T] compressed cRM.

    device: "cuda" (default; raises when there is no CUDA device) or "cpu".
    compute_dtype: bf16 for serving (the default, as the JAX CLI and bench
    run it) or float32 (the CPU tests). gates_bytes_limit: see
    nn.recurrent.LSTMLayer."""

    def __init__(self, config: FullSubNetPlusConfig = FullSubNetPlusConfig(),
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 gates_bytes_limit: Optional[int] = None):
        super().__init__()
        c = config
        dev = resolve_device(device)
        self.config = c
        self.compute_dtype = compute_dtype
        self.norm = get_norm(c.norm_type)
        for suffix in ("", "_real", "_imag"):
            self.add_module(f"channel_attention{suffix}", make_channel_attention(
                c.channel_attention_model, c.num_channels, c.kersize,
                c.subband_num, device=dev))
        for suffix in ("", "_real", "_imag"):
            self.add_module(f"fb_model{suffix}", SequenceModel(
                c.num_freqs, c.num_freqs, c.fb_model_hidden_size, num_layers=2,
                sequence_model="TCN",
                output_activate_function=c.fb_output_activate_function,
                compute_dtype=compute_dtype, device=dev))
        fb_w = c.fb_num_neighbors * 2 + 1
        sb_w = c.sb_num_neighbors * 2 + 1
        self.sb_model = SequenceModel(
            sb_w + 3 * fb_w, c.output_size, c.sb_model_hidden_size,
            num_layers=2, sequence_model=c.sequence_model,
            output_activate_function=c.sb_output_activate_function,
            compute_dtype=compute_dtype, gates_bytes_limit=gates_bytes_limit,
            device=dev)

    def forward(self, noisy_mag: torch.Tensor, noisy_real: torch.Tensor,
                noisy_imag: torch.Tensor,
                num_groups: Optional[int] = None,
                global_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """num_groups overrides config.num_groups_in_drop_band for this call
        (1 = full band), on the same parameters. global_rows places the
        batch's rows in a global batch split over ranks, for drop_band
        (ops.subband.drop_band)."""
        c = self.config
        if num_groups is None:
            num_groups = c.num_groups_in_drop_band
        if noisy_mag.ndim != 4 or noisy_mag.shape[1] != 1:
            raise ValueError("FullSubNetPlus takes [B, 1, F, T] inputs, got "
                             f"{tuple(noisy_mag.shape)}")
        pad = (0, c.look_ahead)
        noisy_mag = F.pad(noisy_mag, pad)
        noisy_real = F.pad(noisy_real, pad)
        noisy_imag = F.pad(noisy_imag, pad)
        b, _, f, t = noisy_mag.shape

        fb_input, fbr_input, fbi_input = (
            attend(self.norm(x), attention, c.subband_num) for x, attention in
            ((noisy_mag, self.channel_attention),
             (noisy_real, self.channel_attention_real),
             (noisy_imag, self.channel_attention_imag)))

        fb_output = self.fb_model(fb_input).reshape(b, 1, f, t)
        fbr_output = self.fb_model_real(fbr_input).reshape(b, 1, f, t)
        fbi_output = self.fb_model_imag(fbi_input).reshape(b, 1, f, t)

        fb_w = c.fb_num_neighbors * 2 + 1
        sb_w = c.sb_num_neighbors * 2 + 1
        unfolded = [
            band_unfold(fb_input.reshape(b, 1, f, t),
                        c.sb_num_neighbors).reshape(b, f, sb_w, t),
            *(band_unfold(y, c.fb_num_neighbors).reshape(b, f, fb_w, t)
              for y in (fb_output, fbr_output, fbi_output))]
        sb_input = self.norm(torch.cat(unfolded, dim=2))

        num_freqs = f
        if (b if global_rows is None else global_rows[1]) > 1:
            sb_input = drop_band(sb_input.permute(0, 2, 1, 3),
                                 num_groups=num_groups,
                                 global_rows=global_rows)
            num_freqs = sb_input.shape[2]
            sb_input = sb_input.permute(0, 2, 1, 3)

        sb_input = sb_input.reshape(b * num_freqs, sb_w + 3 * fb_w, t)
        sb_mask = self.sb_model(sb_input)                   # [B*F, out, T]
        sb_mask = sb_mask.reshape(b, num_freqs, c.output_size, t)
        return sb_mask.permute(0, 2, 1, 3)[:, :, :, c.look_ahead:]


@dataclasses.dataclass(frozen=True)
class MultiDirectionConfig(FullSubNetPlusConfig):
    """The head's configuration: output_size is 2 * n_directions, whatever
    the inherited field says."""
    n_directions: int = 4


class MultiDirectionFullSubNetPlus(nn.Module):
    """Six [B, 1, F, T] streams (noisy mag, real, imag, enhanced mag, real,
    imag) -> [B, 2 * n_directions, F', T] (F' = F // G after drop_band when
    B > 1, group-major batch order).

    As in the reference, the sub-band unfold takes the raw padded noisy
    magnitude, not its attended stream as FullSubNetPlus does. device and
    compute_dtype as for FullSubNetPlus."""

    def __init__(self, config: MultiDirectionConfig = MultiDirectionConfig(),
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        c = config
        dev = resolve_device(device)
        self.config = c
        self.compute_dtype = compute_dtype
        self.norm = get_norm(c.norm_type)
        for suffix in ("", "_real", "_imag"):
            self.add_module(f"channel_attention{suffix}", make_channel_attention(
                c.channel_attention_model, c.num_channels, c.kersize,
                c.subband_num, device=dev))
        for suffix in ("", "_real", "_imag"):
            self.add_module(f"fb_model{suffix}", SequenceModel(
                2 * c.num_freqs, c.num_freqs, c.fb_model_hidden_size,
                num_layers=2, sequence_model="TCN",
                output_activate_function=c.fb_output_activate_function,
                compute_dtype=compute_dtype, device=dev))
        fb_w = c.fb_num_neighbors * 2 + 1
        sb_w = c.sb_num_neighbors * 2 + 1
        self.sb_model = SequenceModel(
            sb_w + 3 * fb_w, 2 * c.n_directions, c.sb_model_hidden_size,
            num_layers=2, sequence_model=c.sequence_model,
            output_activate_function=c.sb_output_activate_function,
            compute_dtype=compute_dtype, device=dev)

    def forward(self, noisy_mag: torch.Tensor, noisy_real: torch.Tensor,
                noisy_imag: torch.Tensor, enhanced_mag: torch.Tensor,
                enhanced_real: torch.Tensor,
                enhanced_imag: torch.Tensor,
                global_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """global_rows places the batch's rows in a global batch split over
        ranks, for drop_band (ops.subband.drop_band)."""
        c = self.config
        n_dirs = c.n_directions
        if noisy_mag.ndim != 4 or noisy_mag.shape[1] != 1:
            raise ValueError("MultiDirectionFullSubNetPlus takes [B, 1, F, T] "
                             f"inputs, got {tuple(noisy_mag.shape)}")
        pad = (0, c.look_ahead)
        (noisy_mag, noisy_real, noisy_imag, enhanced_mag, enhanced_real,
         enhanced_imag) = (F.pad(x, pad) for x in (
             noisy_mag, noisy_real, noisy_imag, enhanced_mag, enhanced_real,
             enhanced_imag))
        b, ch, f, t = noisy_mag.shape

        def prep(x, attention):
            return attend(self.norm(x), attention, c.subband_num)

        towers = []
        for tower, attention, noisy, enhanced in (
                (self.fb_model, self.channel_attention, noisy_mag,
                 enhanced_mag),
                (self.fb_model_real, self.channel_attention_real, noisy_real,
                 enhanced_real),
                (self.fb_model_imag, self.channel_attention_imag, noisy_imag,
                 enhanced_imag)):
            fb_input = torch.cat([prep(noisy, attention),
                                  prep(enhanced, attention)], dim=1)
            towers.append(tower(fb_input).reshape(b, 1, f, t))

        fb_w = c.fb_num_neighbors * 2 + 1
        sb_w = c.sb_num_neighbors * 2 + 1
        unfolded = [
            band_unfold(noisy_mag, c.sb_num_neighbors).reshape(b, f, sb_w, t),
            *(band_unfold(y, c.fb_num_neighbors).reshape(b, f, fb_w, t)
              for y in towers)]
        sb_input = self.norm(torch.cat(unfolded, dim=2))

        num_freqs = f
        if (b if global_rows is None else global_rows[1]) > 1:
            sb_input = drop_band(sb_input.permute(0, 2, 1, 3),
                                 num_groups=c.num_groups_in_drop_band,
                                 global_rows=global_rows)
            num_freqs = sb_input.shape[2]
            sb_input = sb_input.permute(0, 2, 1, 3)

        sb_input = sb_input.reshape(b * num_freqs, sb_w + 3 * fb_w, t)
        sb_masks = self.sb_model(sb_input)                 # [B*F, 2K, T]
        sb_masks = sb_masks.reshape(b, num_freqs, n_dirs, 2, t)
        out = sb_masks.permute(0, 2, 3, 1, 4)[..., c.look_ahead:]
        return out.reshape(b, 2 * n_dirs, num_freqs, -1)
