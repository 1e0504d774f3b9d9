"""FullSubNet (v1), the magnitude-only baseline enhancement model.

Port of generative_audio_tpu/models/fullsubnet.py:22-89: pad look_ahead
frames -> norm -> full-band 2-layer GRU or LSTM over B rows of F features ->
band_unfold of its output and of the noisy magnitude -> concat -> norm ->
drop_band (B > 1) -> sub-band 2-layer GRU or LSTM over B*F rows ->
[B, 2, F, T] compressed cRM, cropped by look_ahead.

Parameter names are the reference checkpoint's (`fb_model.sequence_model.
weight_ih_l0`, ...), so a reference FullSubNet state_dict loads with
`load_state_dict`, and utils/convert.py carries the JAX package's params
across.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from generative_audio_torch.models.fullsubnet_plus import sub_band
from generative_audio_torch.nn.recurrent import SequenceModel
from generative_audio_torch.ops.norms import get_norm
from generative_audio_torch.ops.subband import band_unfold, drop_band
from generative_audio_torch.utils.device import resolve_device

__all__ = ["FullSubNetConfig", "FullSubNet"]


@dataclasses.dataclass(frozen=True)
class FullSubNetConfig:
    """The reference's FullSubNet configuration (fullsubnet.py:12-40)."""
    num_freqs: int = 257
    look_ahead: int = 2
    sequence_model: str = "LSTM"
    fb_num_neighbors: int = 0
    sb_num_neighbors: int = 15
    fb_output_activate_function: str = "ReLU"
    sb_output_activate_function: Optional[str] = None
    fb_model_hidden_size: int = 512
    sb_model_hidden_size: int = 384
    norm_type: str = "offline_laplace_norm"
    num_groups_in_drop_band: int = 2


class FullSubNet(nn.Module):
    """[B, 1, F, T] noisy magnitude -> [B, 2, F, T] compressed cRM.

    device: "cuda" (default; raises when there is no CUDA device) or "cpu".
    compute_dtype: bf16 (the default) or float32, the JAX model's default
    (on the card the recurrent layers' mixed route, nn.recurrent; on the
    CPU the float32 loop). gates_bytes_limit: see nn.recurrent; it applies to the
    full-band and the sub-band model alike. subband_sharding as for
    FullSubNetPlus: it splits the sub-band model's rows, the full-band
    model's B rows stay whole."""

    def __init__(self, config: FullSubNetConfig = FullSubNetConfig(),
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 gates_bytes_limit: Optional[int] = None,
                 subband_sharding=None):
        super().__init__()
        c = config
        if c.sequence_model not in ("GRU", "LSTM"):
            raise ValueError("FullSubNet only supports GRU and LSTM.")
        dev = resolve_device(device)
        self.config = c
        self.compute_dtype = compute_dtype
        self.subband_sharding = subband_sharding
        self.norm = get_norm(c.norm_type)
        fb_w = c.fb_num_neighbors * 2 + 1
        sb_w = c.sb_num_neighbors * 2 + 1
        common = dict(num_layers=2, bidirectional=False,
                      sequence_model=c.sequence_model,
                      compute_dtype=compute_dtype,
                      gates_bytes_limit=gates_bytes_limit, device=dev)
        self.fb_model = SequenceModel(
            c.num_freqs, c.num_freqs, c.fb_model_hidden_size,
            output_activate_function=c.fb_output_activate_function, **common)
        self.sb_model = SequenceModel(
            sb_w + fb_w, 2, c.sb_model_hidden_size,
            output_activate_function=c.sb_output_activate_function, **common)

    def forward(self, noisy_mag: torch.Tensor,
                num_groups: Optional[int] = None,
                global_rows: Optional[Tuple[int, int]] = None,
                subband_sharding=None) -> torch.Tensor:
        """num_groups overrides config.num_groups_in_drop_band for this call
        (1 = full band), on the same parameters. global_rows places the
        batch's rows in a global batch split over ranks, for drop_band
        (ops.subband.drop_band); subband_sharding overrides the module's
        for this call."""
        c = self.config
        if num_groups is None:
            num_groups = c.num_groups_in_drop_band
        if noisy_mag.ndim != 4 or noisy_mag.shape[1] != 1:
            raise ValueError("FullSubNet takes the [B, 1, F, T] magnitude as "
                             f"input, got {tuple(noisy_mag.shape)}")
        noisy_mag = F.pad(noisy_mag, (0, c.look_ahead))
        b, ch, f, t = noisy_mag.shape

        fb_input = self.norm(noisy_mag).reshape(b, ch * f, t)
        fb_output = self.fb_model(fb_input).reshape(b, 1, f, t)

        fb_w = c.fb_num_neighbors * 2 + 1
        sb_w = c.sb_num_neighbors * 2 + 1
        fb_unf = band_unfold(fb_output, c.fb_num_neighbors).reshape(b, f, fb_w, t)
        mag_unf = band_unfold(noisy_mag, c.sb_num_neighbors).reshape(b, f, sb_w, t)
        sb_input = self.norm(torch.cat([mag_unf, fb_unf], dim=2))

        num_freqs = f
        if (b if global_rows is None else global_rows[1]) > 1:
            sb_input = drop_band(sb_input.permute(0, 2, 1, 3),
                                 num_groups=num_groups,
                                 global_rows=global_rows)
            num_freqs = sb_input.shape[2]
            sb_input = sb_input.permute(0, 2, 1, 3)

        sb_input = sb_input.reshape(b * num_freqs, sb_w + fb_w, t)
        sb_mask = sub_band(self.sb_model, sb_input,         # [B*F, 2, T]
                           subband_sharding or self.subband_sharding)
        sb_mask = sb_mask.reshape(b, num_freqs, 2, t)
        return sb_mask.permute(0, 2, 1, 3)[:, :, :, c.look_ahead:]
