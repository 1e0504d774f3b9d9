"""Sub-band unfolding and drop_band. Port of generative_audio_tpu/ops/subband.py."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["band_unfold", "drop_band"]


def band_unfold(x: torch.Tensor, num_neighbors: int) -> torch.Tensor:
    """[B, C, F, T] -> [B, F, C, 2n+1, T]: every (2n+1)-wide window along F,
    reflect-padded by n at both ends."""
    if x.ndim != 4:
        raise ValueError(f"expected [B, C, F, T], got {tuple(x.shape)}")
    b, c, f, t = x.shape
    if num_neighbors < 1:
        return x.permute(0, 2, 1, 3).reshape(b, f, c, 1, t)
    n = num_neighbors
    padded = F.pad(x, (0, 0, n, n), mode="reflect")
    windows = padded.unfold(2, 2 * n + 1, 1)          # [B, C, F, T, 2n+1]
    return windows.permute(0, 2, 1, 4, 3)             # [B, F, C, 2n+1, T]


def drop_band(x: torch.Tensor, num_groups: int = 2,
              global_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """[B, C, F, T] -> [B, C, F // G, T]: sample group g (samples g, g+G, ...)
    keeps frequencies g, g+G, ...; the output batch is group-major.

    global_rows = (first row, global batch size) places x's rows in a
    global batch split over ranks (parallel.mesh.place_rows): a row's group
    is its index in the global batch, and the check that the batch is
    larger than G is taken on the global batch. Each rank's result is then
    the global batch's result at that rank's rows, in the same order."""
    first, batch_size = (0, x.shape[0]) if global_rows is None \
        else global_rows
    num_freqs = x.shape[2]
    if batch_size <= num_groups:
        raise ValueError(
            f"Batch size = {batch_size}, num_groups = {num_groups}. The batch "
            "size should be larger than the number of groups.")
    if num_groups <= 1:
        return x
    if num_freqs % num_groups != 0:
        x = x[:, :, :num_freqs - (num_freqs % num_groups), :]
    parts = [x[(g - first) % num_groups::num_groups, :, g::num_groups, :]
             for g in range(num_groups)]
    return torch.cat(parts, dim=0)
