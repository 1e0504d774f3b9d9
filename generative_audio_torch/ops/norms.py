"""Input normalisation. Port of generative_audio_tpu/ops/norms.py:32-35, 185-190.

Only `offline_laplace_norm` (the FullSubNet+ default) is ported so far; the
other six names raise until their slice lands (ROADMAP.md, queue A item 13).
"""
from __future__ import annotations

import torch

__all__ = ["offline_laplace_norm", "get_norm"]

_NOT_PORTED = ("cumulative_laplace_norm", "offline_gaussian_norm",
               "cumulative_layer_norm", "forgetting_norm",
               "sband_forgetting_norm", "hybrid_norm")


def offline_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """x / (mean over (C, F, T) + 1e-5), x: [B, C, F, T]."""
    mu = x.mean(dim=(1, 2, 3), keepdim=True)
    return x / (mu + 1e-5)


def get_norm(norm_type: str):
    if norm_type == "offline_laplace_norm":
        return offline_laplace_norm
    if norm_type in _NOT_PORTED:
        raise NotImplementedError(
            f"norm {norm_type!r} is not ported to generative_audio_torch yet "
            "(ROADMAP.md, queue A item 13)")
    raise NotImplementedError(f"Unknown norm type {norm_type!r}")
