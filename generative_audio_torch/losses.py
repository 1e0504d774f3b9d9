"""Training objectives of the enhancement line.

Port of generative_audio_tpu/losses.py:34-71 (cirm_mse_loss, cirm_l1_loss,
si_snr_loss), with the reference's eps placements. The masked-MSE and NPPC
objectives wait for their trainers (ROADMAP.md, queue A items 10-11).
"""
from __future__ import annotations

import torch

__all__ = ["cirm_mse_loss", "cirm_l1_loss", "si_snr_loss"]


def cirm_mse_loss(pred_crm: torch.Tensor, gt_cirm: torch.Tensor) -> torch.Tensor:
    """Plain MSE over compressed masks (both [B, 2, F', T])."""
    return torch.mean(torch.square(pred_crm - gt_cirm))


def cirm_l1_loss(pred_crm: torch.Tensor, gt_cirm: torch.Tensor) -> torch.Tensor:
    """L1 over compressed masks, the reference's config-selectable `l1_loss`."""
    return torch.mean(torch.abs(pred_crm - gt_cirm))


def si_snr_loss(enhanced: torch.Tensor, reference: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """Negative mean scale-invariant SNR over the last axis of [..., T]:
    zero-mean both signals, project the enhanced one onto the reference
    (`t`), and return -mean(20*log10(eps + ||t|| / (||x_zm - t|| + eps))).

    As in the JAX package, the norms are sqrt(sum(x^2) + eps^2), so an
    exactly silent reference row (t == 0) has a finite gradient where the
    reference implementation gives NaN."""
    def safe_norm(x):
        return torch.sqrt(torch.sum(torch.square(x), dim=-1) + eps * eps)

    x_zm = enhanced - enhanced.mean(dim=-1, keepdim=True)
    s_zm = reference - reference.mean(dim=-1, keepdim=True)
    dot = torch.sum(x_zm * s_zm, dim=-1, keepdim=True)
    s_energy = torch.sum(torch.square(s_zm), dim=-1, keepdim=True)
    t = dot * s_zm / (s_energy + eps)
    return -torch.mean(20.0 * torch.log10(
        eps + safe_norm(t) / (safe_norm(x_zm - t) + eps)))
