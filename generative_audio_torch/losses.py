"""Training objectives of the enhancement and denoising-NPPC lines.

Port of generative_audio_tpu/losses.py:34-71 (cirm_mse_loss, cirm_l1_loss,
si_snr_loss), with the reference's eps placements, and :85-89, :180-221
(second_moment_lambda, nppc_objective_complex: the denoising line's NPPC
objective in cRM space) and :74-178 (masked_mse_loss, nppc_objective_real,
nppc_objective_mc_aligned: the inpainting line's restoration loss and its
two NPPC objectives).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed

__all__ = ["cirm_mse_loss", "cirm_l1_loss", "si_snr_loss", "masked_mse_loss",
           "second_moment_lambda", "nppc_objective_real",
           "nppc_objective_mc_aligned", "nppc_objective_complex"]


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


def masked_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                    mask: torch.Tensor, group=None) -> torch.Tensor:
    """MSE over the gap (mask == 0 is the inpainted region). The divisor is
    max(sum(gap), 1), so a batch without a gap gives 0, not NaN.

    With a process group of W > 1 ranks (DistributedDataParallel's) the
    batch is one rank's rows of a global batch: the divisor is the global
    gap count (all-reduced) and the result W times this rank's share of the
    global MSE, so that the mean over the ranks, which DDP takes of the
    gradient, is the global batch's MSE and its gradient."""
    gap = 1.0 - mask
    count = torch.sum(gap)
    scale = 1
    if group is not None:
        from generative_audio_torch.parallel.distributed import (
            all_reduce_sum)
        scale = torch.distributed.get_world_size(group)
        count = all_reduce_sum(count.detach(), group)
    return (torch.sum(torch.square(pred - target) * gap) * scale
            / torch.clamp(count, min=1.0))


def second_moment_lambda(step, grace: int,
                         scale: float = 1.0) -> torch.Tensor:
    """The second-moment weight: -1 + 2 * step / grace, clamped to
    [1e-6, 1], times scale (a 0-d float32 tensor)."""
    lam = -1.0 + 2.0 * torch.as_tensor(step, dtype=torch.float32) / grace
    return torch.clamp(lam, 1e-6, 1.0) * scale


def nppc_objective_real(w_mat: torch.Tensor, err: torch.Tensor, step,
                        grace: int, lambda_scale: float = 1.0,
                        eps: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """The inpainting line's NPPC objective.

    w_mat [B, n_dirs, ...] directions after Gram-Schmidt; err [B, ...] the
    restoration error (clean - the frozen prediction); step: the optimizer's
    step, for the lambda ramp. Returns (reconst_err [B], the objective, a log
    dict)."""
    b, n_dirs = w_mat.shape[:2]
    w_flat = w_mat.reshape(b, n_dirs, -1)
    w_norms = torch.linalg.vector_norm(w_flat, dim=2) + eps    # [B, n_dirs]
    w_hat = w_flat / w_norms[:, :, None]

    e = err.reshape(b, -1)
    err_norm = torch.linalg.vector_norm(e, dim=1) + eps        # [B]
    e = e / err_norm[:, None]
    w_norms = w_norms / err_norm[:, None]

    err_proj = torch.einsum("bki,bi->bk", w_hat, e)            # [B, n_dirs]
    reconst_err = 1.0 - torch.sum(torch.square(err_proj), dim=1)
    second_moment_mse = torch.square(
        torch.square(w_norms) - torch.square(err_proj).detach())
    lam = second_moment_lambda(step, grace, lambda_scale).to(w_mat.device)
    objective = torch.mean(reconst_err) + lam * torch.mean(second_moment_mse)
    log = {"err_proj": err_proj, "w_norms": w_norms,
           "reconst_err": reconst_err,
           "second_moment_mse": second_moment_mse,
           "second_moment_lambda": lam}
    return reconst_err, objective, log


def nppc_objective_mc_aligned(w_mat: torch.Tensor, w_mc_scaled: torch.Tensor,
                              singular_values: torch.Tensor, step,
                              grace: int, lambda_scale: float = 1.0,
                              eps: float = 1e-6
                              ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """The MC-PCA-aligned NPPC objective: direction i is aligned to the i-th
    MC-dropout PCA direction (reconst_err_i = 1 - <w_hat_i, w_mc_hat_i>^2),
    and its squared norm is drawn to that direction's squared singular value.

    w_mat [B, n_dirs, ...]; w_mc_scaled [B, n_dirs, ...] the PCA directions
    scaled by their singular values; singular_values [B, n_dirs]. Both MC
    inputs are fixed targets (detached). Returns (reconst_err [B], its mean
    over the directions; the objective; a log dict)."""
    b, n_dirs = w_mat.shape[:2]
    w_flat = w_mat.reshape(b, n_dirs, -1)
    w_norms = torch.linalg.vector_norm(w_flat, dim=2) + eps    # [B, n_dirs]
    w_hat = w_flat / w_norms[:, :, None]

    w_mc = w_mc_scaled.detach().reshape(b, n_dirs, -1)
    mc_norms = torch.linalg.vector_norm(w_mc, dim=2) + eps
    w_mc_hat = w_mc / mc_norms[:, :, None]
    svals = singular_values.detach()

    proj = torch.sum(w_hat * w_mc_hat, dim=2)                  # [B, n_dirs]
    reconst_err = torch.mean(1.0 - torch.square(proj), dim=1)  # [B]
    second_moment_mse = torch.mean(
        torch.square(torch.square(w_norms) - torch.square(svals)), dim=1)
    lam = second_moment_lambda(step, grace, lambda_scale).to(w_mat.device)
    objective = torch.mean(reconst_err) + lam * torch.mean(second_moment_mse)
    log = {"proj_w_mc_on_w_nppc": proj, "w_norms": w_norms,
           "reconst_err": reconst_err,
           "second_moment_mse": second_moment_mse,
           "second_moment_lambda": lam}
    return reconst_err, objective, log


def nppc_objective_complex(w_mat: torch.Tensor, gt_crm: torch.Tensor,
                           pred_crm: torch.Tensor, step, grace: int,
                           lambda_scale: float = 1.0, eps: float = 1e-8
                           ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """The denoising line's NPPC objective, complex maths in real pairs.

    w_mat [B, n_dirs, 2, F, T] cRM directions; gt_crm, pred_crm
    [B, 2, F, T] compressed masks (after drop_band); step: the optimizer's
    step, for the lambda ramp. Returns (reconst_err [B], the objective, a
    log dict). Every sum is in float32."""
    w_mat, gt_crm, pred_crm = w_mat.float(), gt_crm.float(), pred_crm.float()
    b, n_dirs = w_mat.shape[:2]
    w_flat = w_mat.reshape(b, n_dirs, 2, -1)                   # [B, K, 2, D]
    w_norms = torch.sqrt(torch.sum(torch.square(w_flat), dim=(2, 3)))
    w_hat = w_flat / (w_norms[:, :, None, None] + eps)

    err = (gt_crm - pred_crm).reshape(b, 2, -1)                # [B, 2, D]
    err_norm = torch.sqrt(torch.sum(torch.square(err), dim=(1, 2)))
    err = err / (err_norm[:, None, None] + eps)
    w_norms = w_norms / (err_norm[:, None] + eps)

    # err_proj = sum(conj(w_hat) * err) over D:
    # (wr - i wi)(er + i ei) = (wr er + wi ei) + i (wr ei - wi er)
    wr, wi = w_hat[:, :, 0], w_hat[:, :, 1]                    # [B, K, D]
    er, ei = err[:, 0][:, None], err[:, 1][:, None]            # [B, 1, D]
    proj_r = torch.sum(wr * er + wi * ei, dim=-1)              # [B, K]
    proj_i = torch.sum(wr * ei - wi * er, dim=-1)
    err_proj_mag = torch.sqrt(proj_r ** 2 + proj_i ** 2)

    reconst_err = 1.0 - torch.sum(torch.square(err_proj_mag), dim=1)
    second_moment_mse = torch.square(
        torch.square(w_norms) - torch.square(err_proj_mag).detach())
    lam = second_moment_lambda(step, grace, lambda_scale).to(w_mat.device)
    objective = torch.mean(reconst_err) + lam * torch.mean(second_moment_mse)
    log = {"err_proj_mag": err_proj_mag, "w_norms": w_norms,
           "reconst_err": reconst_err,
           "second_moment_mse": second_moment_mse,
           "second_moment_lambda": lam}
    return reconst_err, objective, log
