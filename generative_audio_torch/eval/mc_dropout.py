"""The MC-dropout uncertainty baseline: K stochastic UNet passes and a PCA
per batch item.

Port of generative_audio_tpu/eval/mc_dropout.py:26-131 (reference
utils.py:333-648). Each pass draws its dropout masks from a torch.Generator
of its own, so a pass gives the same samples whether it runs alone, in a
chunk of passes stacked along the batch, or with all K at once. The PCA is
the JAX package's: the K x K Gram matrix of the centred samples, its eigh,
and the components V^T = U^T C / S; the samples are zero outside the gap,
so this is the gap's PCA.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

__all__ = ["mc_dropout_inference", "compute_pca_batch",
           "calculate_unet_baseline", "mc_generators"]


def mc_generators(seed: int, n_samples: int, device) -> List[torch.Generator]:
    """One generator a pass on `device`, pass i seeded with seed * n + i."""
    dev = torch.device(device)
    return [torch.Generator(device=dev).manual_seed(seed * n_samples + i)
            for i in range(n_samples)]


def _chunk(n_samples: int, chunk_size: int) -> int:
    """Passes a forward: all of them for chunk_size <= 0, else the largest
    divisor of n_samples up to chunk_size."""
    if chunk_size <= 0 or chunk_size >= n_samples:
        return n_samples
    return next(c for c in range(chunk_size, 0, -1) if n_samples % c == 0)


def mc_dropout_inference(apply_fn: Callable, masked_spec: torch.Tensor,
                         mask: torch.Tensor,
                         generators: Sequence[torch.Generator],
                         chunk_size: int = 0) -> torch.Tensor:
    """K = len(generators) passes with dropout on -> [K, B, 1, F, T].

    apply_fn(x [P*B, ...], mask [P*B, ...], generators (P of them)) -> the P
    stacked passes [P*B, 1, F, T], pass-major (InpaintingNPPCModel.
    mc_restoration). chunk_size > 0 runs the passes P = chunk_size at a time
    (the largest divisor of K up to it), which bounds the live activations;
    chunk_size <= 0 runs all K in one forward."""
    k, b = len(generators), masked_spec.shape[0]
    p = _chunk(k, chunk_size)
    reps = (p,) + (1,) * (masked_spec.ndim - 1)
    x, m = masked_spec.repeat(reps), mask.repeat(reps)
    outs = [apply_fn(x, m, generators[i:i + p]) for i in range(0, k, p)]
    out = torch.cat(outs)
    return out.reshape((k, b) + out.shape[1:])


def compute_pca_batch(outputs: torch.Tensor, n_components: int = 5):
    """PCA per batch item of samples [K, B, D] -> (components [B, n, D],
    unit; scaled components [B, n, D]; importance weights [B, n]; mean
    [B, D]; singular values [B, n]), n = min(n_components, K)."""
    k = outputs.shape[0]
    n_components = min(n_components, k)
    mean = outputs.mean(dim=0)                                  # [B, D]
    centered = (outputs - mean[None]).transpose(0, 1)           # [B, K, D]
    gram = torch.einsum("bkd,bld->bkl", centered, centered)     # [B, K, K]
    evals, evecs = torch.linalg.eigh(gram)                      # ascending
    top = torch.flip(evals[:, -n_components:], dims=[1])        # [B, n]
    vecs = torch.flip(evecs[:, :, -n_components:], dims=[2])    # [B, K, n]
    singular_values = torch.sqrt(torch.clamp(top, min=0.0))
    components = (torch.einsum("bkn,bkd->bnd", vecs, centered)
                  / (singular_values[:, :, None] + 1e-12))
    scaled = components * singular_values[:, :, None]
    importance = singular_values / torch.sum(singular_values, dim=1,
                                             keepdim=True)
    return components, scaled, importance, mean, singular_values


def calculate_unet_baseline(apply_fn: Callable, masked_spec: torch.Tensor,
                            mask: torch.Tensor,
                            generators: Optional[Sequence[torch.Generator]]
                            = None, n_mc_samples: int = 50,
                            n_components: int = 5, mc_chunk_size: int = 0,
                            seed: int = 0) -> Dict[str, torch.Tensor]:
    """The MC-dropout + PCA baseline of masked_spec [B, 1, F, T] and mask
    [B, 1, F, T] (1 = known): the passes of `generators` (default:
    n_mc_samples from mc_generators(seed, ...) on the input's device), then
    the gap's PCA. Returns mean_prediction [B, 1, F, T],
    principal_components and scaled_principal_components [B, n, F, T] (zero
    in the known region), importance_weights and singular_vals [B, n]."""
    if generators is None:
        generators = mc_generators(seed, n_mc_samples, masked_spec.device)
    preds = mc_dropout_inference(apply_fn, masked_spec, mask, generators,
                                 chunk_size=mc_chunk_size)  # [K, B, 1, F, T]
    k, b = preds.shape[:2]
    f, t = masked_spec.shape[2:]
    gap = 1.0 - mask
    preds_flat = (preds[:, :, 0] * gap[None, :, 0]).reshape(k, b, -1)
    components, scaled, importance, mean, svals = compute_pca_batch(
        preds_flat, n_components)
    n = components.shape[1]
    return {
        "mean_prediction": (mean * gap.reshape(b, -1)).reshape(b, 1, f, t),
        "principal_components": components.reshape(b, n, f, t),
        "scaled_principal_components": scaled.reshape(b, n, f, t),
        "importance_weights": importance,
        "singular_vals": svals,
    }
