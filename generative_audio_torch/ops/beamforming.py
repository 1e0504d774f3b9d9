"""Beamforming ops: cRF filtering, PSD matrices, the beamforming vector.
Port of generative_audio_tpu/ops/beamforming.py:26-73.

The `*_ri` functions take and give (real, imag) pairs, each complex einsum
written as four real ones, as in the JAX package; the complex wrappers take
and give complex64 (the card handles complex dtypes).
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["apply_crf_filter_ri", "get_power_spectral_density_matrix_ri",
           "apply_beamforming_vector_ri", "apply_crf_filter",
           "get_power_spectral_density_matrix", "apply_beamforming_vector"]

Pair = Tuple[torch.Tensor, torch.Tensor]


def _conj_einsum(pattern: str, ar, ai, br, bi) -> Pair:
    """einsum(pattern, conj(a), b) on (real, imag) pairs."""
    rr = torch.einsum(pattern, ar, br)
    ii = torch.einsum(pattern, ai, bi)
    ri = torch.einsum(pattern, ar, bi)
    ir = torch.einsum(pattern, ai, br)
    return rr + ii, ri - ir


def apply_crf_filter_ri(crf: Pair, mix: Pair) -> Pair:
    """conj(cRF) x mix: [B, F, T, D] x [B, C, F, D, T] -> [B, C, F, T]."""
    return _conj_einsum("bftd,bcfdt->bcft", crf[0], crf[1], mix[0], mix[1])


def get_power_spectral_density_matrix_ri(spec: Pair) -> Pair:
    """psd[..., t, c, e] = spec[..., c, t] * conj(spec[..., e, t]):
    [..., F, C, T] -> [..., F, T, C, C]."""
    sr, si = spec
    rr = torch.einsum("...ct,...et->...tce", sr, sr)
    ii = torch.einsum("...ct,...et->...tce", si, si)
    ir = torch.einsum("...ct,...et->...tce", si, sr)
    ri = torch.einsum("...ct,...et->...tce", sr, si)
    return rr + ii, ir - ri


def apply_beamforming_vector_ri(bf: Pair, mix: Pair) -> Pair:
    """conj(w) . x: [B, F, T, C] x [B, F, C, T] -> [B, F, T]."""
    return _conj_einsum("bftc,bfct->bft", bf[0], bf[1], mix[0], mix[1])


def apply_crf_filter(crf: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    return torch.complex(*apply_crf_filter_ri((crf.real, crf.imag),
                                              (mix.real, mix.imag)))


def get_power_spectral_density_matrix(spec: torch.Tensor) -> torch.Tensor:
    return torch.complex(*get_power_spectral_density_matrix_ri(
        (spec.real, spec.imag)))


def apply_beamforming_vector(bf: torch.Tensor,
                             mix: torch.Tensor) -> torch.Tensor:
    return torch.complex(*apply_beamforming_vector_ri((bf.real, bf.imag),
                                                      (mix.real, mix.imag)))
