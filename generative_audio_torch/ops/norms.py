"""Input normalisation: the seven norms of generative_audio_tpu/ops/norms.py:32-190.

The four 4-D norms take [B, C, F, T]; the forgetting family (forgetting,
sband_forgetting, hybrid) takes [B, F, T], and `get_norm` adapts it to the
models' 4-D inputs by folding C into F (`_as_3d`), as the JAX package does.

The JAX package runs the forgetting family's running mean as a `lax.scan`.
Its recurrence, mu_t = c_t * mu_{t-1} + (1 - c_t) * u_t with mu_{-1} = 0,
has coefficients c_t that depend only on t and the training length L, not
on the data. So here it is one product with a lower-triangular [T, T]
matrix, built in float64 with numpy once per (T, L), rounded to float32 and
cached: one matmul on the device instead of T small launches, differentiated
by autograd. Above `_BLOCK` frames the time axis runs in blocks of that
length, each carrying the last mean of the block before it, so the matrix
stays at most 4 MB. The step-by-step loops (`*_reference`) are the plain
versions the tests hold the products against.

Quirks kept from the reference: forgetting_norm's first step, where
alp = min((0 - 1) / (0 + 1), alpha) = -1 gives mu_0 = 2 * mean(frame_0);
offline_gaussian_norm's Bessel correction (ddof 1); cumulative_layer_norm's
variance written as the JAX code writes it; hybrid_norm's warm-up over
min(L, T) frames; sband_forgetting_norm's middle bin f // 2 - 1.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch

__all__ = ["offline_laplace_norm", "cumulative_laplace_norm",
           "offline_gaussian_norm", "cumulative_layer_norm",
           "forgetting_norm", "sband_forgetting_norm", "hybrid_norm",
           "forgetting_norm_reference", "sband_forgetting_norm_reference",
           "hybrid_norm_reference", "get_norm"]

EPSILON = 1e-8  # audio_zen/constant.py
_BLOCK = 1024   # frames of one forgetting-weights product


def offline_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """x / (mean over (C, F, T) + 1e-5), x: [B, C, F, T]."""
    mu = x.mean(dim=(1, 2, 3), keepdim=True)
    return x / (mu + 1e-5)


def _entry_count(f: int, t: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(f, f * t + 1, f, dtype=like.dtype, device=like.device)


def cumulative_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """Causal running-mean norm over [B, C, F, T]."""
    b, c, f, t = x.shape
    xr = x.reshape(b * c, f, t)
    cumulative_mean = xr.sum(dim=1).cumsum(dim=-1) / _entry_count(f, t, x)
    return (xr / (cumulative_mean[:, None, :] + EPSILON)).reshape(b, c, f, t)


def offline_gaussian_norm(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / (std + 1e-5) over (C, F, T), std with ddof 1."""
    mu = x.mean(dim=(1, 2, 3), keepdim=True)
    std = x.std(dim=(1, 2, 3), keepdim=True, unbiased=True)
    return (x - mu) / (std + 1e-5)


def cumulative_layer_norm(x: torch.Tensor) -> torch.Tensor:
    """Causal zero-mean, unit-variance norm over [B, C, F, T]."""
    b, c, f, t = x.shape
    xr = x.reshape(b * c, f, t)
    cumulative_sum = xr.sum(dim=1).cumsum(dim=-1)
    cumulative_pow_sum = (xr * xr).sum(dim=1).cumsum(dim=-1)
    entry_count = _entry_count(f, t, x)
    cumulative_mean = cumulative_sum / entry_count
    cumulative_var = ((cumulative_pow_sum
                       - 2 * cumulative_mean * cumulative_sum) / entry_count
                      + cumulative_mean * cumulative_mean)
    cumulative_std = torch.sqrt(cumulative_var + EPSILON)
    normed = (xr - cumulative_mean[:, None, :]) / cumulative_std[:, None, :]
    return normed.reshape(b, c, f, t)


def _alpha(length: int) -> float:
    return (length - 1) / (length + 1)


def _coefficients(t0: int, n: int, length: int) -> np.ndarray:
    """c_t of frames t0 .. t0 + n - 1 in float64: min((t - 1) / (t + 1),
    alpha) below the training length, alpha from there on."""
    t = np.arange(t0, t0 + n, dtype=np.float64)
    alpha = _alpha(length)
    return np.where(t < length, np.minimum((t - 1.0) / (t + 1.0), alpha),
                    alpha)


@functools.lru_cache(maxsize=32)
def forgetting_weights(t0: int, n: int, length: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(W [n, n], carry [n]) float32 such that the means of frames t0 ..
    t0 + n - 1 are W @ u + carry * mu_{t0 - 1}: W[t, s] = (1 - c_s) *
    prod_{s < k <= t} c_k, carry[t] = prod_{k <= t} c_k. Built in float64
    row by row (no division by a product, which the c_1 = 0 of the warm-up
    would break). Past the training length the coefficients no longer
    depend on t0, so callers key by min(t0, length)."""
    c = _coefficients(t0, n, length)
    w = np.zeros((n, n), np.float64)
    carry = np.empty(n, np.float64)
    row = np.zeros(n, np.float64)
    prev = 1.0
    for t in range(n):
        row = row * c[t]
        row[t] = 1.0 - c[t]
        w[t] = row
        prev = prev * c[t]
        carry[t] = prev
    return w.astype(np.float32), carry.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _weights_on(t0: int, n: int, length: int, device: torch.device,
                dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    w, carry = forgetting_weights(t0, n, length)
    return (torch.from_numpy(w).to(device=device, dtype=dtype),
            torch.from_numpy(carry).to(device=device, dtype=dtype))


def _running_mean(u: torch.Tensor, length: int) -> torch.Tensor:
    """mu [B, T] of the recurrence over u [B, T] as block products."""
    t_len = u.shape[-1]
    out = []
    mu_prev = None
    for t0 in range(0, t_len, _BLOCK):
        n = min(_BLOCK, t_len - t0)
        w, carry = _weights_on(min(t0, length), n, length, u.device,
                              u.dtype)
        mu = u[:, t0:t0 + n] @ w.t()
        if mu_prev is not None:
            mu = mu + mu_prev[:, None] * carry
        out.append(mu)
        mu_prev = mu[:, -1]
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def _running_mean_reference(u: torch.Tensor, length: int) -> torch.Tensor:
    """The same recurrence step by step, as lax.scan runs it."""
    c = _coefficients(0, u.shape[-1], length)
    mu = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    out = []
    for t in range(u.shape[-1]):
        alp = float(np.float32(c[t]))
        mu = alp * mu + (1.0 - alp) * u[:, t]
        out.append(mu)
    return torch.stack(out, dim=1)


def _check_3d(x: torch.Tensor, name: str) -> None:
    if x.ndim != 3:
        raise ValueError(f"{name} takes [B, F, T], got {tuple(x.shape)}")


def _sband_input(x: torch.Tensor, length: int) -> torch.Tensor:
    """The frame mean during the warm-up, the middle bin after it."""
    t = torch.arange(x.shape[-1], device=x.device)
    return torch.where(t < length, x.mean(dim=1), x[:, x.shape[1] // 2 - 1, :])


def forgetting_norm(x: torch.Tensor,
                    sample_length_in_training: int = 192) -> torch.Tensor:
    """Exponentially smoothed running-mean norm over [B, F, T]."""
    _check_3d(x, "forgetting_norm")
    mu = _running_mean(x.mean(dim=1), sample_length_in_training)
    return x / (mu[:, None, :] + 1e-10)


def sband_forgetting_norm(x: torch.Tensor,
                          train_sample_length: int = 192) -> torch.Tensor:
    """forgetting_norm whose running mean, past the warm-up, follows the
    middle frequency bin (f // 2 - 1) instead of the frame mean."""
    _check_3d(x, "sband_forgetting_norm")
    mu = _running_mean(_sband_input(x, train_sample_length),
                       train_sample_length)
    return x / (mu[:, None, :] + 1e-10)


def _hybrid(x: torch.Tensor, length: int, running_mean) -> torch.Tensor:
    b, f, t = x.shape
    cum_mean = x.sum(dim=1).cumsum(dim=-1) / _entry_count(f, t, x)
    warm = min(length, t)
    initial_mu = running_mean(x[:, :, :warm].mean(dim=1), length)
    cum_mean = torch.cat([initial_mu, cum_mean[:, warm:]], dim=1)
    return x / (cum_mean[:, None, :] + 1e-10)


def hybrid_norm(x: torch.Tensor,
                sample_length_in_training: int = 192) -> torch.Tensor:
    """The forgetting norm's running mean over the first min(L, T) frames,
    the cumulative mean after them."""
    _check_3d(x, "hybrid_norm")
    return _hybrid(x, sample_length_in_training, _running_mean)


def forgetting_norm_reference(x: torch.Tensor,
                              sample_length_in_training: int = 192
                              ) -> torch.Tensor:
    """forgetting_norm with the running mean step by step."""
    mu = _running_mean_reference(x.mean(dim=1), sample_length_in_training)
    return x / (mu[:, None, :] + 1e-10)


def sband_forgetting_norm_reference(x: torch.Tensor,
                                    train_sample_length: int = 192
                                    ) -> torch.Tensor:
    """sband_forgetting_norm with the running mean step by step."""
    mu = _running_mean_reference(_sband_input(x, train_sample_length),
                                 train_sample_length)
    return x / (mu[:, None, :] + 1e-10)


def hybrid_norm_reference(x: torch.Tensor,
                          sample_length_in_training: int = 192
                          ) -> torch.Tensor:
    """hybrid_norm with the running mean step by step."""
    return _hybrid(x, sample_length_in_training, _running_mean_reference)


def _as_3d(norm_fn: Callable) -> Callable:
    """A [B, F, T] norm applied to [B, C, F, T] with C folded into F (the
    frame mean then runs over all C * F entries)."""
    @functools.wraps(norm_fn)
    def wrapped(x, *args, **kwargs):
        if x.ndim == 3:
            return norm_fn(x, *args, **kwargs)
        b, c, f, t = x.shape
        return norm_fn(x.reshape(b, c * f, t), *args, **kwargs).reshape(
            b, c, f, t)
    return wrapped


_NORMS = {
    "offline_laplace_norm": offline_laplace_norm,
    "cumulative_laplace_norm": cumulative_laplace_norm,
    "offline_gaussian_norm": offline_gaussian_norm,
    "cumulative_layer_norm": cumulative_layer_norm,
    "forgetting_norm": _as_3d(forgetting_norm),
    "sband_forgetting_norm": _as_3d(sband_forgetting_norm),
    "hybrid_norm": _as_3d(hybrid_norm),
}


def get_norm(norm_type: str) -> Callable:
    """The norm by its reference name; all seven take [B, C, F, T]."""
    if norm_type not in _NORMS:
        raise NotImplementedError(
            f"Unknown norm type {norm_type!r}; expected one of {list(_NORMS)}")
    return _NORMS[norm_type]
