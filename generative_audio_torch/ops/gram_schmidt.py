"""Gram-Schmidt orthogonalization of NPPC principal-component directions.

Port of generative_audio_tpu/ops/gram_schmidt.py:24-101. The projection
basis is a detached, normalized copy of each direction; the directions
emitted stay un-normalized and differentiable. Everything runs in float32,
whatever the dtype of the head that made the directions: the inner products
sum over D = 2 * F * T elements (about 10^5 at 3 s), where bf16 sums would
lose the orthogonality.

The complex form takes the coefficient sum(conj(w2) * w), with the conjugate
on the unit basis vector w2, so that <w2, w'> == 0 after the update. The
reference implementation conjugates the other side, which removes only the
real part of the overlap; the JAX package fixed that and the port keeps the
fix.
"""
from __future__ import annotations

import torch

__all__ = ["gram_schmidt", "gram_schmidt_to_spec_mag", "gram_schmidt_to_crm"]


def gram_schmidt(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Sequential Gram-Schmidt over axis 1 of [B, n_dirs, D], real or
    complex -> orthogonal, un-normalized directions of the same shape.
    Gradients flow through each direction, not through the basis."""
    if not x.is_complex():
        x = x.float()
    x_orth, basis = [], []
    for i in range(x.shape[1]):
        w = x[:, i, :]
        for w2 in basis:
            w = w - w2 * torch.sum(torch.conj(w2) * w, dim=-1, keepdim=True)
        w_detached = w.detach()
        norm = torch.linalg.vector_norm(w_detached, dim=-1, keepdim=True) + eps
        basis.append(w_detached / norm)
        x_orth.append(w)
    return torch.stack(x_orth, dim=1)


def gram_schmidt_to_spec_mag(x: torch.Tensor) -> torch.Tensor:
    """Real Gram-Schmidt over flattened [B, n_dirs, F, T] directions."""
    shape = x.shape
    return gram_schmidt(x.reshape(shape[0], shape[1], -1)).reshape(shape)


def gram_schmidt_to_crm(x: torch.Tensor) -> torch.Tensor:
    """Complex Gram-Schmidt over cRM directions [B, n_dirs, 2, F, T] (real,
    imag on axis 2), in real pair arithmetic -> the same shape, float32."""
    b, n_dirs, _, f, t = x.shape
    x = x.float()
    xr = x[:, :, 0].reshape(b, n_dirs, -1)
    xi = x[:, :, 1].reshape(b, n_dirs, -1)
    out_r, out_i, basis = [], [], []
    for i in range(n_dirs):
        wr, wi = xr[:, i, :], xi[:, i, :]
        for pr, pi in basis:
            # inner = sum(conj(w2) * w) = sum((pr - i pi)(wr + i wi))
            inner_r = torch.sum(pr * wr + pi * wi, dim=-1, keepdim=True)
            inner_i = torch.sum(pr * wi - pi * wr, dim=-1, keepdim=True)
            # w <- w - w2 * inner
            wr = wr - (pr * inner_r - pi * inner_i)
            wi = wi - (pr * inner_i + pi * inner_r)
        wr_d, wi_d = wr.detach(), wi.detach()
        norm = torch.sqrt(torch.sum(wr_d ** 2 + wi_d ** 2, dim=-1,
                                    keepdim=True))
        basis.append((wr_d / norm, wi_d / norm))
        out_r.append(wr)
        out_i.append(wi)
    res_r = torch.stack(out_r, dim=1).reshape(b, n_dirs, f, t)
    res_i = torch.stack(out_i, dim=1).reshape(b, n_dirs, f, t)
    return torch.stack([res_r, res_i], dim=2)
