"""The port's NPPC maths against the JAX package on the CPU: Gram-Schmidt
(real, complex, cRM pairs) and its gradient, the second-moment ramp, the
complex NPPC objective with its log and gradient, and crm_to_stft_components.

Inputs come from numpy with a fixed seed; both sides are float32, so the
tolerances are float32 ones that allow for another order of sums: 1e-5 of
the peak for Gram-Schmidt, 1e-4 of the peak for the gradients, 1e-5
relative for the objective and its log.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu import losses as JL
from generative_audio_tpu.ops import mask as JM
from generative_audio_tpu.ops.gram_schmidt import (
    gram_schmidt as jax_gram_schmidt, gram_schmidt_to_crm as jax_gs_crm,
    gram_schmidt_to_spec_mag as jax_gs_spec_mag)
from generative_audio_torch import losses as TL
from generative_audio_torch import ops as TO

torch.set_num_threads(2)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _peak_close(got, want, share):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=share * np.abs(want).max())


def _complex_dirs(crm):
    """[B, K, 2, F, T] pairs -> complex [B, K, F*T]."""
    b, k = crm.shape[:2]
    return (crm[:, :, 0] + 1j * crm[:, :, 1]).reshape(b, k, -1)


def _reference_convention(x):
    """Gram-Schmidt with the reference implementation's coefficient
    sum(w.conj() * w2): the conjugate on the vector being orthogonalized."""
    out, basis = [], []
    for i in range(x.shape[1]):
        w = x[:, i]
        for w2 in basis:
            w = w - w2 * np.sum(np.conj(w) * w2, axis=-1, keepdims=True)
        basis.append(w / np.linalg.norm(w, axis=-1, keepdims=True))
        out.append(w)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("n_dirs", [2, 3])
def test_gram_schmidt_real_matches_jax(n_dirs):
    x = _rand((4, n_dirs, 40), seed=n_dirs)
    want = jax_gram_schmidt(jnp.asarray(x))
    got = TO.gram_schmidt(torch.from_numpy(x))
    _peak_close(got.numpy(), want, 1e-5)
    spec = x.reshape(4, n_dirs, 5, 8)
    _peak_close(TO.gram_schmidt_to_spec_mag(torch.from_numpy(spec)).numpy(),
                jax_gs_spec_mag(jnp.asarray(spec)), 1e-5)


@pytest.mark.parametrize("n_dirs", [2, 3])
def test_gram_schmidt_to_crm_matches_jax_and_is_orthogonal(n_dirs):
    x = _rand((4, n_dirs, 2, 9, 7), seed=10 + n_dirs)
    want = np.asarray(jax_gs_crm(jnp.asarray(x)))
    got = TO.gram_schmidt_to_crm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    _peak_close(got, want, 1e-5)
    # exact complex orthogonality of the port's directions, and the complex
    # form of gram_schmidt gives the same directions
    w = _complex_dirs(got.astype(np.float64))
    unit = w / np.linalg.norm(w, axis=-1, keepdims=True)
    gram = np.einsum("bkd,bjd->bkj", np.conj(unit), unit)
    off = gram[:, ~np.eye(n_dirs, dtype=bool)]
    assert np.abs(off).max() < 1e-5
    complex_form = TO.gram_schmidt(torch.from_numpy(_complex_dirs(x))).numpy()
    _peak_close(complex_form, _complex_dirs(got), 1e-5)
    # the reference's convention leaves an imaginary overlap, and differs
    ref = _reference_convention(_complex_dirs(x).astype(np.complex128))
    ref_unit = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    ref_gram = np.einsum("bkd,bjd->bkj", np.conj(ref_unit), ref_unit)
    assert np.abs(ref_gram[:, ~np.eye(n_dirs, dtype=bool)]).max() > 1e-2
    assert np.abs(ref - _complex_dirs(got)).max() > 1e-2


def test_gram_schmidt_to_crm_gradient_matches_jax():
    """The basis is detached: a missing detach changes the gradient."""
    x = _rand((3, 3, 2, 6, 5), seed=20)
    weights = _rand((3, 3, 2, 6, 5), seed=21)
    want = jax.grad(lambda v: jnp.sum(jax_gs_crm(v) * weights))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.sum(TO.gram_schmidt_to_crm(xt) * torch.from_numpy(weights)
              ).backward()
    _peak_close(xt.grad.numpy(), want, 1e-4)


@pytest.mark.parametrize("step", [0, 100, 400])
def test_second_moment_lambda_matches_jax(step):
    want = float(JL.second_moment_lambda(jnp.float32(step), 200, 0.1))
    got = TL.second_moment_lambda(step, 200, 0.1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def _objective_inputs(seed):
    w_mat = _rand((4, 3, 2, 8, 6), seed)
    gt = _rand((4, 2, 8, 6), seed + 1)
    pred = gt + _rand((4, 2, 8, 6), seed + 2, 0.3)
    return w_mat, gt, pred


@pytest.mark.parametrize("step", [0, 150, 400])
def test_nppc_objective_complex_matches_jax(step):
    w_mat, gt, pred = _objective_inputs(30 + step)

    def jax_objective(w):
        return JL.nppc_objective_complex(w, gt, pred, jnp.float32(step), 200,
                                         0.1)[1]

    want_rec, want_obj, want_log = JL.nppc_objective_complex(
        jnp.asarray(w_mat), gt, pred, jnp.float32(step), 200, 0.1)
    want_grad = jax.grad(jax_objective)(jnp.asarray(w_mat))
    wt = torch.from_numpy(w_mat).requires_grad_(True)
    rec, obj, log = TL.nppc_objective_complex(
        wt, torch.from_numpy(gt), torch.from_numpy(pred), step, 200, 0.1)
    obj.backward()
    np.testing.assert_allclose(obj.item(), float(want_obj), rtol=1e-5)
    np.testing.assert_allclose(rec.detach().numpy(), want_rec, rtol=1e-5,
                               atol=1e-6)
    assert set(log) == set(want_log)
    for key, value in want_log.items():
        np.testing.assert_allclose(log[key].detach().numpy(), value,
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    _peak_close(wt.grad.numpy(), want_grad, 1e-4)


def test_crm_to_stft_components_matches_jax():
    crm = _rand((2, 9, 7, 2), seed=40)
    nr, ni = _rand((2, 9, 7), seed=41), _rand((2, 9, 7), seed=42)
    want = JM.crm_to_stft_components(jnp.asarray(crm), nr, ni)
    got = TO.crm_to_stft_components(torch.from_numpy(crm),
                                    torch.from_numpy(nr), torch.from_numpy(ni))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
    for g, w in zip(TO.complex_mul(*(torch.from_numpy(a) for a in
                                     (nr, ni, crm[..., 0], crm[..., 1]))),
                    JM.complex_mul(nr, ni, crm[..., 0], crm[..., 1])):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
