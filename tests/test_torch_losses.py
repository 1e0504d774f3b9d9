"""generative_audio_torch.losses against generative_audio_tpu.losses on the
CPU: values and gradients in float32 from the same numpy inputs. The two
differ only in the order of float32 sums, so values agree to 1e-5 relative
and gradients to 1e-6 absolute + 1e-4 relative.
"""
import jax
import numpy as np
import pytest
import torch

from generative_audio_tpu import losses as jlosses
from generative_audio_torch import losses as tlosses

torch.set_num_threads(2)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _compare(name, a, b):
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)
    want, want_grads = jax.value_and_grad(jfn, argnums=(0, 1))(a, b)
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    got = tfn(ta, tb)
    got.backward()
    assert got.ndim == 0 and np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for g, w in zip((ta.grad, tb.grad), want_grads):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-4)


@pytest.mark.parametrize("name", ["cirm_mse_loss", "cirm_l1_loss"])
def test_mask_losses_match_jax(name):
    _compare(name, _rand((3, 2, 16, 9), seed=1), _rand((3, 2, 16, 9), seed=2))


@pytest.mark.parametrize("shape", [(4, 400), (3, 2, 8, 21)])
def test_si_snr_matches_jax(shape):
    """On waveforms [B, T] and, as the trainer uses it, on masks [..., T]."""
    _compare("si_snr_loss", _rand(shape, seed=3), _rand(shape, seed=4))


def test_si_snr_silent_reference_row_has_a_finite_gradient():
    """A row of the reference that is exactly silent: the safe norm keeps the
    gradient finite, and equal to the JAX package's."""
    enhanced = _rand((3, 200), seed=5)
    reference = _rand((3, 200), seed=6)
    reference[1] = 0.0
    _compare("si_snr_loss", enhanced, reference)


def test_si_snr_is_scale_invariant_and_signed():
    x = torch.from_numpy(_rand((2, 300), seed=7))
    noise = torch.from_numpy(_rand((2, 300), seed=8, scale=0.1))
    near = tlosses.si_snr_loss(x + noise, x)
    assert near < tlosses.si_snr_loss(x + 10 * noise, x) and near < 0
    torch.testing.assert_close(tlosses.si_snr_loss(3 * (x + noise), x), near,
                               atol=1e-4, rtol=1e-5)
