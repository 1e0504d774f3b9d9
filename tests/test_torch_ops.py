"""generative_audio_torch.ops against generative_audio_tpu.ops on the CPU.

Inputs come from numpy with a fixed seed and go through both. Everything here
is float32, so the tolerances are float32 ones: 1e-5 absolute for elementwise
maths, and for the STFT pair a relative 1e-4 of the largest value, because
torch.stft (an FFT) and the JAX package (a DFT-basis matmul) sum in a
different order over 512 samples.
"""
import numpy as np
import pytest
import torch

import generative_audio_tpu.ops as jops
from generative_audio_torch import ops

torch.set_num_threads(2)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close_rel(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-6), err


@pytest.mark.parametrize("n_fft,hop,win", [(512, 256, 512), (64, 32, 64),
                                           (512, 128, 400)])
def test_stft_ri_and_prepare_input(n_fft, hop, win):
    wav = _rand((2, 3000), seed=0, scale=0.3)
    r_t, i_t = ops.stft_ri(torch.from_numpy(wav), n_fft, hop, win)
    r_j, i_j = jops.stft_ri(wav, n_fft, hop, win)
    _close_rel(r_t, r_j, 1e-4)
    _close_rel(i_t, i_j, 1e-4)
    got = ops.prepare_input_from_waveform(torch.from_numpy(wav), n_fft, hop, win)
    want = jops.prepare_input_from_waveform(wav, n_fft, hop, win)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close_rel(g, w, 1e-4)


@pytest.mark.parametrize("length", [None, 2500, 3000, 3400])
def test_istft_ri_length_semantics(length):
    """Crop after the centre padding; zero-fill past the end (3400)."""
    n_fft, hop = 64, 32
    re = _rand((2, 33, 90), seed=1)
    im = _rand((2, 33, 90), seed=2)
    got = ops.istft_ri(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop,
                       n_fft, length=length)
    want = jops.istft_ri(re, im, n_fft, hop, n_fft, length=length)
    _close_rel(got, want, 1e-4)


def test_stft_istft_roundtrip():
    wav = _rand((3, 4000), seed=3, scale=0.3)
    r, i = ops.stft_ri(torch.from_numpy(wav), 512, 256, 512)
    back = ops.istft_ri(r, i, 512, 256, 512, length=4000)
    np.testing.assert_allclose(back.numpy(), wav, atol=1e-5)


def test_hann_window_is_periodic():
    np.testing.assert_allclose(ops.hann_window(512).numpy(),
                               np.asarray(jops.hann_window(512)), atol=1e-7)


def test_mask_ops():
    nr, ni, cr, ci = (_rand((2, 9, 7), seed=s) for s in range(4, 8))
    got = ops.build_complex_ideal_ratio_mask_ri(
        *(torch.from_numpy(a) for a in (nr, ni, cr, ci)))
    want = jops.build_complex_ideal_ratio_mask_ri(nr, ni, cr, ci)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    # the -100 clamp of compress and the +/-9.9 saturation of decompress
    m = np.array([-500.0, -100.0, -3.0, 0.0, 2.5, 40.0], np.float32)
    np.testing.assert_allclose(ops.compress_cIRM(torch.from_numpy(m)).numpy(),
                               np.asarray(jops.compress_cIRM(m)), atol=1e-5)
    k = np.array([-12.0, -9.95, -9.9, -1.0, 0.0, 5.0, 9.9, 11.0], np.float32)
    np.testing.assert_allclose(ops.decompress_cIRM(torch.from_numpy(k)).numpy(),
                               np.asarray(jops.decompress_cIRM(k)), atol=1e-5)

    crm = _rand((2, 9, 7, 2), seed=8)
    got_r, got_i = ops.apply_crm(torch.from_numpy(crm), torch.from_numpy(nr),
                                 torch.from_numpy(ni))
    want_r, want_i = jops.apply_crm(crm, nr, ni)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-5)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=1e-5)


def test_offline_laplace_norm_and_get_norm():
    x = np.abs(_rand((3, 2, 9, 11), seed=9))
    got = ops.get_norm("offline_laplace_norm")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jops.offline_laplace_norm(x)),
                               rtol=1e-5)
    for name in ("cumulative_laplace_norm", "forgetting_norm"):
        assert callable(ops.get_norm(name))
    with pytest.raises(NotImplementedError):
        ops.get_norm("bogus")


@pytest.mark.parametrize("n", [0, 1, 3])
def test_band_unfold(n):
    x = _rand((2, 3, 9, 5), seed=10)
    got = ops.band_unfold(torch.from_numpy(x), n)
    want = jops.band_unfold(x, n)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("batch,groups,freqs", [(3, 1, 9), (4, 2, 10),
                                                (5, 2, 9), (7, 3, 11)])
def test_drop_band(batch, groups, freqs):
    x = _rand((batch, 2, freqs, 4), seed=11)
    got = ops.drop_band(torch.from_numpy(x), groups)
    want = jops.drop_band(x, groups)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_drop_band_rejects_small_batch():
    with pytest.raises(ValueError):
        ops.drop_band(torch.zeros(2, 1, 8, 3), 2)
