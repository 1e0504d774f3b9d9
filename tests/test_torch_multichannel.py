"""generative_audio_torch's conv-STFT, multichannel features, beamforming and
the complex STFT and mask helpers against generative_audio_tpu's, on the
CPU.

Inputs come from numpy with a fixed seed. Float32 (complex64) on both sides;
the port's STFT is torch.stft (an FFT) where the JAX package multiplies by a
DFT basis, so spectra agree to 2e-5 of their peak and everything else to
2e-5 absolute plus 1e-4 relative. The LPS feature, log |X|^2, carries the
relative error of a bin's power as an absolute one: 2e-4 (measured 6.6e-5 at
the Nyquist bin, where the power is smallest).
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from generative_audio_tpu.ops import beamforming as jb
from generative_audio_tpu.ops import mask as jmask
from generative_audio_tpu.ops import multichannel as jmc
from generative_audio_torch import ops

# the package exports functions of these names, which hide the modules
jc = importlib.import_module("generative_audio_tpu.ops.conv_stft")
jstft = importlib.import_module("generative_audio_tpu.ops.stft")

torch.set_num_threads(2)
ATOL, RTOL = 2e-5, 1e-4
SPEC_REL = 2e-5
LPS_ATOL = 2e-4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _crand(shape, seed):
    return (_rand(shape, seed) + 1j * _rand(shape, seed + 100)
            ).astype(np.complex64)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("frame_len,hop,num_fft", [(320, 160, None),
                                                   (256, 64, 256)])
def test_conv_stft_and_istft_match_jax(frame_len, hop, num_fft):
    np.testing.assert_array_equal(
        ops.conv_stft_kernel(frame_len, hop, num_fft),
        jc.conv_stft_kernel(frame_len, hop, num_fft))
    x = _rand((2, 4000), seed=1)
    got = ops.conv_stft(torch.from_numpy(x), frame_len, hop, num_fft)
    want = jc.conv_stft(x, frame_len, hop, num_fft)
    for name, g, w in zip(("mag", "phase", "real", "imag"), got, want):
        assert g.shape == w.shape, name
        if name != "phase":             # atan2 of near-zero bins is noise
            assert _rel(g, w) < SPEC_REL, name
    mag, phase = (np.array(a) for a in want[:2])
    wav = ops.conv_istft(torch.from_numpy(mag), torch.from_numpy(phase),
                         frame_len, hop, num_fft)
    _close(wav, jc.conv_istft(mag, phase, frame_len, hop, num_fft),
           atol=1e-4 * np.abs(x).max())
    assert ops.conv_stft(torch.from_numpy(x[0]), frame_len, hop,
                         num_fft)[0].shape[0] == 1


def test_ipd_matches_jax_and_phase_differences():
    real, imag = _rand((2, 4, 9, 7), seed=2), _rand((2, 4, 9, 7), seed=3)
    left, right = [0, 1, 2], [3, 3, 0]
    got = ops.compute_ipd(torch.from_numpy(real), torch.from_numpy(imag),
                          left, right)
    want = jmc.compute_ipd(real, imag, left, right)
    for g, w in zip(got, want):
        _close(g, w)
    phase = np.arctan2(imag, real)
    np.testing.assert_allclose(got[0].numpy(),
                               np.cos(phase[:, left] - phase[:, right]),
                               atol=1e-5)


@pytest.mark.parametrize("features,sin", [(("LPS", "IPD"), False),
                                          (("LPS", "IPD"), True),
                                          (("IPD",), False)])
def test_directional_features_match_jax(features, sin):
    y = _rand((2, 3, 2400), seed=4)
    kw = dict(n_fft=256, win_length=256, hop_length=128,
              input_features=features, mic_pairs=[(0, 1), (0, 2)],
              lps_channel=1, use_sin_IPD=sin)
    jm = jmc.DirectionalFeatureComputer(**kw)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), y)
    want = jax.jit(jm.apply)(variables, y)
    tm = ops.DirectionalFeatureComputer(**kw, device="cpu")
    if "LPS" in features:
        ln = variables["params"]["lps_layer_norm"]["ln"]
        rng = np.random.default_rng(5)   # move them off (1, 0)
        tm.lps_layer_norm.load_state_dict({
            "weight": torch.from_numpy(np.asarray(ln["scale"])
                                       + rng.uniform(-.5, .5, 129)
                                       .astype(np.float32)),
            "bias": torch.from_numpy(rng.uniform(-.5, .5, 129)
                                     .astype(np.float32))})
        variables = {"params": {"lps_layer_norm": {"ln": {
            "scale": tm.lps_layer_norm.weight.detach().numpy(),
            "bias": tm.lps_layer_norm.bias.detach().numpy()}}}}
        want = jax.jit(jm.apply)(variables, y)
    with torch.no_grad():
        got = tm(torch.from_numpy(y))
    assert tm.directional_feature_dim == jm.directional_feature_dim
    assert got[0].shape == (2, tm.directional_feature_dim, got[1].shape[-1])
    _close(got[0], want[0], atol=LPS_ATOL)
    for g, w in zip(got[2:], want[2:]):
        assert _rel(g, w) < SPEC_REL

    cm = jmc.ChannelDirectionalFeatureComputer(**kw)
    want_c = cm.apply({}, y)
    got_c = ops.ChannelDirectionalFeatureComputer(**kw)(torch.from_numpy(y))
    assert got_c[0].shape == want_c[0].shape
    _close(got_c[0], want_c[0], atol=LPS_ATOL)


def test_channel_wise_layer_norm_uses_flax_epsilon():
    ln = ops.ChannelWiseLayerNorm(7)
    assert ln.eps == 1e-5
    x = _rand((2, 7, 5), seed=6)
    want = jmc.ChannelWiseLayerNorm(7).apply(
        {"params": {"ln": {"scale": np.ones(7, np.float32),
                           "bias": np.zeros(7, np.float32)}}}, x)
    with torch.no_grad():
        _close(ln(torch.from_numpy(x)), want)


def test_beamforming_matches_jax():
    crf, mix = _crand((2, 5, 6, 3), seed=7), _crand((2, 4, 5, 3, 6), seed=8)
    spec = _crand((2, 5, 4, 6), seed=9)
    bf, mix2 = _crand((2, 5, 6, 4), seed=10), _crand((2, 5, 4, 6), seed=11)
    cases = [(ops.apply_crf_filter, jb.apply_crf_filter, (crf, mix)),
             (ops.get_power_spectral_density_matrix,
              jb.get_power_spectral_density_matrix, (spec,)),
             (ops.apply_beamforming_vector, jb.apply_beamforming_vector,
              (bf, mix2))]
    for fn, jfn, args in cases:
        got = fn(*(torch.from_numpy(a) for a in args))
        want = np.asarray(jfn(*args))
        assert got.dtype == torch.complex64 and got.shape == want.shape
        _close(got, want)
        pair = getattr(ops, fn.__name__ + "_ri")(
            *((torch.from_numpy(a.real.copy()), torch.from_numpy(a.imag.copy()))
              for a in args))
        _close(pair[0], want.real)
        _close(pair[1], want.imag)


def test_complex_stft_helpers_match_jax():
    y = _rand((2, 3, 3000), seed=12)
    spec = ops.mc_stft(torch.from_numpy(y), 256, 128)
    want = jstft.mc_stft(y, 256, 128)
    assert spec.dtype == torch.complex64 and spec.shape == want.shape
    assert _rel(spec.numpy(), want) < SPEC_REL
    # the port's one route against both of the JAX function's methods
    for method in ("matmul", "fft"):
        assert _rel(ops.stft(torch.from_numpy(y[0]), 256, 128).numpy(),
                    jstft.stft(y[0], 256, 128, method=method)) < SPEC_REL
    wav = ops.istft(spec[0], 256, 128, length=3000)
    _close(wav, jstft.istft(np.asarray(want[0]), 256, 128, length=3000),
           atol=1e-4)
    mag, phase = ops.mag_phase(spec)
    jmag, jphase = jstft.mag_phase(np.asarray(want))
    assert _rel(mag.numpy(), jmag) < SPEC_REL
    stacked = ops.stft_real_imag(torch.from_numpy(y[0, 0]), 256, 128)
    want_stacked = jstft.stft_real_imag(y[0, 0], 256, 128)
    assert stacked.shape == want_stacked.shape == (1, 2, 129, 24)
    assert _rel(stacked.numpy(), want_stacked) < SPEC_REL
    assert ops.audio_to_stft is ops.stft_real_imag


@pytest.mark.parametrize("center", [True, False])
def test_frame_signal_matches_jax(center):
    y = _rand((2, 1000), seed=13)
    for n_fft, hop in ((256, 128), (200, 75)):
        got = ops.frame_signal(torch.from_numpy(y), n_fft, hop, center)
        want = np.asarray(jstft.frame_signal(y, n_fft, hop, center))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_mask_helpers_match_jax():
    noisy, clean = _crand((2, 9, 7), seed=14), _crand((2, 9, 7), seed=15)
    _close(ops.build_ideal_ratio_mask(torch.from_numpy(np.abs(noisy)),
                                      torch.from_numpy(np.abs(clean))),
           jmask.build_ideal_ratio_mask(np.abs(noisy), np.abs(clean)))
    _close(ops.build_complex_ideal_ratio_mask(torch.from_numpy(noisy),
                                              torch.from_numpy(clean)),
           jmask.build_complex_ideal_ratio_mask(noisy, clean))
    crm = _rand((2, 9, 7, 2), seed=16)
    got = ops.crm_to_spectrogram(torch.from_numpy(crm), torch.from_numpy(noisy))
    assert got.dtype == torch.complex64
    _close(got, jmask.crm_to_spectrogram(crm, noisy))
