"""The port's metrics (generative_audio_torch.eval.metrics, eval/pesq, eval/bss)
against the JAX package's on the same arrays.

The metrics are host numpy code in both packages and the port keeps the same
arithmetic, so every comparison here is exact equality (`==`), not a
tolerance: SI_SDR, STOI, ESTOI, WB_PESQ and NB_PESQ (inputs at 16 and 8 kHz),
SDR and the composite score on speech-like fixtures (tests/test_pesq.py's
harmonic bursts with pauses) at several SNRs, delays and levels; the same
PesqError on silent and too-short input; the same ValueError for a missing
WB-PESQ. The port's PESQ and STOI also meet the committed goldens
(tests/golden/pesq_golden.json, stoi_golden.json) at the JAX suites' own
tolerances (5e-4 MOS, 2e-6).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from generative_audio_tpu.eval import bss as JB
from generative_audio_tpu.eval import metrics as JM
from generative_audio_tpu.eval import pesq as JP
from generative_audio_torch.eval import bss as TB
from generative_audio_torch.eval import metrics as TM
from generative_audio_torch.eval import pesq as TP
from test_pesq import _golden_cases, _speech_like, _with_noise
from test_stoi_golden import _fixtures as _stoi_fixtures

torch.set_num_threads(2)
GOLDEN = Path(__file__).parent / "golden"
METRICS = ("SI_SDR", "STOI", "ESTOI", "WB_PESQ", "NB_PESQ", "SDR")


def _case(name):
    """(reference, estimate, sr) of one fixture: 2.5 s of speech-like
    signal with noise at an SNR, delayed, or at another level."""
    x = _speech_like(40, seconds=2.5)
    if name == "snr20":
        return x, _with_noise(x, 20, seed=41), 16000
    if name == "snr5":
        return x, _with_noise(x, 5, seed=42), 16000
    if name == "snr0":
        return x, _with_noise(x, 0, seed=43), 16000
    if name == "delayed":
        y = np.concatenate([np.zeros(320), _with_noise(x, 15, seed=44)])
        return x, y[:len(x)], 16000
    if name == "quiet":
        return x, 0.05 * _with_noise(x, 10, seed=45), 16000
    if name == "sr8k":
        x8 = _speech_like(46, seconds=2.5, fs=8000)
        return x8, _with_noise(x8, 10, seed=47), 8000
    raise KeyError(name)


CASES = ("snr20", "snr5", "snr0", "delayed", "quiet", "sr8k")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("metric", METRICS)
def test_metric_equals_jax(metric, case):
    ref, est, sr = _case(case)
    want = JM.REGISTERED_METRICS[metric](ref, est, sr)
    got = TM.REGISTERED_METRICS[metric](ref, est, sr)
    assert isinstance(got, float)
    assert got == want


def test_registry_and_composite_equal_jax():
    assert list(TM.REGISTERED_METRICS) == list(JM.REGISTERED_METRICS)
    ref, est, sr = _case("snr5")
    stoi, wb = TM.STOI(ref, est, sr), TM.WB_PESQ(ref, est, sr)
    assert TM.composite_validation_score(stoi, wb) == \
        JM.composite_validation_score(stoi, wb)
    for score in (-0.5, 1.2345, 4.64):
        assert TM.transform_pesq_range(score) == JM.transform_pesq_range(score)
    # the refusal of a missing WB-PESQ, word for word
    with pytest.raises(ValueError) as want:
        JM.composite_validation_score(0.8, None)
    with pytest.raises(ValueError) as got:
        TM.composite_validation_score(0.8, None)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode,fs", [("wb", 16000), ("nb", 8000)])
@pytest.mark.parametrize("kind", ["silent", "short"])
def test_pesq_error_equals_jax(kind, mode, fs):
    """Silent input (no utterance for the VAD) and input shorter than
    P.862's minimum raise the same PesqError in both packages."""
    if kind == "silent":
        ref = deg = np.zeros(2 * fs)
    else:
        ref = _speech_like(50, seconds=0.1, fs=fs)
        deg = _with_noise(ref, 10)
    with pytest.raises(JP.PesqError) as want:
        JP.pesq(fs, ref, deg, mode)
    with pytest.raises(TP.PesqError) as got:
        TP.pesq(fs, ref, deg, mode)
    assert str(got.value) == str(want.value)
    metric = "WB_PESQ" if mode == "wb" else "NB_PESQ"
    with pytest.raises(TP.PesqError):
        TM.REGISTERED_METRICS[metric](ref, deg, fs)


@pytest.mark.parametrize("name", list(_golden_cases()))
def test_pesq_golden_and_equal_jax(name):
    """The committed PESQ goldens, at tests/test_pesq.py's tolerance, and
    bit for bit the JAX package's score (pesq and pesq_measure)."""
    golden = json.loads((GOLDEN / "pesq_golden.json").read_text())
    fs, ref, deg, mode = _golden_cases()[name]
    got = TP.pesq(fs, ref, deg, mode)
    assert got == pytest.approx(golden[name], abs=5e-4)
    assert got == JP.pesq(fs, ref, deg, mode)
    assert TP.pesq_measure(ref, deg, fs, mode) == \
        JP.pesq_measure(ref, deg, fs, mode)


@pytest.mark.parametrize("name", list(_stoi_fixtures()))
def test_stoi_golden_and_equal_jax(name):
    """The committed STOI / eSTOI goldens at tests/test_stoi_golden.py's
    tolerance, and equal to the JAX package's."""
    golden = json.loads((GOLDEN / "stoi_golden.json").read_text())[name]
    x, y, fs = _stoi_fixtures()[name]
    for extended, key in ((False, "stoi"), (True, "estoi")):
        got = TM.STOI(x, y, sr=fs, extended=extended)
        np.testing.assert_allclose(got, golden[key], atol=2e-6)
        assert got == JM.STOI(x, y, sr=fs, extended=extended)


@pytest.mark.parametrize("seconds", [0.05, 0.2])
def test_stoi_short_input_returns_pystoi_floor(seconds):
    """Too few samples, or too few frames for one 384 ms segment: both
    packages warn and return pystoi's 1e-5 rather than raise."""
    x = _speech_like(51, seconds=seconds)
    with pytest.warns(UserWarning, match="for STOI"):
        assert TM.STOI(x, x.copy()) == 1e-5


def test_bss_projection_and_refusals_equal_jax():
    rng = np.random.default_rng(52)
    ref = rng.standard_normal(700)
    est = np.convolve(ref, [1.0, 0.4, -0.2])[:700] \
        + 0.1 * rng.standard_normal(700)
    assert TB.bss_eval_sdr(ref, est, flen=16) == JB.bss_eval_sdr(
        ref, est, flen=16)
    np.testing.assert_array_equal(TB._project(ref, est, 16),
                                  JB._project(ref, est, 16))
    # the two constructions of the projection agree (as tests/test_sdr.py
    # holds the JAX pair), so the FFT route is the least-squares one
    np.testing.assert_allclose(TB._project(ref, est, 16),
                               TB._project_dense(ref, est, 16), atol=1e-8)
    for bad in ((np.zeros(50), np.ones(50)), (np.ones(50), np.ones(40))):
        with pytest.raises(ValueError):
            TB.bss_eval_sdr(*bad)


def test_mosnet_unavailable_names_its_queue_item(monkeypatch):
    """Without the speechmetrics wheel and without $GAT_MOSNET_WEIGHTS,
    MOSNET raises MetricUnavailable, which the validator records as None;
    the message names both ways to score (test_torch_mosnet.py runs the
    second)."""
    monkeypatch.delenv("GAT_MOSNET_WEIGHTS", raising=False)
    x = _speech_like(53, seconds=1.0)
    with pytest.raises(TM.MetricUnavailable,
                       match=r"speechmetrics wheel or \$GAT_MOSNET_WEIGHTS"):
        TM.MOSNET(x, x)


def test_metrics_resample_like_jax_at_another_rate():
    """An input at 44.1 kHz: STOI resamples to 10 kHz and the PESQs to 16
    and 8 kHz by the same gcd rule in both packages."""
    x = resample_poly(_speech_like(54, seconds=2.0), 441, 160)
    y = _with_noise(x, 10, seed=55)
    for metric in ("STOI", "WB_PESQ", "NB_PESQ"):
        assert TM.REGISTERED_METRICS[metric](x, y, 44100) == \
            JM.REGISTERED_METRICS[metric](x, y, 44100)
