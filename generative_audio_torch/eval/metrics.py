"""Speech quality metrics registry: the port's own copy of
generative_audio_tpu/eval/metrics.py. Host numpy code with the JAX module's
signatures (numpy in, Python float out) and the same arithmetic, so a score
equals the JAX package's exactly on the same arrays.

Reference: audio_zen/metrics.py:56-139 (SI_SDR, STOI via pystoi, WB/NB_PESQ
via the pesq C extension, MOSNET via speechmetrics, SDR via mir_eval).

None of those native wheels is needed:
  * SI_SDR is reimplemented exactly (numpy, optimal-scaling form).
  * STOI is a from-scratch implementation of Taal et al. 2011 matching
    pystoi's constants (10 kHz, 256/512/128 frames, 15 third-octave bands
    from 150 Hz, 384 ms segments, beta = -15 dB, 40 dB silence trim).
  * Extended STOI (eSTOI, Jensen & Taal 2016) included.
  * WB/NB PESQ compute via the from-scratch ITU-T P.862 / P.862.2
    implementation in eval/pesq/ (the optional `pesq` C wheel is preferred
    when installed, for bit-exactness with the reference).
  * MOSNET dispatches to the optional `speechmetrics` wheel when installed,
    else to the first-party CNN-BLSTM of eval/mosnet.py with the keras
    weights named by $GAT_MOSNET_WEIGHTS (on the card), and raises
    MetricUnavailable with neither.
  * SDR computes via the from-scratch single-source BSS Eval v3 in
    eval/bss.py (the optional `mir_eval` wheel is preferred when
    installed), so every metric but MOSNET computes without a wheel.
  * transform_pesq_range + the composite (STOI + PESQ)/2 validation score
    (base_trainer.py:255-303) are provided for best-model selection.
"""
from __future__ import annotations

import functools
import os
import warnings
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
from scipy.signal import resample_poly

__all__ = [
    "SI_SDR", "STOI", "ESTOI", "WB_PESQ", "NB_PESQ", "SDR", "MOSNET",
    "REGISTERED_METRICS", "MetricUnavailable", "transform_pesq_range",
    "composite_validation_score",
]


class MetricUnavailable(RuntimeError):
    pass


def SI_SDR(reference: np.ndarray, estimation: np.ndarray,
           sr: int = 16000) -> float:
    """Scale-invariant SDR, exactly audio_zen/metrics.py:61-87."""
    estimation, reference = np.broadcast_arrays(estimation, reference)
    reference_energy = np.sum(reference ** 2, axis=-1, keepdims=True)
    optimal_scaling = (np.sum(reference * estimation, axis=-1, keepdims=True)
                       / reference_energy)
    projection = optimal_scaling * reference
    noise = estimation - projection
    ratio = np.sum(projection ** 2, axis=-1) / np.sum(noise ** 2, axis=-1)
    return float(10 * np.log10(ratio))


# ----------------------------------------------------------------- STOI ----
_FS = 10000
_N_FRAME = 256
_NFFT = 512
_NUMBAND = 15
_MINFREQ = 150
_SEG = 30          # 384 ms segments
_BETA = -15.0      # clip at -15 dB SDR
_DYN_RANGE = 40


@functools.lru_cache(maxsize=1)
def _octave_band_matrix():
    cfs = _MINFREQ * np.power(2.0, np.arange(_NUMBAND) / 3.0)
    freqs = np.linspace(0, _FS, _NFFT + 1)[: _NFFT // 2 + 1]
    obm = np.zeros((_NUMBAND, len(freqs)))
    lo = cfs * 2 ** (-1 / 6)
    hi = cfs * 2 ** (1 / 6)
    for i in range(_NUMBAND):
        # pystoi convention: nearest bins to band edges
        li = np.argmin((freqs - lo[i]) ** 2)
        hi_i = np.argmin((freqs - hi[i]) ** 2)
        obm[i, li:hi_i] = 1
    return obm


def _stoi_window():
    return np.hanning(_N_FRAME + 2)[1:-1]


def _frames(x: np.ndarray, framelen: int, hop: int) -> np.ndarray:
    n = 1 + (len(x) - framelen) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(framelen)[None, :]
    return x[idx]


def _remove_silent_frames(x, y, dyn_range=_DYN_RANGE,
                          framelen=_N_FRAME, hop=_N_FRAME // 2):
    w = _stoi_window()
    xf = _frames(x, framelen, hop) * w
    yf = _frames(y, framelen, hop) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    mask = energies > (np.max(energies) - dyn_range)
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    n_out = (len(xf) - 1) * hop + framelen if len(xf) else 0
    x_out = np.zeros(n_out)
    y_out = np.zeros(n_out)
    for i in range(len(xf)):
        x_out[i * hop:i * hop + framelen] += xf[i]
        y_out[i * hop:i * hop + framelen] += yf[i]
    return x_out, y_out


def _band_spectrogram(x: np.ndarray) -> np.ndarray:
    w = _stoi_window()
    frames = _frames(x, _N_FRAME, _N_FRAME // 2) * w
    spec = np.abs(np.fft.rfft(frames, n=_NFFT, axis=1)) ** 2   # [T, F]
    return np.sqrt(_octave_band_matrix() @ spec.T)             # [15, T]


def STOI(ref: np.ndarray, est: np.ndarray, sr: int = 16000,
         extended: bool = False) -> float:
    """Short-Time Objective Intelligibility (Taal et al. 2011)."""
    ref = np.asarray(ref, np.float64)
    est = np.asarray(est, np.float64)
    assert ref.shape == est.shape, "ref/est length mismatch"
    if sr != _FS:
        g = np.gcd(sr, _FS)
        ref = resample_poly(ref, _FS // g, sr // g)
        est = resample_poly(est, _FS // g, sr // g)
    ref, est = _remove_silent_frames(ref, est)
    if len(ref) < _N_FRAME * 2:
        # pystoi semantics: warn and return 1e-5 — a raise here would let
        # one silent/short validation clip abort a whole training run
        warnings.warn("Signal too short (or all-silent) for STOI; "
                      "returning 1e-5 (pystoi behavior)")
        return 1e-5

    X = _band_spectrogram(ref)     # [15, T]
    Y = _band_spectrogram(est)
    T = X.shape[1]
    if T < _SEG:
        warnings.warn("Not enough frames for STOI segments; "
                      "returning 1e-5 (pystoi behavior)")
        return 1e-5

    if not extended:
        c = 10 ** (-_BETA / 20)
        scores = []
        for m in range(_SEG, T + 1):
            x_seg = X[:, m - _SEG:m]
            y_seg = Y[:, m - _SEG:m]
            alpha = (np.linalg.norm(x_seg, axis=1, keepdims=True)
                     / (np.linalg.norm(y_seg, axis=1, keepdims=True) + 1e-12))
            y_prime = np.minimum(alpha * y_seg, x_seg * (1 + c))
            xm = x_seg - x_seg.mean(axis=1, keepdims=True)
            ym = y_prime - y_prime.mean(axis=1, keepdims=True)
            corr = np.sum(xm * ym, axis=1) / (
                np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1)
                + 1e-12)
            scores.append(np.mean(corr))
        return float(np.mean(scores))

    # eSTOI: row+column normalized segment correlation
    scores = []
    for m in range(_SEG, T + 1):
        x_seg = X[:, m - _SEG:m]
        y_seg = Y[:, m - _SEG:m]
        xn = x_seg - x_seg.mean(axis=1, keepdims=True)
        xn = xn / (np.linalg.norm(xn, axis=1, keepdims=True) + 1e-12)
        yn = y_seg - y_seg.mean(axis=1, keepdims=True)
        yn = yn / (np.linalg.norm(yn, axis=1, keepdims=True) + 1e-12)
        xn = xn - xn.mean(axis=0, keepdims=True)
        xn = xn / (np.linalg.norm(xn, axis=0, keepdims=True) + 1e-12)
        yn = yn - yn.mean(axis=0, keepdims=True)
        yn = yn / (np.linalg.norm(yn, axis=0, keepdims=True) + 1e-12)
        scores.append(np.sum(xn * yn) / _SEG)
    return float(np.mean(scores))


def ESTOI(ref, est, sr: int = 16000) -> float:
    return STOI(ref, est, sr, extended=True)


# ----------------------------------------------------------------- PESQ ----
def _pesq_impl():
    """The ITU `pesq` C wheel when installed (bit-exact to the reference's
    metric, metrics.py:92-116); otherwise this package's from-scratch
    P.862/P.862.2 implementation (eval/pesq/), which always computes."""
    try:
        from pesq import pesq as wheel_pesq   # optional C wheel
        return wheel_pesq
    except ImportError:
        from generative_audio_torch.eval.pesq import pesq as local_pesq
        return local_pesq


def WB_PESQ(ref, est, sr: int = 16000) -> float:
    """Wide-band PESQ (P.862.2 MOS-LQO), ref metrics.py:92-101."""
    if sr != 16000:
        g = np.gcd(int(sr), 16000)
        ref = resample_poly(ref, up=16000 // g, down=sr // g)
        est = resample_poly(est, up=16000 // g, down=sr // g)
    return float(_pesq_impl()(16000, ref, est, "wb"))


def NB_PESQ(ref, est, sr: int = 16000) -> float:
    """Narrow-band PESQ; resamples to 8 kHz first (metrics.py:103-116)."""
    if sr != 8000:
        g = np.gcd(int(sr), 8000)   # gcd form: correct for e.g. sr=44100
        ref = resample_poly(ref, up=8000 // g, down=sr // g)
        est = resample_poly(est, up=8000 // g, down=sr // g)
    return float(_pesq_impl()(8000, ref, est, "nb"))


def SDR(reference, estimation, sr: int = 16000) -> float:
    """BSS Eval v3 SDR (512-tap distortion filters), ref metrics.py:56-58.

    The mir_eval wheel is preferred when installed (bit-exactness with the
    reference); otherwise the from-scratch single-source implementation in
    eval/bss.py computes — see its docstring for how it is pinned."""
    try:
        from mir_eval.separation import bss_eval_sources
        sdr, _, _, _ = bss_eval_sources(reference[None, :],
                                        estimation[None, :])
        return float(sdr)
    except ImportError:
        from generative_audio_torch.eval.bss import bss_eval_sdr
        return bss_eval_sdr(reference, estimation)


def MOSNET(ref, est, sr: int = 16000) -> float:
    """MOS prediction of `est` (ref is unused, matching metrics.py:119-130).

    Dispatch order: the `speechmetrics` wheel when installed (the
    reference's exact scorer); else the first-party CNN-BLSTM
    (eval/mosnet.py) with keras weights transplanted from the file named by
    $GAT_MOSNET_WEIGHTS (e.g. speechmetrics' mosnet.h5), scored on the card.
    With neither, the metric is unavailable: the net's weights are a trained
    artifact."""
    try:
        import speechmetrics  # the reference's scorer, lazy like metrics.py:122
        global _mos_metrics
        if "_mos_metrics" not in globals() or _mos_metrics is None:
            _mos_metrics = speechmetrics.load("mosnet", 10)
        return float(np.mean(_mos_metrics(est, rate=sr)["mosnet"]))
    except ImportError:
        pass
    weights = os.environ.get("GAT_MOSNET_WEIGHTS", "")
    if weights and Path(weights).exists():
        from generative_audio_torch.eval.mosnet import (
            load_keras_h5, mosnet_score)
        global _mos_variables
        if "_mos_variables" not in globals() or _mos_variables is None:
            _mos_variables = load_keras_h5(weights)
        return mosnet_score(est, _mos_variables, sr=sr)
    raise MetricUnavailable(
        "MOSNET needs the speechmetrics wheel or $GAT_MOSNET_WEIGHTS "
        "pointing at its keras mosnet.h5 (the eval/mosnet.py architecture "
        "computes with transplanted weights)")


REGISTERED_METRICS: Dict[str, Callable] = {
    "SI_SDR": SI_SDR,
    "STOI": STOI,
    "ESTOI": ESTOI,      # extension beyond the reference registry
    "WB_PESQ": WB_PESQ,
    "NB_PESQ": NB_PESQ,
    "SDR": SDR,          # extension: the reference defines SDR but leaves
                         # it out of its registry (metrics.py:133-139)
    "MOSNET": MOSNET,
}


def transform_pesq_range(pesq_score: float) -> float:
    """[-0.5, 4.5] -> [0, 1] (base_trainer.py:250-255)."""
    return (pesq_score + 0.5) / 5


def composite_validation_score(stoi_score: float,
                               wb_pesq_score: Optional[float]) -> float:
    """(STOI + transformed WB-PESQ) / 2, the reference's best-model criterion
    (base_trainer.py:296-303). PESQ is required: the from-scratch P.862
    implementation (eval/pesq/) always computes, so a None
    here means the caller's validation produced no PESQ value at all —
    refuse rather than silently rank on a different criterion."""
    if wb_pesq_score is None:
        raise ValueError(
            "composite_validation_score requires a WB-PESQ value; the "
            "reference criterion is (STOI + transform_pesq_range(PESQ))/2 "
            "(base_trainer.py:296-303). Handle missing PESQ explicitly at "
            "the call site instead of passing None.")
    return (stoi_score + transform_pesq_range(wb_pesq_score)) / 2
