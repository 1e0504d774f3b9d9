"""P.862 psychoacoustic model: Bark spectra, compensations, loudness,
disturbance, and the Lpq time aggregation.

This is the second half of the PESQ pipeline (the first — buffering,
level alignment and time alignment — lives in common.py / align.py).
Per 32 ms Hann frame at 50 % overlap:

  1. `bark_spectrum` — power spectrum scaled by `SP` and warped onto
     the Bark band table (tables.band_table) to give the pitch power
     densities.
  2. `freq_resp_compensation` — partial transfer-function equalisation:
     the REFERENCE band densities are multiplied by the ratio of the
     speech-active average degraded/reference densities, offset by
     +1000 and clipped to [0.01, 100]  (P.862 sec 10.2.4).
  3. short-term gain compensation — the DEGRADED frame densities are
     scaled by a first-order-smoothed (0.8 new / 0.2 old) audible-power
     ratio clipped to [3e-4, 5]  (P.862 sec 10.2.5).
  4. `loudness` — Zwicker law with exponent 0.23, raised for bands
     below 4 Bark (the standard's modified-Zwicker low-band exponent),
     gated by the absolute hearing threshold and scaled by `SL`.
  5. `frame_disturbance` — signed loudness difference per band with a
     0.25*min(ref,deg) deadzone; the symmetric disturbance is the
     width-weighted L2 over bands, the asymmetric one the L1 of the
     difference multiplied per band by ((deg+50)/(ref+50))**1.2
     clipped to {0} ∪ [3, 12]; both divided by a soft loudness-of-frame
     normaliser ((P_ref + 1e5)/1e7)**0.04 and clipped at 45.
  6. `lpq_weight` — L_p over 20-frame "syllable" windows at hop 10,
     then L_q over windows (p=6,q=2 symmetric; p=1,q=2 asymmetric).

Raw PESQ MOS = 4.5 - 0.1*D - 0.0309*DA, mapped to MOS-LQO by the
published P.862.1 (NB) / P.862.2 (WB) logistic mappings in core.py.

Constants marked RECALLED reproduce the standard's published values;
the Bark tables and hearing thresholds are DERIVED (see tables.py), so
absolute scores are a calibrated reconstruction — pinned by committed
golden vectors and by the gated wheel-parity test in
tests/test_pesq.py the day a `pesq` wheel is installed.

Reference behaviour: audio_zen/metrics.py:92-116 delegates WB/NB PESQ
to the pesq C extension whose model this reimplements.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .tables import BandTable

__all__ = ["SP_8K", "SP_16K", "SL", "PerceptualFrames", "bark_spectra",
           "freq_resp_compensation", "gain_compensation", "loudness",
           "frame_disturbances", "lpq_weight", "total_audible"]

# RECALLED power/loudness scale factors (P.862 ANSI-C appendix).  SP
# converts raw |FFT|^2 (length-256/512 Hann frames of a signal level-
# aligned to 1e7 average band power) into the internal pitch-power
# scale the +50/+1000/1e5/1e7 offsets below are expressed in; SL is the
# overall loudness scale.  SP scales with 1/Nf^2 between the two rates.
SP_8K = 2.764344e-5
SP_16K = 6.910853e-6
SL = 1.866055e-1

_SILENCE_CRITERION = 1.0e7       # speech-active frame threshold
_GAIN_OFFSET = 5.0e3
_GAIN_MIN, _GAIN_MAX = 3.0e-4, 5.0
_FREQ_OFFSET = 1.0e3
_FREQ_MIN, _FREQ_MAX = 0.01, 100.0
_DEADZONE = 0.25
_ASYM_OFFSET = 50.0
_ASYM_EXP = 1.2
_ASYM_LO, _ASYM_HI = 3.0, 12.0
_NORM_OFFSET = 1.0e5
_NORM_EXP = 0.04
_DISTURBANCE_CAP = 45.0
_SYLLABLE = 20                   # frames per Lpq "split second" window
_SYLLABLE_HOP = 10


def _hann(n: int) -> np.ndarray:
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


@dataclass
class PerceptualFrames:
    """Per-frame Bark pitch-power densities for one signal."""
    pitch_pow: np.ndarray        # [n_frames, nb]
    table: BandTable


def bark_spectra(data: np.ndarray, starts: np.ndarray,
                 table: BandTable, sp: float) -> PerceptualFrames:
    """Pitch power densities for frames starting at `starts` (samples).

    Each frame is table.nf samples, Hann windowed; bin powers are
    grouped onto the Bark bands by tables.bin_band with the
    energy-preserving width correction baked into that construction."""
    nf = table.nf
    window = _hann(nf)
    idx = starts[:, None] + np.arange(nf)[None, :]
    frames = data[idx] * window
    power = np.abs(np.fft.rfft(frames, axis=1)[:, :nf // 2]) ** 2 * sp

    nb = table.nb
    # mean bin power per band, times width_hz / bin spacing (tables.py)
    sums = np.zeros((len(starts), nb))
    np.add.at(sums.T, table.bin_band, power.T)
    mean = sums / table.bins_per_band
    corr = table.width_hz / (table.fs / nf)
    return PerceptualFrames(pitch_pow=mean * corr, table=table)


def total_audible(pitch_pow: np.ndarray, table: BandTable,
                  factor: float) -> np.ndarray:
    """Per-frame total power in bands above factor*abs_threshold
    (band 0 excluded, as in every P.862 band iteration)."""
    pp = pitch_pow[:, 1:]
    thresh = factor * table.abs_thresh_power[1:]
    return np.sum(np.where(pp > thresh, pp, 0.0), axis=1)


def freq_resp_compensation(ref: PerceptualFrames,
                           deg: PerceptualFrames) -> np.ndarray:
    """Partial transfer-function equalisation factors (applied to ref).

    The standard's time_avg_audible_of semantics: per band, sum only
    the AUDIBLE cell values (pitch power > 100x the band's absolute
    threshold) over speech-active frames (total audible power at 100x
    threshold above the silence criterion on the REFERENCE), divided
    by the total frame count — the same denominator for ref and deg,
    so it cancels in the ratio, but the audibility gating does not:
    it keeps sub-threshold valley bands out of the averages, which is
    what makes the +1000 offset a genuinely *partial* compensation."""
    table = ref.table
    active = (total_audible(ref.pitch_pow, table, 100.0)
              > _SILENCE_CRITERION)
    if not np.any(active):
        return np.ones(table.nb)
    n_total = len(ref.pitch_pow)
    gate = 100.0 * table.abs_thresh_power[None, :]
    pr = ref.pitch_pow[active]
    pd = deg.pitch_pow[active]
    avg_ref = np.sum(np.where(pr > gate, pr, 0.0), axis=0) / n_total
    avg_deg = np.sum(np.where(pd > gate, pd, 0.0), axis=0) / n_total
    factor = (avg_deg + _FREQ_OFFSET) / (avg_ref + _FREQ_OFFSET)
    return np.clip(factor, _FREQ_MIN, _FREQ_MAX)


def gain_compensation(ref: PerceptualFrames,
                      deg: PerceptualFrames) -> np.ndarray:
    """Short-term gain factors (applied to deg): smoothed audible-power
    ratio ref/deg per frame, 0.8 new / 0.2 previous, clipped."""
    table = ref.table
    p_ref = total_audible(ref.pitch_pow, table, 1.0)
    p_deg = total_audible(deg.pitch_pow, table, 1.0)
    raw = (p_ref + _GAIN_OFFSET) / (p_deg + _GAIN_OFFSET)
    out = np.empty_like(raw)
    h = raw[0] if len(raw) else 1.0
    for i, g in enumerate(raw):
        h = 0.2 * h + 0.8 * g
        out[i] = h
    return np.clip(out, _GAIN_MIN, _GAIN_MAX)


def loudness(pitch_pow: np.ndarray, table: BandTable) -> np.ndarray:
    """Modified-Zwicker specific loudness per band, [n_frames, nb]."""
    thresh = table.abs_thresh_power[None, :]
    # low-band exponent raise: h = clip(6/(z+2), ., 2)^0.15, z < 4 Bark
    h = np.where(table.centre_bark < 4.0,
                 np.minimum(6.0 / (table.centre_bark + 2.0), 2.0), 1.0)
    h = np.maximum(h, 1.0) ** 0.15
    zwicker = 0.23 * h[None, :]
    base = SL * (thresh / 0.5) ** zwicker
    ratio = np.maximum(pitch_pow, 0.0) / thresh
    dens = base * ((0.5 + 0.5 * ratio) ** zwicker - 1.0)
    return np.where(pitch_pow > thresh, dens, 0.0)


def _pseudo_lp(d: np.ndarray, widths: np.ndarray, p: float) -> np.ndarray:
    """Width-weighted L_p over bands 1..nb-1 (P.862's pseudo_Lp):
    ((sum (|d|*w)^p)/sum w)^(1/p) * sum w, per frame."""
    prod = np.abs(d[:, 1:]) * widths[None, 1:]
    total_w = float(np.sum(widths[1:]))
    return (np.sum(prod ** p, axis=1) / total_w) ** (1.0 / p) * total_w


def frame_disturbances(loud_ref: np.ndarray, loud_deg: np.ndarray,
                       pp_ref: np.ndarray, pp_deg: np.ndarray,
                       table: BandTable) -> tuple:
    """(symmetric, asymmetric) frame disturbances, each [n_frames]."""
    d = loud_deg - loud_ref
    m = _DEADZONE * np.minimum(loud_deg, loud_ref)
    d = np.where(d > m, d - m, np.where(d < -m, d + m, 0.0))

    sym = _pseudo_lp(d, table.width_bark, 2.0)

    ratio = ((pp_deg + _ASYM_OFFSET) / (pp_ref + _ASYM_OFFSET)) ** _ASYM_EXP
    h = np.where(ratio < _ASYM_LO, 0.0, np.minimum(ratio, _ASYM_HI))
    asym = _pseudo_lp(d * h, table.width_bark, 1.0)

    norm = ((total_audible(pp_ref, table, 1.0) + _NORM_OFFSET)
            / 1.0e7) ** _NORM_EXP
    sym = np.minimum(sym / norm, _DISTURBANCE_CAP)
    asym = np.minimum(asym / norm, _DISTURBANCE_CAP)
    return sym, asym


def lpq_weight(frame_vals: np.ndarray, p: float, q: float) -> float:
    """L_p within 20-frame windows at hop 10, L_q across windows."""
    n = len(frame_vals)
    if n == 0:
        return 0.0
    vals = []
    for start in range(0, n, _SYLLABLE_HOP):
        chunk = frame_vals[start:start + _SYLLABLE]
        vals.append(float(np.mean(chunk.astype(np.float64) ** p)
                          ** (1.0 / p)))
        if start + _SYLLABLE >= n:
            break
    vals = np.asarray(vals)
    return float(np.mean(vals ** q) ** (1.0 / q))
