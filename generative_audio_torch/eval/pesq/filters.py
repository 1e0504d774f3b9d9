"""P.862 input filtering: FFT piecewise-linear-dB filters, IIR cascades,
DC blocking.

Three filter families, matching the standard's signal conditioning:

  * `apply_filter_db_curve` — zero-phase full-signal FFT filter whose
    magnitude response linearly interpolates a (freq_hz, gain_dB) break
    point table, normalised to 0 dB at 1 kHz.  Used for the level
    bandpass (`ALIGN_FILTER_DB`, 350-3250 Hz) and the narrow-band IRS
    receive characteristic (`STANDARD_IRS_FILTER_DB`).
  * `iir_sos` — cascade of second-order sections in the standard's
    {b0,b1,b2,a1,a2} layout (denominator 1 + a1 z^-1 + a2 z^-2).  The
    narrow-band alignment filter (8 sections at 8 kHz, 12 at 16 kHz)
    and the wide-band input filter (single section) are SOS cascades.
  * `dc_block` — mean removal plus a short linear taper at the active
    region's edges.

The SOS coefficient sets reproduce the standard's filter
characteristics: the NB cascades are a telephone-band (IRS-receive
style) bandpass with ~10 dB presence boost at 500-1000 Hz and steep
rejection below 200 Hz; the WB input filter is a +9 dB high-pass with
~200 Hz corner (verified against the response plots in P.862/P.862.2).

Reference behaviour: audio_zen/metrics.py:92-116 delegates to the pesq
C extension, whose conditioning chain this module re-implements.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import sosfilt

__all__ = [
    "ALIGN_FILTER_DB", "STANDARD_IRS_FILTER_DB",
    "IN_IIR_SOS_8K", "IN_IIR_SOS_16K", "WB_IN_IIR_SOS",
    "apply_filter_db_curve", "iir_sos", "dc_block",
]

# (frequency Hz, gain dB) break points; -500 dB == stopband.
# Level-alignment bandpass: passband 350-3250 Hz ("power above 300 Hz").
ALIGN_FILTER_DB = np.array([
    [0.0, -500.0], [50.0, -500.0], [100.0, -500.0], [125.0, -500.0],
    [160.0, -500.0], [200.0, -500.0], [250.0, -500.0], [300.0, -500.0],
    [350.0, 0.0], [400.0, 0.0], [500.0, 0.0], [600.0, 0.0],
    [630.0, 0.0], [800.0, 0.0], [1000.0, 0.0], [1250.0, 0.0],
    [1600.0, 0.0], [2000.0, 0.0], [2500.0, 0.0], [3000.0, 0.0],
    [3250.0, 0.0], [3500.0, -500.0], [4000.0, -500.0], [5000.0, -500.0],
    [6300.0, -500.0], [8000.0, -500.0]])

# IRS receive characteristic (narrow-band model input filter).
STANDARD_IRS_FILTER_DB = np.array([
    [0.0, -200.0], [50.0, -40.0], [100.0, -20.0], [125.0, -12.0],
    [160.0, -6.0], [200.0, 0.0], [250.0, 4.0], [300.0, 6.0],
    [350.0, 8.0], [400.0, 10.0], [500.0, 11.0], [600.0, 12.0],
    [700.0, 12.0], [800.0, 12.0], [1000.0, 12.0], [1300.0, 12.0],
    [1600.0, 12.0], [2000.0, 12.0], [2500.0, 12.0], [3000.0, 12.0],
    [3250.0, 12.0], [3500.0, 4.0], [4000.0, -200.0], [5000.0, -200.0],
    [6300.0, -200.0], [8000.0, -200.0]])

# SOS rows are {b0, b1, b2, a1, a2}: H(z) = (b0+b1 z^-1+b2 z^-2)
#                                          / (1 + a1 z^-1 + a2 z^-2).
# Alignment-path bandpass, 8 kHz model (8 sections).
IN_IIR_SOS_8K = np.array([
    [0.885535424, -0.885535424, 0.000000000, -0.771070709, 0.000000000],
    [0.895092588, 1.292907193, 0.449260174, 1.268869037, 0.442025372],
    [4.049527940, -7.865190042, 3.815662102, -1.746859852, 0.786305963],
    [0.500002353, -0.500002353, 0.000000000, 0.000000000, 0.000000000],
    [0.565002834, -0.241585934, -0.306009671, 0.259688659, 0.249979657],
    [2.115237288, 0.919935084, 1.141240051, -1.587313419, 0.665935315],
    [0.912224584, -0.224397719, -0.641121413, -0.246029464, -0.556720590],
    [0.444617727, -0.307589321, 0.141638062, -0.996391149, 0.502251622]])

# Alignment-path bandpass, 16 kHz model (12 sections).
IN_IIR_SOS_16K = np.array([
    [0.325631521, -0.086782860, -0.238848661, -1.079416490, 0.434583902],
    [0.403961804, -0.556985881, 0.153024077, -0.415115835, 0.696590244],
    [4.736162769, 3.287251046, 1.753289019, -1.859599046, 0.876284034],
    [0.365373469, 0.000000000, 0.000000000, -0.634626531, 0.000000000],
    [0.884811506, 0.000000000, 0.000000000, -0.256725271, 0.141536777],
    [0.723593055, -1.447186099, 0.723593044, -1.129587469, 0.657232737],
    [1.644910855, -1.817280902, 1.249658063, -1.778403899, 0.801724355],
    [0.633692689, -0.284644314, -0.319789663, 0.000000000, 0.000000000],
    [1.032763031, 0.268428979, 0.602913323, 0.000000000, 0.000000000],
    [1.001616361, -0.823749013, 0.439731942, -0.885778255, 0.000000000],
    [0.752472096, -0.375388990, 0.188977609, -0.077258216, 0.247230734],
    [1.023700575, 0.001661628, 0.521284240, -0.183867259, 0.354324187]])

# Wide-band (P.862.2) input filter: +9 dB high-pass, ~200 Hz corner.
WB_IN_IIR_SOS = np.array([
    [2.6657628, -5.3315255, 2.6657628, -1.8890331, 0.89487434]])


def apply_filter_db_curve(x: np.ndarray, fs: int,
                          curve: np.ndarray) -> np.ndarray:
    """Zero-phase FFT filter with a piecewise-linear dB response.

    The response is normalised so the gain at 1 kHz is 0 dB (the
    standard's `overallGainFilter` convention): the IRS curve's
    absolute level then doesn't change the signal level, only its
    shape."""
    x = np.asarray(x, np.float64)
    n = len(x)
    n_fft = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 1)
    spec = np.fft.rfft(x, n_fft)
    freqs = np.arange(len(spec)) * (fs / n_fft)
    gain_db = np.interp(freqs, curve[:, 0], curve[:, 1])
    gain_db -= np.interp(1000.0, curve[:, 0], curve[:, 1])
    spec *= 10.0 ** (gain_db / 20.0)
    return np.fft.irfft(spec, n_fft)[:n]


def iir_sos(x: np.ndarray, sos_ba: np.ndarray) -> np.ndarray:
    """Run the {b0,b1,b2,a1,a2} cascade (zero initial state)."""
    sos = np.concatenate([sos_ba[:, :3],
                          np.ones((len(sos_ba), 1)),
                          sos_ba[:, 3:]], axis=1)
    return sosfilt(sos, np.asarray(x, np.float64))


def dc_block(x: np.ndarray, active: slice, taper: int) -> np.ndarray:
    """Remove the mean over the active region and linearly taper the
    first/last `taper` samples of it (the standard's DC_block: mean
    subtraction plus a one-Downsample-block ramp at each edge)."""
    x = np.asarray(x, np.float64).copy()
    seg = x[active]
    seg -= seg.mean()
    if len(seg) >= 2 * taper > 0:
        ramp = (0.5 + np.arange(taper)) / taper
        seg[:taper] *= ramp
        seg[-taper:] *= ramp[::-1]
    x[active] = seg
    return x
