"""Auditory band tables for the from-scratch P.862 (PESQ) implementation.

ITU-T P.862 defines its psychoacoustic frequency axis through numeric
tables in the normative ANSI-C appendix (42 Bark bands for the 8 kHz
narrow-band model, 49 for 16 kHz): band centres/widths in Bark and Hz,
FFT-bin-per-band counts, per-band power-density correction factors and
absolute hearing thresholds.  Those tables are not available without
the `pesq` wheel or the ITU source, so this module DERIVES
functionally equivalent tables from the published psychoacoustics the
standard is built on:

  * Hz -> Bark warping: Zwicker & Terhardt 1980,
        z(f) = 13*atan(0.00076 f) + 3.5*atan((f/7500)^2)
  * band layout: a half-width band at DC followed by equal-Bark-width
    bands covering [0, z(fs/2)] (P.862's tables follow this structure:
    their first band has half the width of the rest)
  * FFT-bin assignment: each bin of the 32 ms analysis frame belongs to
    the band whose Bark interval contains the bin centre frequency;
    per-band power is the MEAN bin power times the band width in Hz
    divided by the bin spacing, which makes the binning exactly
    energy-preserving (this plays the role of P.862's
    `pow_dens_correction_factor`, absorbed into the construction)
  * absolute threshold of hearing: Terhardt 1979,
        ATH(f)[dB SPL] = 3.64 f_k^-0.8 - 6.5 e^{-0.6 (f_k-3.3)^2}
                         + 1e-3 f_k^4   (f_k in kHz)
    converted to P.862 internal power units with a -5.9 dB calibration
    constant anchored to the magnitudes of the standard's published
    abs_thresh_power table (ANSI-C appendix): the ITU values bottom
    out near 0.24 internal power (~ -6.2 dB) around 3 kHz and sit at
    ~0.5-2 through 1-2 kHz, i.e. about 6 dB below the raw Terhardt
    curve in the speech bands.  The original +14.3 dB anchor was a
    20 dB miscalibration: it put every threshold ~100x too high,
    which disabled the standard's audibility gating and drove the
    +1000/+50 "partial compensation" offsets to negligibility —
    measured to inflate broadband-noisy real speech by ~1.7 MOS-LQO
    (operating points pinned by tests/test_pesq.py and audited in
    scripts/pesq_family_audit.py / BASELINE.md).

Residual numeric differences against the ITU tables are pinned by the
gated wheel-parity test in tests/test_pesq.py the day a `pesq` wheel
exists in the environment.

Reference behaviour being reproduced: audio_zen/metrics.py:92-116
(WB_PESQ/NB_PESQ via the pesq C extension).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

__all__ = ["BandTable", "band_table", "bark_of_hz"]


def bark_of_hz(f):
    """Zwicker & Terhardt (1980) critical-band-rate approximation."""
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _ath_db_spl(f_hz):
    """Terhardt (1979) absolute threshold of hearing, dB SPL."""
    f = np.maximum(np.asarray(f_hz, np.float64), 10.0) / 1000.0   # kHz
    return (3.64 * f ** -0.8
            - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
            + 1e-3 * f ** 4)


# Calibration of the Terhardt threshold into P.862 internal power units;
# anchored to the published ITU abs_thresh_power magnitudes (see module
# docstring): 1 kHz lands at ~0.56, the 3 kHz minimum at ~0.09.
_ATH_CALIBRATION_DB = -5.9


@dataclass(frozen=True)
class BandTable:
    """Frequency-warping table for one sample rate."""
    fs: int
    nb: int                     # number of Bark bands
    nf: int                     # analysis frame length (32 ms, hop nf/2)
    centre_bark: np.ndarray     # [nb]
    width_bark: np.ndarray      # [nb]
    centre_hz: np.ndarray       # [nb]
    width_hz: np.ndarray        # [nb]
    bin_band: np.ndarray        # [nf//2] band index of each FFT bin (1..)
    bins_per_band: np.ndarray   # [nb] number of FFT bins in each band
    abs_thresh_power: np.ndarray  # [nb] hearing threshold, internal units

    @property
    def total_width_bark(self) -> float:
        # band 0 is excluded from all audible-band loops (P.862 starts
        # its band iterations at 1)
        return float(np.sum(self.width_bark[1:]))


@functools.lru_cache(maxsize=2)
def band_table(fs: int) -> BandTable:
    """Build the Bark band table for fs in {8000, 16000}.

    P.862 band counts: 42 bands for the 8 kHz model, 49 for 16 kHz;
    32 ms analysis frames (256 / 512 samples)."""
    if fs == 8000:
        nb, nf = 42, 256
    elif fs == 16000:
        nb, nf = 49, 512
    else:
        raise ValueError(f"PESQ supports fs 8000/16000, got {fs}")

    z_hi = float(bark_of_hz(fs / 2.0))
    # half-width first band + (nb - 1) full bands: nb - 0.5 width units
    dz = z_hi / (nb - 0.5)
    edges = np.concatenate([[0.0, 0.5 * dz],
                            0.5 * dz + dz * np.arange(1, nb)])
    centre_bark = 0.5 * (edges[:-1] + edges[1:])
    width_bark = np.diff(edges)

    # invert z(f) on a dense grid (z is monotone)
    f_grid = np.linspace(0.0, fs / 2.0, 200001)
    z_grid = bark_of_hz(f_grid)
    edges_hz = np.interp(edges, z_grid, f_grid)
    centre_hz = np.interp(centre_bark, z_grid, f_grid)
    width_hz = np.diff(edges_hz)

    # assign FFT bins (the nf//2 real-FFT magnitude bins P.862's hz
    # spectrum keeps, DC included but band 0 is never iterated) to
    # bands sequentially, forcing >= 1 bin per band: the lowest Bark
    # bands are narrower than one bin, and P.862's
    # nr_of_hz_bands_per_bark_band tables likewise never contain zeros
    n_bins = nf // 2
    bin_hz = np.arange(n_bins) * (fs / nf)
    bin_band = np.full(n_bins, nb - 1, dtype=np.int64)
    nxt = 0
    for b in range(nb):
        remaining_bands = nb - 1 - b
        count = 0
        while nxt < n_bins - remaining_bands:
            if count >= 1 and bin_hz[nxt] >= edges_hz[b + 1]:
                break
            bin_band[nxt] = b
            nxt += 1
            count += 1
    bins_per_band = np.bincount(bin_band, minlength=nb)
    assert bins_per_band.min() >= 1

    abs_thresh_power = 10.0 ** ((_ath_db_spl(np.maximum(centre_hz, 25.0))
                                 + _ATH_CALIBRATION_DB) / 10.0)

    return BandTable(fs=fs, nb=nb, nf=nf,
                     centre_bark=centre_bark, width_bark=width_bark,
                     centre_hz=centre_hz, width_hz=width_hz,
                     bin_band=bin_band, bins_per_band=bins_per_band,
                     abs_thresh_power=abs_thresh_power)
