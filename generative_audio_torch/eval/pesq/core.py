"""P.862 / P.862.2 end-to-end PESQ measure.

Pipeline (matching the standard's pesq_measure):

  1. buffer layout + level alignment (common.py)
  2. input filtering — model path gets the IRS receive curve (NB) or
     the WB high-pass SOS (P.862.2); a separate alignment path gets
     DC blocking + the alignment IIR cascade
  3. VAD + crude/fine utterance alignment (align.py)
  4. psychoacoustic model per 32 ms half-overlapped frame with the
     per-utterance delays (perceptual.py)
  5. bad-interval realignment: runs of frames whose symmetric
     disturbance exceeds 30 are re-aligned by raw cross-correlation
     and rescored, keeping the per-frame minimum (the standard's
     "bad frames" second pass)
  6. Lpq aggregation -> raw PESQ MOS = 4.5 - 0.1*D - 0.0309*DA
  7. MOS-LQO mapping: P.862.1 (NB) / P.862.2 (WB) logistics

Public API mirrors the `pesq` wheel: pesq(fs, ref, deg, mode) with
mode in {"nb", "wb"}; returns MOS-LQO.

Reference behaviour: audio_zen/metrics.py:92-116 (WB_PESQ at 16 kHz,
NB_PESQ after resample_poly to 8 kHz).
"""
from __future__ import annotations

from typing import List

import numpy as np

from . import align as A
from . import perceptual as P
from .common import (DATAPADDING_MSECS, SEARCHBUFFER, SignalBuffer,
                     fix_power_level, make_buffer, rate_config)
from .filters import (STANDARD_IRS_FILTER_DB, WB_IN_IIR_SOS,
                      apply_filter_db_curve, dc_block, iir_sos)

__all__ = ["pesq", "pesq_measure", "PesqError"]

_BAD_FRAME_THRESHOLD = 30.0   # symmetric disturbance triggering re-align
_MIN_BAD_RUN = 2              # frames; single spikes are kept as-is


class PesqError(ValueError):
    """Raised for inputs PESQ cannot score (too short / silent ref)."""


def _frame_starts_and_delays(ref: SignalBuffer,
                             utts: List[A.Utterance]) -> tuple:
    """Reference frame starts (samples) + per-frame delays from the
    utterance table. Frames between utterances inherit the nearest
    utterance's delay (the standard assigns by utterance span)."""
    cfg = ref.cfg
    nf = {8000: 256, 16000: 512}[cfg.fs]
    hop = nf // 2
    first = cfg.search_samples
    last = ref.n_samples - cfg.search_samples - nf
    starts = np.arange(first, last + 1, hop, dtype=np.int64)
    if len(starts) == 0:
        raise PesqError("signal shorter than one 32 ms PESQ frame")

    centers_block = (starts + nf // 2) // cfg.downsample
    delays = np.zeros(len(starts), np.int64)
    bounds = np.array([[u.start_block, u.end_block] for u in utts])
    for i, cb in enumerate(centers_block):
        inside = (bounds[:, 0] <= cb) & (cb < bounds[:, 1])
        if np.any(inside):
            delays[i] = utts[int(np.argmax(inside))].delay
        else:
            dist = np.minimum(np.abs(bounds[:, 0] - cb),
                              np.abs(bounds[:, 1] - cb))
            delays[i] = utts[int(np.argmin(dist))].delay
    return starts, delays, nf


def _deg_starts(starts: np.ndarray, delays: np.ndarray,
                deg: SignalBuffer, nf: int) -> np.ndarray:
    return np.clip(starts + delays, 0, len(deg.data) - nf)


def _disturbances(ref_buf, deg_buf, starts, deg_starts, table, sp):
    """Full perceptual chain for one (ref starts, deg starts) pairing."""
    fr = P.bark_spectra(ref_buf.data, starts, table, sp)
    fd = P.bark_spectra(deg_buf.data, deg_starts, table, sp)
    freq_comp = P.freq_resp_compensation(fr, fd)
    pp_ref = fr.pitch_pow * freq_comp[None, :]
    gains = P.gain_compensation(
        P.PerceptualFrames(pp_ref, table), fd)
    pp_deg = fd.pitch_pow * gains[:, None]
    loud_ref = P.loudness(pp_ref, table)
    loud_deg = P.loudness(pp_deg, table)
    return P.frame_disturbances(loud_ref, loud_deg, pp_ref, pp_deg, table)


def _bad_runs(sym: np.ndarray) -> List[slice]:
    bad = sym > _BAD_FRAME_THRESHOLD
    runs = []
    i = 0
    while i < len(bad):
        if not bad[i]:
            i += 1
            continue
        j = i
        while j < len(bad) and bad[j]:
            j += 1
        if j - i >= _MIN_BAD_RUN:
            runs.append(slice(i, j))
        i = j
    return runs


def _realign_interval(ref: SignalBuffer, deg: SignalBuffer,
                      starts: np.ndarray, delays: np.ndarray,
                      run: slice, nf: int) -> np.ndarray:
    """Search a replacement delay for one bad interval by raw
    cross-correlation of the (alignment-path) signals, within the
    standard search range around the current delay."""
    cfg = ref.cfg
    s0 = int(starts[run][0])
    s1 = int(starts[run][-1]) + nf
    seg_ref = ref.data[s0:s1]
    cur = int(np.median(delays[run]))
    span = cfg.search_samples
    d0 = max(s0 + cur - span, 0)
    d1 = min(s1 + cur + span, len(deg.data))
    seg_deg = deg.data[d0:d1]
    if (np.max(np.abs(seg_ref)) == 0 or np.max(np.abs(seg_deg)) == 0
            or len(seg_deg) <= len(seg_ref)):
        return delays
    corr = np.correlate(seg_deg, seg_ref, mode="valid")
    new_delay = d0 + int(np.argmax(np.abs(corr))) - s0
    out = delays.copy()
    out[run] = new_delay
    return out


def pesq_measure(ref_x: np.ndarray, deg_x: np.ndarray, fs: int,
                 mode: str = "nb") -> float:
    """Raw PESQ MOS (pre MOS-LQO mapping) for mode in {"nb", "wb"}."""
    if mode not in ("nb", "wb"):
        raise ValueError(f"mode must be 'nb' or 'wb', got {mode!r}")
    if mode == "wb" and fs != 16000:
        raise ValueError("wide-band PESQ is defined at 16 kHz only")
    cfg = rate_config(fs)
    ref_x = np.asarray(ref_x, np.float64).ravel()
    deg_x = np.asarray(deg_x, np.float64).ravel()
    if min(len(ref_x), len(deg_x)) < fs // 4:
        raise PesqError("PESQ needs at least 0.25 s of audio")
    if float(np.max(np.abs(ref_x))) == 0.0:
        raise PesqError("reference signal is all zeros")

    ref = make_buffer(ref_x, cfg)
    deg = make_buffer(deg_x, cfg)
    max_n = max(ref.n_samples, deg.n_samples)
    fix_power_level(ref, max_n)
    fix_power_level(deg, max_n)

    # model path: IRS receive (NB) / WB high-pass SOS (P.862.2)
    if mode == "nb":
        model_ref = ref.data.copy()
        model_ref[:] = apply_filter_db_curve(ref.data, fs,
                                             STANDARD_IRS_FILTER_DB)
        model_deg = apply_filter_db_curve(deg.data, fs,
                                          STANDARD_IRS_FILTER_DB)
    else:
        model_ref = iir_sos(ref.data, WB_IN_IIR_SOS)
        model_deg = iir_sos(deg.data, WB_IN_IIR_SOS)

    # alignment path: DC block + alignment IIR cascade
    ref.data = iir_sos(dc_block(ref.data, ref.active,
                                cfg.downsample), cfg.in_iir_sos)
    deg.data = iir_sos(dc_block(deg.data, deg.active,
                                cfg.downsample), cfg.in_iir_sos)
    A.compute_vad(ref)
    A.compute_vad(deg)
    utts = A.locate_utterances(ref, deg)

    starts, delays, nf = _frame_starts_and_delays(ref, utts)
    table_sp = P.SP_8K if fs == 8000 else P.SP_16K
    from .tables import band_table
    table = band_table(fs)

    model_ref_buf = SignalBuffer(model_ref, ref.n_samples, cfg)
    model_deg_buf = SignalBuffer(model_deg, deg.n_samples, cfg)

    sym, asym = _disturbances(model_ref_buf, model_deg_buf, starts,
                              _deg_starts(starts, delays, ref, nf),
                              table, table_sp)

    # bad-interval second pass: re-align, rescore, keep per-frame min
    for run in _bad_runs(sym):
        new_delays = _realign_interval(ref, deg, starts, delays, run, nf)
        if np.array_equal(new_delays[run], delays[run]):
            continue
        sym2, asym2 = _disturbances(
            model_ref_buf, model_deg_buf, starts,
            _deg_starts(starts, new_delays, ref, nf), table, table_sp)
        better = sym2[run] < sym[run]
        sym[run] = np.where(better, sym2[run], sym[run])
        asym[run] = np.where(better, asym2[run], asym[run])

    d_ind = P.lpq_weight(sym, 6.0, 2.0)
    a_ind = P.lpq_weight(asym, 1.0, 2.0)
    return 4.5 - 0.1 * d_ind - 0.0309 * a_ind


def _mos_lqo_nb(raw: float) -> float:
    """P.862.1 raw-to-LQO logistic."""
    return 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))


def _mos_lqo_wb(raw: float) -> float:
    """P.862.2 raw-to-LQO logistic."""
    return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))


def pesq(fs: int, ref: np.ndarray, deg: np.ndarray,
         mode: str = "wb") -> float:
    """MOS-LQO PESQ score; signature mirrors the `pesq` wheel."""
    raw = pesq_measure(ref, deg, fs, mode)
    return float(_mos_lqo_wb(raw) if mode == "wb" else _mos_lqo_nb(raw))
