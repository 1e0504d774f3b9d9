"""P.862 time alignment: VAD, crude + fine delay estimation, utterances.

Pipeline (matching the standard's alignment stage):

  1. `compute_vad` — block-power voice activity on the alignment-path
     filtered signal (blocks of `downsample` samples), with an iterative
     noise-floor estimate (12 refinement passes), ratio-to-floor
     normalisation, minimum-burst and gap-joining rules, and a log-VAD
     envelope used for correlation.
  2. `crude_align` — whole-signal (or per-utterance) cross-correlation
     of the log-VAD envelopes; resolves delay to one downsample block.
  3. `locate_utterances` — speech runs of at least MIN_UTT_BLOCKS on
     the reference become utterances; each is crude-aligned then
     fine-aligned, and long utterances whose two halves align to
     different delays are split at the best boundary (the standard's
     utterance splitting, one recursion level per split, bounded by
     MAX_UTTERANCES).
  4. `time_align` — fine alignment: Hann-windowed Align_Nfft frames at
     quarter-frame hops, circular FFT cross-correlation compressed by
     |.|**0.125, peaks voted into a delay histogram with a triangular
     kernel; the histogram argmax is the delay and its mass fraction
     the confidence.

Delay convention: degraded_sample_index = reference_sample_index + delay.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
from scipy.signal import fftconvolve

from .common import (JOIN_SPEECH_BLOCKS, MAX_UTTERANCES, MIN_SPEECH_BLOCKS,
                     MIN_UTT_BLOCKS, SEARCHBUFFER, SignalBuffer)

__all__ = ["Utterance", "compute_vad", "crude_align", "time_align",
           "locate_utterances"]

# speech = blocks at least 3 dB above the estimated noise floor
_SPEECH_RATIO = 2.0


@dataclass
class Utterance:
    start_block: int           # ref coords, downsample blocks
    end_block: int             # exclusive
    delay: int = 0             # samples; deg = ref + delay
    confidence: float = 0.0


def compute_vad(buf: SignalBuffer) -> None:
    d = buf.cfg.downsample
    n_blocks = buf.n_samples // d
    x = buf.data[:n_blocks * d].reshape(n_blocks, d)
    vad = np.mean(x ** 2, axis=1)

    level_min = max(float(vad.max()) * 1e-4, 1e-10)
    vad = np.maximum(vad, level_min)

    # iterative noise-floor estimate
    thresh = float(vad.mean())
    noise_level = thresh
    for _ in range(12):
        noise = vad[vad <= thresh]
        if len(noise) == 0:
            break
        noise_level = float(noise.mean())
        thresh = 1.001 * (noise_level + 2.0 * float(noise.std()))
    noise_level = max(noise_level, 1e-10)

    vad = vad / noise_level            # ratio to noise floor
    speech = vad > _SPEECH_RATIO

    # drop speech bursts shorter than MIN_SPEECH_BLOCKS
    speech = _filter_runs(speech, True, MIN_SPEECH_BLOCKS)
    # join gaps shorter than JOIN_SPEECH_BLOCKS between speech regions
    speech = ~_filter_runs(~speech, True, JOIN_SPEECH_BLOCKS,
                           interior_only=True)

    log_vad = np.where(speech, np.log(np.maximum(vad, 1.0)), 0.0)
    buf.vad = np.where(speech, vad, 0.0)
    buf.log_vad = log_vad


def _filter_runs(mask: np.ndarray, value: bool, min_len: int,
                 interior_only: bool = False) -> np.ndarray:
    """Zero out runs of `value` shorter than min_len. With
    interior_only, head/tail runs are left alone (a leading silence is
    not a 'gap' to join)."""
    mask = mask.copy()
    n = len(mask)
    i = 0
    while i < n:
        if mask[i] != value:
            i += 1
            continue
        j = i
        while j < n and mask[j] == value:
            j += 1
        if j - i < min_len and not (interior_only and (i == 0 or j == n)):
            mask[i:j] = not value
        i = j
    return mask


def crude_align(ref: SignalBuffer, deg: SignalBuffer,
                start_block: Optional[int] = None,
                end_block: Optional[int] = None) -> int:
    """Delay estimate (in samples) from log-VAD cross-correlation.

    With start/end the reference envelope is windowed to one utterance;
    the degraded envelope always spans the whole signal."""
    r = ref.log_vad
    if start_block is not None:
        window = np.zeros_like(r)
        window[start_block:end_block] = r[start_block:end_block]
        r = window
    g = deg.log_vad
    if not np.any(r) or not np.any(g):
        return 0
    corr = fftconvolve(g, r[::-1])
    # the valid delay range is +-SEARCHBUFFER blocks: take the argmax
    # WITHIN that window (clipping a distant global peak into range
    # would manufacture a garbage delay)
    center = len(r) - 1
    lo = max(center - SEARCHBUFFER, 0)
    hi = min(center + SEARCHBUFFER, len(corr) - 1)
    lag_blocks = lo + int(np.argmax(corr[lo:hi + 1])) - center
    return lag_blocks * ref.cfg.downsample


def time_align(ref: SignalBuffer, deg: SignalBuffer, start_block: int,
               end_block: int, crude_delay: int) -> tuple:
    """Fine alignment over one utterance. Returns (delay, confidence)."""
    cfg = ref.cfg
    nfft = cfg.align_nfft
    d = cfg.downsample
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(nfft) / nfft))

    start = start_block * d
    stop = end_block * d
    hist = np.zeros(nfft, np.float64)
    kernel = nfft // 64
    tri = 1.0 - np.abs(np.arange(-kernel, kernel + 1)) / (kernel + 1)

    startr = start
    while startr + nfft <= stop:
        startd = startr + crude_delay
        if startd < 0 or startd + nfft > len(deg.data):
            startr += nfft // 4
            continue
        x1 = ref.data[startr:startr + nfft] * window
        x2 = deg.data[startd:startd + nfft] * window
        if np.max(np.abs(x1)) > 0 and np.max(np.abs(x2)) > 0:
            corr = np.fft.irfft(np.conj(np.fft.rfft(x1))
                                * np.fft.rfft(x2), nfft)
            c = np.abs(corr) ** 0.125
            v_max = 0.99 * float(c.max())
            peaks = np.flatnonzero(c > v_max)
            for p in peaks:
                idx = (p + np.arange(-kernel, kernel + 1)) % nfft
                hist[idx] += tri * v_max
        startr += nfft // 4

    total = float(hist.sum())
    if total <= 0:
        return crude_delay, 0.0
    best = int(np.argmax(hist))
    lag = best if best <= nfft // 2 else best - nfft
    confidence = float(hist.max()) / total
    return crude_delay + lag, confidence


def _split_point(ref: SignalBuffer, deg: SignalBuffer,
                 utt: Utterance) -> Optional[int]:
    """If the utterance's two halves align to clearly different delays,
    return a split block; else None (the standard's split_align test)."""
    length = utt.end_block - utt.start_block
    if length < 2 * MIN_UTT_BLOCKS:
        return None
    mid = utt.start_block + length // 2
    c1 = crude_align(ref, deg, utt.start_block, mid)
    d1, conf1 = time_align(ref, deg, utt.start_block, mid, c1)
    c2 = crude_align(ref, deg, mid, utt.end_block)
    d2, conf2 = time_align(ref, deg, mid, utt.end_block, c2)
    if conf1 <= 0 or conf2 <= 0:
        return None
    # a split is accepted when the halves disagree by more than one
    # downsample block and both alignments are at least as confident as
    # the joint one
    if (abs(d1 - d2) > ref.cfg.downsample
            and min(conf1, conf2) > utt.confidence):
        return mid
    return None


def locate_utterances(ref: SignalBuffer, deg: SignalBuffer) -> List[Utterance]:
    speech = ref.vad > 0
    utts: List[Utterance] = []
    n = len(speech)
    i = 0
    while i < n:
        if not speech[i]:
            i += 1
            continue
        j = i
        while j < n and speech[j]:
            j += 1
        if j - i >= MIN_UTT_BLOCKS:
            utts.append(Utterance(i, j))
        i = j

    if not utts:
        # no speech located (noise-only input): one pseudo-utterance
        # over the active region with the whole-signal crude delay
        d = ref.cfg.downsample
        utts = [Utterance(SEARCHBUFFER, ref.n_samples // d - SEARCHBUFFER)]

    whole_delay = crude_align(ref, deg)

    aligned: List[Utterance] = []
    queue = list(utts)
    while queue:
        utt = queue.pop(0)
        c = crude_align(ref, deg, utt.start_block, utt.end_block)
        if c == 0 and whole_delay != 0:
            c = whole_delay
        utt.delay, utt.confidence = time_align(
            ref, deg, utt.start_block, utt.end_block, c)
        # splitting adds one utterance; allowed only under the cap
        if len(aligned) + len(queue) + 2 <= MAX_UTTERANCES:
            split = _split_point(ref, deg, utt)
            if split is not None:
                queue.insert(0, Utterance(split, utt.end_block))
                queue.insert(0, Utterance(utt.start_block, split))
                continue
        aligned.append(utt)
    aligned.sort(key=lambda u: u.start_block)
    return aligned
