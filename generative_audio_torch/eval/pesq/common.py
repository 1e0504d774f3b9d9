"""P.862 signal buffer layout, rate constants and level alignment.

The standard processes signals in a fixed buffer layout: the raw file
is framed by SEARCHBUFFER downsample-blocks of zeros on each side (the
alignment search range) and DATAPADDING_MSECS of trailing zeros (filter
tails), and all sample positions in the algorithm are expressed in that
padded coordinate system.  Level alignment scales each signal so its
average power through the 350-3250 Hz bandpass equals TARGET_AVG_POWER
(1e7) over the active region.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .filters import (ALIGN_FILTER_DB, IN_IIR_SOS_8K, IN_IIR_SOS_16K,
                      apply_filter_db_curve)

__all__ = ["RateConfig", "rate_config", "SignalBuffer", "make_buffer",
           "fix_power_level", "SEARCHBUFFER", "DATAPADDING_MSECS",
           "TARGET_AVG_POWER"]

SEARCHBUFFER = 75          # in downsample blocks, each side
DATAPADDING_MSECS = 320
TARGET_AVG_POWER = 1.0e7
MIN_SPEECH_BLOCKS = 4      # MINSPEECHLGTH: shortest kept speech burst
JOIN_SPEECH_BLOCKS = 50    # JOINSPEECHLGTH: gaps shorter than this join
MIN_UTT_BLOCKS = 50        # MINUTTLENGTH: shortest standalone utterance
MAX_UTTERANCES = 50


@dataclass(frozen=True)
class RateConfig:
    fs: int
    downsample: int        # envelope/VAD block size in samples
    align_nfft: int        # fine-alignment frame length
    in_iir_sos: np.ndarray  # alignment-path IIR cascade

    @property
    def search_samples(self) -> int:
        return SEARCHBUFFER * self.downsample

    @property
    def padding_samples(self) -> int:
        return DATAPADDING_MSECS * self.fs // 1000


def rate_config(fs: int) -> RateConfig:
    if fs == 8000:
        return RateConfig(8000, 32, 512, IN_IIR_SOS_8K)
    if fs == 16000:
        return RateConfig(16000, 64, 1024, IN_IIR_SOS_16K)
    raise ValueError(f"PESQ supports fs 8000/16000, got {fs}")


@dataclass
class SignalBuffer:
    """One signal in the padded P.862 coordinate system."""
    data: np.ndarray           # [search | signal | search | padding]
    n_samples: int             # signal + both search buffers
    cfg: RateConfig
    # VAD products (filled by align.compute_vad)
    vad: np.ndarray = field(default=None, repr=False)
    log_vad: np.ndarray = field(default=None, repr=False)

    @property
    def active(self) -> slice:
        """signal region (between the two search buffers)"""
        s = self.cfg.search_samples
        return slice(s, self.n_samples - s)


def make_buffer(x: np.ndarray, cfg: RateConfig) -> SignalBuffer:
    x = np.asarray(x, np.float64).ravel()
    s, pad = cfg.search_samples, cfg.padding_samples
    data = np.zeros(len(x) + 2 * s + pad, np.float64)
    data[s:s + len(x)] = x
    return SignalBuffer(data=data, n_samples=len(x) + 2 * s, cfg=cfg)


def fix_power_level(buf: SignalBuffer, max_n_samples: int) -> None:
    """Scale in place so the 350-3250 Hz average power is 1e7.

    The power window runs from the end of the leading search buffer to
    DATAPADDING past the start of the trailing one, and the divisor is
    computed from the LONGER of the two signals so both get the same
    effective normalisation window (the standard's pow_of call in
    fix_power_level)."""
    cfg = buf.cfg
    s, pad = cfg.search_samples, cfg.padding_samples
    filtered = apply_filter_db_curve(buf.data, cfg.fs, ALIGN_FILTER_DB)
    region = filtered[s:buf.n_samples - s + pad]
    divisor = max_n_samples - 2 * s + pad
    power = float(np.sum(region ** 2)) / divisor
    if power <= 0:
        return
    buf.data *= np.sqrt(TARGET_AVG_POWER / power)
