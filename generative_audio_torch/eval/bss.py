"""First-party BSS-eval SDR (single reference source). The port's own copy
of generative_audio_tpu/eval/bss.py, the same arithmetic.

The reference's ``SDR`` metric is ``mir_eval.separation.bss_eval_sources``
on a single (reference, estimate) pair (audio_zen/metrics.py:56-58), which
is BSS Eval v3 (Vincent et al. 2006): the estimate is decomposed by
least-squares projection onto the span of the reference delayed by
0..L-1 samples (L = 512 taps), and

    SDR = 10 log10( ||s_filt||^2 / ||e_interf + e_artif||^2 )

With one reference source the interference term is identically zero, so
SDR = 10 log10(||proj||^2 / ||est - proj||^2) where ``proj`` is the
projection of the (zero-padded) estimate onto the delayed-reference
subspace. Without the mir_eval wheel, this module computes
that projection from scratch; correctness is pinned by

  * a deliberately-different dense direct construction of the same
    least-squares problem (``_project_dense``) cross-checked on random
    signals in tests/test_sdr.py, and
  * a gated bit-parity test against ``mir_eval`` for the day a wheel
    appears (the eval/pesq + STOI validation pattern).

Semantics transcribed from the published BSS Eval v3 definition as
implemented by mir_eval.separation (FFT cross-correlations, Toeplitz
Gram matrix, ``solve`` with an ``lstsq`` fallback, FFT filtering).
"""
from __future__ import annotations

import numpy as np
from scipy.linalg import toeplitz
from scipy.signal import fftconvolve

__all__ = ["bss_eval_sdr", "FLEN"]

FLEN = 512  # distortion-filter length, BSS Eval v3 / mir_eval default


def _project(reference: np.ndarray, estimate: np.ndarray,
             flen: int) -> np.ndarray:
    """LS projection of ``estimate`` onto span{reference delayed 0..flen-1}.

    Returns the projected signal of length ``n + flen - 1`` (the full
    support of the distortion filter applied to the reference).
    """
    n = reference.shape[0]
    ref_p = np.concatenate([reference, np.zeros(flen - 1)])
    est_p = np.concatenate([estimate, np.zeros(flen - 1)])
    n_fft = int(2 ** np.ceil(np.log2(n + flen - 1)))
    rf = np.fft.fft(ref_p, n=n_fft)
    ef = np.fft.fft(est_p, n=n_fft)

    # Gram matrix of delayed references: G[i, j] = <ref>>i, ref>>j> is a
    # symmetric Toeplitz of the circular autocorrelation (zero padding to
    # >= n + flen - 1 makes the circular correlation exact at lags < flen)
    acorr = np.real(np.fft.ifft(rf * np.conj(rf)))
    col = np.concatenate([acorr[:1], acorr[-1:-flen:-1]])
    G = toeplitz(col, r=acorr[:flen])

    # rhs: d[i] = <est, ref>>i>
    xcorr = np.real(np.fft.ifft(rf * np.conj(ef)))
    d = np.concatenate([xcorr[:1], xcorr[-1:-flen:-1]])

    try:
        c = np.linalg.solve(G, d)
    except np.linalg.LinAlgError:
        c = np.linalg.lstsq(G, d, rcond=None)[0]
    return fftconvolve(c, ref_p)[: n + flen - 1]


def _project_dense(reference: np.ndarray, estimate: np.ndarray,
                   flen: int) -> np.ndarray:
    """Literal construction of the same projection: build the
    (n + flen - 1) x flen delay matrix column by column and ``lstsq`` it.
    O(n * flen^2) — test-sized signals only. Kept in the package (not the
    test file) so both implementations version together."""
    n = reference.shape[0]
    m = n + flen - 1
    A = np.zeros((m, flen))
    for k in range(flen):
        A[k:k + n, k] = reference
    est_p = np.concatenate([estimate, np.zeros(flen - 1)])
    coef = np.linalg.lstsq(A, est_p, rcond=None)[0]
    return A @ coef


def bss_eval_sdr(reference: np.ndarray, estimation: np.ndarray,
                 flen: int = FLEN) -> float:
    """BSS Eval v3 SDR for one reference source, one estimate.

    Matches ``mir_eval.separation.bss_eval_sources(ref[None], est[None])``'s
    SDR output for the single-source case (where e_interf == 0 and the
    source permutation is trivial).
    """
    reference = np.asarray(reference, np.float64).reshape(-1)
    estimation = np.asarray(estimation, np.float64).reshape(-1)
    if reference.shape != estimation.shape:
        raise ValueError(
            f"reference/estimation length mismatch: "
            f"{reference.shape} vs {estimation.shape}")
    if not np.any(reference):
        raise ValueError("reference source is all-silent (mir_eval errors "
                         "on silent sources)")
    proj = _project(reference, estimation, flen)
    est_p = np.concatenate([estimation, np.zeros(flen - 1)])
    e_artif = est_p - proj
    num = float(np.sum(proj ** 2))
    den = float(np.sum(e_artif ** 2))
    if den == 0.0:
        return np.inf
    return float(10 * np.log10(num / den))
