"""Real-time streaming enhancement: a push/pull wrapper over the
overlapped-chunk scheme.

Port of generative_audio_tpu/eval/streaming.py. The reference's only
streaming story is the offline `overlapped_chunk` inference mode
(fullsubnet_plus/inferencer/inferencer.py:191-250): Hann-crossfaded
50%-overlap chunks with a 256-sample noisy pre-roll, run over a complete
clip. This module computes the same thing incrementally, so a live source
can feed samples as they arrive and collect finalized enhanced audio with
bounded latency:

    stream = StreamingEnhancer(inferencer)
    for piece in microphone():          # pieces of any size
        play(stream.feed(piece))        # the samples finalized so far
    play(stream.flush())                # the tail

Several streams: feed [K, n] arrays instead of [n], and K lockstep streams
(a conference bridge, a fan-in server) share one K-row chunk program.

Guarantee: feed()/flush() give output bit-identical to
`Inferencer.overlapped_chunk` on the concatenated input run with the same
K rows (the same chunk program on the same shapes, the same crossfade
arithmetic in numpy float32). A K-stream row matches the single stream up
to the model's arithmetic at another row count (cuBLAS and the scan's
launch plan may change with the rows), not bit for bit.

Pipelining (`async_depth=d`): feed() launches every ready chunk without
waiting and returns the chunks whose results have reached the host (each
result is copied to pinned memory behind a CUDA event, which feed()
queries), keeping at most d chunks in flight. Values are unchanged; only
the feed() call on which a span is returned moves, by at most d chunks;
flush() drains everything.

Latency: a chunk starting at sample `s` finalizes output [s, s + hop) once
input through s + chunk_length has arrived, so an output sample waits
between hop and chunk_length input samples, plus the chunk's compute. Host
buffering is O(K x chunk_length).
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from generative_audio_torch.eval.inferencer import (
    PRE_ROLL, Inferencer, _Pending)
from generative_audio_torch.ops.stft import hann_window

__all__ = ["StreamingEnhancer"]


class StreamingEnhancer:
    """Incremental overlapped-chunk enhancement with carried crossfade state.

    Wraps an `Inferencer` (its device, model, `chunk_model` and
    `chunk_length_seconds`). `n_streams=1` (default) feeds and returns 1-D
    sample arrays; `n_streams=K` feeds and returns [K, n] arrays of K
    lockstep streams sharing one K-row chunk program. Not thread-safe; one
    instance per stream group. After `flush()` the instance resets and can
    stream again.
    """

    def __init__(self, inferencer: Inferencer, n_streams: int = 1,
                 async_depth: int = 0):
        self._inf = inferencer
        c = inferencer.config
        self.n_streams = n_streams
        self.chunk_length = c.sr * c.chunk_length_seconds
        self.hop = self.chunk_length // 2
        self._win = hann_window(self.chunk_length).numpy()
        self._program = inferencer._chunk_program()
        self.last_rtf: Optional[float] = None   # of the last flushed stream
        # async_depth=0: each ready chunk is launched and fetched inside
        # feed(). async_depth=d>0: up to d chunks stay in flight, and feed()
        # finalizes the chunks whose results have already landed.
        self.async_depth = int(async_depth)
        self.reset()

    # ------------------------------------------------------------- state --
    def reset(self):
        k = self.n_streams
        self._buf = np.zeros((k, 0), np.float32)  # raw from _buf_start
        self._buf_start = 0                   # absolute index of _buf[:, 0]
        self._total = 0                       # samples received per stream
        self._chunk_idx = 0                   # next chunk to launch
        self._emitted = 0                     # finalized samples emitted
        self._prev: Optional[np.ndarray] = None   # carried windowed tail
        self._compute_seconds = 0.0
        self._inflight: List[Tuple[int, _Pending]] = []
        self._finalized = 0                   # chunks finalized so far
        # where the time goes, per stream group
        self.t_dispatch = 0.0   # host preparation + the launch
        self.t_fetch = 0.0      # waiting for a result (its event)
        self.t_crossfade = 0.0  # window and crossfade arithmetic

    @property
    def latency_samples(self) -> int:
        """Algorithmic latency: input samples needed beyond a given output
        sample before it can be finalized."""
        return self.chunk_length

    @property
    def rtf(self) -> Optional[float]:
        """Compute real-time factor so far (processing time over per-stream
        audio time), the offline mode's convention. For K streams, divide
        by K for the per-stream share."""
        if self._emitted == 0:
            return None
        return self._compute_seconds / (self._emitted / self._inf.config.sr)

    # ----------------------------------------------------------- chunks --
    def _dispatch_chunk(self) -> None:
        """Launch chunk `self._chunk_idx` and retire the raw input samples
        no later chunk reads."""
        start = self._chunk_idx * self.hop
        rel = start - self._buf_start
        seg = self._buf[:, rel:rel + self.chunk_length]
        if seg.shape[-1] < self.chunk_length:  # only in the flush() phase
            seg = np.pad(seg,
                         ((0, 0), (0, self.chunk_length - seg.shape[-1])))
        if self._chunk_idx == 0:
            pad = np.zeros((self.n_streams, PRE_ROLL), np.float32)
        else:
            pad = self._buf[:, rel - PRE_ROLL:rel]
        t0 = time.perf_counter()
        pending = self._inf._dispatch(self._program,
                                      np.concatenate([pad, seg], axis=-1))
        dt = time.perf_counter() - t0
        self._compute_seconds += dt
        self.t_dispatch += dt
        self._inflight.append((self._chunk_idx, pending))
        self._chunk_idx += 1
        # the next chunk reads from (next_start - pre_roll)
        keep_from = self._chunk_idx * self.hop - PRE_ROLL - self._buf_start
        if keep_from > 0:
            self._buf = self._buf[:, keep_from:]
            self._buf_start += keep_from

    def _finalize_head(self) -> np.ndarray:
        """Wait for the oldest chunk in flight and crossfade it exactly as
        the offline loop does; returns its finalized [K, hop] samples."""
        idx, pending = self._inflight.pop(0)
        if idx != self._finalized:
            raise RuntimeError(f"chunk {idx} finalized out of order "
                               f"(expected {self._finalized})")
        t0 = time.perf_counter()
        enhanced = pending.result()             # its event, then the host copy
        t1 = time.perf_counter()
        self._compute_seconds += t1 - t0
        self.t_fetch += t1 - t0
        enhanced = enhanced[:, PRE_ROLL:]
        if idx == 0:
            cur = enhanced[:, :self.hop]
            self._prev = enhanced[:, self.hop:] * self._win[self.hop:]
        else:
            enhanced = enhanced * self._win[: enhanced.shape[-1]]
            tmp = enhanced[:, :self.hop]
            m = min(tmp.shape[-1], self._prev.shape[-1])
            cur = tmp[:, :m] + self._prev[:, :m]
            self._prev = enhanced[:, self.hop:]
        self.t_crossfade += time.perf_counter() - t1
        self._finalized += 1
        return cur

    def _collect(self, drain: bool) -> list:
        """Finalize chunks in flight: always down to async_depth, plus any
        head whose result has landed; everything when draining."""
        out = []
        while self._inflight:
            if not (drain or len(self._inflight) > self.async_depth
                    or self._inflight[0][1].ready()):
                break
            out.append(self._finalize_head())
        return out

    def _shape_in(self, samples: np.ndarray) -> np.ndarray:
        samples = np.asarray(samples, np.float32)
        if samples.ndim == 1:
            if self.n_streams != 1:
                raise ValueError(
                    f"1-D input for an n_streams={self.n_streams} enhancer;"
                    " feed [K, n] arrays")
            return samples.reshape(1, -1)
        if samples.ndim != 2 or samples.shape[0] != self.n_streams:
            raise ValueError(f"expected [{self.n_streams}, n] stream rows, "
                             f"got {samples.shape}")
        return samples

    def _shape_out(self, out: np.ndarray) -> np.ndarray:
        return out[0] if self.n_streams == 1 else out

    def _joined(self, out: list) -> np.ndarray:
        return (np.concatenate(out, axis=-1) if out
                else np.zeros((self.n_streams, 0), np.float32))

    # -------------------------------------------------------------- api --
    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Push raw samples ([n], or [K, n] for K streams); returns the
        newly finalized enhanced samples (possibly none, same leading
        shape). With async_depth=0, output sample i is returned by the
        feed() that supplies input sample i + chunk_length; with
        async_depth=d its chunk is launched on that feed but may be returned
        up to d chunks later. The values are the same either way."""
        samples = self._shape_in(samples)
        self._buf = np.concatenate([self._buf, samples], axis=-1)
        self._total += samples.shape[-1]
        # a chunk is ready when its whole window has arrived
        while self._chunk_idx * self.hop + self.chunk_length <= self._total:
            self._dispatch_chunk()
        done = self._joined(self._collect(drain=self.async_depth == 0))
        self._emitted += done.shape[-1]
        return self._shape_out(done)

    def flush(self) -> np.ndarray:
        """Drain: run the remaining (zero-padded) chunks and return the last
        enhanced samples, cropping the stream to its exact length (the
        offline mode's `num_chunks = len // hop + 1`, then `[:len]`). An
        empty stream runs no chunk. Resets the stream afterwards."""
        if self._total == 0:
            self.last_rtf = self.rtf
            self.reset()
            return self._shape_out(np.zeros((self.n_streams, 0), np.float32))
        num_chunks = int(self._total / self.hop) + 1
        while self._chunk_idx < num_chunks:
            self._dispatch_chunk()
        done = self._joined(self._collect(drain=True))
        done = done[:, : self._total - self._emitted]
        self._emitted += done.shape[-1]
        self.last_rtf = self.rtf
        self.reset()
        return self._shape_out(done)
