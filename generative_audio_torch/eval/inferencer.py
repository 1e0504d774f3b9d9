"""Enhancement inferencer: the eight inference modes of the reference, the
overlapped-chunk program that streaming shares, and batched serving.

Port of generative_audio_tpu/eval/inferencer.py. Modes (`enhance` dispatches
by `InferencerConfig.inference_type`; an unknown name raises
NotImplementedError):
  * `mag`: a magnitude model, reconstructed with the noisy phase;
  * `scaled_mask`: a real mask per component of the complex spectrum;
  * `sub_band_crm_mask`: a sub-band model over the 2n+1 neighbour bins of
    every frequency (one clip, [F, 2n+1, T] in, [F, 2, T] out);
  * `full_band_crm_mask`: a magnitude-input cRM model (FullSubNet v1);
  * `mag_complex_full_band_crm_mask` (the default): a (mag, real, imag)-input
    cRM model (FullSubNet+);
  * `complex_full_band_crm_mask`: a stacked (real, imag)-input cRM model;
  * `overlapped_chunk`: Hann-crossfaded 50%-overlap chunks with a 256-sample
    noisy pre-roll, through a waveform model or the default cRM pipeline
    (`chunk_model`); eval/streaming.py runs the same program incrementally;
  * `time_domain`: a waveform-to-waveform model.
Clips are zero-padded up to a multiple of `length_bucket` samples and the
output is cropped back. PyTorch runs eagerly, so a single request has no
compile to warm up; `last_rtf` is wall time from a synchronized start to
the result on the host, over seconds of audio.

A result leaves the card by a non-blocking copy into pinned host memory
followed by a CUDA event (`_Pending`), so that a writer thread or a stream
waits on that event and not on a copy queued behind later work.
"""
from __future__ import annotations

import dataclasses
import inspect
import queue
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from generative_audio_torch.data.audio_io import write_wav
from generative_audio_torch.ops.mask import apply_crm, decompress_cIRM
from generative_audio_torch.ops.stft import hann_window, istft_ri, stft_ri
from generative_audio_torch.ops.subband import band_unfold
from generative_audio_torch.utils.device import resolve_device

__all__ = ["InferencerConfig", "Inferencer"]

MODES = ("mag", "scaled_mask", "sub_band_crm_mask", "full_band_crm_mask",
         "mag_complex_full_band_crm_mask", "complex_full_band_crm_mask",
         "overlapped_chunk", "time_domain")
# the modes batched enhance_dir serves (cRM models over a batch of clips),
# and their programs
_BATCHED_MODES = {"mag_complex_full_band_crm_mask": "_mag_complex",
                  "full_band_crm_mask": "_full_band"}
PRE_ROLL = 256      # noisy samples ahead of each chunk (ref inferencer.py:205-213)

Program = Callable[[torch.Tensor], torch.Tensor]     # [B, L] -> [B, L]


@dataclasses.dataclass
class InferencerConfig:
    n_fft: int = 512
    hop_length: int = 256
    win_length: int = 512
    sr: int = 16000
    inference_type: str = "mag_complex_full_band_crm_mask"
    length_bucket: int = 16000        # pad clips up to multiples of this
    chunk_length_seconds: int = 4     # for overlapped_chunk
    n_neighbor: int = 15              # for sub_band_crm_mask
    # overlapped_chunk per-chunk model kind: "waveform" (forward(wav) ->
    # wav), "spectral" (forward(mag, real, imag) -> cRM, run through the
    # default cRM pipeline per chunk), or "auto": decided from the
    # signature of the model's forward, and an error where the signature
    # cannot decide (*args, or both conventions callable).
    chunk_model: str = "auto"


class _Pending:
    """A float32 result on its way to the host. On CUDA a non-blocking copy
    into pinned memory and the event recorded after it; on the CPU the
    tensor itself, ready at once."""

    def __init__(self, out: torch.Tensor):
        out = out.float()
        self.event = None
        if out.is_cuda:
            self.host = torch.empty(out.shape, dtype=torch.float32,
                                    pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = out

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class Inferencer:
    """Serves an `nn.Module` in one of the eight modes. A model that drops
    bands for a batch above one clip (FullSubNet's num_groups_in_drop_band >
    1) cannot serve batches through a cRM mode: its mask no longer covers
    the spectrum, and the Inferencer raises.

    device: "cuda" (default; raises when there is none) or "cpu". The model
    is moved there and put in eval mode."""

    def __init__(self, model: nn.Module,
                 config: InferencerConfig = InferencerConfig(), device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.config = config
        self.last_rtf = None

    # ---------------------------------------------------------- helpers ----
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pad_bucket(self, noisy: np.ndarray) -> Tuple[np.ndarray, int]:
        bucket = self.config.length_bucket
        orig = noisy.shape[-1]
        padded = -(-orig // bucket) * bucket
        return np.pad(noisy, (0, padded - orig)), orig

    def _dispatch(self, program: Program, wavs: np.ndarray) -> _Pending:
        """Run `program` on [B, L] float32 waveforms on the device; the
        result is on its way to the host. On CUDA the input goes through
        pinned memory, so that nothing here waits for earlier work."""
        x = torch.from_numpy(np.ascontiguousarray(wavs, np.float32))
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        with torch.inference_mode():
            return _Pending(program(x))

    def _run(self, program: Program, noisy: np.ndarray) -> np.ndarray:
        """One clip [L] -> enhanced [L] through `program`, timed."""
        padded, orig = self._pad_bucket(noisy)
        self._sync()
        t1 = time.perf_counter()
        out = self._dispatch(program, padded[None]).result()
        self.last_rtf = (time.perf_counter() - t1) / (orig / self.config.sr)
        return out[0, :orig]

    def _spectra(self, wav: torch.Tensor):
        c = self.config
        real, imag = stft_ri(wav, c.n_fft, c.hop_length, c.win_length)
        return torch.sqrt(real ** 2 + imag ** 2), real, imag

    def _istft(self, real: torch.Tensor, imag: torch.Tensor,
               length: int) -> torch.Tensor:
        c = self.config
        return istft_ri(real, imag, c.n_fft, c.hop_length, c.win_length,
                        length=length)

    def _crm_out(self, crm: torch.Tensor, real: torch.Tensor,
                 imag: torch.Tensor, length: int) -> torch.Tensor:
        """Compressed cRM [B, 2, F, T] applied to the noisy spectrum."""
        if crm.shape[2] != real.shape[1]:
            raise ValueError(
                f"the model's mask has {crm.shape[2]} of {real.shape[1]} "
                "frequencies: serve a batch with num_groups_in_drop_band=1")
        er, ei = apply_crm(decompress_cIRM(crm.permute(0, 2, 3, 1)), real,
                           imag)
        return self._istft(er, ei, length)

    # ----------------------------------------------- programs by mode ----
    def _mag(self, wav: torch.Tensor) -> torch.Tensor:
        mag, real, imag = self._spectra(wav)
        phase = torch.atan2(imag, real)
        enhanced = self.model(mag[:, None])[:, 0].float()
        return self._istft(enhanced * torch.cos(phase),
                           enhanced * torch.sin(phase), wav.shape[-1])

    def _scaled_mask(self, wav: torch.Tensor) -> torch.Tensor:
        mag, real, imag = self._spectra(wav)
        mask = self.model(mag[:, None]).float()              # [B, 2, F, T]
        return self._istft(real * mask[:, 0], imag * mask[:, 1],
                           wav.shape[-1])

    def _sub_band(self, wav: torch.Tensor) -> torch.Tensor:
        """One clip: every frequency's 2n+1 neighbours are a row of the
        model's batch."""
        mag, real, imag = self._spectra(wav)                 # [1, F, T]
        n, f = self.config.n_neighbor, mag.shape[1]
        unfolded = band_unfold(mag[:, None], n).reshape(f, 2 * n + 1, -1)
        crm = self.model(unfolded).float().permute(0, 2, 1)  # [F, T, 2]
        er, ei = apply_crm(decompress_cIRM(crm, limit=9.99), real[0], imag[0])
        return self._istft(er[None], ei[None], wav.shape[-1])

    def _full_band(self, wav: torch.Tensor) -> torch.Tensor:
        mag, real, imag = self._spectra(wav)
        return self._crm_out(self.model(mag[:, None]), real, imag,
                             wav.shape[-1])

    def _mag_complex(self, wav: torch.Tensor) -> torch.Tensor:
        mag, real, imag = self._spectra(wav)
        crm = self.model(mag[:, None], real[:, None], imag[:, None])
        return self._crm_out(crm, real, imag, wav.shape[-1])

    def _complex(self, wav: torch.Tensor) -> torch.Tensor:
        _, real, imag = self._spectra(wav)
        crm = self.model(torch.stack([real, imag], dim=1))
        return self._crm_out(crm, real, imag, wav.shape[-1])

    def _time_domain(self, wav: torch.Tensor) -> torch.Tensor:
        return self.model(wav)

    # ------------------------------------------------------------ modes ----
    def mag(self, noisy: np.ndarray) -> np.ndarray:
        """Magnitude-only model; reconstruct with the noisy phase."""
        return self._run(self._mag, noisy)

    def scaled_mask(self, noisy: np.ndarray) -> np.ndarray:
        """Real scaling mask [B, 2, F, T] on the complex spectrum."""
        return self._run(self._scaled_mask, noisy)

    def sub_band_crm_mask(self, noisy: np.ndarray) -> np.ndarray:
        """Per-frequency unfolded sub-band inference; the cRM saturates at
        9.99."""
        return self._run(self._sub_band, noisy)

    def full_band_crm_mask(self, noisy: np.ndarray) -> np.ndarray:
        """Magnitude-input cRM model, e.g. FullSubNet v1."""
        return self._run(self._full_band, noisy)

    def mag_complex_full_band_crm_mask(self, noisy: np.ndarray) -> np.ndarray:
        """The default FullSubNet+ path."""
        return self._run(self._mag_complex, noisy)

    def complex_full_band_crm_mask(self, noisy: np.ndarray) -> np.ndarray:
        """Stacked (real, imag) input model."""
        return self._run(self._complex, noisy)

    def time_domain(self, noisy: np.ndarray) -> np.ndarray:
        """Direct waveform-to-waveform model."""
        return self._run(self._time_domain, noisy)

    def _chunk_model_is_waveform(self) -> bool:
        """The overlapped_chunk model kind (config.chunk_model). "auto"
        reads the signature of the model's forward: one required
        positional input is the waveform convention, three the spectral
        one. A signature that allows both, neither, or hides its arity
        behind *args raises."""
        kind = self.config.chunk_model
        if kind in ("waveform", "spectral"):
            return kind == "waveform"
        if kind != "auto":
            raise ValueError("chunk_model must be waveform/spectral/auto, "
                             f"got {kind!r}")
        params = list(inspect.signature(self.model.forward).parameters.values())
        ask = "set InferencerConfig.chunk_model to 'waveform' or 'spectral'"
        if any(p.kind is p.VAR_POSITIONAL for p in params):
            raise ValueError("chunk_model='auto': the model's forward takes "
                             f"*args, so its signature cannot decide; {ask}")
        pos = [p for p in params
               if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        n_required = sum(p.default is p.empty for p in pos)
        wav_callable = n_required <= 1 <= len(pos)          # forward(wav)
        spec_callable = n_required <= 3 <= len(pos)         # (mag, real, imag)
        if wav_callable != spec_callable:
            return wav_callable
        raise ValueError(
            "chunk_model='auto': the model's forward takes "
            f"{'both' if wav_callable else 'neither'} the waveform (wav) and "
            f"the spectral (mag, real, imag) convention; {ask}")

    def _chunk_program(self) -> Program:
        """The per-chunk waveform-to-waveform program shared by
        `overlapped_chunk` and `eval.streaming.StreamingEnhancer`."""
        return (self.model if self._chunk_model_is_waveform()
                else self._mag_complex)

    def overlapped_chunk(self, noisy: np.ndarray) -> np.ndarray:
        """Streaming Hann-crossfaded 50%-overlap chunks with a 256-sample
        noisy pre-roll (ref :191-250). `noisy` is [L], or [K, L] for K clips
        that run as K rows of every chunk."""
        c = self.config
        chunk_length = c.sr * c.chunk_length_seconds
        hop = chunk_length // 2
        x = np.asarray(noisy, np.float32)
        length = x.shape[-1]
        rows = x.reshape(-1, length)
        num_chunks = int(length / hop) + 1
        win = hann_window(chunk_length).numpy()
        program = self._chunk_program()

        prev = None
        out = []
        t_start = time.perf_counter()
        for chunk_idx in range(num_chunks):
            start = chunk_idx * hop
            seg = rows[:, start:start + chunk_length]
            if seg.shape[-1] < chunk_length:
                seg = np.pad(seg, ((0, 0), (0, chunk_length - seg.shape[-1])))
            if chunk_idx == 0:
                pad = np.zeros((rows.shape[0], PRE_ROLL), np.float32)
            else:
                pad = rows[:, start - PRE_ROLL:start]
            chunk_in = np.concatenate([pad, seg], axis=-1)
            enhanced = self._dispatch(program, chunk_in).result()[:, PRE_ROLL:]
            if chunk_idx == 0:
                cur = enhanced[:, :hop]
                prev = enhanced[:, hop:] * win[hop:]
            else:
                enhanced = enhanced * win[: enhanced.shape[-1]]
                tmp = enhanced[:, :hop]
                m = min(tmp.shape[-1], prev.shape[-1])
                cur = tmp[:, :m] + prev[:, :m]
                prev = enhanced[:, hop:]
            out.append(cur)
        self.last_rtf = (time.perf_counter() - t_start) / (length / c.sr)
        return np.concatenate(out, axis=-1)[:, :length].reshape(x.shape)

    # -------------------------------------------------------------- run ----
    def enhance(self, noisy: np.ndarray) -> np.ndarray:
        mode = self.config.inference_type
        if mode not in MODES:
            raise NotImplementedError(f"Unknown inference type {mode!r}")
        return getattr(self, mode)(noisy)

    def _write_enhanced(self, output_dir, name: str, enhanced: np.ndarray):
        enhanced = np.reshape(enhanced, -1)
        amp = np.max(np.abs(enhanced))
        if amp > 0:
            enhanced = enhanced / amp * 0.8
        write_wav(Path(output_dir) / f"{name}.wav", enhanced, self.config.sr)

    def _warm_batch_size(self, program: Program, padded_len: int,
                         batch_size: int, log) -> int:
        """The largest batch, halving from batch_size, that runs at this
        bucket length without running out of device memory. Only
        torch.OutOfMemoryError halves; any other error is raised."""
        bs = batch_size
        while True:
            try:
                self._dispatch(program, np.zeros((bs, padded_len),
                                                 np.float32)).result()
                return bs
            except torch.OutOfMemoryError:
                if bs == 1:
                    raise
            # out of the handler, so that its traceback frees the tensors
            log(f"bucket {padded_len}: batch {bs} ran out of device memory; "
                f"retrying at {bs // 2}")
            bs //= 2
            torch.cuda.empty_cache()

    def enhance_dir(self, dataset, output_dir, log=print,
                    batch_size: int = 1) -> None:
        """Enhance a dataset of (waveform, name) items into int16 wavs
        peak-normalised to 0.8.

        batch_size=1 runs clip by clip through `enhance`. batch_size>1 is
        the serving mode (the two cRM modes): clips are grouped by padded
        bucket length; each bucket runs once outside the timed window at the
        largest batch it serves (its clips, up to batch_size), halving that
        batch while the card runs out of memory;
        then the batches of up to that size run while a writer thread waits
        for each result's event and writes its clips (a queue of 2). The
        batch dimension is not padded. last_rtf is the wall time of the
        serving loop over the seconds served."""
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        if batch_size <= 1:
            for i in range(len(dataset)):
                noisy, name = dataset[i]
                self._write_enhanced(output_dir, name, self.enhance(noisy))
                log(f"[{i + 1}/{len(dataset)}] {name} rtf={self.last_rtf}")
            return

        if self.config.inference_type not in _BATCHED_MODES:
            raise NotImplementedError(
                "batched enhance_dir serves the cRM modes only: "
                f"{', '.join(_BATCHED_MODES)}")
        program = getattr(self, _BATCHED_MODES[self.config.inference_type])
        bucket = self.config.length_bucket
        groups: Dict[int, List] = {}
        for i in range(len(dataset)):
            noisy, name = dataset[i]
            groups.setdefault(-(-len(noisy) // bucket) * bucket, []).append(
                (noisy, name))
        bucket_bs = {plen: self._warm_batch_size(
            program, plen, min(batch_size, len(groups[plen])), log)
            for plen in sorted(groups)}

        done = 0
        writes: queue.Queue = queue.Queue(maxsize=2)
        writer_err: List[BaseException] = []

        def _writer():
            nonlocal done
            while True:
                item = writes.get()
                if item is None:
                    return
                if writer_err:
                    continue            # drain without processing
                chunk, pending = item
                try:
                    out = pending.result()
                    for j, (noisy, name) in enumerate(chunk):
                        self._write_enhanced(output_dir, name,
                                             out[j, :len(noisy)])
                    done += len(chunk)
                    log(f"[{done}/{len(dataset)}] batch of {len(chunk)}")
                except Exception as e:          # raised after the join
                    writer_err.append(e)

        writer = threading.Thread(target=_writer, daemon=True)
        total_audio_s = 0.0
        self._sync()
        t0 = time.perf_counter()
        writer.start()
        try:
            for padded_len, items in sorted(groups.items()):
                bs = bucket_bs[padded_len]
                for start in range(0, len(items), bs):
                    chunk = items[start:start + bs]
                    wavs = np.zeros((len(chunk), padded_len), np.float32)
                    for j, (noisy, _) in enumerate(chunk):
                        wavs[j, :len(noisy)] = noisy
                    # blocks only while two batches wait for the writer
                    writes.put((chunk, self._dispatch(program, wavs)))
                    total_audio_s += sum(len(n) for n, _ in chunk) / self.config.sr
        finally:
            writes.put(None)
            writer.join()
        if writer_err:
            raise writer_err[0]
        self.last_rtf = (time.perf_counter() - t0) / max(total_audio_s, 1e-9)
        log(f"served {done} clips, rtf={self.last_rtf:.4f}")
