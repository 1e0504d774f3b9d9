"""Enhancement inferencer: wav -> STFT -> model -> decompressed cIRM -> iSTFT -> wav.

Port of generative_audio_tpu/eval/inferencer.py: InferencerConfig, the
default mode `mag_complex_full_band_crm_mask` (:234-248), `enhance`, and both
branches of `enhance_dir` (per clip, and batched serving by length bucket,
:343-491). Clips are zero-padded up to a multiple of `length_bucket`
samples, as in the JAX package, and the output is cropped back.

The other seven inference modes raise until their slice lands (ROADMAP.md,
queue A item 7). PyTorch runs eagerly, so there is no per-bucket compile to
warm up; `last_rtf` is wall time after `torch.cuda.synchronize()` over
seconds of audio.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from generative_audio_torch.data.audio_io import write_wav
from generative_audio_torch.ops.mask import apply_crm, decompress_cIRM
from generative_audio_torch.ops.stft import istft_ri, stft_ri
from generative_audio_torch.utils.device import resolve_device

__all__ = ["InferencerConfig", "Inferencer"]

_NOT_PORTED_MODES = ("mag", "scaled_mask", "sub_band_crm_mask",
                     "full_band_crm_mask", "complex_full_band_crm_mask",
                     "overlapped_chunk", "time_domain")


@dataclasses.dataclass
class InferencerConfig:
    n_fft: int = 512
    hop_length: int = 256
    win_length: int = 512
    sr: int = 16000
    inference_type: str = "mag_complex_full_band_crm_mask"
    length_bucket: int = 16000        # pad clips up to multiples of this


class Inferencer:
    """Serves a FullSubNet+-style model `(mag, real, imag) -> cRM`.

    device: "cuda" (default; raises when there is none) or "cpu". The model
    is moved there and put in eval mode."""

    def __init__(self, model: nn.Module,
                 config: InferencerConfig = InferencerConfig(), device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.config = config
        self.last_rtf = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pad_bucket(self, noisy: np.ndarray) -> Tuple[np.ndarray, int]:
        bucket = self.config.length_bucket
        orig = noisy.shape[-1]
        padded = -(-orig // bucket) * bucket
        return np.pad(noisy, (0, padded - orig)), orig

    @torch.inference_mode()
    def _enhance_batch(self, wavs: np.ndarray) -> np.ndarray:
        """[B, L] float waveforms -> [B, L] enhanced, through the default mode."""
        c = self.config
        wav = torch.from_numpy(np.asarray(wavs, np.float32)).to(self.device)
        real, imag = stft_ri(wav, c.n_fft, c.hop_length, c.win_length)
        mag = torch.sqrt(real ** 2 + imag ** 2)
        crm = self.model(mag[:, None], real[:, None], imag[:, None])
        crm = decompress_cIRM(crm.permute(0, 2, 3, 1))
        er, ei = apply_crm(crm, real, imag)
        out = istft_ri(er, ei, c.n_fft, c.hop_length, c.win_length,
                       length=wav.shape[-1])
        return out.cpu().numpy()

    def mag_complex_full_band_crm_mask(self, noisy: np.ndarray) -> np.ndarray:
        """The default FullSubNet+ path: one clip [L] -> enhanced [L]."""
        padded, orig = self._pad_bucket(noisy)
        self._sync()
        t1 = time.perf_counter()
        out = self._enhance_batch(padded[None])
        self._sync()
        self.last_rtf = (time.perf_counter() - t1) / (orig / self.config.sr)
        return out[0, :orig]

    def enhance(self, noisy: np.ndarray) -> np.ndarray:
        mode = self.config.inference_type
        if mode in _NOT_PORTED_MODES:
            raise NotImplementedError(
                f"inference mode {mode!r} is not ported to generative_audio_torch "
                "yet (ROADMAP.md, queue A item 7)")
        if mode != "mag_complex_full_band_crm_mask":
            raise NotImplementedError(f"Unknown inference type {mode!r}")
        return self.mag_complex_full_band_crm_mask(noisy)

    def _write_enhanced(self, output_dir, name: str, enhanced: np.ndarray):
        enhanced = np.reshape(enhanced, -1)
        amp = np.max(np.abs(enhanced))
        if amp > 0:
            enhanced = enhanced / amp * 0.8
        write_wav(Path(output_dir) / f"{name}.wav", enhanced, self.config.sr)

    def enhance_dir(self, dataset, output_dir, log=print,
                    batch_size: int = 1) -> None:
        """Enhance a dataset of (waveform, name) items into int16 wavs
        peak-normalised to 0.8.

        batch_size=1 runs clip by clip through `enhance`. batch_size>1 is the
        serving mode: clips are grouped by padded bucket length and run in
        batches of up to batch_size per bucket (default mode only); last_rtf
        is then the wall time of the whole run over the seconds served."""
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        if batch_size <= 1:
            for i in range(len(dataset)):
                noisy, name = dataset[i]
                self._write_enhanced(output_dir, name, self.enhance(noisy))
                log(f"[{i + 1}/{len(dataset)}] {name} rtf={self.last_rtf}")
            return

        if self.config.inference_type != "mag_complex_full_band_crm_mask":
            raise NotImplementedError(
                "batched enhance_dir serves mag_complex_full_band_crm_mask only")
        bucket = self.config.length_bucket
        groups: Dict[int, List] = {}
        for i in range(len(dataset)):
            noisy, name = dataset[i]
            groups.setdefault(-(-len(noisy) // bucket) * bucket, []).append(
                (noisy, name))

        done = 0
        total_audio_s = 0.0
        self._sync()
        t0 = time.perf_counter()
        for padded_len, items in sorted(groups.items()):
            for start in range(0, len(items), batch_size):
                chunk = items[start:start + batch_size]
                wavs = np.zeros((len(chunk), padded_len), np.float32)
                for j, (noisy, _) in enumerate(chunk):
                    wavs[j, :len(noisy)] = noisy
                out = self._enhance_batch(wavs)
                for j, (noisy, name) in enumerate(chunk):
                    self._write_enhanced(output_dir, name, out[j, :len(noisy)])
                done += len(chunk)
                total_audio_s += sum(len(n) for n, _ in chunk) / self.config.sr
                log(f"[{done}/{len(dataset)}] batch of {len(chunk)}")
        self._sync()
        self.last_rtf = (time.perf_counter() - t0) / max(total_audio_s, 1e-9)
        log(f"served {done} clips, rtf={self.last_rtf:.4f}")
