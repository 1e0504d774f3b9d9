"""The denoising-NPPC validator: each direction's cRM variation applied to the
noisy spectrogram, swept over alpha, as audio and as a figure.

Port of generative_audio_tpu/eval/nppc_denoising_validator.py:25-205
(reference nppc_audio/validator.py:55-302). The whole (pc, alpha) grid runs
on the device in one pass: the variations are taken in the complex-spectrum
domain (enhanced + alpha * pc_spec, as the reference does; in the compressed
cRM domain the decompress clip at +/-9.9 would flatten large alphas), and
every iSTFT with them. The wavs are peak-normalised, as the reference
writes them.

The figure keeps the JAX package's layout, (1 + n_dirs) rows x max(n_alphas
+ 1, 9) columns of spectrogram panels in dB, origin lower, the fixed
[-60, 0] dB range where the JAX figure sets one, each other panel scaled to
its own range; it is written as a PNG by utils/plot (no matplotlib or PIL),
without titles or colorbars.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from generative_audio_torch.data.audio_io import write_wav
from generative_audio_torch.ops.mask import apply_crm, decompress_cIRM
from generative_audio_torch.ops.stft import istft_ri, stft_ri
from generative_audio_torch.utils.device import resolve_device
from generative_audio_torch.utils.plot import GAP as _GAP
from generative_audio_torch.utils.plot import heatmap as _panel
from generative_audio_torch.utils.plot import write_png

__all__ = ["DenoisingNPPCValidatorConfig", "DenoisingNPPCValidator",
           "figure_size", "write_png"]

# the figure's base row, in order
_BASE_ORDER = ("Noisy", "Clean", "Enhanced", "Error (Enh - Clean)")


@dataclasses.dataclass
class DenoisingNPPCValidatorConfig:
    save_dir: str = "denoising_validation"
    nfft: int = 512
    hop_length: int = 256
    win_length: int = 512
    sample_rate: int = 16000
    n_alphas: int = 6   # linspace(-3, 3, 6), as the reference sweeps


def figure_size(n_dirs: int, n_alphas: int, n_freqs: int, n_frames: int):
    """(width, height) in pixels of the figure of n_dirs directions."""
    n_cols = max(n_alphas + 1, 9) if n_alphas >= 6 else n_alphas + 1
    n_rows = n_dirs + 1
    return (n_cols * n_frames + (n_cols + 1) * _GAP,
            n_rows * n_freqs + (n_rows + 1) * _GAP)


class DenoisingNPPCValidator:
    """model_fn(noisy [1, L] on the device) -> w_mat [1, n_dirs, 2, F, T],
    or, when crm_fn is None, (w_mat, compressed cRM [1, 2, F, T]), as
    DenoisingNPPCModel.forward_with_pred_crm gives them from one enhancer
    forward; crm_fn(noisy) -> the compressed cRM (the split form, which runs
    the enhancer twice). Both are called under torch.inference_mode().
    device: "cuda" (default; raises without one) or "cpu"."""

    def __init__(self, model_fn: Callable, crm_fn: Optional[Callable],
                 config: Optional[DenoisingNPPCValidatorConfig] = None,
                 device=None):
        self.model_fn = model_fn
        self.crm_fn = crm_fn
        self.config = (config if config is not None
                       else DenoisingNPPCValidatorConfig())
        self.device = resolve_device(device)

    def _grid(self, noisy, pred_crm, w_mat):
        """The (pc, alpha) grid on the device: the noisy and enhanced
        spectra, the enhanced waveform, each direction's spectrum, the
        variations' spectra and their waveforms."""
        c = self.config
        stft = (c.nfft, c.hop_length, c.win_length)
        length = noisy.shape[-1]
        alphas = torch.linspace(-3.0, 3.0, c.n_alphas, device=noisy.device)
        nr, ni = stft_ri(noisy, *stft)
        crm = decompress_cIRM(pred_crm.float().permute(0, 2, 3, 1))
        er, ei = apply_crm(crm, nr, ni)                         # [1, F, T]
        enhanced = istft_ri(er, ei, *stft, length=length)
        pc = decompress_cIRM(w_mat[0].float().permute(0, 2, 3, 1))
        pr, pi = apply_crm(pc, nr, ni)                          # [n, F, T]
        a = alphas[None, :, None, None]
        vr = er + a * pr[:, None]                               # [n, A, F, T]
        vi = ei + a * pi[:, None]
        f, t = vr.shape[-2:]
        var_wavs = istft_ri(vr.reshape(-1, f, t), vi.reshape(-1, f, t),
                            *stft, length=length)
        return nr, ni, er, ei, enhanced, pr, pi, vr, vi, var_wavs

    def validate_sample(self, noisy_waveform: np.ndarray,
                        clean_waveform: Optional[np.ndarray] = None,
                        sample_idx: int = 0, make_plot: bool = True,
                        write_audio: bool = True) -> Dict:
        """[L] noisy waveform -> the variations (pc, alpha, rms) and the
        directory of sample_idx's files. clean_waveform adds the Clean and
        Error panels and clean.wav."""
        c = self.config
        noisy_np = np.asarray(noisy_waveform, np.float32)[None]
        noisy = torch.from_numpy(noisy_np).to(self.device)
        with torch.inference_mode():
            if self.crm_fn is None:
                w_mat, pred_crm = self.model_fn(noisy)
            else:
                w_mat = self.model_fn(noisy)
                pred_crm = self.crm_fn(noisy)
            grid = self._grid(noisy, pred_crm, w_mat)
            clean_spec = None
            if clean_waveform is not None:
                cw = torch.from_numpy(
                    np.asarray(clean_waveform, np.float32).reshape(1, -1))
                clean_spec = stft_ri(cw.to(self.device), c.nfft,
                                     c.hop_length, c.win_length)
        (nr, ni, er, ei, enhanced, pr, pi, vr, vi, var_wavs) = [
            x.cpu().numpy() for x in grid]
        alphas = np.linspace(-3, 3, c.n_alphas)
        n_dirs = pr.shape[0]
        out_dir = Path(c.save_dir) / f"sample_{sample_idx}"
        out_dir.mkdir(parents=True, exist_ok=True)

        def write_norm(path, wav):
            wav = np.asarray(wav).reshape(-1)
            write_wav(path, wav / (np.max(np.abs(wav)) + 1e-8),
                      c.sample_rate)

        if write_audio:
            write_norm(out_dir / "enhanced.wav", enhanced[0])
            write_norm(out_dir / "noisy.wav", noisy_np[0])
            if clean_waveform is not None:
                write_norm(out_dir / "clean.wav", clean_waveform)

        def mag_db(r, i):
            return 20 * np.log10(np.sqrt(r ** 2 + i ** 2) + 1e-8)

        base_row = {"Noisy": mag_db(nr[0], ni[0]),
                    "Enhanced": mag_db(er[0], ei[0])}
        if clean_spec is not None:
            cr, ci = (x.cpu().numpy()[0] for x in clean_spec)
            base_row["Clean"] = mag_db(cr, ci)
            base_row["Error (Enh - Clean)"] = mag_db(er[0] - cr, ei[0] - ci)

        variations = []
        var_wavs = var_wavs.reshape(n_dirs, len(alphas), -1)
        for i in range(n_dirs):
            for j, alpha in enumerate(alphas):
                wav = var_wavs[i, j]
                if write_audio:
                    write_norm(out_dir / f"pc{i + 1}_alpha{alpha:+.1f}.wav",
                               wav)
                variations.append({"pc": i + 1, "alpha": float(alpha),
                                   "rms": float(np.sqrt(np.mean(wav ** 2)))})

        if make_plot:
            self._plot_grid(base_row, mag_db(pr, pi), mag_db(vr, vi), out_dir)
        return {"variations": variations, "n_dirs": n_dirs,
                "save_dir": str(out_dir)}

    def _plot_grid(self, base_row, pc_specs, specs, out_dir):
        """Row 0: the base spectrograms (noisy, clean, enhanced, error); row
        i + 1: direction i's own spectrum, then one panel per alpha."""
        n_dirs, n_alphas, f, t = specs.shape
        width, height = figure_size(n_dirs, n_alphas, f, t)
        rgb = np.full((height, width, 3), 255, np.uint8)

        def place(row, col, panel):
            y, x = _GAP + row * (f + _GAP), _GAP + col * (t + _GAP)
            rgb[y:y + f, x:x + t] = panel

        titles = [k for k in _BASE_ORDER if k in base_row]
        for col, title in enumerate(titles):
            fixed = (-60, 0) if "Error" in title else (None, None)
            place(0, col, _panel(base_row[title], *fixed))
        for i in range(n_dirs):
            place(i + 1, 0, _panel(pc_specs[i], -60, 0))
            for j in range(n_alphas):
                place(i + 1, j + 1, _panel(specs[i, j]))
        write_png(Path(out_dir) / "pc_spectrograms_variations.png", rgb)
