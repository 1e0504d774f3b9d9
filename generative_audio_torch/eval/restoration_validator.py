"""The inpainting restoration model's validator.

Port of generative_audio_tpu/eval/restoration_validator.py:27-157
(reference nppc_audio/inpainting/validator/validator_restoration_model.py):
per sample, the gap's MSE in normalised log-magnitude space and the 2 x 2
figure (clean | masked / model output | the gap's |clean - output|); over a
loader, their mean, written to restoration_validation.json.

The model is a callable on tensors on the validator's device, where the JAX
validator takes an apply function and its variables. The figure is a PNG
drawn by utils/plot: the JAX figure's panels and fixed ranges ([-3, 3] for
the spectrograms, [0, 3] for the error), origin lower, the gap panel
stretched to the panels' width, without titles or colorbars.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from generative_audio_torch.ops.preprocess import preprocess_data
from generative_audio_torch.utils.device import conv_tf32, resolve_device
from generative_audio_torch.utils.plot import compose, heatmap, write_png

__all__ = ["RestorationValidatorConfig", "RestorationValidator",
           "plot_spectrograms_and_error"]


def plot_spectrograms_and_error(clean_norm_log, masked_norm_log, output,
                                mask_frames, sample_len_seconds: float,
                                vmin: float = -3.0, vmax: float = 3.0,
                                vmin_err: float = 0.0, vmax_err: float = 3.0
                                ) -> np.ndarray:
    """The 2 x 2 figure as uint8 [H, W, 3]: clean, masked and output
    [1, 1, F, T] normalised log-magnitudes on [vmin, vmax], and |clean -
    output| over the gap's frames of the [T] frame mask (1 = known) on
    [vmin_err, vmax_err], repeated across the panel's width. The time axis
    (sample_len_seconds) is not drawn."""
    clean = np.asarray(clean_norm_log)[0, 0]
    masked = np.asarray(masked_norm_log)[0, 0]
    out = np.asarray(output)[0, 0]
    gap_cols = np.where(np.asarray(mask_frames).reshape(-1) == 0)[0]
    err = np.abs(clean - out)
    err_gap = (err[:, gap_cols] if gap_cols.size
               else np.zeros((clean.shape[0], 1), err.dtype))
    cols = np.arange(clean.shape[1]) * err_gap.shape[1] // clean.shape[1]
    return compose([
        [heatmap(clean, vmin, vmax), heatmap(masked, vmin, vmax)],
        [heatmap(out, vmin, vmax), heatmap(err_gap[:, cols], vmin_err,
                                           vmax_err)]])


@dataclasses.dataclass
class RestorationValidatorConfig:
    save_dir: str = "validation_results"
    sample_len_seconds: float = 2.044
    max_figures: int = 4     # figures for the first N samples


class RestorationValidator:
    """restoration_fn(masked_norm_log [B, 1, F, T], mask [B, 1, F, T]) ->
    [B, 1, F, T], on tensors on `device` (e.g. an InpaintingRestorationModel
    with train=False), called under torch.no_grad() and conv_tf32().
    device: "cuda" (default; raises without one) or "cpu"."""

    def __init__(self, restoration_fn: Callable,
                 config: Optional[RestorationValidatorConfig] = None,
                 device=None):
        self.restoration_fn = restoration_fn
        self.config = (config if config is not None
                       else RestorationValidatorConfig())
        self.device = resolve_device(device)

    def validate_sample(self, masked_spec, mask_frames, clean_spec,
                        sample_idx: int = 0, make_plot: bool = True) -> Dict:
        """One sample: STFT pairs [1, 2, F, T] and the frame mask [1, T]
        (numpy) -> {"mse": the gap's MSE in normalised log-magnitude space,
        "output": [1, 1, F, T]} (+ "figure_path")."""
        dev = self.device
        with torch.no_grad(), conv_tf32():
            clean_norm_log, mask4, masked_norm_log = preprocess_data(
                *(torch.as_tensor(np.asarray(x), dtype=torch.float32).to(dev)
                  for x in (clean_spec, masked_spec, mask_frames)))
            out = self.restoration_fn(masked_norm_log, mask4)
        out, clean_norm_log, mask4, masked_norm_log = (
            x.cpu().numpy() for x in (out, clean_norm_log, mask4,
                                      masked_norm_log))
        omask = 1.0 - mask4
        diff = out - clean_norm_log
        mse_gap = float((diff ** 2 * omask).sum() / max(omask.sum(), 1.0))
        result = {"mse": mse_gap, "output": out}
        if make_plot:
            out_dir = Path(self.config.save_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            path = out_dir / f"spectrogram_comparison_{sample_idx}.png"
            write_png(path, plot_spectrograms_and_error(
                clean_norm_log, masked_norm_log, out,
                np.asarray(mask_frames)[0], self.config.sample_len_seconds))
            result["figure_path"] = str(path)
        return result

    def validate_dataloader(self, loader, max_samples: Optional[int] = None
                            ) -> Dict:
        """The mean gap MSE over the (masked_spec, mask_frames, clean_spec,
        ...) batches, figures for the first config.max_figures samples, and
        restoration_validation.json in save_dir."""
        mses = []
        idx = 0
        for batch in loader:
            masked_spec, mask_frames, clean_spec = (np.asarray(x)
                                                    for x in batch[:3])
            for b in range(masked_spec.shape[0]):
                if max_samples is not None and idx >= max_samples:
                    break
                r = self.validate_sample(
                    masked_spec[b:b + 1], mask_frames[b:b + 1],
                    clean_spec[b:b + 1], sample_idx=idx,
                    make_plot=idx < self.config.max_figures)
                mses.append(r["mse"])
                idx += 1
            if max_samples is not None and idx >= max_samples:
                break
        summary = {"num_samples": idx,
                   "mean_gap_mse": float(np.mean(mses)) if mses else None,
                   "per_sample_mse": mses}
        out_dir = Path(self.config.save_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "restoration_validation.json").write_text(
            json.dumps(summary, indent=4))
        return summary
