"""The inpainting-NPPC validator: the PC directions against the MC-dropout
PCA baseline, the gap's RMSE, the residual error, principal angles, the
zoomed alpha-sweep spectrogram grid, audio variations with the clean phase
and their pitch, and the per-sample JSON.

Port of generative_audio_tpu/eval/nppc_validator.py:36-404 (reference
nppc_audio/inpainting/validator/validator_nppc_model.py). The models are
callables on tensors on the validator's device, where the JAX validator
takes apply functions and their variables:
  * nppc_fn(masked [B, 1, F, T], mask [B, 1, F, T]) -> [B, n_dirs, F, T]
    (InpaintingNPPCModel);
  * restoration_fn(masked, mask, generator=None) -> [B, 1, F, T], the
    frozen restoration prediction; with a sequence of P generators the
    input holds P stacked MC-dropout passes, one per generator
    (InpaintingNPPCModel.mc_restoration).
The MC passes of sample i draw from eval/mc_dropout.mc_generators(seed),
seed = i unless given (the JAX validator keys them with PRNGKey(i)).
transcribe_fn and phoneme_fn ((audio, sr) -> str) stay injected, as in the
JAX package. The figures are PNGs drawn by utils/plot (the JAX validator's
panels, order, zoom, fixed ranges and dashed gap bounds; no titles or
colorbars); organize_jsons returns its table as a list of dicts (the card's
machine has no pandas).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from generative_audio_torch.data.audio_io import write_wav
from generative_audio_torch.eval.mc_dropout import (
    calculate_unet_baseline, mc_generators)
from generative_audio_torch.eval.pitch import yin_pitch_track
from generative_audio_torch.ops.stft import istft_ri
from generative_audio_torch.utils.device import conv_tf32, resolve_device
from generative_audio_torch.utils.plot import (
    bar_chart, compose, heatmap, line_plot, write_png)

__all__ = ["compute_metrics", "NPPCValidatorConfig", "NPPCValidator",
           "organize_jsons"]


# ------------------------------------------------------------- metrics -----
def _rmse_in_gap(pred, target, mask) -> float:
    """||(pred - target)[mask == 0]||_2."""
    err = np.asarray(pred) - np.asarray(target)
    return float(np.linalg.norm(err[np.asarray(mask) == 0]))


def _residual_error(error, directions) -> float:
    """||e - W W^T e||_2 with W's rows normalised."""
    error_flat = np.asarray(error).reshape(1, -1)
    w = np.asarray(directions)
    w = w.reshape(w.shape[1], -1)
    norms = np.linalg.norm(w, axis=1) + 1e-6
    w = w / norms[:, None]
    wt_e = w @ error_flat.T
    w_wt_e = w.T @ wt_e
    return float(np.linalg.norm(error_flat.T - w_wt_e))


def _principal_angles(dirs_a, dirs_b) -> List[float]:
    """Both spans orthonormalised by QR, the SVD of their cross-Gram, the
    angles in degrees."""
    a = np.asarray(dirs_a)
    a = a.reshape(a.shape[1], -1)
    b = np.asarray(dirs_b)
    b = b.reshape(b.shape[1], -1)
    qa, _ = np.linalg.qr(a.T)
    qb, _ = np.linalg.qr(b.T)
    s = np.linalg.svd(qa.T @ qb, compute_uv=False)
    return (np.degrees(np.arccos(np.clip(s, -1, 1)))).tolist()


def compute_metrics(nppc_directions, mc_dropout_directions, pred_spec_mag,
                    mean_prediction, clean_spec_mag, mask) -> Dict:
    """The gap's RMSE and the residual error of each method, and the
    principal angles between their spans (numpy arrays [1, ...])."""
    error = np.asarray(pred_spec_mag) - np.asarray(clean_spec_mag)
    return {
        "nppc": {
            "rmse": _rmse_in_gap(pred_spec_mag, clean_spec_mag, mask),
            "residual_error": _residual_error(error, nppc_directions),
        },
        "mc_dropout": {
            "rmse": _rmse_in_gap(mean_prediction, clean_spec_mag, mask),
            "residual_error": _residual_error(error, mc_dropout_directions),
        },
        "principal_angles": _principal_angles(nppc_directions,
                                              mc_dropout_directions),
    }


# ----------------------------------------------------------- validator -----
@dataclasses.dataclass
class NPPCValidatorConfig:
    save_dir: str = "validation_output"
    n_mc_samples: int = 50
    n_components: int = 5
    alphas: tuple = tuple(np.arange(-3.0, 3.5, 0.5).tolist())
    audio_alphas: tuple = (-3.0, -1.5, 0.0, 1.5, 3.0)
    nfft: int = 255
    hop_length: int = 128
    win_length: int = 255
    sample_rate: int = 16000


def _gap_lines(panel: np.ndarray, cols) -> np.ndarray:
    """Dashed red vertical lines at the panel's columns `cols`."""
    panel = panel.copy()
    for c in cols:
        if 0 <= c < panel.shape[1]:
            panel[::2, c] = (255, 0, 0)
    return panel


class NPPCValidator:
    """See the module's docstring. device: "cuda" (default; raises without
    one) or "cpu"; the models run under torch.no_grad() and
    conv_tf32()."""

    def __init__(self, nppc_fn: Callable, restoration_fn: Callable,
                 config: Optional[NPPCValidatorConfig] = None,
                 transcribe_fn: Optional[Callable] = None,
                 phoneme_fn: Optional[Callable] = None, device=None):
        self.nppc_fn = nppc_fn
        self.restoration_fn = restoration_fn
        self.config = config if config is not None else NPPCValidatorConfig()
        self.transcribe_fn = transcribe_fn
        self.phoneme_fn = phoneme_fn
        self.device = resolve_device(device)

    # -------------------------------------------------------------- core ---
    def device_outputs(self, masked, mask, seed: int):
        """(directions, the restoration prediction, the MC-dropout baseline)
        of one sample, as numpy arrays."""
        c = self.config
        dev = self.device
        masked, mask = ((x if torch.is_tensor(x) else torch.from_numpy(
            np.asarray(x))).to(dev, torch.float32) for x in (masked, mask))
        with torch.no_grad(), conv_tf32():
            pc = self.nppc_fn(masked, mask)
            pred = self.restoration_fn(masked, mask)
            base = calculate_unet_baseline(
                self.restoration_fn, masked, mask,
                mc_generators(seed, c.n_mc_samples, dev),
                n_components=c.n_components)
        return (pc.cpu().numpy(), pred.cpu().numpy(),
                {k: v.cpu().numpy() for k, v in base.items()})

    def validate_sample(self, masked_log_mag, mask4, clean_log_mag,
                        sample_idx: int = 0, seed: Optional[int] = None,
                        stats: Optional[tuple] = None,
                        clean_phase: Optional[np.ndarray] = None,
                        full_audio: Optional[np.ndarray] = None,
                        gap_bounds: Optional[tuple] = None,
                        make_plots: bool = True,
                        make_audio: bool = True) -> Dict:
        """One sample, its spectrograms [1, 1, F, T] in normalised log-mag
        space (numpy or tensors); stats = (mean, std) undoes the
        normalisation for the audio, clean_phase [F, T] gives its phase."""
        pc_dirs, pred, baseline = self.device_outputs(
            masked_log_mag, mask4, sample_idx if seed is None else seed)
        clean_log_mag, mask4 = (np.asarray(x.cpu() if torch.is_tensor(x)
                                           else x)
                                for x in (clean_log_mag, mask4))
        metrics = compute_metrics(
            pc_dirs, baseline["principal_components"], pred,
            baseline["mean_prediction"], clean_log_mag, mask4)
        metrics["importance_weights"] = baseline["importance_weights"].tolist()

        out_dir = Path(self.config.save_dir) / f"sample_{sample_idx}"
        out_dir.mkdir(parents=True, exist_ok=True)
        if make_plots:
            masked = (masked_log_mag.cpu() if torch.is_tensor(masked_log_mag)
                      else masked_log_mag)
            self.plot_pc_spectrograms(pred, pc_dirs, clean_log_mag, mask4,
                                      out_dir, masked=np.asarray(masked))
        if make_audio and stats is not None and clean_phase is not None:
            metrics["audio_variations"] = self.save_pc_audio_variations(
                pred, pc_dirs, clean_phase, stats, out_dir,
                full_audio=full_audio, gap_bounds=gap_bounds)
        # written last, so that the audio analyses land in it
        self.save_metrics_to_json(metrics, out_dir, sample_idx)
        return metrics

    @staticmethod
    def save_metrics_to_json(metrics: Dict, save_dir, sample_idx: int):
        path = Path(save_dir) / f"metrics_sample_{sample_idx}.json"
        with open(path, "w") as f:
            json.dump(metrics, f, indent=4, default=float)
        return path

    # -------------------------------------------------------------- plots --
    def plot_pc_spectrograms(self, pred, pc_dirs, clean, mask4, out_dir,
                             masked=None, per_image_pngs: bool = True,
                             max_dirs: Optional[int] = None) -> Path:
        """pc_spectrograms.png, every panel zoomed to the gap and one gap
        width on each side: the top row clean, masked, output, |clean -
        output| on [0, 3], then clean and output with the gap's bounds;
        one row a direction, the direction and output + alpha * direction
        for each alpha, all on [-3, 3]. Each panel also as its own PNG
        under spectrograms/ (with the gap's bounds)."""
        c = self.config
        pred = np.asarray(pred)[0, 0]
        clean = np.asarray(clean)[0, 0]
        dirs = np.asarray(pc_dirs)[0]
        if max_dirs is not None:
            dirs = dirs[:max_dirs]
        mask4 = np.asarray(mask4)
        frame_mask = mask4.reshape(mask4.shape[0], -1, mask4.shape[-1])[0, 0]
        masked = (np.asarray(masked)[0, 0] if masked is not None
                  else clean * frame_mask[None, :])
        n_frames = clean.shape[1]
        gap_cols = np.where(frame_mask == 0)[0]
        g0, g1 = ((int(gap_cols[0]), int(gap_cols[-1]) + 1) if gap_cols.size
                  else (0, n_frames))
        width = max(g1 - g0, 1)
        c0, c1 = max(0, g0 - width), min(n_frames, g1 + width)
        bounds = (g0 - c0, g1 - c0)

        spec_dir = Path(out_dir) / "spectrograms"
        if per_image_pngs:
            spec_dir.mkdir(parents=True, exist_ok=True)

        def panel(data, is_err=False, lines=True):
            img = heatmap(data[:, c0:c1], *((0.0, 3.0) if is_err
                                           else (-3.0, 3.0)))
            return _gap_lines(img, bounds) if lines else img

        def save(img, name):
            if per_image_pngs:
                write_png(spec_dir / name, _gap_lines(img, bounds))

        error = np.abs(clean - pred)
        top = [panel(clean, lines=False), panel(masked, lines=False),
               panel(pred, lines=False), panel(error, True, lines=False)]
        for img, name in zip(top, ("clean_spec.png", "masked_spec.png",
                                   "output_spec.png", "error_spec.png")):
            save(img, name)
        n_cols = len(c.alphas) + 1
        top += [panel(clean), panel(pred)][:max(0, n_cols - 4)]
        rows = [top[:n_cols]]
        for i in range(dirs.shape[0]):
            row = [panel(dirs[i])]
            save(row[0], f"pc_direction_{i + 1}.png")
            for alpha in c.alphas:
                row.append(panel(pred + alpha * dirs[i]))
                save(row[-1], f"pc{i + 1}_alpha_{alpha:.1f}.png")
            rows.append(row)
        return write_png(Path(out_dir) / "pc_spectrograms.png", compose(rows))

    # -------------------------------------------------------------- audio --
    def save_pc_audio_variations(self, pred, pc_dirs, clean_phase, stats,
                                 out_dir, full_audio=None, gap_bounds=None
                                 ) -> List[Dict]:
        """A wav for each (direction, alpha of audio_alphas): the
        denormalised log-magnitude of output + alpha * direction with the
        clean phase, through the iSTFT, spliced into full_audio at
        gap_bounds where given; each entry with its transcription and
        phonemes (where the hooks are given) and its mean f0 (YIN)."""
        c = self.config
        mean, std = (float(np.asarray(v.cpu() if torch.is_tensor(v) else v))
                     for v in stats)
        pred = np.asarray(pred)[0, 0]
        dirs = np.asarray(pc_dirs)[0]
        phase = np.asarray(clean_phase)
        grid = [(i, alpha) for i in range(dirs.shape[0])
                for alpha in c.audio_alphas]
        mags = np.stack([np.exp((pred + alpha * dirs[i]) * std + mean) - 1e-6
                         for i, alpha in grid])
        real = torch.from_numpy(mags * np.cos(phase)).float()
        imag = torch.from_numpy(mags * np.sin(phase)).float()
        wavs = istft_ri(real, imag, c.nfft, c.hop_length, c.win_length).numpy()
        results = []
        for (i, alpha), wav in zip(grid, wavs):
            if full_audio is not None and gap_bounds is not None:
                s, e = gap_bounds
                spliced = np.asarray(full_audio).reshape(-1).copy()
                seg = wav[s:e]
                spliced[s:s + len(seg)] = seg
                wav = spliced
            name = f"pc{i + 1}_alpha{alpha:+.1f}.wav"
            write_wav(Path(out_dir) / name, wav, c.sample_rate)
            entry = {"pc": i + 1, "alpha": alpha, "file": name}
            if self.transcribe_fn is not None:
                entry["transcription"] = self.transcribe_fn(wav, c.sample_rate)
            if self.phoneme_fn is not None:
                entry["phonemes"] = self.phoneme_fn(wav, c.sample_rate)
            f0, voiced, _ = yin_pitch_track(wav, c.sample_rate)
            entry["mean_f0"] = float(np.nanmean(f0)) if voiced.any() else None
            results.append(entry)
        return results

    # ------------------------------------------------------------- pitch ---
    def plot_pitch_comparison(self, wavs: Dict[str, np.ndarray], out_dir,
                              name: str = "pitch_comparison.png") -> Path:
        """The YIN f0 contour of each wav, one colour each, over time."""
        tracks = [yin_pitch_track(w, self.config.sample_rate)
                  for w in wavs.values()]
        img = line_plot([f0 for f0, _, _ in tracks],
                        x=[times for _, _, times in tracks])
        return write_png(Path(out_dir) / name, img)


def organize_jsons(json_dir, output_path=None) -> List[Dict]:
    """The rows of every metrics_sample_*.json under json_dir (sample,
    nppc_rmse, nppc_residual, mc_rmse, mc_residual, min_principal_angle),
    in path order, and, with output_path, a PNG of the residuals as
    grouped bars (NPPC, MC-dropout) per sample."""
    rows = []
    for path in sorted(Path(json_dir).rglob("metrics_sample_*.json")):
        m = json.loads(path.read_text())
        rows.append({
            "sample": path.stem,
            "nppc_rmse": m["nppc"]["rmse"],
            "nppc_residual": m["nppc"]["residual_error"],
            "mc_rmse": m["mc_dropout"]["rmse"],
            "mc_residual": m["mc_dropout"]["residual_error"],
            "min_principal_angle": min(m["principal_angles"]),
        })
    if output_path and rows:
        write_png(output_path, bar_chart(
            [[r["nppc_residual"], r["mc_residual"]] for r in rows]))
    return rows
