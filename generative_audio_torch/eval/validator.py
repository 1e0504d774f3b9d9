"""Batch evaluation of an enhancement model over (noisy, clean) pairs: the
validation the trainer selects its best model by, and the recorded-baseline
pipeline.

Port of generative_audio_tpu/eval/validator.py (reference:
use_pre_trained_model/model_validator/model_validator.py:26-189). Each clip is
enhanced at its own length: stft -> model -> decompress_cIRM (limit 9.9) ->
apply_crm -> istft. That is not the Inferencer's pipeline, which pads every
clip to a multiple of `length_bucket`; the padded frames would change the
STFT's last frames, the model's look-ahead and so the metrics. The metrics
are host numpy code (eval/metrics.py) on the enhanced waveform.
"""
from __future__ import annotations

import json
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from generative_audio_torch.eval import metrics as M
from generative_audio_torch.eval.inferencer import _Pending
from generative_audio_torch.eval.pesq import PesqError
from generative_audio_torch.ops.mask import apply_crm, decompress_cIRM
from generative_audio_torch.ops.stft import istft_ri, stft_ri
from generative_audio_torch.utils.device import resolve_device

__all__ = ["ModelValidator"]


class ModelValidator:
    """Evaluates an enhancement model over (noisy, clean) pairs.

    model_type "fullsubnet_plus" calls `model(mag, real, imag)`, "fullsubnet"
    (v1) calls `model(mag)`, as the trainer's model types take their inputs.
    device: "cuda" (default; raises without one) or "cpu"; the model is
    moved there. Enhancement leaves the model's training flag as it found
    it, and runs under torch.inference_mode(), so in bf16 on CUDA the
    recurrent layers launch the inference scan kernels."""

    def __init__(self, model: nn.Module, n_fft: int = 512,
                 hop_length: int = 256, win_length: int = 512,
                 sr: int = 16000,
                 metric_names=("WB_PESQ", "NB_PESQ", "STOI", "SI_SDR"),
                 device=None, model_type: str = "fullsubnet_plus"):
        if model_type not in ("fullsubnet_plus", "fullsubnet"):
            raise ValueError(f"unknown model_type {model_type!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.model_type = model_type
        self.n_fft, self.hop, self.win = n_fft, hop_length, win_length
        self.sr = sr
        self.metric_names = list(metric_names)

    def _enhance(self, noisy: torch.Tensor) -> torch.Tensor:
        """[1, L] float32 on the device -> enhanced [1, L]."""
        real, imag = stft_ri(noisy, self.n_fft, self.hop, self.win)
        mag = torch.sqrt(real ** 2 + imag ** 2)
        if self.model_type == "fullsubnet":
            crm = self.model(mag[:, None])
        else:
            crm = self.model(mag[:, None], real[:, None], imag[:, None])
        crm = decompress_cIRM(crm.float().permute(0, 2, 3, 1))
        er, ei = apply_crm(crm, real, imag)
        return istft_ri(er, ei, self.n_fft, self.hop, self.win,
                        length=noisy.shape[-1])

    def _enhance_ref(self, noisy: np.ndarray) -> _Pending:
        """Launch one clip's enhancement; the result is on its way to the
        host (on CUDA through pinned memory and an event), so the card
        computes while the caller scores the previous clip."""
        x = torch.from_numpy(np.ascontiguousarray(noisy, np.float32))[None]
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                return _Pending(self._enhance(x))
        finally:
            self.model.train(was_training)

    def enhance_audio(self, noisy: np.ndarray) -> np.ndarray:
        """Ref model_validator.py:84-133: noisy [L] -> enhanced [L]."""
        return self._enhance_ref(noisy).result()[0]

    def calculate_metrics(self, clean: np.ndarray, enhanced: np.ndarray
                          ) -> Dict[str, Optional[float]]:
        """Ref model_validator.py:37-82; an unavailable metric (MOSNET
        without its wheel) and an unscoreable clip (PESQ on silent or too
        short audio) record None for that metric of that clip."""
        out: Dict[str, Optional[float]] = {}
        for name in self.metric_names:
            fn = M.REGISTERED_METRICS[name]
            try:
                out[name] = float(fn(clean, enhanced, self.sr))
            except (M.MetricUnavailable, PesqError):
                out[name] = None
        return out

    def validate_dataset(self, dataset, output_path: Optional[str] = None,
                         max_items: Optional[int] = None,
                         log=print) -> Dict[str, Optional[float]]:
        """Ref model_validator.py:135-176 -> mean metrics (+ JSON).

        Depth-2 pipeline: item i+1's enhancement is launched before item i's
        host metrics run, so the card computes while the CPU scores."""
        per_item: List[Dict[str, Optional[float]]] = []
        n = len(dataset) if max_items is None else min(max_items, len(dataset))
        inflight: deque = deque()    # (index, clean, pending)

        def _drain():
            i, clean, pending = inflight.popleft()
            scores = self.calculate_metrics(clean, pending.result()[0])
            per_item.append(scores)
            log(f"[{i + 1}/{n}] " + " ".join(
                f"{k}={v:.4f}" if v is not None else f"{k}=n/a"
                for k, v in scores.items()))

        for i in range(n):
            item = dataset[i]
            noisy, clean = np.asarray(item[0]), np.asarray(item[1])
            inflight.append((i, clean, self._enhance_ref(noisy)))
            while len(inflight) >= 2:
                _drain()
        while inflight:
            _drain()

        means: Dict[str, Optional[float]] = {}
        for name in self.metric_names:
            vals = [s[name] for s in per_item if s[name] is not None]
            means[name] = float(np.mean(vals)) if vals else None
        if output_path:
            Path(output_path).parent.mkdir(parents=True, exist_ok=True)
            with open(output_path, "w") as f:
                json.dump(means, f, indent=4)
        return means
