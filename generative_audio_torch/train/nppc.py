"""The denoising-NPPC trainer: K uncertainty directions in cRM space, trained
over a frozen FullSubNet+.

Port of generative_audio_tpu/train/nppc.py:303-433 (NPPCDenoisingTrainConfig,
NPPCDenoisingTrainer; reference nppc_audio/trainer.py:40-371): one forward
gives w_mat and the frozen enhancer's compressed cRM; the ground-truth cIRM
comes from the float32 STFTs of the noisy and clean waveforms; drop_band with
the head's G is applied to both masks; the complex NPPC objective with the
lambda ramp of the step before the update; global-norm clip and Adam over
the head's parameters only (the counterpart of optax.multi_transform with
set_to_zero on pretrained_restoration_model). The inpainting line's trainer
waits for the UNet (ROADMAP.md, queue A item 8), and the multi-GPU step for
item 6.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Mapping, Optional, Tuple

import torch

from generative_audio_torch.losses import nppc_objective_complex
from generative_audio_torch.models.nppc_model import (
    DenoisingNPPCConfig, DenoisingNPPCModel)
from generative_audio_torch.ops.mask import build_complex_ideal_ratio_mask_ri
from generative_audio_torch.ops.stft import stft_ri
from generative_audio_torch.ops.subband import drop_band
from generative_audio_torch.train.checkpoint import (
    CheckpointManager, resume_latest)
from generative_audio_torch.train.state import TrainState, make_optimizer
from generative_audio_torch.utils.device import resolve_device

__all__ = ["NPPCDenoisingTrainConfig", "NPPCDenoisingTrainer"]


@dataclasses.dataclass(frozen=True)
class NPPCDenoisingTrainConfig:
    model: DenoisingNPPCConfig = DenoisingNPPCConfig()
    learning_rate: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    max_grad_norm: float = 1.0
    second_moment_loss_lambda: float = 1.0
    second_moment_loss_grace: int = 500
    log_interval: int = 100
    save_interval: int = 1000


def _restoration_state_dict(params: Mapping) -> Mapping:
    """A FullSubNet+ state_dict as it is, or the JAX package's nested param
    tree carried across."""
    if any(isinstance(v, Mapping) for v in params.values()):
        from generative_audio_torch.utils.convert import (
            convert_fullsubnet_plus)
        return convert_fullsubnet_plus(params)
    return params


class NPPCDenoisingTrainer:
    """Trains the AudioPCWrapper of a DenoisingNPPCModel; the enhancer stays
    frozen. restoration_params: the enhancer's weights, a FullSubNet+
    state_dict or the JAX param tree (None keeps the seeded init, as the JAX
    trainer keeps its random init). device: "cuda" (default; raises without
    one) or "cpu"; compute_dtype: bf16 on the card, float32 for the CPU
    tests."""

    def __init__(self, config: NPPCDenoisingTrainConfig,
                 restoration_params=None, checkpoint_dir=None, seed: int = 0,
                 device=None, compute_dtype: torch.dtype = torch.bfloat16):
        self.config = config
        dev = resolve_device(device)
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed(seed)
            model = DenoisingNPPCModel(config.model,
                                       compute_dtype=compute_dtype, device=dev)
        if restoration_params is not None:
            model.pretrained_restoration_model.load_state_dict(
                _restoration_state_dict(restoration_params))
        optimizer = make_optimizer(model.audio_pc_wrapper.parameters(),
                                   config.learning_rate, config.betas)
        self.state = TrainState(model, optimizer,
                                clip_norm=config.max_grad_norm)
        self.device = dev
        self.ckpt = (CheckpointManager(checkpoint_dir, config)
                     if checkpoint_dir else None)
        self.loss_history = []
        self.reconst_err_history = []

    def objective(self, noisy: torch.Tensor, clean: torch.Tensor, step):
        """(objective, reconst_err [B], log) of waveforms [B, L] on the
        model's device, with the lambda of `step`."""
        c = self.config
        s = c.model.stft
        w_mat, pred_crm = self.state.model.forward_with_pred_crm(noisy)
        nr, ni = stft_ri(noisy, s.nfft, s.hop_length, s.win_length)
        cr, ci = stft_ri(clean, s.nfft, s.hop_length, s.win_length)
        gt_crm = build_complex_ideal_ratio_mask_ri(nr, ni, cr, ci)
        groups = c.model.pc_wrapper.num_groups_in_drop_band
        gt_crm = drop_band(gt_crm.permute(0, 3, 1, 2), groups)
        pred_crm = drop_band(pred_crm, groups)
        reconst_err, objective, log = nppc_objective_complex(
            w_mat, gt_crm, pred_crm, step,
            grace=c.second_moment_loss_grace,
            lambda_scale=c.second_moment_loss_lambda)
        return objective, reconst_err, log

    def train_step(self, noisy, clean) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer update on a batch of (noisy, clean) waveforms
        [B, L]; returns (objective, mean reconst_err), on the device."""
        noisy = torch.as_tensor(noisy, dtype=torch.float32).to(self.device)
        clean = torch.as_tensor(clean, dtype=torch.float32).to(self.device)
        state = self.state
        state.model.train()
        objective, reconst_err, _ = self.objective(noisy, clean, state.step)
        objective.backward()
        state.apply_gradients()
        return objective.detach(), reconst_err.detach().mean()

    def train(self, loader, n_steps: Optional[int] = None,
              n_epochs: Optional[int] = None, log=print):
        """n_steps or n_epochs over a loader of (noisy, clean) batches. The
        metrics stay on the device between log points."""
        from generative_audio_torch.data.loader import LoopIterator
        loop = LoopIterator(loader, n_steps=n_steps, n_epochs=n_epochs)
        pending = []
        step = self.state.step
        for batch in loop:
            pending.append(self.train_step(batch[0], batch[1]))
            step += 1
            if step % self.config.log_interval == 0:
                self._fetch(pending)
                pending = []
                log(f"step {step}: objective={self.loss_history[-1]:.5f} "
                    f"reconst_err={self.reconst_err_history[-1]:.5f}")
            if self.ckpt and step % self.config.save_interval == 0:
                self._save(step)
        self._fetch(pending)
        if self.ckpt:
            # a run that ends between save_interval boundaries keeps its
            # steps for a resume
            self._save(step, final=True)
        return self.loss_history

    def _fetch(self, pending):
        if pending:
            values = torch.stack([torch.stack(p) for p in pending]).cpu()
            self.loss_history.extend(values[:, 0].tolist())
            self.reconst_err_history.extend(values[:, 1].tolist())

    def _save(self, step: int, final: bool = False):
        tree = self.state.state_dict()
        self.ckpt.save_latest(tree, step)
        if final:
            ts = time.strftime("%Y%m%d_%H%M%S")
            self.ckpt.save_step(tree, step)
            (self.ckpt.directory / f"metrics_final_{ts}.json").write_text(
                json.dumps({
                    "timestamp": ts, "total_steps": step,
                    "final_objective": self.loss_history[-1]
                    if self.loss_history else None,
                    "final_reconst_err": self.reconst_err_history[-1]
                    if self.reconst_err_history else None}, indent=4))

    def restore_latest(self) -> bool:
        """Resume from the latest checkpoint (`-R`): step, parameters and the
        optimizer's state."""
        new_state, _ = resume_latest(self.ckpt, self.state)
        return new_state is not None
