"""The inpainting restoration trainer: a dropout UNet trained on the gap's
masked MSE.

Port of generative_audio_tpu/train/restoration.py:32-211 (reference
nppc_audio/inpainting/trainer/restoration_trainer.py): preprocess_data ->
InpaintingRestorationModel (train=True: BatchNorm on batch statistics,
dropout from the trainer's generator) -> masked_mse_loss; global-norm clip
(5 by default) and Adam or AdamW (train/state.make_optimizer); an optional
EMA of the parameters, on which validation and best/ run; validation at
each log point with the val-minimum best/ checkpoint, its score carried
across a resume; latest/ every save_interval steps and at the end, with a
step-tagged copy and metrics_final_*.json.

The UNet's convolutions run with cuDNN's TF32 (torch's default; scoped by
utils.device.conv_tf32), forward and backward.

With a mesh (parallel.make_mesh) the trainer is one rank of a multi-GPU
job: the UNet trains under DistributedDataParallel on this rank's rows of
the global batch, with the global batch's BatchNorm statistics, its
dropout masks drawn for the global batch and the masked MSE divided by the
global gap count, so that the step is the single process's over the
global batch. The recorded losses are the global batch's; every rank
validates and takes rank 0's score, so that all take the same best/
decision; rank 0 alone writes checkpoints; a resume takes rank 0's state
and best_val on every rank.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional, Tuple

import numpy as np
import torch

from generative_audio_torch.losses import masked_mse_loss
from generative_audio_torch.models.nppc_model import (
    InpaintingRestorationModel, UNetModelConfig)
from generative_audio_torch.ops.preprocess import preprocess_data
from generative_audio_torch.parallel.mesh import (
    data_parallel, from_coordinator, mean_over_ranks, place_rows,
    resume_from_coordinator)
from generative_audio_torch.train.checkpoint import (
    CheckpointManager, resume_latest)
from generative_audio_torch.train.state import TrainState, make_optimizer
from generative_audio_torch.utils.device import conv_tf32, resolve_device

__all__ = ["RestorationTrainConfig", "RestorationTrainer", "device_batch",
           "save_run"]


@dataclasses.dataclass(frozen=True)
class RestorationTrainConfig:
    model: UNetModelConfig = UNetModelConfig(in_channels=1, out_channels=1,
                                             dropout=0.2)
    learning_rate: float = 1e-4
    betas: Tuple[float, float] = (0.5, 0.999)
    clip_grad_norm: float = 5.0
    num_freqs: int = 128
    num_frames: int = 256
    log_interval: int = 100
    save_interval: int = 1000
    # ema_decay > 0 keeps an EMA of the parameters: validation and best/
    # use it; optimizer "adamw" with weight_decay is decoupled decay
    ema_decay: float = 0.0
    optimizer: str = "Adam"
    weight_decay: float = 0.0


def device_batch(batch, device):
    """(stft_masked [B, 2, F, T], mask_frames [B, T], stft_clean
    [B, 2, F, T]) of a collate_inpainting batch (numpy arrays, or tensors
    on any device) as float32 tensors on device."""
    return tuple(torch.as_tensor(x if isinstance(x, torch.Tensor)
                                 else np.asarray(x), dtype=torch.float32
                                 ).to(device, non_blocking=True)
                 for x in batch[:3])


def save_run(trainer, step: int, final: bool, loss_key: str,
             reconst_key: Optional[str] = None) -> None:
    """A trainer's latest/ and, at the end, a step-tagged copy and
    metrics_final_<time>.json with the last objective under loss_key and,
    where reconst_key is given, the last reconst_err under it."""
    tree = trainer.state.state_dict()
    trainer.ckpt.save_latest(tree, step)
    if final:
        ts = time.strftime("%Y%m%d_%H%M%S")
        trainer.ckpt.save_step(tree, step)
        metrics = {"timestamp": ts, "total_steps": step,
                   loss_key: trainer.loss_history[-1]
                   if trainer.loss_history else None}
        if reconst_key:
            metrics[reconst_key] = (trainer.reconst_err_history[-1]
                                    if trainer.reconst_err_history else None)
        trainer.ckpt.write_text(f"metrics_final_{ts}.json",
                                json.dumps(metrics, indent=4))


class RestorationTrainer:
    """device: "cuda" (default; raises without one) or "cpu"; seed: the
    UNet's init (torch's default initialisers) and, with seed + 1, the
    dropout masks' generator; mesh: a parallel.make_mesh() of a multi-GPU
    job, or None."""

    def __init__(self, config: RestorationTrainConfig, checkpoint_dir=None,
                 seed: int = 0, device=None, mesh=None):
        self.config = config
        dev = resolve_device(device)
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed(seed)
            model = InpaintingRestorationModel(config.model)
        model.to(dev)
        optimizer = make_optimizer(model.parameters(), config.learning_rate,
                                   config.betas, config.weight_decay,
                                   config.optimizer)
        self.state = TrainState(model, optimizer,
                                clip_norm=config.clip_grad_norm,
                                ema_decay=config.ema_decay)
        self.device = dev
        self.mesh = mesh
        self.net = data_parallel(model, mesh)
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)
        self.ckpt = (CheckpointManager(checkpoint_dir, config)
                     if checkpoint_dir else None)
        self.loss_history = []
        self.val_loss_history = []
        self.best_val = float("inf")

    def loss(self, batch, train: bool, global_rows=None) -> torch.Tensor:
        """The gap's masked MSE of a batch (tensors on the device). With
        train=False it is taken on the EMA parameters where there are. In
        training under a mesh the batch is this rank's rows of the global
        batch at global_rows: the normalisation takes the global batch's
        statistics and the loss is this rank's share of the global batch's
        (ops.preprocess.preprocess_data, losses.masked_mse_loss with DDP's
        group)."""
        masked_spec, mask_frames, clean_spec = batch
        group = (self.mesh.get_group("data")
                 if train and self.mesh is not None else None)
        clean_norm_log, mask4, masked_norm_log = preprocess_data(
            clean_spec, masked_spec, mask_frames, group=group)
        model = self.state.model
        if train:
            out = self.net(masked_norm_log, mask4, train=True,
                           generator=self.generator, global_rows=global_rows)
            return masked_mse_loss(out, clean_norm_log, mask4, group=group)
        if self.state.ema_params is not None:
            out = torch.func.functional_call(
                model, self.state.ema_params, (masked_norm_log, mask4),
                {"train": False})
        else:
            out = model(masked_norm_log, mask4, train=False)
        return masked_mse_loss(out, clean_norm_log, mask4)

    def train_step(self, batch) -> torch.Tensor:
        """One optimizer update on a collate_inpainting batch; returns the
        loss, on the device (under a mesh this rank's share times the
        ranks: their mean is the global batch's loss)."""
        batch, rows = place_rows(batch, self.mesh)
        with conv_tf32():
            loss = self.loss(device_batch(batch, self.device), train=True,
                             global_rows=rows)
            loss.backward()
        self.state.apply_gradients()
        return loss.detach()

    def train(self, loader, n_steps: Optional[int] = None,
              n_epochs: Optional[int] = None, val_loader=None, log=print):
        """n_steps or n_epochs over the loader. The losses stay on the device
        between log points; each log point validates on val_loader (when
        given) and keeps the val-minimum best/ checkpoint."""
        from generative_audio_torch.data.loader import LoopIterator
        loop = LoopIterator(loader, n_steps=n_steps, n_epochs=n_epochs)
        pending = []
        step = self.state.step
        for batch in loop:
            pending.append(self.train_step(batch))
            step += 1
            if step % self.config.log_interval == 0:
                self._fetch(pending)
                pending = []
                msg = f"step {step}: loss={self.loss_history[-1]:.5f}"
                if val_loader is not None:
                    # every rank validated; rank 0's score decides for all
                    val = from_coordinator(self.validate(val_loader),
                                           self.mesh)
                    self.val_loss_history.append((step, val))
                    msg += f" val_loss={val:.5f}"
                    # the NPPC head wraps the val-minimum model, not the
                    # last snapshot: the gap's MSE is noisy across steps
                    if self.ckpt and val < self.best_val:
                        self.best_val = val
                        self.ckpt.save_best(
                            {"params": self.selected_state_dict()}, val, step,
                            extra={"ema_decay": self.config.ema_decay,
                                   "weight_decay": self.config.weight_decay})
                log(msg)
            if self.ckpt and step % self.config.save_interval == 0:
                self._save(step)
        self._fetch(pending)
        if self.ckpt:
            self._save(step, final=True)
        return self.loss_history

    def _fetch(self, pending):
        if pending:
            self.loss_history.extend(mean_over_ranks(
                torch.stack(pending), self.mesh).cpu().tolist())

    def selected_state_dict(self):
        """The model's state_dict with the EMA parameters where there are:
        what validation scores and best/ keeps."""
        sd = self.state.model.state_dict()
        if self.state.ema_params is not None:
            sd.update(self.state.ema_params)
        return sd

    def validate(self, val_loader) -> float:
        """Mean masked MSE over the loader's batches (EMA parameters where
        there are), BatchNorm on its running statistics."""
        losses = []
        with torch.no_grad(), conv_tf32():
            for batch in val_loader:
                losses.append(self.loss(device_batch(batch, self.device),
                                        train=False))
        return float(np.mean(torch.stack(losses).double().cpu().numpy())) \
            if losses else float("nan")

    def _save(self, step: int, final: bool = False):
        save_run(self, step, final, "final_loss")

    def restore_latest(self) -> bool:
        """Resume from the latest checkpoint (`-R`): parameters, BatchNorm
        statistics, the optimizer's state, the EMA and the step; and the
        best validation score, so that a resumed run cannot replace best/
        with a worse model."""
        new_state, _ = resume_latest(self.ckpt, self.state)
        if new_state is not None:
            best = self.ckpt.best_score()
            if best is not None:
                self.best_val = float(best)
        return resume_from_coordinator(self, self.mesh, new_state is not None,
                                       "best_val")
