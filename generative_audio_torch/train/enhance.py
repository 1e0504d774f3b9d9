"""FullSubNet+ enhancement training: the loss, the train step, the trainer.

Port of generative_audio_tpu/train/enhance.py:40-423 (reference trainer:
stft(noisy/clean) -> gt cIRM (compressed) -> drop_band(gt, G) -> model
(mag, real, imag) -> cRM -> loss -> clip grad 10 -> Adam 1e-3; canonical
hyperparameters batch 18, 3.072 s clips, n_fft 512 / hop 256, G = 2).

Where the JAX package passes a params pytree and returns a new TrainState,
the port passes the `nn.Module` and updates a `train.state.TrainState` in
place. In bf16 on CUDA the sub-band LSTM runs through ops.lstm.LSTMScan,
whose forward and backward are the hand-written scan kernels. Not ported
yet: FullSubNet v1 (`model_type="fullsubnet"`, ROADMAP.md queue A item 8),
validation inside the trainer (items 7 and 14), the HTML training report
(item 14) and the multi-GPU step (item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from generative_audio_torch.losses import (
    cirm_l1_loss, cirm_mse_loss, si_snr_loss)
from generative_audio_torch.models.fullsubnet_plus import (
    FullSubNetPlus, FullSubNetPlusConfig)
from generative_audio_torch.ops.mask import (
    apply_crm, build_complex_ideal_ratio_mask_ri, decompress_cIRM)
from generative_audio_torch.ops.stft import istft_ri, stft_ri
from generative_audio_torch.ops.subband import drop_band
from generative_audio_torch.train.checkpoint import (
    CheckpointManager, resume_latest)
from generative_audio_torch.train.state import TrainState, make_optimizer
from generative_audio_torch.utils.device import resolve_device

__all__ = ["EnhanceTrainConfig", "enhance_loss_fn", "make_enhance_train_step",
           "init_enhance_state", "EnhanceTrainer"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class EnhanceTrainConfig:
    """The JAX EnhanceTrainConfig's fields, without `model_v1` (FullSubNet
    v1 is not ported). loss_alpha > 0 adds the complex-spectrum term of the
    Residual_Trainer objective; loss_type is "mse", "l1", "si_snr" (on the
    mask pair, the reference's literal semantics) or "si_snr_wave" (on the
    enhanced waveform, at full band)."""
    model_type: str = "fullsubnet_plus"
    model: FullSubNetPlusConfig = FullSubNetPlusConfig(
        num_groups_in_drop_band=2)
    n_fft: int = 512
    hop_length: int = 256
    win_length: int = 512
    learning_rate: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    clip_grad_norm: float = 10.0
    compute_dtype: str = "bfloat16"
    loss_alpha: float = 0.0
    loss_type: str = "mse"

    def __post_init__(self):
        if self.loss_type not in ("mse", "l1", "si_snr", "si_snr_wave"):
            raise ValueError(f"unknown loss_type {self.loss_type!r}")
        if self.loss_alpha > 0 and self.loss_type != "mse":
            raise ValueError(
                "loss_alpha (Residual_Trainer) is defined on the cIRM MSE "
                "objective only; use loss_type='mse'")
        if self.model_type == "fullsubnet":
            raise NotImplementedError(
                "FullSubNet v1 is not ported to generative_audio_torch yet "
                "(ROADMAP.md, queue A item 8)")
        if self.model_type != "fullsubnet_plus":
            raise ValueError(f"unknown model_type {self.model_type!r}")
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")


def enhance_loss_fn(model: FullSubNetPlus, noisy: torch.Tensor,
                    clean: torch.Tensor,
                    config: EnhanceTrainConfig) -> torch.Tensor:
    """Waveforms [B, L] on the model's device -> the scalar training loss."""
    stft = (config.n_fft, config.hop_length, config.win_length)
    nr, ni = stft_ri(noisy, *stft)
    cr, ci = stft_ri(clean, *stft)
    noisy_mag = torch.sqrt(nr ** 2 + ni ** 2)
    gt_cirm = build_complex_ideal_ratio_mask_ri(nr, ni, cr, ci)   # [B,F,T,2]

    def crm_of(num_groups=None):                                  # [B,2,F',T]
        return model(noisy_mag[:, None], nr[:, None], ni[:, None],
                     num_groups=num_groups)

    # The two full-band objectives run the same parameters with drop_band
    # off (num_groups=1): drop_band decimates the mask's frequencies and
    # permutes batch rows, so its output cannot meet the noisy spectrum.
    if config.loss_type == "si_snr_wave":
        dec = decompress_cIRM(crm_of(1).permute(0, 2, 3, 1))
        er, ei = apply_crm(dec, nr, ni)
        enhanced = istft_ri(er, ei, *stft, length=clean.shape[-1])
        return si_snr_loss(enhanced, clean)

    if config.loss_alpha > 0:
        crm = crm_of(1)
        loss_cirm = cirm_mse_loss(crm, gt_cirm.permute(0, 3, 1, 2))
        er, ei = apply_crm(decompress_cIRM(crm.permute(0, 2, 3, 1)), nr, ni)
        spec_mse = (torch.mean(torch.square(er - cr))
                    + torch.mean(torch.square(ei - ci))) / 2
        return (config.loss_alpha * spec_mse
                + (1 - config.loss_alpha) * loss_cirm)

    gt_cirm = drop_band(gt_cirm.permute(0, 3, 1, 2),
                        config.model.num_groups_in_drop_band)
    crm = crm_of()
    if config.loss_type == "l1":
        return cirm_l1_loss(crm, gt_cirm)
    if config.loss_type == "si_snr":
        # per-row SI-SNR over the T axis of the masks, gt in the first slot
        return si_snr_loss(gt_cirm, crm)
    return cirm_mse_loss(crm, gt_cirm)


def init_enhance_state(config: EnhanceTrainConfig, seed: int = 0,
                       device=None) -> TrainState:
    """A freshly initialised model (torch's default initialisers, drawn from
    `seed` without touching the global generator) with its optimizer."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        model = FullSubNetPlus(config.model,
                               compute_dtype=_DTYPES[config.compute_dtype],
                               device=dev)
    optimizer = make_optimizer(model.parameters(), config.learning_rate,
                               config.betas)
    return TrainState(model, optimizer, clip_norm=config.clip_grad_norm)


def make_enhance_train_step(config: EnhanceTrainConfig,
                            accum_steps: int = 1) -> Callable:
    """Returns step(state, noisy [B, L], clean [B, L]) -> (state, loss): one
    optimizer update of `state` in place; the loss stays on the device.

    accum_steps > 1 splits the batch into that many microbatches, adds up
    their gradients and makes ONE update with their mean; the loss returned
    is the mean of the microbatch losses."""

    def train_step(state: TrainState, noisy, clean):
        dev = next(state.model.parameters()).device
        noisy = torch.as_tensor(noisy, dtype=torch.float32).to(dev)
        clean = torch.as_tensor(clean, dtype=torch.float32).to(dev)
        b = noisy.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} is not a multiple of accum_steps "
                             f"{accum_steps}")
        micro = b // accum_steps
        state.model.train()
        loss_sum = torch.zeros((), device=dev)
        for k in range(accum_steps):
            rows = slice(k * micro, (k + 1) * micro)
            loss = enhance_loss_fn(state.model, noisy[rows], clean[rows],
                                   config)
            (loss / accum_steps).backward()
            loss_sum += loss.detach()
        state.apply_gradients()
        return state, loss_sum / accum_steps

    return train_step


class EnhanceTrainer:
    """The training loop with the reference trainer's semantics: epochs over
    a loader of (noisy, clean) batches, latest and step-tagged checkpoints,
    resume. Validation and best-model selection are not ported yet."""

    def __init__(self, config: EnhanceTrainConfig, checkpoint_dir=None,
                 seed: int = 0, pretrained_state_dict=None, tracker=None,
                 device=None):
        self.config = config
        self.state = init_enhance_state(config, seed, device)
        if pretrained_state_dict is not None:
            self.state.model.load_state_dict(pretrained_state_dict)
        self._step_fn = make_enhance_train_step(config)
        self.ckpt = (CheckpointManager(checkpoint_dir, config)
                     if checkpoint_dir else None)
        self.best_score = -float("inf")
        self.loss_history = []
        self.tracker = tracker        # anything with .log(dict, step=int)

    def train_epoch(self, loader, log=print) -> float:
        # the losses stay on the device and are fetched once per epoch: a
        # float(loss) per step would make the host wait for every step
        losses = []
        for noisy, clean in loader:
            self.state, loss = self._step_fn(self.state, noisy, clean)
            losses.append(loss)
        avg = float(torch.stack(losses).mean().item()) if losses else 0.0
        self.loss_history.append(avg)
        if self.tracker is not None:
            self.tracker.log({"train_loss": avg}, step=self.state.step)
        return avg

    def validate(self, dataset, max_items: int = 10) -> dict:
        raise NotImplementedError(
            "EnhanceTrainer.validate needs eval/validator.py and "
            "eval/metrics.py, which are not ported to generative_audio_torch "
            "yet (ROADMAP.md, queue A items 7 and 14)")

    def train(self, loader, epochs: int, val_dataset=None, log=print) -> None:
        """Epoch loop: train, then save the latest and a step-tagged
        checkpoint. Raises for a val_dataset (see validate)."""
        if val_dataset is not None:
            self.validate(val_dataset)
        for epoch in range(1, epochs + 1):
            avg = self.train_epoch(loader, log=log)
            log(f"[Train] Epoch {epoch}, Loss {avg:.5f}")
            if self.ckpt:
                step = self.state.step
                tree = {**self.state.state_dict(),
                        "best_score": float(self.best_score)}
                self.ckpt.save_latest(tree, step)
                self.ckpt.save_step(tree, step)

    def restore_latest(self) -> bool:
        """Resume from the latest checkpoint: step, parameters, optimizer
        state and best_score. A checkpoint without best_score keeps this
        trainer's; best_score.json wins when it holds a higher score."""
        _, restored = resume_latest(
            self.ckpt, self.state, extra={"best_score": self.best_score})
        if restored is None:
            return False
        best_json = self.ckpt.best_score()
        self.best_score = max(float(restored["best_score"]),
                              best_json if best_json is not None
                              else -float("inf"))
        return True
