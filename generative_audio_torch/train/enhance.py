"""FullSubNet+ and FullSubNet enhancement training: the loss, the train step,
the trainer.

Port of generative_audio_tpu/train/enhance.py:40-423 (reference trainer:
stft(noisy/clean) -> gt cIRM (compressed) -> drop_band(gt, G) -> model
(mag, real, imag) -> cRM -> loss -> clip grad 10 -> Adam 1e-3; canonical
hyperparameters batch 18, 3.072 s clips, n_fft 512 / hop 256, G = 2).

Where the JAX package passes a params pytree and returns a new TrainState,
the port passes the `nn.Module` and updates a `train.state.TrainState` in
place. `model_type="fullsubnet"` trains FullSubNet v1 (`model_v1`, the
magnitude-only model; the same loss otherwise). In bf16 on CUDA the
recurrent layers run through ops.lstm.LSTMScan or ops.gru.GRUScan, whose
forward and backward are the hand-written scan kernels. The trainer
validates with eval/validator.ModelValidator (composite (STOI + WB-PESQ)/2,
optionally blended with a probe set's), keeps the best model and writes
report.html.

With a mesh (parallel.make_mesh) the trainer is one rank of a multi-GPU
job: the model trains under DistributedDataParallel (parallel.mesh.
data_parallel), each step on this rank's rows of the global batch
(parallel.mesh.place_rows), drop_band grouping each row by its index in the
global batch, so the step is the single process's over the global batch;
accum_steps > 1 adds the microbatches' gradients under DDP's no_sync. The
losses it records are the global batch's (the mean over the ranks); every
rank validates and takes rank 0's scores, so that all take the same
best-model decision; rank 0 alone writes checkpoints and report.html; a
resume takes rank 0's state on every rank. The JAX trainer takes a
`subband_sharding` instead, which spreads the sub-band rows over the same
data axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from generative_audio_torch.losses import (
    cirm_l1_loss, cirm_mse_loss, si_snr_loss)
from generative_audio_torch.models.fullsubnet import (
    FullSubNet, FullSubNetConfig)
from generative_audio_torch.models.fullsubnet_plus import (
    FullSubNetPlus, FullSubNetPlusConfig)
from generative_audio_torch.ops.mask import (
    apply_crm, build_complex_ideal_ratio_mask_ri, decompress_cIRM)
from generative_audio_torch.ops.stft import istft_ri, stft_ri
from generative_audio_torch.ops.subband import drop_band
from generative_audio_torch.parallel import distributed as D
from generative_audio_torch.parallel.mesh import (
    data_parallel, from_coordinator, mean_over_ranks, place_rows,
    resume_from_coordinator)
from generative_audio_torch.train.checkpoint import (
    CheckpointManager, resume_latest)
from generative_audio_torch.train.state import TrainState, make_optimizer
from generative_audio_torch.utils.device import resolve_device

__all__ = ["EnhanceTrainConfig", "enhance_loss_fn", "make_enhance_train_step",
           "init_enhance_state", "EnhanceTrainer"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class EnhanceTrainConfig:
    """The JAX EnhanceTrainConfig's fields. model_type "fullsubnet_plus"
    trains `model` on (mag, real, imag), "fullsubnet" trains `model_v1` on
    the magnitude alone. loss_alpha > 0 adds the complex-spectrum term of
    the Residual_Trainer objective; loss_type is "mse", "l1", "si_snr" (on
    the mask pair, the reference's literal semantics) or "si_snr_wave" (on
    the enhanced waveform, at full band)."""
    model_type: str = "fullsubnet_plus"
    model: FullSubNetPlusConfig = FullSubNetPlusConfig(
        num_groups_in_drop_band=2)
    model_v1: FullSubNetConfig = FullSubNetConfig()
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
        if self.model_type not in ("fullsubnet_plus", "fullsubnet"):
            raise ValueError(f"unknown model_type {self.model_type!r}")
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")


def _model_config(config: EnhanceTrainConfig):
    return (config.model_v1 if config.model_type == "fullsubnet"
            else config.model)


def enhance_loss_fn(model: nn.Module, noisy: torch.Tensor,
                    clean: torch.Tensor, config: EnhanceTrainConfig,
                    global_rows: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """Waveforms [B, L] on the model's device -> the scalar training loss.
    `model` is the FullSubNetPlus or FullSubNet that config.model_type
    names, or its DistributedDataParallel; global_rows places the rows in a
    global batch split over ranks (drop_band's argument)."""
    stft = (config.n_fft, config.hop_length, config.win_length)
    nr, ni = stft_ri(noisy, *stft)
    cr, ci = stft_ri(clean, *stft)
    noisy_mag = torch.sqrt(nr ** 2 + ni ** 2)
    gt_cirm = build_complex_ideal_ratio_mask_ri(nr, ni, cr, ci)   # [B,F,T,2]

    def crm_of(num_groups: Optional[int] = None):                 # [B,2,F',T]
        if config.model_type == "fullsubnet":
            return model(noisy_mag[:, None], num_groups=num_groups,
                         global_rows=global_rows)
        return model(noisy_mag[:, None], nr[:, None], ni[:, None],
                     num_groups=num_groups, global_rows=global_rows)

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
                        _model_config(config).num_groups_in_drop_band,
                        global_rows)
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
        model_cls = (FullSubNet if config.model_type == "fullsubnet"
                     else FullSubNetPlus)
        model = model_cls(_model_config(config),
                          compute_dtype=_DTYPES[config.compute_dtype],
                          device=dev)
    optimizer = make_optimizer(model.parameters(), config.learning_rate,
                               config.betas)
    return TrainState(model, optimizer, clip_norm=config.clip_grad_norm)


def make_enhance_train_step(config: EnhanceTrainConfig,
                            accum_steps: int = 1,
                            net: Optional[nn.Module] = None) -> Callable:
    """Returns step(state, noisy [B, L], clean [B, L], global_rows=None) ->
    (state, loss): one optimizer update of `state` in place; the loss stays
    on the device.

    accum_steps > 1 splits the batch into that many microbatches, adds up
    their gradients and makes ONE update with their mean; the loss returned
    is the mean of the microbatch losses. net: the module the step calls in
    place of state.model, its DistributedDataParallel
    (parallel.mesh.data_parallel) in a multi-GPU step, whose backward
    averages the gradient over the ranks (after the last microbatch only:
    the others run under its no_sync); global_rows: the batch's rows in the
    global batch (parallel.mesh.place_rows), each microbatch then the same
    share of a global microbatch."""

    def train_step(state: TrainState, noisy, clean, global_rows=None):
        model = state.model if net is None else net
        dev = next(state.model.parameters()).device
        noisy = torch.as_tensor(noisy, dtype=torch.float32).to(dev)
        clean = torch.as_tensor(clean, dtype=torch.float32).to(dev)
        b = noisy.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} is not a multiple of accum_steps "
                             f"{accum_steps}")
        micro = b // accum_steps
        micro_rows = None if global_rows is None else (
            global_rows[0] // accum_steps, global_rows[1] // accum_steps)
        state.model.train()
        loss_sum = torch.zeros((), device=dev)
        for k in range(accum_steps):
            rows = slice(k * micro, (k + 1) * micro)
            sync = (model.no_sync() if k < accum_steps - 1
                    and hasattr(model, "no_sync")
                    else contextlib.nullcontext())
            with sync:
                loss = enhance_loss_fn(model, noisy[rows], clean[rows],
                                       config, micro_rows)
                (loss / accum_steps).backward()
            loss_sum += loss.detach()
        state.apply_gradients()
        return state, loss_sum / accum_steps

    return train_step


class EnhanceTrainer:
    """The training loop with the reference trainer's semantics
    (Trainer_Finetune, fullsubnet_plus/trainer/trainer.py:309-446 +
    base_trainer.py:305-342): epochs over a loader of (noisy, clean)
    batches, periodic validation with the composite (STOI + PESQ)/2 score,
    latest, step-tagged and best checkpoints, resume."""

    def __init__(self, config: EnhanceTrainConfig, checkpoint_dir=None,
                 seed: int = 0, pretrained_state_dict=None, tracker=None,
                 device=None, mesh=None):
        self.config = config
        self.state = init_enhance_state(config, seed, device)
        if pretrained_state_dict is not None:
            self.state.model.load_state_dict(pretrained_state_dict)
        self.mesh = mesh
        self.net = data_parallel(self.state.model, mesh)
        self._step_fn = make_enhance_train_step(config, net=self.net)
        self.ckpt = (CheckpointManager(checkpoint_dir, config)
                     if checkpoint_dir else None)
        self.best_score = -float("inf")
        self.loss_history = []
        self.val_history = []
        # (step, probe composite) when a probe dataset is given, recorded
        # even at probe_weight 0 so that the selection can be swept later
        self.probe_history = []
        self.tracker = tracker        # anything with .log(dict, step=int)
        self._validator = None

    def train_epoch(self, loader, log=print) -> float:
        # the losses stay on the device and are fetched once per epoch: a
        # float(loss) per step would make the host wait for every step
        losses = []
        for noisy, clean in loader:
            (noisy, clean), rows = place_rows((noisy, clean), self.mesh)
            self.state, loss = self._step_fn(self.state, noisy, clean, rows)
            losses.append(loss)
        avg = (float(mean_over_ranks(torch.stack(losses), self.mesh)
                     .mean().item()) if losses else 0.0)
        self.loss_history.append(avg)
        if self.tracker is not None:
            self.tracker.log({"train_loss": avg}, step=self.state.step)
        return avg

    def validate(self, dataset, max_items: int = 10) -> dict:
        """Composite validation on (noisy, clean) pairs (trainer.py:365-446):
        the mean STOI, SI_SDR and WB_PESQ of the live model, and
        "composite". The model's parameters, training flag and device and
        the optimizer's state are left as they were."""
        from generative_audio_torch.eval.metrics import (
            composite_validation_score)
        from generative_audio_torch.eval.validator import ModelValidator
        model = self.state.model
        if self._validator is None:
            self._validator = ModelValidator(
                model, n_fft=self.config.n_fft,
                hop_length=self.config.hop_length,
                win_length=self.config.win_length,
                metric_names=("STOI", "SI_SDR", "WB_PESQ"),
                device=next(model.parameters()).device,
                model_type=self.config.model_type)
        self._validator.model = model
        means = self._validator.validate_dataset(dataset, max_items=max_items,
                                                 log=lambda *_: None)
        if means.get("WB_PESQ") is None:
            # every clip failed PESQ (silent or too short): rank on STOI and
            # say so, rather than hide the change of criterion
            warnings.warn("validation produced no WB_PESQ value; composite "
                          "falls back to STOI for this epoch")
            means["composite"] = means.get("STOI") or 0.0
        else:
            means["composite"] = composite_validation_score(
                means.get("STOI") or 0.0, means["WB_PESQ"])
        return means

    def train(self, loader, epochs: int, val_dataset=None,
              validation_interval: int = 1, log=print,
              probe_dataset=None, probe_weight: float = 0.0) -> None:
        """Epoch loop: train, save the latest and a step-tagged checkpoint,
        and every `validation_interval` epochs validate and keep the best
        model (best.pt, best_score.json); report.html at the end.

        The selection score is the reference's in-distribution composite
        (base_trainer.py:296-303). With `probe_dataset` and probe_weight w
        > 0 it is (1 - w) * val + w * probe composite; at w = 0 the probe is
        evaluated and recorded (probe_history, tracker) but never selects.
        A new best also re-saves latest with the updated best_score, so
        that a resume does not restore the score from before the
        validation."""
        # scores are comparable under one criterion only: when a resumed
        # best/ was selected under another probe_weight, its score is on
        # another scale, and best-model tracking starts again
        if self.ckpt is not None:
            meta = self.ckpt.best_meta()
            if meta is not None and self.best_score > -float("inf"):
                saved_w = float(meta.get("probe_weight", 0.0))
                cur_w = probe_weight if probe_dataset is not None else 0.0
                if saved_w != cur_w:
                    warnings.warn(
                        f"resumed best_score was selected with probe_weight="
                        f"{saved_w:g} but this run uses {cur_w:g}; resetting "
                        "best-model tracking (scores are incommensurate)")
                    self.best_score = -float("inf")
        for epoch in range(1, epochs + 1):
            avg = self.train_epoch(loader, log=log)
            log(f"[Train] Epoch {epoch}, Loss {avg:.5f}")
            step = self.state.step
            if self.ckpt:
                tree = {**self.state.state_dict(),
                        "best_score": float(self.best_score)}
                self.ckpt.save_latest(tree, step)
                self.ckpt.save_step(tree, step)
            if val_dataset is None or epoch % validation_interval:
                continue
            scores = self.validate(val_dataset)
            if probe_dataset is not None:
                scores["probe_composite"] = self.validate(
                    probe_dataset)["composite"]
            # every rank validated; rank 0's scores decide for all
            scores = from_coordinator(scores, self.mesh)
            select = scores["composite"]
            if probe_dataset is not None:
                self.probe_history.append((step, scores["probe_composite"]))
                if probe_weight > 0.0:
                    select = ((1.0 - probe_weight) * scores["composite"]
                              + probe_weight * scores["probe_composite"])
                    scores["selection"] = select
            log(f"[Validate] Epoch {epoch}: {scores}")
            self.val_history.append((step, scores.get("composite") or 0.0))
            if self.tracker is not None:
                self.tracker.log(
                    {k: v for k, v in scores.items() if v is not None},
                    step=step)
            if self.ckpt and select > self.best_score:
                self.best_score = select
                self.ckpt.save_best(
                    {"params": self.state.model.state_dict()}, select, step,
                    extra={"probe_weight": (probe_weight
                                            if probe_dataset is not None
                                            else 0.0),
                           "composite": scores["composite"]})
                # latest again, with the new best_score (ref
                # base_trainer.py:315-340): a resume from here must not
                # restore the score from before this validation
                tree["best_score"] = float(self.best_score)
                self.ckpt.save_latest(tree, step)
        if self.ckpt and D.is_coordinator():
            from generative_audio_torch.utils.report import (
                write_training_report)
            write_training_report(
                self.ckpt.directory / "report.html", "enhancement training",
                self.loss_history, self.val_history,
                {"best_composite": self.best_score, "steps": self.state.step})

    def restore_latest(self) -> bool:
        """Resume from the latest checkpoint: step, parameters, optimizer
        state and best_score. A checkpoint without best_score keeps this
        trainer's; best_score.json wins when it holds a higher score."""
        _, restored = resume_latest(
            self.ckpt, self.state, extra={"best_score": self.best_score})
        if restored is not None:
            best_json = self.ckpt.best_score()
            self.best_score = max(float(restored["best_score"]),
                                  best_json if best_json is not None
                                  else -float("inf"))
        return resume_from_coordinator(self, self.mesh, restored is not None,
                                       "best_score")
