"""The NPPC trainers: K uncertainty directions trained over a frozen
restoration model, for the inpainting and the denoising line.

Port of generative_audio_tpu/train/nppc.py:42-433. Both optimise the PC
head's parameters only, with the global-norm clip over the head alone (the
counterpart of optax.multi_transform with set_to_zero on
pretrained_restoration_model), and take the lambda ramp at the step before
the update, as the JAX trainers read state.step.
  * NPPCInpaintingTrainer (reference inpainting/trainer/nppc_trainer.py):
    preprocess_data -> the frozen UNet's prediction, computed once a step
    and handed to both of its uses (the PC UNet's input and the error) ->
    AudioInpaintingPCWrapper; objective_variant "base_step" projects the
    restoration error (nppc_objective_real), "mc_pca_aligned" aligns each
    direction with the MC-dropout PCA of the frozen model
    (nppc_objective_mc_aligned; eval/mc_dropout, mc_chunk_size passes a
    forward, one generator a pass). The PC UNet's BatchNorm updates its
    running statistics in training; the frozen UNet's never change. The
    convolutions run with cuDNN's TF32 (utils.device.conv_tf32).
  * NPPCDenoisingTrainer (reference nppc_audio/trainer.py:40-371): one
    forward gives w_mat and the frozen enhancer's compressed cRM; the
    ground-truth cIRM comes from the float32 STFTs of the noisy and clean
    waveforms; drop_band with the head's G is applied to both masks; the
    complex NPPC objective.
With a mesh (parallel.make_mesh) each trainer is one rank of a multi-GPU
job: the PC head alone trains under DistributedDataParallel (the frozen
model stays outside it, under no_grad), each step on this rank's rows of
the global batch, drop_band, the dropout masks and the MC passes' masks
drawn for the global batch (global_rows), so that the step is the single
process's over the global batch; the PC UNet's BatchNorm takes the global
batch's statistics. The recorded metrics are the global batch's; rank 0
alone writes checkpoints; a resume takes rank 0's state on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from generative_audio_torch.eval.mc_dropout import calculate_unet_baseline
from generative_audio_torch.losses import (
    nppc_objective_complex, nppc_objective_mc_aligned, nppc_objective_real)
from generative_audio_torch.models.nppc_model import (
    DenoisingNPPCConfig, DenoisingNPPCModel, InpaintingNPPCConfig,
    InpaintingNPPCModel)
from generative_audio_torch.ops.preprocess import preprocess_data
from generative_audio_torch.ops.mask import build_complex_ideal_ratio_mask_ri
from generative_audio_torch.ops.stft import stft_ri
from generative_audio_torch.ops.subband import drop_band
from generative_audio_torch.parallel.mesh import (
    data_parallel, from_coordinator, mean_over_ranks, place_rows,
    resume_from_coordinator)
from generative_audio_torch.train.checkpoint import (
    CheckpointManager, resume_latest)
from generative_audio_torch.train.state import TrainState, make_optimizer
from generative_audio_torch.train.restoration import device_batch, save_run
from generative_audio_torch.utils.device import conv_tf32, resolve_device

__all__ = ["NPPCInpaintingTrainConfig", "NPPCInpaintingTrainer",
           "NPPCDenoisingTrainConfig", "NPPCDenoisingTrainer"]


@dataclasses.dataclass(frozen=True)
class NPPCInpaintingTrainConfig:
    model: InpaintingNPPCConfig = InpaintingNPPCConfig()
    learning_rate: float = 1e-4
    betas: Tuple[float, float] = (0.5, 0.999)
    max_grad_norm: float = 1.0
    second_moment_loss_lambda: float = 1.0
    second_moment_loss_grace: int = 500
    num_freqs: int = 128
    num_frames: int = 256
    log_interval: int = 100
    save_interval: int = 1000
    # "base_step" (error projection) or "mc_pca_aligned" (each direction
    # aligned with the matching MC-dropout PCA direction)
    objective_variant: str = "base_step"
    n_mc_samples: int = 50
    # MC passes stacked into one forward of the frozen UNet in the
    # mc_pca_aligned step (the largest divisor of n_mc_samples up to it)
    mc_chunk_size: int = 5


def _unet_state_dict(variables: Mapping) -> Mapping:
    """An InpaintingRestorationModel state_dict as it is, or the JAX
    package's {"params", "batch_stats"} carried across."""
    if "batch_stats" in variables:
        from generative_audio_torch.utils.convert import (
            convert_inpainting_restoration)
        return convert_inpainting_restoration(variables)
    return variables


class NPPCInpaintingTrainer:
    """Trains the AudioInpaintingPCWrapper of an InpaintingNPPCModel; the
    restoration UNet stays frozen. restoration_variables: its weights, a
    state_dict or the JAX variables (None keeps the seeded init). device:
    "cuda" (default; raises without one) or "cpu"; seed: the init, and with
    seed + 1 the generator of the PC UNet's dropout and of the MC passes'
    seeds; mesh: a parallel.make_mesh() of a multi-GPU job, or None."""

    def __init__(self, config: NPPCInpaintingTrainConfig,
                 restoration_variables=None, checkpoint_dir=None,
                 seed: int = 0, device=None, mesh=None):
        self.config = config
        dev = resolve_device(device)
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed(seed)
            model = InpaintingNPPCModel(config.model)
        if restoration_variables is not None:
            model.pretrained_restoration_model.load_state_dict(
                _unet_state_dict(restoration_variables))
        model.to(dev)
        optimizer = make_optimizer(model.pc_wrapper.parameters(),
                                   config.learning_rate, config.betas)
        self.state = TrainState(model, optimizer,
                                clip_norm=config.max_grad_norm)
        self.device = dev
        self.mesh = mesh
        self.net = data_parallel(model.pc_wrapper, mesh)
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)
        self._mc_seeds = np.random.default_rng(seed + 1)
        self.ckpt = (CheckpointManager(checkpoint_dir, config)
                     if checkpoint_dir else None)
        self.loss_history = []
        self.reconst_err_history = []

    @classmethod
    def from_artifact(cls, config: NPPCInpaintingTrainConfig, registry_root,
                      artifact_ref: str = "restoration-model:latest",
                      **kwargs):
        """The trainer over the restoration weights of a named artifact of
        utils.tracking.ArtifactRegistry: a checkpoint directory holding
        latest.pt, at the artifact's root or one level down."""
        from generative_audio_torch.utils.tracking import ArtifactRegistry
        art_dir = ArtifactRegistry(registry_root).get_artifact(artifact_ref)
        candidates = [art_dir] + sorted(d for d in art_dir.iterdir()
                                        if d.is_dir())
        found = [d for d in candidates if (d / "latest.pt").exists()]
        if not found:
            raise FileNotFoundError(
                f"artifact {artifact_ref} holds no 'latest' checkpoint")
        restored = CheckpointManager(found[0]).restore("latest")
        return cls(config, restoration_variables=restored["params"], **kwargs)

    def _mc_generators(self, train: bool):
        """One generator a MC pass: new seeds each training step, the same
        ones (0 ... K-1) for every evaluation."""
        k = self.config.n_mc_samples
        seeds = (self._mc_seeds.integers(0, 2 ** 62, k) if train
                 else range(k))
        return [torch.Generator(device=self.device).manual_seed(int(s))
                for s in seeds]

    def objective(self, batch, step, train: bool, global_rows=None):
        """(objective, reconst_err [B], log) of a batch (tensors on the
        device), with the lambda of `step`; global_rows: the rows' place in
        the global batch of a multi-GPU step, whose head is then the
        DistributedDataParallel one."""
        c = self.config
        masked_spec, mask_frames, clean_spec = batch
        clean_norm_log, mask4, masked_norm_log = preprocess_data(
            clean_spec, masked_spec, mask_frames,
            group=(self.mesh.get_group("data")
                   if train and self.mesh is not None else None))
        model = self.state.model
        w_mat, pred = model.forward_with_pred(
            masked_norm_log, mask4, train=train,
            generator=self.generator if train else None,
            head=self.net if train else None, global_rows=global_rows)
        if c.objective_variant == "mc_pca_aligned":
            baseline = calculate_unet_baseline(
                lambda x, m, g: model.mc_restoration(x, m, g, global_rows),
                masked_norm_log, mask4, self._mc_generators(train),
                n_components=c.model.pc_wrapper.n_dirs,
                mc_chunk_size=c.mc_chunk_size)
            reconst_err, objective, log = nppc_objective_mc_aligned(
                w_mat, baseline["scaled_principal_components"],
                baseline["singular_vals"], step,
                grace=c.second_moment_loss_grace,
                lambda_scale=c.second_moment_loss_lambda)
        else:
            reconst_err, objective, log = nppc_objective_real(
                w_mat, clean_norm_log - pred, step,
                grace=c.second_moment_loss_grace,
                lambda_scale=c.second_moment_loss_lambda)
        return objective, reconst_err, log

    def train_step(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer update on a collate_inpainting batch; returns
        (objective, mean reconst_err), on the device."""
        state = self.state
        batch, rows = place_rows(batch, self.mesh)
        with conv_tf32():
            objective, reconst_err, _ = self.objective(
                device_batch(batch, self.device), state.step, train=True,
                global_rows=rows)
            objective.backward()
        state.apply_gradients()
        return objective.detach(), reconst_err.detach().mean()

    def train(self, loader, n_steps: Optional[int] = None,
              n_epochs: Optional[int] = None, val_loader=None, log=print):
        """n_steps or n_epochs over a loader of collate_inpainting batches.
        The metrics stay on the device between log points."""
        from generative_audio_torch.data.loader import LoopIterator
        loop = LoopIterator(loader, n_steps=n_steps, n_epochs=n_epochs)
        pending = []
        step = self.state.step
        for batch in loop:
            pending.append(self.train_step(batch))
            step += 1
            if step % self.config.log_interval == 0:
                _fetch(self, pending)
                pending = []
                msg = (f"step {step}: objective={self.loss_history[-1]:.5f} "
                       f"reconst_err={self.reconst_err_history[-1]:.5f}")
                if val_loader is not None:
                    v_obj, v_rec = from_coordinator(
                        self.validate(val_loader), self.mesh)
                    msg += f" val={v_obj:.5f}/{v_rec:.5f}"
                log(msg)
            if self.ckpt and step % self.config.save_interval == 0:
                self._save(step)
        _fetch(self, pending)
        if self.ckpt:
            self._save(step, final=True)
        return self.loss_history

    def validate(self, val_loader) -> Tuple[float, float]:
        """Mean (objective, reconst_err) over the loader's batches, both
        UNets on their running statistics."""
        values = []
        with torch.no_grad(), conv_tf32():
            for batch in val_loader:
                obj, rec, _ = self.objective(
                    device_batch(batch, self.device), self.state.step,
                    train=False)
                values.append(torch.stack([obj, rec.mean()]))
        if not values:
            return float("nan"), float("nan")
        mean = torch.stack(values).double().cpu().numpy().mean(axis=0)
        return float(mean[0]), float(mean[1])

    def _save(self, step: int, final: bool = False):
        save_run(self, step, final, "final_loss")

    def restore_latest(self) -> bool:
        """Resume from the latest checkpoint (`-R`): parameters (both UNets'
        and their BatchNorm statistics), the optimizer's state and the
        step (rank 0's on every rank)."""
        new_state, _ = resume_latest(self.ckpt, self.state)
        return resume_from_coordinator(self, self.mesh, new_state is not None)


def _fetch(trainer, pending):
    """(objective, reconst_err) pairs on the device -> the histories (the
    global batch's: the mean over the ranks)."""
    if pending:
        values = mean_over_ranks(torch.stack([torch.stack(p)
                                              for p in pending]),
                                 trainer.mesh).cpu()
        trainer.loss_history.extend(values[:, 0].tolist())
        trainer.reconst_err_history.extend(values[:, 1].tolist())


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
    tests; mesh: a parallel.make_mesh() of a multi-GPU job, or None."""

    def __init__(self, config: NPPCDenoisingTrainConfig,
                 restoration_params=None, checkpoint_dir=None, seed: int = 0,
                 device=None, compute_dtype: torch.dtype = torch.bfloat16,
                 mesh=None):
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
        self.mesh = mesh
        self.net = data_parallel(model.audio_pc_wrapper, mesh)
        self.ckpt = (CheckpointManager(checkpoint_dir, config)
                     if checkpoint_dir else None)
        self.loss_history = []
        self.reconst_err_history = []

    def objective(self, noisy: torch.Tensor, clean: torch.Tensor, step,
                  global_rows=None, head=None):
        """(objective, reconst_err [B], log) of waveforms [B, L] on the
        model's device, with the lambda of `step`; global_rows: the rows'
        place in the global batch of a multi-GPU step (drop_band's
        argument); head: the module called in place of the PC head (its
        DistributedDataParallel in such a step)."""
        c = self.config
        s = c.model.stft
        w_mat, pred_crm = self.state.model.forward_with_pred_crm(
            noisy, head=head, global_rows=global_rows)
        nr, ni = stft_ri(noisy, s.nfft, s.hop_length, s.win_length)
        cr, ci = stft_ri(clean, s.nfft, s.hop_length, s.win_length)
        gt_crm = build_complex_ideal_ratio_mask_ri(nr, ni, cr, ci)
        groups = c.model.pc_wrapper.num_groups_in_drop_band
        gt_crm = drop_band(gt_crm.permute(0, 3, 1, 2), groups, global_rows)
        pred_crm = drop_band(pred_crm, groups, global_rows)
        reconst_err, objective, log = nppc_objective_complex(
            w_mat, gt_crm, pred_crm, step,
            grace=c.second_moment_loss_grace,
            lambda_scale=c.second_moment_loss_lambda)
        return objective, reconst_err, log

    def train_step(self, noisy, clean) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer update on a batch of (noisy, clean) waveforms
        [B, L]; returns (objective, mean reconst_err), on the device."""
        (noisy, clean), rows = place_rows((noisy, clean), self.mesh)
        noisy = torch.as_tensor(noisy, dtype=torch.float32).to(self.device)
        clean = torch.as_tensor(clean, dtype=torch.float32).to(self.device)
        state = self.state
        state.model.train()
        objective, reconst_err, _ = self.objective(
            noisy, clean, state.step, global_rows=rows, head=self.net)
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
                _fetch(self, pending)
                pending = []
                log(f"step {step}: objective={self.loss_history[-1]:.5f} "
                    f"reconst_err={self.reconst_err_history[-1]:.5f}")
            if self.ckpt and step % self.config.save_interval == 0:
                self._save(step)
        _fetch(self, pending)
        if self.ckpt:
            # a run that ends between save_interval boundaries keeps its
            # steps for a resume
            self._save(step, final=True)
        return self.loss_history

    def _save(self, step: int, final: bool = False):
        save_run(self, step, final, "final_objective", "final_reconst_err")

    def restore_latest(self) -> bool:
        """Resume from the latest checkpoint (`-R`): step, parameters and the
        optimizer's state (rank 0's on every rank)."""
        new_state, _ = resume_latest(self.ckpt, self.state)
        return resume_from_coordinator(self, self.mesh, new_state is not None)
