"""The image-line trainers: restoration (MSE or MAE) and NPPC.

Port of generative_audio_tpu/train/image.py (reference nppc/restoration.py
RestorationTrainer :387-917 and nppc/nppc.py NPPCTrainer :289-871):
  * the shared loop: batches of the data module's train set in an order
    drawn from np.random.default_rng(0), redrawn when a pass runs out; every
    `benchmark_every` steps a benchmark on the valid set's first 256 items
    in the order of np.random.RandomState(42), whose minimum keeps a copy of
    the parameters; at the end latest/ and best/ through CheckpointManager
    and report.html (loss curve, summary, image grids);
  * ImageRestorationTrainer: distort (a draw of the trainer's generator),
    restore, MSE or MAE against the clean image, Adam;
  * ImageNPPCTrainer: the restoration model frozen under no_grad, the PC
    wrapper's directions, nppc_objective_real with eps 0 and the second
    moment ramped by the step, Adam; the benchmark is the mean reconst_err.

Both optimizers are plain Adam with betas (0.9, 0.999): the JAX trainers
hand `weight_decay` to make_optimizer with its default "Adam", which drops
it, so the config's weight_decay has no effect there, and none here. The
report's sample grids are best effort, as in the JAX trainers: an exception
while drawing them is logged and written into the report instead.

The device and the generator come in explicitly: `device` is "cuda" (the
default; raises without one) or "cpu"; the distortions draw from
`generator` (a torch.Generator on the device, seeded with seed + 1 unless
given), so noise draws differ from the JAX trainers' jax.random ones. The
nets' convolutions run with cuDNN's TF32 in train_step
(utils.device.conv_tf32); `loss_value`, `objective` and the benchmarks
leave the flag as they find it.

With a mesh (parallel.make_mesh) each trainer is one rank of a multi-GPU
job, as the JAX trainers take `mesh`: every rank draws the same batch
order, takes its rows of each global batch, draws its rows of the global
batch's distortion noise (global_rows) and trains the wrapper under
DistributedDataParallel, so that a step is the single process's over the
global batch; the recorded losses are the global batch's; every rank runs
the benchmark and takes rank 0's score, so that all keep the same best
parameters; rank 0 alone writes the checkpoints and report.html.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from generative_audio_torch.losses import nppc_objective_real
from generative_audio_torch.models.image_nppc import (
    ImageNPPCConfig, ImageNPPCModel)
from generative_audio_torch.models.image_restoration import (
    ImageRestorationConfig, ImageRestorationModel)
from generative_audio_torch.parallel import distributed as D
from generative_audio_torch.parallel.mesh import (
    data_parallel, from_coordinator, mean_over_ranks, place_rows)
from generative_audio_torch.train.checkpoint import CheckpointManager
from generative_audio_torch.train.state import TrainState, make_optimizer
from generative_audio_torch.utils.device import conv_tf32, resolve_device
from generative_audio_torch.utils.logging import get_logger

__all__ = ["ImageRestorationTrainer", "ImageNPPCTrainer"]


def _seeded(seed: int, build):
    """build() with torch's default generators seeded, their state restored
    after it."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


class _ImageTrainerBase:
    """The shared loop, benchmark subset, best-parameter copy, checkpoints
    and report."""

    def __init__(self, checkpoint_dir, config_for_ckpt, seed: int, device,
                 generator: Optional[torch.Generator], mesh):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.ckpt = (CheckpointManager(checkpoint_dir, config_for_ckpt)
                     if checkpoint_dir else None)
        self.generator = generator or torch.Generator(
            device=self.device).manual_seed(seed + 1)
        self.loss_history = []
        self.best_score: Optional[float] = None
        self.best_params: Optional[Dict[str, torch.Tensor]] = None

    def _device_batch(self, batch) -> torch.Tensor:
        return torch.as_tensor(
            batch if isinstance(batch, torch.Tensor) else np.asarray(batch),
            dtype=torch.float32).to(self.device, non_blocking=True)

    def _maybe_update_best(self, score: float) -> bool:
        """Keep a copy (not an alias) of the parameters where `score` is the
        lowest so far (reference auxil.py:399-416 update_best)."""
        if self.best_score is None or score < self.best_score:
            self.best_score = score
            self.best_params = {k: v.detach().clone() for k, v in
                                self.state.model.state_dict().items()}
            return True
        return False

    @staticmethod
    def _batches(dataset, batch_size: int, n_samples: int, seed: int = 42):
        indices = np.random.RandomState(seed).permutation(len(dataset))
        indices = indices[:n_samples]
        for start in range(0, len(indices), batch_size):
            chunk = indices[start:start + batch_size]
            yield np.stack([np.asarray(dataset[int(i)]) for i in chunk])

    def step(self, x_org) -> float:
        """One optimizer update on a batch of clean images; the loss (the
        global batch's under a mesh)."""
        return float(mean_over_ranks(self.train_step(x_org), self.mesh))

    def train(self, n_steps: int, batch_size: int = 32,
              benchmark_every: Optional[int] = None, log=print):
        """n_steps over the train set (reference LoopLoader, auxil.py:124);
        returns the loss history. The losses stay on the device between
        benchmarks."""
        dataset = self.model.data_module.train_set
        n = len(dataset)
        order_rng = np.random.default_rng(0)
        order = order_rng.permutation(n)
        pos = 0
        pending = []
        for step_i in range(n_steps):
            if pos + batch_size > n:
                order = order_rng.permutation(n)
                pos = 0
            idx = order[pos:pos + batch_size]
            pos += batch_size
            batch = np.stack([np.asarray(dataset[int(i)]) for i in idx])
            pending.append(self.train_step(batch))
            if benchmark_every and (step_i + 1) % benchmark_every == 0:
                self._fetch(pending)
                pending = []
                # every rank ran it; rank 0's score decides for all
                score = from_coordinator(
                    self.benchmark(batch_size=batch_size), self.mesh)
                is_best = self._maybe_update_best(score)
                log(f"step {self.state.step}: loss={self.loss_history[-1]:.5f} "
                    f"benchmark={score:.5f}{' *best*' if is_best else ''}")
        self._fetch(pending)
        if self.ckpt:
            step = self.state.step
            self.ckpt.save_latest(self.state.state_dict(), step)
            if self.best_params is not None:
                self.ckpt.save_best({"params": self.best_params, "step": step},
                                    self.best_score, step)
            if D.is_coordinator():
                self.write_report(self.ckpt.directory / "report.html")
        return self.loss_history

    def _fetch(self, pending):
        if pending:
            self.loss_history.extend(mean_over_ranks(
                torch.stack(pending), self.mesh).cpu().tolist())

    def write_report(self, path):
        """One self-contained HTML report: the loss curve, a summary and the
        sample grids (reference log_html, nppc/restoration.py:803-917)."""
        from generative_audio_torch.utils.report import HTMLReport
        rep = HTMLReport(type(self).__name__)
        if self.loss_history:
            rep.add_curve("loss", {"train": self.loss_history})
        metrics = {"steps": self.state.step}
        if self.best_score is not None:
            metrics["best_benchmark"] = self.best_score
        rep.add_scalars("summary", metrics)
        try:
            with torch.no_grad():
                self._add_report_samples(rep)
        except Exception as e:  # the sample figures are best effort
            get_logger().exception("report sample grids failed")
            rep.add_scalars("samples", {"error": str(e)})
        return rep.write(path)


class ImageRestorationTrainer(_ImageTrainerBase):
    """MSE or MAE restoration training (RestorationTrainer :387-917). The
    model's wrapper trains; a trainer that builds its own model seeds its
    initial weights with config.random_seed."""

    @classmethod
    def from_checkpoint(cls, checkpoint_dir, **kwargs):
        """The model rebuilt from the checkpoint's config.json with the
        parameters of its latest (reference RestorationModel.load,
        restoration.py:218-224)."""
        from generative_audio_torch.utils.config import build_dataclass
        mgr = CheckpointManager(checkpoint_dir)
        config_dict = mgr.load_config()
        if config_dict is None:
            raise FileNotFoundError(f"no config.json in {checkpoint_dir}")
        config = build_dataclass(ImageRestorationConfig, config_dict)
        trainer = cls(config, checkpoint_dir=checkpoint_dir, **kwargs)
        restored = mgr.restore("latest")
        if restored is not None:
            trainer.state.model.load_state_dict(restored["params"])
        return trainer

    def __init__(self, config: ImageRestorationConfig,
                 model: Optional[ImageRestorationModel] = None,
                 checkpoint_dir: Optional[str] = None, seed: int = 0,
                 device=None, generator: Optional[torch.Generator] = None,
                 mesh=None):
        self.config = config
        self.model = model or _seeded(config.random_seed,
                                      lambda: ImageRestorationModel(config))
        super().__init__(checkpoint_dir, config, seed, device, generator,
                         mesh)
        self.model.to(self.device)
        wrapper = self.model.wrapper
        self.state = TrainState(wrapper, make_optimizer(
            wrapper.parameters(), config.lr, (0.9, 0.999)))
        self.net = data_parallel(wrapper, mesh)

    def loss_value(self, x_org: torch.Tensor, x_distorted: torch.Tensor,
                   net=None) -> torch.Tensor:
        """The MSE or MAE of the restored image against x_org (JAX:
        _loss_value); net: the module called in place of the wrapper (its
        DistributedDataParallel in a multi-GPU step)."""
        err = x_org - (self.model.restore(x_distorted) if net is None
                       else net(x_distorted))
        if self.config.loss_type == "mse":
            return torch.mean(torch.square(err))
        if self.config.loss_type == "mae":
            return torch.mean(torch.abs(err))
        raise ValueError(f"Unsupported loss_type: {self.config.loss_type!r}")

    def train_step(self, x_org) -> torch.Tensor:
        """One Adam update on a batch of clean images; the loss, on the
        device."""
        x_org, rows = place_rows(x_org, self.mesh)
        x_org = self._device_batch(x_org)
        with conv_tf32():
            x_distorted = self.model.distort(x_org, self.generator, rows)
            loss = self.loss_value(x_org, x_distorted, self.net)
            loss.backward()
        self.state.apply_gradients()
        return loss.detach()

    def benchmark(self, batch_size: int = 32, max_samples: int = 256) -> float:
        """The mean valid-set loss on the fixed seed-42 subset, with the
        distortions drawn from a generator seeded 42 (reference :700-730)."""
        gen = torch.Generator(device=self.device).manual_seed(42)
        losses, weights = [], []
        with torch.no_grad():
            for batch in self._batches(self.model.data_module.valid_set,
                                       batch_size, max_samples):
                x = self._device_batch(batch)
                losses.append(self.loss_value(x, self.model.distort(x, gen)))
                weights.append(len(batch))
        return float(np.average(torch.stack(losses).cpu().numpy(),
                                weights=weights))

    def restore(self, x_distorted, use_best: bool = True) -> torch.Tensor:
        """The restored images, with the best parameters where there are
        (use_best) and else the current ones."""
        x = torch.as_tensor(x_distorted, dtype=torch.float32).to(self.device)
        if use_best and self.best_params is not None:
            return torch.func.functional_call(self.state.model,
                                              self.best_params, (x,))
        return self.model.restore(x)

    def _add_report_samples(self, rep):
        """Rows of original, distorted and restored valid images (reference
        log_html's fixed batch panels)."""
        dm = self.model.data_module
        x = self._device_batch(np.stack([
            np.asarray(dm.valid_set[i]) for i in range(min(8,
                                                           len(dm.valid_set)))]))
        x_d = self.model.distort(x, torch.Generator(
            device=self.device).manual_seed(42))
        x_r = self.restore(x_d, use_best=True)
        rep.add_image_grid("original", x.cpu().numpy(), nrow=8)
        rep.add_image_grid("distorted", x_d.clamp(0, 1).cpu().numpy(), nrow=8)
        rep.add_image_grid("restored", x_r.clamp(0, 1).cpu().numpy(), nrow=8)


class ImageNPPCTrainer(_ImageTrainerBase):
    """NPPC direction training against a frozen restoration model
    (NPPCTrainer :289-871). `restoration_variables` is a state_dict of the
    restoration model's wrapper, loaded into it (None keeps its weights);
    the PC wrapper's initial weights are seeded with config.random_seed."""

    def __init__(self, config: ImageNPPCConfig,
                 restoration_model: ImageRestorationModel,
                 restoration_variables=None,
                 checkpoint_dir: Optional[str] = None, seed: int = 0,
                 device=None, generator: Optional[torch.Generator] = None,
                 mesh=None):
        self.config = config
        self.restoration_model = restoration_model
        if restoration_variables is not None:
            restoration_model.wrapper.load_state_dict(restoration_variables)
        self.model = _seeded(config.random_seed,
                             lambda: ImageNPPCModel(config, restoration_model))
        super().__init__(checkpoint_dir, config, seed, device, generator,
                         mesh)
        restoration_model.to(self.device)
        self.model.to(self.device)
        wrapper = self.model.wrapper
        self.state = TrainState(wrapper, make_optimizer(
            wrapper.parameters(), config.lr, (0.9, 0.999)))
        self.net = data_parallel(wrapper, mesh)

    def process_batch(self, x_org: torch.Tensor,
                      generator: Optional[torch.Generator],
                      global_rows=None):
        """(x_distorted, x_restored) of the frozen restoration model, without
        gradient (JAX: _process_batch); global_rows: the rows' place in the
        global batch of a multi-GPU step, for the noise."""
        with torch.no_grad():
            x_distorted = self.restoration_model.distort(x_org, generator,
                                                         global_rows)
            return x_distorted, self.restoration_model.restore(x_distorted)

    def objective(self, x_org, x_distorted, x_restored, step, net=None):
        """(objective, reconst_err [B]) of the current directions (JAX:
        _objective); net: the module called in place of the PC wrapper
        (its DistributedDataParallel in a multi-GPU step)."""
        w_mat = (self.model.get_dirs(x_distorted, x_restored) if net is None
                 else net(x_distorted, x_restored))
        reconst_err, objective, _ = nppc_objective_real(
            w_mat, x_org - x_restored, step,
            self.config.second_moment_loss_grace,
            self.config.second_moment_loss_lambda, eps=0.0)
        return objective, reconst_err

    def train_step(self, x_org) -> torch.Tensor:
        """One Adam update on a batch of clean images; the objective, on the
        device."""
        x_org, rows = place_rows(x_org, self.mesh)
        x_org = self._device_batch(x_org)
        with conv_tf32():
            x_distorted, x_restored = self.process_batch(
                x_org, self.generator, rows)
            objective, _ = self.objective(x_org, x_distorted, x_restored,
                                          self.state.step, self.net)
            objective.backward()
        self.state.apply_gradients()
        return objective.detach()

    def benchmark(self, batch_size: int = 32, max_samples: int = 256) -> float:
        """The mean reconst_err on the fixed seed-42 valid subset
        (nppc.py:561-586)."""
        gen = torch.Generator(device=self.device).manual_seed(42)
        vals, weights = [], []
        with torch.no_grad():
            for batch in self._batches(
                    self.restoration_model.data_module.valid_set, batch_size,
                    max_samples):
                x = self._device_batch(batch)
                _, reconst_err = self.objective(
                    x, *self.process_batch(x, gen), self.state.step)
                vals.append(reconst_err.mean())
                weights.append(len(batch))
        return float(np.average(torch.stack(vals).cpu().numpy(),
                                weights=weights))

    def get_dirs(self, x_distorted, x_restored) -> torch.Tensor:
        def dev(x):
            return torch.as_tensor(x, dtype=torch.float32).to(self.device)
        return self.model.get_dirs(dev(x_distorted), dev(x_restored))

    def _add_report_samples(self, rep):
        """The PC directions of one valid item, normalised to [0, 1]
        (reference nppc.py:604-745 per-direction panels)."""
        dm = self.restoration_model.data_module
        x = self._device_batch(np.asarray(dm.valid_set[0])[None])
        x_d, x_r = self.process_batch(x, torch.Generator(
            device=self.device).manual_seed(42))
        w = self.model.get_dirs(x_d, x_r)[0].cpu().numpy()
        norm = np.abs(w).max() + 1e-9
        rep.add_image_grid("pc_directions (normalized)",
                           0.5 + 0.5 * w / norm, nrow=w.shape[0])
