"""Training entry point.

    python -m generative_audio_torch.cli.train -C config.{json,toml,yaml} \
        [-R] [--steps N] [--epochs N] [--device cpu] [--distributed]

Port of generative_audio_tpu/cli/train.py. The config's `line` picks the
model line; the port trains all six. The `enhance` line (FullSubNet+ or
FullSubNet v1, `train:` is the EnhanceTrainConfig) is wired as the JAX CLI
wires it:
DNSTrainDataset when `data:` names a `clean_dataset` scp (the DNS regime),
else AudioDataset over clean and noise directories; BatchLoader with
`dataloader:` (global_batch_size 18 by default); EnhanceTrainer writing
to `checkpoint_dir`; `-R` resumes from its latest checkpoint; the optional
`validation:` block (val_dir, probe_dir, validation_interval, probe_weight)
turns on in-loop validation and best-model selection. The dataset is
seeded with the loader's `seed` (default 0), so a run is repeatable.
The `nppc_denoising` line (`train:` is the NPPCDenoisingTrainConfig) trains
uncertainty directions over a frozen FullSubNet+ on AudioDataset batches
(global_batch_size 8 by default); as in the JAX CLI, no enhancer checkpoint
is loaded, so the frozen enhancer keeps its seeded init. A `train.n_dirs`
key sets `model.pc_wrapper.n_directions`, the intent of
configs/denoising_nppc.yaml, which the JAX CLI refuses as an unknown key.
The line takes no `validation:` block (a ValueError).
The `restoration` line (`train:` is the RestorationTrainConfig) trains the
inpainting UNet on AudioInpaintingDataset batches (`data:` is the
AudioInpaintingConfig; collate_inpainting; global_batch_size 16 by default);
an optional `validation:` block is a second AudioInpaintingConfig, validated
at each log point, whose minimum keeps best/. The `nppc_inpainting` line
(`train:` is the NPPCInpaintingTrainConfig) trains the PC UNet over the
restoration UNet of `pretrained_restoration_checkpoint`, a checkpoint
directory of the restoration line: its best/ where there is one, else its
latest/ (the JAX CLI takes latest/, though the restoration trainer keeps
best/ for the NPPC head); a named directory with neither raises, where the
JAX CLI trains over a random UNet without a word. Without the key the
frozen UNet keeps its seeded init, as in the JAX CLI. The line takes no
`validation:` block (a ValueError). The inpainting datasets draw from the
loader's `seed` where `data.seed` is not set.
The image lines take no `data:`, `dataloader:` or `validation:` block (a
ValueError; the JAX CLI ignores them): their trainers own the data module,
as in the JAX CLI (make_data_module of
`train.dataset`, synthetic digits for mnist, since no data folder is
passed), and `run:` gives n_steps (1000 by default), batch_size (32) and
benchmark_every. The `image_restoration` line (`train:` is the
ImageRestorationConfig) trains ImageRestorationTrainer; the `image_nppc`
line (`train:` is the ImageNPPCConfig, `restoration:` the
ImageRestorationConfig of the frozen model) trains ImageNPPCTrainer over the
latest/ of `restoration_checkpoint`, as the JAX CLI does; a named directory
without latest.pt raises, where the JAX CLI trains over a random restoration
net without a word. Without the key the frozen net keeps its seeded init.
The image lines do not resume: `-R` raises for them (the JAX CLI ignores it).
`--epochs` (default 1) counts passes over the loader; `--steps N` makes each
epoch N steps, looping the loader (LoopIterator); for the image lines it is
the number of steps. `--device` is `cuda` (default; raises without a CUDA
device) or `cpu`.

Multi-GPU training, as the JAX CLI does it: under cli/launch.py (the
GAT_* environment) every line runs as one rank of the job without a flag;
`--distributed` takes the job from torchrun's environment instead (a
RuntimeError names the variables it lacks). Each rank takes its card
(parallel.distributed.local_device: cuda:LOCAL_RANK in an NCCL job; the CPU
with --device cpu, over gloo), loads its contiguous rows of every global
batch (BatchLoader's host_id and num_hosts, DistributedBatches) and trains
under DistributedDataParallel over a parallel.make_mesh(); the image lines
draw the same batches on every rank and take their rows. Validation sets
are not split: every rank validates and rank 0's score decides. Rank 0
alone logs and writes checkpoints and reports; -R resumes every rank from
rank 0's state.

    python -m generative_audio_torch.cli.launch --nprocs 2 --backend gloo \
        -- python -m generative_audio_torch.cli.train -C cfg.yaml --device cpu
    torchrun --nproc-per-node 4 -m generative_audio_torch.cli.train \
        -C cfg.yaml --distributed
"""
from __future__ import annotations

import argparse
from pathlib import Path

from generative_audio_torch.utils.config import (
    build_dataclass, load_config_file)
from generative_audio_torch.utils.logging import get_logger

__all__ = ["main", "nppc_denoising_config", "restoration_checkpoint"]


def nppc_denoising_config(train):
    """The `train:` block of an nppc_denoising config -> the
    NPPCDenoisingTrainConfig. `n_dirs` sets model.pc_wrapper.n_directions (a
    ValueError where both are given and differ); every other key builds as
    strictly as build_dataclass does."""
    from generative_audio_torch.train import NPPCDenoisingTrainConfig
    train = dict(train or {})
    if "n_dirs" in train:
        n_dirs = train.pop("n_dirs")
        model = dict(train.get("model") or {})
        head = dict(model.get("pc_wrapper") or {})
        if head.setdefault("n_directions", n_dirs) != n_dirs:
            raise ValueError(
                f"train.n_dirs = {n_dirs} but train.model.pc_wrapper."
                f"n_directions = {head['n_directions']}")
        train["model"] = {**model, "pc_wrapper": head}
    return build_dataclass(NPPCDenoisingTrainConfig, train)


def _loader(dataset, loader_cfg, steps, mesh=None):
    """The BatchLoader (this rank's rows of each batch under a mesh),
    looped for `steps` steps an epoch where given."""
    from generative_audio_torch.data import BatchLoader, LoopIterator
    from generative_audio_torch.parallel import distributed as D
    if mesh is not None:
        loader_cfg = {**loader_cfg, "host_id": D.process_index(),
                      "num_hosts": D.process_count()}
    loader = BatchLoader(dataset, **loader_cfg)
    if steps is not None:
        loader = LoopIterator(loader, n_steps=steps)
    return loader if mesh is None else D.DistributedBatches(loader, mesh)


def _train_enhance(args, raw, data_cfg, loader_cfg, checkpoint_dir, device,
                   log, mesh):
    from generative_audio_torch.data import (
        AudioDataSetConfig, AudioDataset, DNSTrainConfig, DNSTrainDataset,
        DNSValidationDataset)
    from generative_audio_torch.train import EnhanceTrainConfig, EnhanceTrainer
    seed = loader_cfg.get("seed", 0)
    if "clean_dataset" in data_cfg:         # DNS scp regime
        dataset = DNSTrainDataset(build_dataclass(DNSTrainConfig, data_cfg),
                                  seed=seed)
    else:
        dataset = AudioDataset(build_dataclass(AudioDataSetConfig, data_cfg),
                               seed=seed)
    loader = _loader(dataset, loader_cfg, args.steps, mesh)
    trainer = EnhanceTrainer(
        build_dataclass(EnhanceTrainConfig, raw.get("train")),
        checkpoint_dir=checkpoint_dir, device=device, mesh=mesh)
    if args.resume:
        trainer.restore_latest()
    val_cfg = raw.get("validation")
    val_ds = probe_ds = None
    val_interval, probe_weight = 1, 0.0
    if val_cfg:
        sr = int(data_cfg.get("sr", 16000))
        if val_cfg.get("val_dir"):
            val_ds = DNSValidationDataset([val_cfg["val_dir"]], sr=sr)
        if val_cfg.get("probe_dir"):
            probe_ds = DNSValidationDataset([val_cfg["probe_dir"]], sr=sr)
        val_interval = int(val_cfg.get("validation_interval", 1))
        probe_weight = float(val_cfg.get("probe_weight", 0.0))
    trainer.train(loader, epochs=args.epochs or 1, log=log,
                  val_dataset=val_ds, validation_interval=val_interval,
                  probe_dataset=probe_ds, probe_weight=probe_weight)
    return trainer


def _train_nppc_denoising(args, raw, data_cfg, loader_cfg, checkpoint_dir,
                          device, log, mesh):
    from generative_audio_torch.data import AudioDataSetConfig, AudioDataset
    from generative_audio_torch.train import NPPCDenoisingTrainer
    if raw.get("validation"):
        raise ValueError("the nppc_denoising line takes no validation: block")
    dataset = AudioDataset(build_dataclass(AudioDataSetConfig, data_cfg),
                           seed=loader_cfg.get("seed", 0))
    loader = _loader(dataset, loader_cfg, args.steps, mesh)
    trainer = NPPCDenoisingTrainer(nppc_denoising_config(raw.get("train")),
                                   checkpoint_dir=checkpoint_dir,
                                   device=device, mesh=mesh)
    if args.resume:
        trainer.restore_latest()
    trainer.train(loader, n_epochs=args.epochs or 1, log=log)
    return trainer


def _inpainting_loader(data_cfg, loader_cfg, steps, mesh=None):
    from generative_audio_torch.data import (
        AudioInpaintingConfig, AudioInpaintingDataset, collate_inpainting)
    dataset = AudioInpaintingDataset(
        build_dataclass(AudioInpaintingConfig, data_cfg),
        seed=loader_cfg.get("seed", 0))
    return _loader(dataset, {**loader_cfg, "collate_fn": collate_inpainting},
                   steps, mesh)


def _train_restoration(args, raw, data_cfg, loader_cfg, checkpoint_dir,
                       device, log, mesh):
    from generative_audio_torch.train import (
        RestorationTrainConfig, RestorationTrainer)
    loader = _inpainting_loader(data_cfg, loader_cfg, args.steps, mesh)
    trainer = RestorationTrainer(
        build_dataclass(RestorationTrainConfig, raw.get("train")),
        checkpoint_dir=checkpoint_dir, device=device, mesh=mesh)
    if args.resume:
        trainer.restore_latest()
    val_cfg = raw.get("validation")
    # not split over the ranks: each validates it whole
    val_loader = (_inpainting_loader(val_cfg, loader_cfg, None) if val_cfg
                  else None)
    trainer.train(loader, n_epochs=args.epochs or 1, val_loader=val_loader,
                  log=log)
    return trainer


def restoration_checkpoint(directory):
    """(the restoration UNet's state_dict, "best" or "latest") from a
    checkpoint directory of the restoration line: best/ where there is one,
    else latest/; FileNotFoundError where it holds neither."""
    from generative_audio_torch.train import CheckpointManager
    if Path(directory).is_dir():
        ckpt = CheckpointManager(directory)
        for name in ("best", "latest"):
            tree = ckpt.restore(name)
            if tree is not None:
                return tree["params"], name
    raise FileNotFoundError(
        f"pretrained_restoration_checkpoint {directory} holds no best.pt or "
        f"latest.pt")


def _train_nppc_inpainting(args, raw, data_cfg, loader_cfg, checkpoint_dir,
                           device, log, mesh):
    from generative_audio_torch.train import (
        NPPCInpaintingTrainConfig, NPPCInpaintingTrainer)
    if raw.get("validation"):
        raise ValueError("the nppc_inpainting line takes no validation: block")
    restoration = None
    if raw.get("pretrained_restoration_checkpoint"):
        restoration, name = restoration_checkpoint(
            raw["pretrained_restoration_checkpoint"])
        log(f"frozen restoration UNet: {name} of "
            f"{raw['pretrained_restoration_checkpoint']}")
    loader = _inpainting_loader(data_cfg, loader_cfg, args.steps, mesh)
    trainer = NPPCInpaintingTrainer(
        build_dataclass(NPPCInpaintingTrainConfig, raw.get("train")),
        restoration_variables=restoration, checkpoint_dir=checkpoint_dir,
        device=device, mesh=mesh)
    if args.resume:
        trainer.restore_latest()
    trainer.train(loader, n_epochs=args.epochs or 1, log=log)
    return trainer


def _run_image(args, raw, trainer, log):
    if args.resume:
        raise ValueError("the image lines do not resume (-R)")
    run = raw.get("run", {})
    trainer.train(n_steps=args.steps or run.get("n_steps", 1000),
                  batch_size=run.get("batch_size", 32),
                  benchmark_every=run.get("benchmark_every"), log=log)
    return trainer


def _train_image_restoration(args, raw, data_cfg, loader_cfg, checkpoint_dir,
                             device, log, mesh):
    from generative_audio_torch.models import ImageRestorationConfig
    from generative_audio_torch.train import ImageRestorationTrainer
    cfg = build_dataclass(ImageRestorationConfig, raw.get("train"))
    return _run_image(args, raw, ImageRestorationTrainer(
        cfg, checkpoint_dir=checkpoint_dir, device=device, mesh=mesh), log)


def _train_image_nppc(args, raw, data_cfg, loader_cfg, checkpoint_dir,
                      device, log, mesh):
    import torch
    from generative_audio_torch.models import (
        ImageNPPCConfig, ImageRestorationConfig, ImageRestorationModel)
    from generative_audio_torch.train import (
        CheckpointManager, ImageNPPCTrainer)
    rest_cfg = build_dataclass(ImageRestorationConfig, raw.get("restoration"))
    # the JAX CLI initialises the frozen net from PRNGKey(0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        rest_model = ImageRestorationModel(rest_cfg)
    rest_vars = None
    rest_ckpt = raw.get("restoration_checkpoint")
    if rest_ckpt:
        tree = (CheckpointManager(rest_ckpt).restore("latest")
                if Path(rest_ckpt).is_dir() else None)
        if tree is None:
            raise FileNotFoundError(
                f"restoration_checkpoint {rest_ckpt} holds no latest.pt")
        rest_vars = tree["params"]
        log(f"frozen restoration net: latest of {rest_ckpt}")
    trainer = ImageNPPCTrainer(
        build_dataclass(ImageNPPCConfig, raw.get("train")), rest_model,
        rest_vars, checkpoint_dir=checkpoint_dir, device=device, mesh=mesh)
    return _run_image(args, raw, trainer, log)


# each line: (its run, the loader's default global_batch_size; None for
# the image lines, which take no loader)
_LINES = {"enhance": (_train_enhance, 18),
          "nppc_denoising": (_train_nppc_denoising, 8),
          "restoration": (_train_restoration, 16),
          "nppc_inpainting": (_train_nppc_inpainting, 16),
          "image_restoration": (_train_image_restoration, None),
          "image_nppc": (_train_image_nppc, None)}


def main(argv=None):
    """Run the CLI; returns the trainer after its last epoch."""
    parser = argparse.ArgumentParser(
        description="generative_audio_torch train")
    parser.add_argument("-C", "--configuration", required=True)
    parser.add_argument("-R", "--resume", action="store_true",
                        help="resume from the latest checkpoint")
    parser.add_argument("--steps", type=int, default=None,
                        help="steps per epoch (default: one pass over the "
                             "loader)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--distributed", action="store_true",
                        help="multi-GPU training under torchrun: the job "
                             "from its env:// variables (cli.launch's "
                             "GAT_* environment needs no flag)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    raw = load_config_file(args.configuration)
    line = raw.pop("line")
    if line not in _LINES:
        raise ValueError(f"Unknown training line {line!r}")
    run, batch_size = _LINES[line]
    checkpoint_dir = raw.pop("checkpoint_dir", "checkpoints")
    if batch_size is None:      # the image lines own their data
        extra = sorted({"data", "dataloader", "validation"} & set(raw))
        if extra:
            raise ValueError(f"the {line} line takes no {', '.join(extra)} "
                             f"block: its trainer owns the data module")
        data_cfg, loader_cfg = None, None
    else:
        data_cfg = raw.pop("data")
        loader_cfg = {"global_batch_size": batch_size,
                      **raw.pop("dataloader", {})}

    from generative_audio_torch.parallel import distributed as D
    log = get_logger().info
    mesh = None
    distributed = D.initialize(
        auto=args.distributed,
        backend="gloo" if args.device == "cpu" else None)
    device = D.local_device(args.device)
    if distributed:
        from generative_audio_torch.parallel import make_mesh
        mesh = make_mesh(device_type=device.type)
        log(f"distributed: rank {D.process_index()} of "
            f"{D.process_count()} on {device}")
        if not D.is_coordinator():
            log = lambda *a, **k: None  # noqa: E731
    return run(args, raw, data_cfg, loader_cfg, checkpoint_dir, device, log,
               mesh)


if __name__ == "__main__":
    main()
