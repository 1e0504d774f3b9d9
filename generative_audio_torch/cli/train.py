"""Training entry point.

    python -m generative_audio_torch.cli.train -C config.{json,toml,yaml} \
        [-R] [--steps N] [--epochs N] [--device cpu]

Port of generative_audio_tpu/cli/train.py. The config's `line` picks the
model line; the port trains the `enhance` line (FullSubNet+ or FullSubNet
v1, `train:` is the EnhanceTrainConfig), wired as the JAX CLI wires it:
DNSTrainDataset when `data:` names a `clean_dataset` scp (the DNS regime),
else AudioDataset over clean and noise directories; BatchLoader with
`dataloader:` (global_batch_size 18 by default); EnhanceTrainer writing
to `checkpoint_dir`; `-R` resumes from its latest checkpoint; the optional
`validation:` block (val_dir, probe_dir, validation_interval, probe_weight)
turns on in-loop validation and best-model selection. The dataset is
seeded with the loader's `seed` (default 0), so a run is repeatable.
`--epochs` (default 1) counts passes over the loader; `--steps N` makes each
epoch N steps, looping the loader (LoopIterator). `--device` is `cuda`
(default; raises without a CUDA device) or `cpu`.

The other lines (restoration, nppc_inpainting, nppc_denoising,
image_restoration, image_nppc) and `--distributed` raise
NotImplementedError until their slices are ported (ROADMAP.md, queue A
items 6-9).
"""
from __future__ import annotations

import argparse

from generative_audio_torch.utils.config import (
    build_dataclass, load_config_file)
from generative_audio_torch.utils.logging import get_logger

__all__ = ["main"]

# the JAX CLI's other lines, and the item of ROADMAP.md's queue A that
# ports each
_UNPORTED_LINES = {"restoration": 8, "nppc_inpainting": 8,
                   "nppc_denoising": 7, "image_restoration": 9,
                   "image_nppc": 9}


def main(argv=None):
    """Run the CLI; returns the EnhanceTrainer after its last epoch."""
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
                        help="multi-GPU training (not ported yet)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            "--distributed: multi-GPU training is not ported yet "
            "(ROADMAP.md, queue A item 6)")

    raw = load_config_file(args.configuration)
    line = raw.pop("line")
    if line in _UNPORTED_LINES:
        raise NotImplementedError(
            f"training line {line!r} is not ported yet (ROADMAP.md, queue A "
            f"item {_UNPORTED_LINES[line]})")
    if line != "enhance":
        raise ValueError(f"Unknown training line {line!r}")
    checkpoint_dir = raw.pop("checkpoint_dir", "checkpoints")
    data_cfg = raw.pop("data")
    loader_cfg = {"global_batch_size": 18, **raw.pop("dataloader", {})}
    val_cfg = raw.pop("validation", None)
    log = get_logger().info

    from generative_audio_torch.data import (
        AudioDataSetConfig, AudioDataset, BatchLoader, DNSTrainConfig,
        DNSTrainDataset, LoopIterator)
    from generative_audio_torch.train import (
        EnhanceTrainConfig, EnhanceTrainer)
    from generative_audio_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    cfg = build_dataclass(EnhanceTrainConfig, raw.get("train"))
    seed = loader_cfg.get("seed", 0)
    if "clean_dataset" in data_cfg:         # DNS scp regime
        dataset = DNSTrainDataset(build_dataclass(DNSTrainConfig, data_cfg),
                                  seed=seed)
    else:
        dataset = AudioDataset(build_dataclass(AudioDataSetConfig, data_cfg),
                               seed=seed)
    loader = BatchLoader(dataset, **loader_cfg)
    if args.steps is not None:
        loader = LoopIterator(loader, n_steps=args.steps)
    trainer = EnhanceTrainer(cfg, checkpoint_dir=checkpoint_dir,
                             device=device)
    if args.resume:
        trainer.restore_latest()
    val_ds = probe_ds = None
    val_interval, probe_weight = 1, 0.0
    if val_cfg:
        from generative_audio_torch.data import DNSValidationDataset
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


if __name__ == "__main__":
    main()
