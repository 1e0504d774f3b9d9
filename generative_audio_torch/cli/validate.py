"""Pretrained-model validation CLI: the reference's recorded baseline pipeline
(use_pre_trained_model/model_validator/validate_pre_trained_model.py):
AudioDataset's on-the-fly mixing -> enhance -> metrics ->
validation_results.json.

    python -m generative_audio_torch.cli.validate -C config.{json,toml,yaml} \
        -M model.pth|checkpoint_dir [-O validation_results.json] \
        [--max_items N] [--device cpu]

Port of generative_audio_tpu/cli/validate.py. The config's `model` block
configures FullSubNet+ (bf16), `data` the AudioDataset (seed 0) and `stft`
the validator's STFT (nfft, hop_length, win_length). `-M` takes the weights
as cli/inference.py does: a reference-format state-dict file or a
CheckpointManager directory (`best`, then `latest`). `--device` is `cuda`
(default; raises without a CUDA device) or `cpu`.
"""
from __future__ import annotations

import argparse

import torch

from generative_audio_torch.utils.config import (
    build_dataclass, load_config_file)
from generative_audio_torch.utils.logging import get_logger

__all__ = ["main"]


def main(argv=None):
    """Run the CLI; returns the mean metrics it wrote."""
    parser = argparse.ArgumentParser(
        description="generative_audio_torch validate")
    parser.add_argument("-C", "--configuration", required=True)
    parser.add_argument("-M", "--model_checkpoint_path", required=True)
    parser.add_argument("-O", "--output", default="validation_results.json")
    parser.add_argument("--max_items", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    raw = load_config_file(args.configuration)
    from generative_audio_torch.cli.inference import load_model_state
    from generative_audio_torch.data import AudioDataSetConfig, AudioDataset
    from generative_audio_torch.eval.validator import ModelValidator
    from generative_audio_torch.models import (
        FullSubNetPlus, FullSubNetPlusConfig)

    model_cfg = build_dataclass(FullSubNetPlusConfig, raw.get("model"))
    model = FullSubNetPlus(model_cfg, compute_dtype=torch.bfloat16,
                           device=args.device)
    load_model_state(args.model_checkpoint_path, model)

    dataset = AudioDataset(
        build_dataclass(AudioDataSetConfig, raw["data"]), seed=0)
    stft_cfg = raw.get("stft", {})
    validator = ModelValidator(
        model, n_fft=stft_cfg.get("nfft", 512),
        hop_length=stft_cfg.get("hop_length", 256),
        win_length=stft_cfg.get("win_length", 512), device=args.device)
    log = get_logger().info
    means = validator.validate_dataset(dataset, output_path=args.output,
                                       max_items=args.max_items, log=log)
    log(f"Validation means: {means}")
    return means


if __name__ == "__main__":
    main()
