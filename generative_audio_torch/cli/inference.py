"""Enhancement inference CLI: noisy wav dir -> enhanced wav dir with RTF.

    python -m generative_audio_torch.cli.inference -C configs/inference.yaml \
        -M /path/to/best_model.tar -I noisy_dir -O out_dir [--device cpu]

Port of generative_audio_tpu/cli/inference.py. The model is FullSubNet+ in
bf16, configured by the config file's `model` block; its `inferencer` block
configures the Inferencer and `--mode` picks the inference mode. `-M` takes
a state-dict file (.tar, .pth or .pt: a bare state_dict, or one under
`model`, `model_state_dict` or `state_dict`, as the reference saves them;
the port's modules use the reference's key names, so it loads as it is), or
a directory of `train.checkpoint.CheckpointManager`, whose `best` and then
`latest` checkpoint is restored. `--device` is `cuda` (default; raises
without a CUDA device) or `cpu`.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch
from torch import nn

from generative_audio_torch.utils.config import build_dataclass, load_config_file
from generative_audio_torch.utils.logging import get_logger

__all__ = ["load_model_state", "main"]

_STATE_DICT_SUFFIXES = (".tar", ".pth", ".pt")
_WRAPPER_KEYS = ("model", "model_state_dict", "state_dict")


def load_model_state(checkpoint_path, model: nn.Module) -> None:
    """Load a state-dict file or a CheckpointManager directory into `model`
    (strict: every key of the model and no other)."""
    path = Path(checkpoint_path)
    if path.suffix in _STATE_DICT_SUFFIXES:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for key in _WRAPPER_KEYS:
            if isinstance(sd.get(key), dict):
                sd = sd[key]
                break
        model.load_state_dict(sd, strict=True)
        return
    if path.is_dir():
        from generative_audio_torch.train import CheckpointManager
        mgr = CheckpointManager(path)
        for name in ("best", "latest"):
            tree = mgr.restore(name)
            if tree is not None:
                model.load_state_dict(tree["params"], strict=True)
                return
    raise FileNotFoundError(f"No checkpoint found under {path}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="generative_audio_torch inference")
    parser.add_argument("-C", "--configuration", default=None)
    parser.add_argument("-M", "--model_checkpoint_path", required=True)
    parser.add_argument("-I", "--dataset_dir_name", required=True)
    parser.add_argument("-O", "--output_dir", required=True)
    parser.add_argument("--mode", default="mag_complex_full_band_crm_mask")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from generative_audio_torch.data import InferenceDataset
    from generative_audio_torch.eval import Inferencer, InferencerConfig
    from generative_audio_torch.models import (
        FullSubNetPlus, FullSubNetPlusConfig)

    raw = load_config_file(args.configuration) if args.configuration else {}
    model_cfg = build_dataclass(FullSubNetPlusConfig, raw.get("model"))
    model = FullSubNetPlus(model_cfg, compute_dtype=torch.bfloat16,
                           device=args.device)
    load_model_state(args.model_checkpoint_path, model)

    inf_cfg = build_dataclass(InferencerConfig, raw.get("inferencer"))
    inf_cfg.inference_type = args.mode
    inferencer = Inferencer(model, inf_cfg, device=args.device)
    dataset = InferenceDataset(args.dataset_dir_name, sr=inf_cfg.sr)
    log = get_logger().info
    log(f"Enhancing {len(dataset)} clips -> {args.output_dir}")
    inferencer.enhance_dir(dataset, args.output_dir, log=log)


if __name__ == "__main__":
    main()
