"""Audio-inpainting NPPC on synthetic spectrograms, on the port: the
restoration UNet, then the PC directions over it, then their principal
angles against the MC-dropout + PCA baseline.

    python3 -m generative_audio_torch.examples.nppc_inpainting_demo \
        [--steps 20] [--device cpu]

Port of examples/nppc_inpainting_demo.py (no scan kernel on this line).
Runs on the card unless given --device cpu.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch


def synthetic_batch(rng, b=4, f=32, t=64):
    """Harmonic-stack spectrograms [b, 2, f, t] with a masked gap of 16
    frames: (masked, frame mask [b, t], clean)."""
    freqs = np.arange(f)[None, :, None]
    times = np.arange(t)[None, None, :]
    base = np.sin(2 * np.pi * freqs * 0.11 + 0.3 * times) \
        + 0.3 * rng.standard_normal((b, f, t))
    spec = np.stack([base, 0.5 * base], axis=1).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[:, 24:40] = 0.0
    masked = spec * mask[:, None, None, :]
    return masked, mask, spec


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from generative_audio_torch.eval import (
        NPPCValidator, NPPCValidatorConfig)
    from generative_audio_torch.models import (
        AudioInpaintingPCWrapperConfig, InpaintingNPPCConfig, UNetModelConfig)
    from generative_audio_torch.ops.preprocess import preprocess_data
    from generative_audio_torch.train import (
        NPPCInpaintingTrainConfig, NPPCInpaintingTrainer,
        RestorationTrainConfig, RestorationTrainer)

    rng = np.random.default_rng(0)
    batch = synthetic_batch(rng)

    print("== restoration (masked MSE) ==")
    rcfg = RestorationTrainConfig(
        model=UNetModelConfig(in_channels=1, out_channels=1, dropout=0.2),
        num_freqs=32, num_frames=64, log_interval=10)
    rtrainer = RestorationTrainer(rcfg, device=args.device)
    rtrainer.train([batch], n_steps=args.steps, log=print)

    print("== NPPC (PC directions over the frozen restoration) ==")
    ncfg = NPPCInpaintingTrainConfig(
        model=InpaintingNPPCConfig(
            restoration=UNetModelConfig(1, 1, 0.2),
            pc_wrapper=AudioInpaintingPCWrapperConfig(
                in_channels=2, out_channels=3, n_dirs=3)),
        num_freqs=32, num_frames=64, second_moment_loss_grace=10,
        log_interval=10)
    ntrainer = NPPCInpaintingTrainer(
        ncfg, restoration_variables=rtrainer.state.model.state_dict(),
        device=args.device)
    ntrainer.train([batch], n_steps=args.steps, log=print)

    print("== validation: principal angles vs MC-dropout PCA baseline ==")
    model = ntrainer.state.model.eval()

    def restoration(x, m, generator=None):
        # with generators: the MC-dropout passes (dropout on)
        return (model.get_pred_spec_mag_norm(x, m) if generator is None
                else model.mc_restoration(x, m, generator))

    masked, mask, clean = (torch.from_numpy(a) for a in batch)
    clean_norm, mask4, masked_norm = preprocess_data(clean, masked, mask)
    with tempfile.TemporaryDirectory() as out:
        validator = NPPCValidator(
            model, restoration,
            NPPCValidatorConfig(save_dir=out, n_mc_samples=8, n_components=3),
            device=args.device)
        report = validator.validate_sample(
            masked_norm[:1], mask4[:1], clean_norm[:1], stats=(0.0, 1.0),
            make_plots=False)
    for key, value in report.items():
        if isinstance(value, dict):
            value = {k: round(float(v), 4) for k, v in value.items()}
            print(f"  {key}: {value}")
        elif isinstance(value, (int, float)):
            print(f"  {key}: {value:.4f}")
        elif isinstance(value, (list, np.ndarray)):
            print(f"  {key}: {np.round(np.asarray(value, float), 3)}")
    return report


if __name__ == "__main__":
    main()
