"""Enhancement on synthetic audio, end to end on the port, no external data.

    python3 -m generative_audio_torch.examples.enhance_demo [--steps 30] \
        [--device cpu]

1. synthesizes a tiny (clean, noise) corpus,
2. trains a small FullSubNet+ in float32 (on the card: the recurrent layers'
   bf16 gates into the scan kernels with float32 output, the rest in
   float32) for a few steps on DNS-style dynamic mixing,
3. enhances a held-out noisy clip through the Inferencer and prints SI-SDR
   and STOI before and after.

Port of examples/enhance_demo.py. Runs on the card unless given
--device cpu.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np


def make_corpus(root: Path, sr: int = 16000, n: int = 6) -> None:
    """n harmonic 3 s clips under root/clean and n noise clips under
    root/noise."""
    from generative_audio_torch.data import write_wav
    rng = np.random.default_rng(0)
    (root / "clean").mkdir(parents=True)
    (root / "noise").mkdir(parents=True)
    t = np.arange(sr * 3)
    for i in range(n):
        f0 = 110 * (i + 2)
        speechish = sum(np.sin(2 * np.pi * f0 * k * t / sr) / k
                        for k in range(1, 5))
        env = 0.5 * (1 + np.sin(2 * np.pi * 1.7 * t / sr + i))
        write_wav(root / "clean" / f"c{i}.wav",
                  (0.25 * speechish * env / np.abs(speechish).max())
                  .astype(np.float32), sr)
        write_wav(root / "noise" / f"n{i}.wav",
                  (0.2 * rng.standard_normal(len(t))).astype(np.float32), sr)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from generative_audio_torch.data import (
        AudioDataSetConfig, AudioDataset, BatchLoader)
    from generative_audio_torch.eval import (
        SI_SDR, STOI, Inferencer, InferencerConfig)
    from generative_audio_torch.models import FullSubNetPlusConfig
    from generative_audio_torch.train import (
        EnhanceTrainConfig, EnhanceTrainer)
    from generative_audio_torch.utils.auxil import LoopLoader

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        make_corpus(root)

        cfg = EnhanceTrainConfig(
            model=FullSubNetPlusConfig(
                num_freqs=65, sb_num_neighbors=3, fb_model_hidden_size=64,
                sb_model_hidden_size=32, num_groups_in_drop_band=1),
            n_fft=128, hop_length=64, win_length=128,
            compute_dtype="float32", learning_rate=5e-4)
        dataset = AudioDataset(AudioDataSetConfig(
            clean_path=str(root / "clean"), noisy_path=str(root / "noise"),
            sub_sample_length_seconds=1.0, snr_range=(0, 5)), seed=0)
        loader = BatchLoader(dataset, global_batch_size=4, num_workers=2)
        trainer = EnhanceTrainer(cfg, device=args.device)
        losses = []
        for i, (noisy, clean) in enumerate(
                LoopLoader(loader, n_steps=args.steps)):
            trainer.state, loss = trainer._step_fn(trainer.state, noisy,
                                                   clean)
            losses.append(loss)
            if (i + 1) % 10 == 0 or i + 1 == args.steps:
                print(f"step {i + 1}: loss={float(loss):.5f}")

        # held-out clip
        noisy, clean = dataset[0]
        inf = Inferencer(trainer.state.model,
                         InferencerConfig(n_fft=128, hop_length=64,
                                          win_length=128, length_bucket=4000),
                         device=args.device)
        enhanced = inf.enhance(noisy)
        scores = {"SI-SDR noisy": SI_SDR(clean, noisy),
                  "SI-SDR enhanced": SI_SDR(clean, enhanced),
                  "STOI noisy": STOI(clean, noisy),
                  "STOI enhanced": STOI(clean, enhanced)}
        for name, value in scores.items():
            unit = " dB" if name.startswith("SI-SDR") else ""
            print(f"{name:<16}: {value:6.3f}{unit}")
        return {"losses": [float(v) for v in losses], **scores}


if __name__ == "__main__":
    main()
