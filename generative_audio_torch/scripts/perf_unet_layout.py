"""The inpainting UNets' two design choices on the card, against the
designs they replaced: channels-last activations against NCHW, and MC
passes whose convolutions run pass by pass against passes batched together.

    # on one CUDA card (the UNets at full width, seeded weights)
    python -m generative_audio_torch.scripts.perf_unet_layout

At configs/inpainting_*.yaml's width (128 x 256, UNets 64 -> 512, TF32
convolutions) it times a RestorationTrainer step and an
NPPCInpaintingTrainer base step at batch 128 (median of 4 after one
warm-up step, synchronised), and 50 MC-dropout passes at batch 16, 5 a
forward, in rounds that alternate the port's design and the replaced one
(nn.unet._layout keeping NCHW; nn.unet._conv convolving a chunk's stacked
passes at once). Then, for each MC design, the largest difference between
the passes at 5 a forward and all 50 in one forward. The replaced designs
are measurements, not paths of the package.
"""
from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
from unittest import mock

import numpy as np
import torch

from generative_audio_torch.eval import mc_dropout
from generative_audio_torch.models import InpaintingNPPCConfig
from generative_audio_torch.nn import unet
from generative_audio_torch.ops.preprocess import preprocess_data
from generative_audio_torch.train import (
    NPPCInpaintingTrainConfig, NPPCInpaintingTrainer, RestorationTrainConfig,
    RestorationTrainer)
from generative_audio_torch.utils import convert
from generative_audio_torch.utils.device import conv_tf32, resolve_device

__all__ = ["main"]

SEED, F_, T_, BATCH, MC_BATCH, N_MC = 0, 128, 256, 128, 16, 50
ROUNDS, STEPS = 2, 4


@contextlib.contextmanager
def nchw():
    """The UNets' activations NCHW on the card (the design before
    channels-last)."""
    with mock.patch.object(unet, "_layout", lambda x: x.contiguous()):
        yield


@contextlib.contextmanager
def stacked():
    """Each convolution over a chunk's stacked passes at once (the design
    before the pass-by-pass convolutions)."""
    with mock.patch.object(unet, "_conv",
                           lambda conv, x, parts: unet._layout(conv(x))):
        yield


def _batch(batch):
    rng = np.random.default_rng(SEED)
    clean = rng.standard_normal((batch, 2, F_, T_), np.float32)
    mask = np.ones((batch, T_), np.float32)
    mask[:, 100:118] = 0
    return clean * mask[:, None, None, :], mask, clean


def _median_ms(step):
    step()
    ms = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def _mc(model, batch, dev, chunk):
    _, mask, masked = preprocess_data(*(torch.from_numpy(x).to(dev)
                                        for x in (batch[2], batch[0],
                                                  batch[1])))
    with torch.no_grad(), conv_tf32(True):
        return mc_dropout.mc_dropout_inference(
            model.mc_restoration, masked, mask,
            mc_dropout.mc_generators(SEED, N_MC, dev), chunk_size=chunk)


def main():
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    params = convert.random_inpainting_nppc_params(InpaintingNPPCConfig(),
                                                   seed=SEED)
    sd = convert.convert_inpainting_nppc(params)
    rest_sd = {k[len("pretrained_restoration_model."):]: v
               for k, v in sd.items()
               if k.startswith("pretrained_restoration_model.")}
    rest = RestorationTrainer(RestorationTrainConfig(), seed=SEED, device=dev)
    rest.state.model.load_state_dict(rest_sd)
    nppc = NPPCInpaintingTrainer(NPPCInpaintingTrainConfig(),
                                 restoration_variables=rest_sd, seed=SEED,
                                 device=dev)
    nppc.state.model.load_state_dict(sd)
    batch, mc_batch = _batch(BATCH), _batch(MC_BATCH)
    readings = {}
    for _ in range(ROUNDS):
        for name, design in (("channels-last", contextlib.nullcontext),
                             ("NCHW", nchw)):
            with design():
                for what, step in (
                        ("restoration step", lambda: rest.train_step(batch)),
                        ("nppc base step", lambda: nppc.train_step(batch)),
                        (f"{N_MC} MC passes",
                         lambda: _mc(nppc.state.model, mc_batch, dev, 5))):
                    readings.setdefault((what, name), []).append(
                        _median_ms(step))
    for (what, name), ms in readings.items():
        print(f"{what}, {name}: {' '.join(f'{m:.2f}' for m in ms)} ms "
              f"(rounds), on {card}", flush=True)
    for name, design in (("pass by pass", contextlib.nullcontext),
                         ("stacked", stacked)):
        with design():
            a = _mc(nppc.state.model, mc_batch, dev, 5)
            b = _mc(nppc.state.model, mc_batch, dev, 0)
        diff = (a - b).abs().max().item()
        print(f"MC passes {name}: 5 a forward vs {N_MC} in one, max|diff| "
              f"{diff:.3e} ({diff / b.abs().max().item():.3e} of the peak), "
              f"equal: {torch.equal(a, b)}, on {card}", flush=True)


if __name__ == "__main__":
    main()
