"""Batched serving's dependence on the batch, and what a batch-invariant
FullSubNet+ costs.

    # on one CUDA card (FullSubNet+ at full width, bf16, seeded weights)
    python -m generative_audio_torch.scripts.perf_batch_invariance

On the card, clip 0 of a batch and clip 0 alone part in every GEMM and
reduction over the batch's rows (chip_smoke.py phase 13's trace names the
first: the TCN towers' 1x1 convolutions, bf16 `F.linear` with M = B*T). This
script builds, inside its own process, a variant of the model in which no
such op depends on the batch: every TCN 1x1 convolution and each tower's
head is one product per clip (M = T, as a clip alone has it), and the TCN
norms', the offline norm's and TSSE's reductions, and TSSE's three linears,
are summed in float64 and rounded once. It serves the same clips (8 x 10 s
+ 5 x 7.5 s) through `enhance_dir` at batch 8 and clip by clip under the
port's model and under the variant, and prints the largest difference of
the two in int16 steps; then the batched RTF of 8 x 10 s clips and the RTF
of one 10 s request of both, in alternating rounds. The variant is a
measurement, not a path of the package.
"""
from __future__ import annotations

import contextlib
import statistics
import tempfile
from pathlib import Path

import numpy as np
import torch

from generative_audio_torch.data import read_wav
from generative_audio_torch.eval import Inferencer
from generative_audio_torch.models import FullSubNetPlus, FullSubNetPlusConfig
from generative_audio_torch.nn import attention, recurrent, tcn
from generative_audio_torch.utils import convert
from generative_audio_torch.utils.device import resolve_device

__all__ = ["batch_invariant", "batched_vs_serial_steps", "main"]

SEED = 0
ROUNDS, REPS = 3, 3


def _per_clip(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """x [B, T, K] @ weight^T + bias as B products of M = T rows, in
    `dtype`, returned in float32."""
    w, b, xc = weight.to(dtype).t(), bias.to(dtype), x.to(dtype)
    out = torch.empty(x.shape[0], x.shape[1], w.shape[1], dtype=dtype,
                      device=x.device)
    for i in range(x.shape[0]):
        torch.addmm(b, xc[i], w, out=out[i])
    return out.float()


def _pointwise(self, conv, x):
    return _per_clip(x, conv.weight[:, :, 0], conv.bias, self.compute_dtype)


def _global_layer_norm(self, x):
    xd = x.double()
    mean = xd.mean(dim=(1, 2), keepdim=True).float()
    var = xd.var(dim=(1, 2), keepdim=True, unbiased=False).float()
    return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def _offline_laplace_norm(x):
    return x / (x.double().mean(dim=(1, 2, 3), keepdim=True).float() + 1e-5)


def _linear64(layer, v):
    return ((v.double()[..., None, :] * layer.weight.double()).sum(-1)
            + layer.bias.double()).float()


def _tsse(self, x):
    pooled = [torch.relu(conv(x).double().mean(dim=-1).float())
              for conv in (self.smallConv1d, self.middleConv1d,
                           self.largeConv1d)]
    squeeze = _linear64(self.feature_concate_fc,
                        torch.stack(pooled, dim=2))[..., 0]
    scale = torch.sigmoid(_linear64(
        self.fc2, torch.relu(_linear64(self.fc1, squeeze))))
    return x * scale[:, :, None]


_SEQUENCE_FORWARD = recurrent.SequenceModel.forward


def _sequence(self, x):
    if self.kind in recurrent._STACKS:
        return _SEQUENCE_FORWARD(self, x)
    y = self.sequence_model(x).transpose(1, 2)
    fc = self.fc_output_layer
    y = _per_clip(y, fc.weight, fc.bias, self.compute_dtype)
    if self.activation is not None:
        y = self.activation(y)
    return y.transpose(1, 2)


@contextlib.contextmanager
def batch_invariant(model: FullSubNetPlus):
    """Inside the block, `model` (and every FullSubNet+ in this process)
    computes the batch-invariant variant."""
    saved = [(tcn.TCNBlock, "_pointwise", _pointwise),
             (tcn._GlobalLayerNorm, "forward", _global_layer_norm),
             (attention.ChannelTimeSenseSELayer, "forward", _tsse),
             (recurrent.SequenceModel, "forward", _sequence)]
    old = [getattr(cls, name) for cls, name, _ in saved]
    old_norm = model.norm
    for cls, name, fn in saved:
        setattr(cls, name, fn)
    model.norm = _offline_laplace_norm
    try:
        yield model
    finally:
        for (cls, name, _), fn in zip(saved, old):
            setattr(cls, name, fn)
        model.norm = old_norm


def _noise(seed, samples):
    return (np.random.default_rng(seed).standard_normal(samples) * 0.1
            ).astype(np.float32)


def batched_vs_serial_steps(inf: Inferencer) -> float:
    """enhance_dir of 8 x 10 s + 5 x 7.5 s at batch 8 against clip by clip:
    the largest difference of a written sample in int16 steps."""
    clips = [(_noise(SEED + 60 + i, 160000), f"ten{i}") for i in range(8)]
    clips += [(_noise(SEED + 70 + i, 120000), f"sevenhalf{i}")
              for i in range(5)]
    with tempfile.TemporaryDirectory() as tmp:
        out = {}
        for batch in (8, 1):
            d = Path(tmp) / str(batch)
            inf.enhance_dir(clips, d, log=lambda *_: None, batch_size=batch)
            out[batch] = {n: read_wav(d / f"{n}.wav")[1] for _, n in clips}
    return max(float(np.abs(out[8][n] - out[1][n]).max())
               for _, n in clips) * 32768


def _batched_rtf(inf: Inferencer) -> list:
    clips = [(_noise(SEED + 2 + i, 160000), f"c{i}") for i in range(8)]
    rtf = []
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(REPS):
            inf.enhance_dir(clips, Path(tmp) / str(r), log=lambda *_: None,
                            batch_size=8)
            rtf.append(inf.last_rtf)
    return rtf


def _single_rtf(inf: Inferencer) -> list:
    one = _noise(SEED + 5, 160000)
    rtf = []
    for _ in range(REPS):
        inf.enhance(one)
        rtf.append(inf.last_rtf)
    return rtf


def main() -> int:
    dev = resolve_device("cuda")
    cfg = FullSubNetPlusConfig()
    model = FullSubNetPlus(cfg, compute_dtype=torch.bfloat16, device=dev)
    model.load_state_dict(convert.convert_fullsubnet_plus(
        convert.random_fullsubnet_plus_params(cfg, seed=SEED)))
    inf = Inferencer(model, device=dev)
    name = torch.cuda.get_device_name(dev)
    port = batched_vs_serial_steps(inf)
    with batch_invariant(model):
        invariant = batched_vs_serial_steps(inf)
    print(f"enhance_dir 8 x 10 s + 5 x 7.5 s, batch 8 vs clip by clip: the "
          f"port {port:.0f} int16 steps, the batch-invariant variant "
          f"{invariant:.0f}; on {name}", flush=True)
    readings = {False: ([], []), True: ([], [])}
    for r in range(ROUNDS):
        for variant in ((False, True) if r % 2 == 0 else (True, False)):
            ctx = (batch_invariant(model) if variant
                   else contextlib.nullcontext())
            with ctx:
                readings[variant][0].extend(_batched_rtf(inf))
                readings[variant][1].extend(_single_rtf(inf))
    for variant, (batched, single) in readings.items():
        print(f"{'batch-invariant variant' if variant else 'the port'}: "
              f"batched RTF (8 x 10 s) median {statistics.median(batched):.5f}"
              f" [{min(batched):.5f}-{max(batched):.5f}], one 10 s request "
              f"median {statistics.median(single):.5f} "
              f"[{min(single):.5f}-{max(single):.5f}], {len(batched)} runs "
              f"each in {ROUNDS} alternating rounds; on {name}", flush=True)
    ratio = (statistics.median(readings[True][0])
             / statistics.median(readings[False][0]))
    print(f"batched RTF, variant over the port: {ratio:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
