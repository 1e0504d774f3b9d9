"""MOSNet (CNN-BLSTM), the objective MOS predictor, and its keras-h5 weight
transplant. Port of generative_audio_tpu/eval/mosnet.py:50-263.

The reference scores MOSNET through the `speechmetrics` wheel
(audio_zen/metrics.py:119-130): Lo et al.'s pretrained CNN-BLSTM, which
predicts a MOS from the magnitude spectrogram, over 10 s windows whose
scores are averaged. Here:

  * `MOSNet`: four blocks of three 3x3 convolutions (TF 'SAME' padding; the
    third of each with stride 3 along frequency, 257 -> 86 -> 29 -> 10 -> 4
    bins), a keras BiLSTM(128), a per-frame Dense(128) -> ReLU -> Dense(1),
    and the frame mean as the utterance's score. torch's padding="same"
    refuses a stride above 1, so the padding is made by hand, the extra bin
    at the high end as TF puts it. The keras LSTM (gates i, f, c, o, one
    bias) runs as the float32 recurrence step by step, both directions in
    one loop: the counterpart of the JAX module's lax.scan, which is no
    Pallas kernel (the scan kernels take bf16 only). Parameters: `conv{b}_{c}`
    (Conv2d), `lstm_fwd` / `lstm_bwd` ([D + H + 1, 4H]: kernel, recurrent
    kernel and bias stacked, the JAX package's layout), `dense1`, `frame`.
  * `load_keras_h5`: a keras `.h5` weight file (speechmetrics' `mosnet.h5`
    layout) -> the MOSNet state_dict. h5py is imported inside it only.
  * `mosnet_features`, `mosnet_score`: the librosa-convention magnitude STFT
    (numpy on the host) and the windowed score. `mosnet_score` runs the net
    on the card unless asked for the CPU (the JAX function pins itself to
    the CPU), with TF32 off for its convolutions.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from generative_audio_torch.utils.device import conv_tf32, resolve_device

__all__ = ["MOSNet", "MOSNetConfig", "load_keras_h5", "mosnet_features",
           "mosnet_score"]

SR = 16000
N_FFT = 512
HOP = 256
_STRIDES = (1, 1, 3)      # frequency strides of the three convs of a block


class MOSNetConfig:
    """Shape knobs; the defaults are the published CNN-BLSTM."""

    def __init__(self, num_freqs: int = N_FFT // 2 + 1,
                 conv_channels: Sequence[int] = (16, 32, 64, 128),
                 lstm_units: int = 128, dense_units: int = 128):
        self.num_freqs = num_freqs
        self.conv_channels = tuple(conv_channels)
        self.lstm_units = lstm_units
        self.dense_units = dense_units
        f = num_freqs
        for _ in self.conv_channels:     # each block's stride-3 conv: ceil(f / 3)
            f = -(-f // 3)
        self.reduced_freqs = f           # 4 for 257 bins


def _same_pad(x: torch.Tensor, stride_f: int) -> torch.Tensor:
    """TF 'SAME' padding of a 3x3 conv over [B, C, T, F]: one frame each
    side of T; along F, as much as ceil(F / stride) outputs need, the odd
    one at the high end."""
    f = x.shape[-1]
    out_f = -(-f // stride_f)
    pad_f = max((out_f - 1) * stride_f + 3 - f, 0)
    return F.pad(x, (pad_f // 2, pad_f - pad_f // 2, 1, 1))


def _keras_bilstm(x: torch.Tensor, packed: Sequence[torch.Tensor]
                  ) -> torch.Tensor:
    """keras LSTM directions (forward, backward) over [B, T, D] -> [B, T,
    2H], float32, both in one loop over time."""
    d = x.shape[-1]
    h_units = packed[0].shape[1] // 4
    kernel = torch.stack([p[:d] for p in packed])              # [2, D, 4H]
    recurrent = torch.stack([p[d:d + h_units] for p in packed])
    bias = torch.stack([p[d + h_units] for p in packed])       # [2, 4H]
    gates_x = torch.einsum("btd,kdg->kbtg", x, kernel) + bias[:, None, None]
    gates_x = torch.stack([gates_x[0], gates_x[1].flip(1)])    # backward reversed
    b, t_len = x.shape[:2]
    h = x.new_zeros(2, b, h_units)
    c = x.new_zeros(2, b, h_units)
    hs = []
    for t in range(t_len):
        g = gates_x[:, :, t] + torch.bmm(h, recurrent)
        i, f, cc, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cc)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    hs = torch.stack(hs, dim=2)                                # [2, B, T, H]
    return torch.cat([hs[0], hs[1].flip(1)], dim=-1)


class MOSNet(nn.Module):
    """CNN-BLSTM MOS predictor: magnitude spectrogram [B, T, F] ->
    (utterance score [B], frame scores [B, T]). The published net's dropout
    layers do nothing at inference and are left out."""

    def __init__(self, config: MOSNetConfig, device=None):
        super().__init__()
        self.config = cfg = config
        in_ch = 1
        for bi, ch in enumerate(cfg.conv_channels):
            for ci, stride in enumerate(_STRIDES):
                self.add_module(f"conv{bi}_{ci}", nn.Conv2d(
                    in_ch, ch, 3, stride=(1, stride), device=device))
                in_ch = ch
        h = cfg.lstm_units
        d = cfg.reduced_freqs * cfg.conv_channels[-1]
        for name in ("lstm_fwd", "lstm_bwd"):
            self.register_parameter(name, nn.Parameter(
                torch.zeros(d + h + 1, 4 * h, device=device)))
        self.dense1 = nn.Linear(2 * h, cfg.dense_units, device=device)
        self.frame = nn.Linear(cfg.dense_units, 1, device=device)

    def forward(self, mag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        b, t, _ = mag.shape
        x = mag[:, None]                                   # [B, 1, T, F]
        for bi in range(len(cfg.conv_channels)):
            for ci, stride in enumerate(_STRIDES):
                x = torch.relu(getattr(self, f"conv{bi}_{ci}")(
                    _same_pad(x, stride)))
        x = x.permute(0, 2, 3, 1).reshape(b, t, -1)        # [B, T, F' * C]
        x = _keras_bilstm(x, (self.lstm_fwd, self.lstm_bwd))
        frame = self.frame(torch.relu(self.dense1(x)))[..., 0]
        return frame.mean(dim=1), frame


def load_keras_h5(path, config: Optional[MOSNetConfig] = None
                  ) -> Dict[str, torch.Tensor]:
    """A keras `.h5` weight file -> the MOSNet state_dict.

    Walks `model_weights/` (the file root for a weights-only save) in the
    saved layer order and sorts each layer's arrays by shape: 3x3 conv
    kernels and biases fill conv{b}_{c} in order; a bidirectional LSTM's
    forward and backward (kernel, recurrent, bias) triples are stacked into
    lstm_fwd / lstm_bwd; the two dense layers go to dense1 (the wider) and
    frame. Keras conv kernels are HWIO and dense kernels (in, out)."""
    import h5py

    from generative_audio_torch.utils.convert import convert_mosnet

    cfg = config or MOSNetConfig()
    convs, denses, lstm_dirs = [], [], {}

    def classify(wnames, arrays):
        kernels = [a for a in arrays if a.ndim == 4]
        if kernels:
            biases = [a for a in arrays if a.ndim == 1]
            convs.extend(zip(kernels, biases))
            return
        mats = [a for a in arrays if a.ndim == 2]
        vecs = [a for a in arrays if a.ndim == 1]
        if len(mats) >= 2 and any(m.shape[1] == 4 * cfg.lstm_units
                                  for m in mats):
            for direction in ("backward", "forward"):
                trip = [a for n, a in zip(wnames, arrays) if direction in n]
                if len(trip) == 3:
                    lstm_dirs[direction] = trip
            if not lstm_dirs:                     # a single unnamed direction
                lstm_dirs["forward"] = [mats[0], mats[1], vecs[0]]
            return
        denses.extend(zip(mats, vecs))

    def decoded(names):
        return [n.decode() if isinstance(n, bytes) else n for n in names]

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for lname in decoded(root.attrs.get("layer_names", list(root))):
            layer = root[lname]
            wnames = decoded(layer.attrs.get("weight_names", []))
            if not wnames:                        # walk nested groups
                stack = [layer]
                while stack:
                    g = stack.pop(0)
                    for k in g:
                        item = g[k]
                        if isinstance(item, h5py.Group):
                            stack.append(item)
                        else:
                            wnames.append(item.name)
            classify(wnames, [np.asarray(layer.file[w] if w.startswith("/")
                                         else layer[w]) for w in wnames])

    n_conv = 3 * len(cfg.conv_channels)
    if len(convs) != n_conv or len(denses) < 2 or len(lstm_dirs) != 2:
        raise ValueError(
            f"unrecognized keras layout: {len(convs)} convs (want {n_conv}), "
            f"{len(denses)} denses, {sorted(lstm_dirs)} lstm directions")
    params = {f"conv{i // 3}_{i % 3}": {"kernel": k, "bias": b}
              for i, (k, b) in enumerate(convs)}
    for name, key in (("forward", "lstm_fwd"), ("backward", "lstm_bwd")):
        kern, rec, bias = lstm_dirs[name]
        params[key] = np.concatenate([kern, rec, np.asarray(bias)[None]],
                                     axis=0)
    denses.sort(key=lambda kv: kv[0].shape[1], reverse=True)
    params["dense1"] = {"kernel": denses[0][0], "bias": denses[0][1]}
    params["frame"] = {"kernel": denses[1][0], "bias": denses[1][1]}
    return convert_mosnet(params)


def mosnet_features(wav: np.ndarray) -> np.ndarray:
    """Magnitude spectrogram with librosa's conventions (n_fft 512, hop 256,
    periodic Hann, centred with reflect padding): [T, 257] float32."""
    wav = np.asarray(wav, np.float32)
    pad = N_FFT // 2
    x = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - N_FFT) // HOP
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = x[idx] * np.hanning(N_FFT + 1)[:-1]
    return np.abs(np.fft.rfft(frames, N_FFT, axis=1)).astype(np.float32)


def mosnet_score(wav: np.ndarray, variables: Dict[str, torch.Tensor],
                 sr: int = SR, config: Optional[MOSNetConfig] = None,
                 window_seconds: float = 10.0, device=None) -> float:
    """The utterance's MOS by the reference's protocol: 10 s windows (the
    last one kept if it holds at least a hop), each scored alone, their
    mean. `variables` is a MOSNet state_dict (load_keras_h5's); device:
    "cuda" (default) or "cpu"."""
    from scipy.signal import resample_poly

    if sr != SR:
        g = np.gcd(int(sr), SR)
        wav = resample_poly(wav, up=SR // g, down=sr // g)
    dev = resolve_device(device)
    model = MOSNet(config or MOSNetConfig(), device=dev)
    model.load_state_dict(variables)
    win = int(window_seconds * SR)
    chunks = [wav[s:s + win] for s in range(0, max(len(wav), 1), win)]
    chunks = [c for c in chunks if len(c) >= HOP] or [wav]
    scores = []
    with torch.inference_mode(), conv_tf32(False):
        for c in chunks:
            mag = torch.from_numpy(mosnet_features(c))[None].to(dev)
            scores.append(model(mag)[0][0].item())
    return float(np.mean(scores))
