"""Sequence models: the LSTM layer and the SequenceModel head.

Port of generative_audio_tpu/nn/recurrent.py:55-172 (LSTMLayer) and
:272-332 (SequenceModel, LSTM and TCN bodies). Parameters carry the reference
checkpoint's names: `sequence_model.weight_ih_l0` [4H, in], `weight_hh_l0`
[4H, H], `bias_ih_l0`, `bias_hh_l0`, ... for the LSTM body (held by
`_LSTMStack`, whose layers own no parameters), `sequence_model.<i>.*` for
the TCN body, and `fc_output_layer.*` for the head.

The LSTM keeps the JAX package's time-major chain: one [B, F, T] -> [T, B, F]
transpose in, the layers stay time-major, one transpose out after the head.
In bf16 each layer hoists its input projection into one matmul that writes
bf16 gates [T, B, 4H] and runs the scan kernel over them (ops/lstm.py);
above a gates working-set limit it switches to the time-chunked layer.
Under autograd the same calls go through ops.lstm.LSTMScan (the training
forward and the backward scan kernels); the projection's own backward
(dx, dW_ih, db) is autograd's, in bf16 like its forward.
In float32 (a constructor option, used by the CPU tests) the recurrence is
the full-precision plain loop, the counterpart of the JAX lax.scan path,
differentiated by autograd; the CUDA kernels take bf16 operands only, so
float32 is refused on CUDA.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from generative_audio_torch.nn.tcn import TCNStack
from generative_audio_torch.ops.lstm import (
    lstm_layer_tm_chunked, lstm_scan_reference_tm, lstm_scan_tm)

__all__ = ["LSTMLayer", "SequenceModel", "default_gates_bytes_limit"]

# Share of the card's memory that one layer's bf16 gates buffer may take
# before the layer switches to the time-chunked projection, and the share of
# that limit one chunk's gates take. At batch 8 x 10 s the buffer is 3.97 GB;
# a quarter of an 80 GB card is 20 GB.
_GATES_SHARE_OF_DEVICE = 0.25
_CHUNK_SHARE_OF_LIMIT = 0.125


def default_gates_bytes_limit(device: torch.device) -> Optional[int]:
    """The gates working-set limit derived from the card's memory; None
    (never chunk) on the CPU."""
    if device.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(device).total_memory
    return int(total * _GATES_SHARE_OF_DEVICE)


class LSTMLayer(nn.Module):
    """One (optionally bidirectional) LSTM layer over [B, T, F], or [T, B, F]
    with time_major=True. The layer owns no parameters: `forward` takes each
    direction's (w_ih [4H, in], w_hh [4H, H], b_ih, b_hh) in torch layout,
    so that the enclosing stack can hold them under the checkpoint's names.

    gates_bytes_limit: above this size of the bf16 gates buffer the layer
    runs the time-chunked projection (ops.lstm.lstm_layer_tm_chunked).
    None derives it from the card's memory (default_gates_bytes_limit)."""

    def __init__(self, hidden_size: int, bidirectional: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 gates_bytes_limit: Optional[int] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.bidirectional = bidirectional
        self.compute_dtype = compute_dtype
        self.gates_bytes_limit = gates_bytes_limit

    def _limit(self, device: torch.device) -> Optional[int]:
        if self.gates_bytes_limit is not None:
            return self.gates_bytes_limit
        return default_gates_bytes_limit(device)

    def _scan(self, x_tm: torch.Tensor, w_ih, w_hh, b_ih, b_hh,
              reverse: bool) -> torch.Tensor:
        h = self.hidden_size
        cdt = self.compute_dtype
        bias = b_ih + b_hh
        if cdt == torch.float32:
            if x_tm.is_cuda:
                raise NotImplementedError(
                    "the CUDA LSTM kernel takes bf16 operands; build the model "
                    "with compute_dtype=torch.bfloat16 on CUDA")
            gates = F.linear(x_tm, w_ih, bias)
            return lstm_scan_reference_tm(gates, w_hh.t(), reverse,
                                          compute_dtype=torch.float32)
        if cdt != torch.bfloat16:
            raise ValueError(f"compute_dtype must be bfloat16 or float32, got {cdt}")
        t_len, b, _ = x_tm.shape
        limit = self._limit(x_tm.device)
        slab = t_len * b * 4 * h * 2                        # bf16 gates bytes
        if limit is not None and slab > limit:
            chunk_bytes = int(limit * _CHUNK_SHARE_OF_LIMIT)
            t_chunk = max(64, -(-chunk_bytes // (b * 4 * h * 2)))
            return lstm_layer_tm_chunked(x_tm, w_ih.t(), w_hh.t(), bias,
                                         reverse, t_chunk, out_dtype=cdt,
                                         proj_dtype=cdt)
        # hoisted projection: one matmul writes the bf16 gates time-major
        gates = F.linear(x_tm.to(cdt), w_ih.to(cdt), bias.to(cdt))
        return lstm_scan_tm(gates, w_hh.t(), reverse, out_dtype=cdt)

    def forward(self, x: torch.Tensor, weights, weights_reverse=None,
                time_major: bool = False) -> torch.Tensor:
        x_tm = x if time_major else x.transpose(0, 1)
        y = self._scan(x_tm, *weights, reverse=False)
        if self.bidirectional:
            y = torch.cat([y, self._scan(x_tm, *weights_reverse,
                                         reverse=True)], dim=-1)
        return y if time_major else y.transpose(0, 1)


class _LSTMStack(nn.Module):
    """The parameters of a multi-layer LSTM under torch.nn.LSTM's names, and
    the LSTMLayers that run them, time-major [T, B, F] -> [T, B, H]."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 bidirectional: bool, compute_dtype: torch.dtype,
                 gates_bytes_limit: Optional[int], device=None):
        super().__init__()
        self.num_layers = num_layers
        self.suffixes = [""] + (["_reverse"] if bidirectional else [])
        bound = hidden_size ** -0.5              # torch's RNN initialisation
        n_dir = len(self.suffixes)
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size * n_dir
            for suffix in self.suffixes:
                shapes = {"weight_ih": (4 * hidden_size, in_size),
                          "weight_hh": (4 * hidden_size, hidden_size),
                          "bias_ih": (4 * hidden_size,),
                          "bias_hh": (4 * hidden_size,)}
                for kind, shape in shapes.items():
                    p = torch.empty(shape, device=device).uniform_(-bound, bound)
                    self.register_parameter(f"{kind}_l{layer}{suffix}",
                                            nn.Parameter(p))
        self.layers = nn.ModuleList(
            LSTMLayer(hidden_size, bidirectional, compute_dtype,
                      gates_bytes_limit) for _ in range(num_layers))

    def _weights(self, layer: int, suffix: str):
        return tuple(getattr(self, f"{kind}_l{layer}{suffix}") for kind in
                     ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            rev = self._weights(i, "_reverse") if len(self.suffixes) > 1 else None
            y = layer(y, self._weights(i, ""), rev, time_major=True)
        return y


_ACTIVATIONS = {
    "Tanh": torch.tanh,
    "ReLU": torch.relu,
    "ReLU6": lambda x: torch.clamp(x, 0.0, 6.0),
}


class SequenceModel(nn.Module):
    """LSTM or TCN body + Linear head + optional activation: [B, F, T] ->
    [B, F', T]. For "TCN" the hidden width is fixed at 512, as in the
    reference, whatever hidden_size says. GRU waits for its kernel
    (ROADMAP.md, queue B)."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int,
                 num_layers: int = 2, bidirectional: bool = False,
                 sequence_model: str = "GRU",
                 output_activate_function: Optional[str] = "Tanh",
                 compute_dtype: torch.dtype = torch.float32,
                 gates_bytes_limit: Optional[int] = None, device=None):
        super().__init__()
        self.kind = sequence_model
        self.compute_dtype = compute_dtype
        self.activation = (_ACTIVATIONS[output_activate_function]
                           if output_activate_function else None)
        if sequence_model in ("TCN", "TCN-subband"):
            hidden = hidden_size if sequence_model == "TCN-subband" else 512
            self.sequence_model = TCNStack(input_size, hidden, compute_dtype,
                                           device=device)
            head_in = input_size
        elif sequence_model == "LSTM":
            self.sequence_model = _LSTMStack(
                input_size, hidden_size, num_layers, bidirectional,
                compute_dtype, gates_bytes_limit, device=device)
            head_in = hidden_size * (2 if bidirectional else 1)
        else:
            raise NotImplementedError(
                f"sequence model {sequence_model!r} is not ported to "
                "generative_audio_torch yet (ROADMAP.md, queue A item 8)")
        self.fc_output_layer = nn.Linear(head_in, output_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 3:
            raise ValueError(f"expected [B, F, T], got {tuple(x.shape)}")
        cdt = self.compute_dtype
        if self.kind == "LSTM":
            y = self.sequence_model(x.permute(2, 0, 1))      # [T, B, H]
        else:
            y = self.sequence_model(x).transpose(1, 2)       # [B, T, F]
        fc = self.fc_output_layer
        y = F.linear(y.to(cdt), fc.weight.to(cdt), fc.bias.to(cdt)).float()
        if self.activation is not None:
            y = self.activation(y)
        if self.kind == "LSTM":
            return y.permute(1, 2, 0)                        # [B, F', T]
        return y.transpose(1, 2)
