"""Sequence models: the LSTM and GRU layers and the SequenceModel head.

Port of generative_audio_tpu/nn/recurrent.py:55-172 (LSTMLayer), :175-262
(GRULayer), :272-332 (SequenceModel, LSTM, GRU and TCN bodies) and
:335-399 (ComplexSequenceModel).
Parameters carry the reference checkpoint's names:
`sequence_model.weight_ih_l0` [GH, in], `weight_hh_l0` [GH, H],
`bias_ih_l0`, `bias_hh_l0`, ... for the recurrent bodies (G = 4 gates for
the LSTM, 3 for the GRU; held by `_LSTMStack` / `_GRUStack`, whose layers
own no parameters), `sequence_model.<i>.*` for the TCN body, and
`fc_output_layer.*` for the head.

Both recurrent bodies keep the JAX LSTM's time-major chain: one [B, F, T] ->
[T, B, F] transpose in, the layers stay time-major, one transpose out after
the head (the JAX GRU body is batch-major inside; the public layout is the
same). In bf16 each layer hoists its input projection into one matmul that
writes bf16 gates [T, B, GH] and runs the scan kernel over them
(ops/lstm.py, ops/gru.py); above a gates working-set limit it switches to
the time-chunked layer. Under autograd the same calls go through
ops.lstm.LSTMScan or ops.gru.GRUScan (the training forward and the backward
kernels); the projection's own backward (dx, dW_ih, db) is autograd's, in
bf16 like its forward.
In float32 (the JAX models' default compute dtype) the route depends on the
tensors' device, where the JAX layers choose by pallas_available():
  * on CUDA, the "mixed" route, the JAX layers' TPU route: bf16 gates made
    once from the fp32-accumulated projection plus the fp32 bias
    (ops.lstm.mixed_gates), the same scan kernels with float32 output (or
    the chunked layer with that projection), and float32 everywhere else;
  * on the CPU, the "float32" route: the full-precision plain loop, the
    JAX lax.scan path, differentiated by autograd.
`scan_kernels` runs the kernels' route on any device, so that the CPU tests
hold the mixed route on the kernels' plain versions.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from generative_audio_torch.nn.tcn import TCNStack
from generative_audio_torch.ops.gru import (
    gru_layer_tm_chunked, gru_scan_reference_tm, gru_scan_tm)
from generative_audio_torch.ops.lstm import (
    lstm_layer_tm_chunked, lstm_scan_reference_tm, lstm_scan_tm, mixed_gates)

__all__ = ["LSTMLayer", "GRULayer", "SequenceModel", "ComplexSequenceModel",
           "default_gates_bytes_limit"]

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


class _RecurrentLayer(nn.Module):
    """What LSTMLayer and GRULayer share: one (optionally bidirectional)
    layer over [B, T, F], or [T, B, F] with time_major=True. The layer owns
    no parameters: `forward` takes each direction's (w_ih [GH, in], w_hh
    [GH, H], b_ih, b_hh) in torch layout, so that the enclosing stack can
    hold them under the checkpoint's names. A subclass sets `num_gates` (G)
    and the three routes of `_scan`.

    compute_dtype: bf16 or float32 (see `route`). gates_bytes_limit: above
    this size of the bf16 gates buffer the layer runs the time-chunked
    projection. None derives it from the card's memory
    (default_gates_bytes_limit)."""
    num_gates: int

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

    def _scan_float32(self, x_tm, w_ih, w_hh, b_ih, b_hh, reverse):
        raise NotImplementedError

    def _scan_chunked(self, x_tm, w_ih, w_hh, b_ih, b_hh, reverse, t_chunk):
        raise NotImplementedError

    def _scan_hoisted(self, x_tm, w_ih, w_hh, b_ih, b_hh, reverse):
        raise NotImplementedError

    def route(self, device: torch.device) -> str:
        """The route of a call on `device`: "bf16" for a bf16 layer; for a
        float32 layer "mixed" on CUDA (the scan kernels over bf16 gates,
        float32 out) and "float32" elsewhere (the plain float32 loop)."""
        cdt = self.compute_dtype
        if cdt == torch.bfloat16:
            return "bf16"
        if cdt != torch.float32:
            raise ValueError(f"compute_dtype must be bfloat16 or float32, got {cdt}")
        return "mixed" if device.type == "cuda" else "float32"

    @property
    def _mixed(self) -> bool:
        return self.compute_dtype == torch.float32

    def _gates(self, x_tm, w_ih, bias):
        """The hoisted bf16 gates: in bf16 one F.linear with the bias in
        bf16; in float32 mixed_gates (fp32 accumulation, the fp32 bias, one
        rounding to bf16, as the JAX TPU route)."""
        if self._mixed:
            return mixed_gates(x_tm, w_ih.t(), bias)
        cdt = self.compute_dtype
        return F.linear(x_tm.to(cdt), w_ih.to(cdt), bias.to(cdt))

    def _scan(self, x_tm: torch.Tensor, w_ih, w_hh, b_ih, b_hh,
              reverse: bool) -> torch.Tensor:
        if self.route(x_tm.device) == "float32":
            return self._scan_float32(x_tm, w_ih, w_hh, b_ih, b_hh, reverse)
        return self.scan_kernels(x_tm, w_ih, w_hh, b_ih, b_hh, reverse)

    def scan_kernels(self, x_tm: torch.Tensor, w_ih, w_hh, b_ih, b_hh,
                     reverse: bool) -> torch.Tensor:
        """One direction [T, B, F] -> [T, B, H] on the scan kernels' route
        (bf16, or mixed for a float32 layer) whatever the device: CUDA
        tensors launch the kernels, CPU tensors run their plain versions.
        The hoisted gates, or the time-chunked layer above the gates
        limit."""
        t_len, b, _ = x_tm.shape
        limit = self._limit(x_tm.device)
        row_bytes = b * self.num_gates * self.hidden_size * 2   # bf16 gates
        if limit is not None and t_len * row_bytes > limit:
            chunk_bytes = int(limit * _CHUNK_SHARE_OF_LIMIT)
            t_chunk = max(64, -(-chunk_bytes // row_bytes))
            return self._scan_chunked(x_tm, w_ih, w_hh, b_ih, b_hh, reverse,
                                      t_chunk)
        return self._scan_hoisted(x_tm, w_ih, w_hh, b_ih, b_hh, reverse)

    def forward(self, x: torch.Tensor, weights, weights_reverse=None,
                time_major: bool = False) -> torch.Tensor:
        x_tm = x if time_major else x.transpose(0, 1)
        y = self._scan(x_tm, *weights, reverse=False)
        if self.bidirectional:
            y = torch.cat([y, self._scan(x_tm, *weights_reverse,
                                         reverse=True)], dim=-1)
        return y if time_major else y.transpose(0, 1)


class LSTMLayer(_RecurrentLayer):
    """One LSTM layer (see _RecurrentLayer); gates in torch order i, f, g, o.
    On the kernels' route: ops.lstm.lstm_scan_tm over the hoisted gates, or
    ops.lstm.lstm_layer_tm_chunked above the gates limit."""
    num_gates = 4

    def _scan_float32(self, x_tm, w_ih, w_hh, b_ih, b_hh, reverse):
        gates = F.linear(x_tm, w_ih, b_ih + b_hh)
        return lstm_scan_reference_tm(gates, w_hh.t(), reverse,
                                      compute_dtype=torch.float32)

    def _scan_chunked(self, x_tm, w_ih, w_hh, b_ih, b_hh, reverse, t_chunk):
        return lstm_layer_tm_chunked(x_tm, w_ih.t(), w_hh.t(), b_ih + b_hh,
                                     reverse, t_chunk,
                                     out_dtype=self.compute_dtype,
                                     proj_dtype=torch.bfloat16,
                                     mixed=self._mixed)

    def _scan_hoisted(self, x_tm, w_ih, w_hh, b_ih, b_hh, reverse):
        # hoisted projection: one matmul writes the bf16 gates time-major
        return lstm_scan_tm(self._gates(x_tm, w_ih, b_ih + b_hh), w_hh.t(),
                            reverse, out_dtype=self.compute_dtype)


class GRULayer(_RecurrentLayer):
    """One GRU layer (see _RecurrentLayer); gates in torch order r, z, n.
    Only b_ih joins the hoisted x-side gates: b_hh goes to the scan, because
    the candidate gate is tanh(x_n + r * (h W_hn + b_hn)). On the kernels'
    route: ops.gru.gru_scan_tm, or ops.gru.gru_layer_tm_chunked above the
    gates limit."""
    num_gates = 3

    def _scan_float32(self, x_tm, w_ih, w_hh, b_ih, b_hh, reverse):
        gates = F.linear(x_tm, w_ih, b_ih)
        return gru_scan_reference_tm(gates, w_hh.t(), b_hh, reverse,
                                     compute_dtype=torch.float32)

    def _scan_chunked(self, x_tm, w_ih, w_hh, b_ih, b_hh, reverse, t_chunk):
        return gru_layer_tm_chunked(x_tm, w_ih.t(), w_hh.t(), b_ih, b_hh,
                                    reverse, t_chunk,
                                    out_dtype=self.compute_dtype,
                                    proj_dtype=torch.bfloat16,
                                    mixed=self._mixed)

    def _scan_hoisted(self, x_tm, w_ih, w_hh, b_ih, b_hh, reverse):
        return gru_scan_tm(self._gates(x_tm, w_ih, b_ih), w_hh.t(), b_hh,
                           reverse, out_dtype=self.compute_dtype)


class _RecurrentStack(nn.Module):
    """The parameters of a multi-layer LSTM or GRU under torch.nn.LSTM's and
    torch.nn.GRU's names (weight_ih_l0 [GH, in], weight_hh_l0 [GH, H],
    bias_ih_l0, bias_hh_l0, ..._reverse), and the layers that run them,
    time-major [T, B, F] -> [T, B, H]."""
    layer_cls = _RecurrentLayer

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 bidirectional: bool, compute_dtype: torch.dtype,
                 gates_bytes_limit: Optional[int], device=None):
        super().__init__()
        self.num_layers = num_layers
        self.suffixes = [""] + (["_reverse"] if bidirectional else [])
        bound = hidden_size ** -0.5              # torch's RNN initialisation
        n_dir = len(self.suffixes)
        gh = self.layer_cls.num_gates * hidden_size
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size * n_dir
            for suffix in self.suffixes:
                shapes = {"weight_ih": (gh, in_size),
                          "weight_hh": (gh, hidden_size),
                          "bias_ih": (gh,), "bias_hh": (gh,)}
                for kind, shape in shapes.items():
                    p = torch.empty(shape, device=device).uniform_(-bound, bound)
                    self.register_parameter(f"{kind}_l{layer}{suffix}",
                                            nn.Parameter(p))
        self.layers = nn.ModuleList(
            self.layer_cls(hidden_size, bidirectional, compute_dtype,
                           gates_bytes_limit) for _ in range(num_layers))

    def _weights(self, layer: int, suffix: str):
        return tuple(getattr(self, f"{kind}_l{layer}{suffix}") for kind in
                     ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            rev = self._weights(i, "_reverse") if len(self.suffixes) > 1 else None
            y = layer(y, self._weights(i, ""), rev, time_major=True)
        return y


class _LSTMStack(_RecurrentStack):
    layer_cls = LSTMLayer


class _GRUStack(_RecurrentStack):
    layer_cls = GRULayer


_ACTIVATIONS = {
    "Tanh": torch.tanh,
    "ReLU": torch.relu,
    "ReLU6": lambda x: torch.clamp(x, 0.0, 6.0),
}


_STACKS = {"LSTM": _LSTMStack, "GRU": _GRUStack}


class SequenceModel(nn.Module):
    """LSTM, GRU or TCN body + Linear head + optional activation: [B, F, T]
    -> [B, F', T]. For "TCN" the hidden width is fixed at 512, as in the
    reference, whatever hidden_size says."""

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
        elif sequence_model in _STACKS:
            self.sequence_model = _STACKS[sequence_model](
                input_size, hidden_size, num_layers, bidirectional,
                compute_dtype, gates_bytes_limit, device=device)
            head_in = hidden_size * (2 if bidirectional else 1)
        else:
            raise NotImplementedError(f"Not implemented {sequence_model}")
        self.fc_output_layer = nn.Linear(head_in, output_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 3:
            raise ValueError(f"expected [B, F, T], got {tuple(x.shape)}")
        cdt = self.compute_dtype
        recurrent = self.kind in _STACKS
        if recurrent:
            y = self.sequence_model(x.permute(2, 0, 1))      # [T, B, H]
        else:
            y = self.sequence_model(x).transpose(1, 2)       # [B, T, F]
        fc = self.fc_output_layer
        y = F.linear(y.to(cdt), fc.weight.to(cdt), fc.bias.to(cdt)).float()
        if self.activation is not None:
            y = self.activation(y)
        if recurrent:
            return y.permute(1, 2, 0)                        # [B, F', T]
        return y.transpose(1, 2)


class ComplexSequenceModel(nn.Module):
    """Complex LSTM or GRU: two towers (`real_sequence_model`,
    `imag_sequence_model`, torch.nn.LSTM's / GRU's parameter names) with the
    complex pairing (r2r - i2i, i2r + r2i), a Linear head for each part
    (`real_fc_output_layer`, `imag_fc_output_layer`) and an optional
    activation. [B, 2F, T] = concat(real, imag) along the features ->
    [B, 2 * output_size, T].

    The real and the imag stream go through each tower together, as one
    batch of 2B rows: each layer of each tower is one scan launch (two when
    bidirectional), as in the JAX module."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int,
                 num_layers: int = 2, bidirectional: bool = False,
                 sequence_model: str = "GRU",
                 output_activate_function: Optional[str] = "Tanh",
                 compute_dtype: torch.dtype = torch.float32,
                 gates_bytes_limit: Optional[int] = None, device=None):
        super().__init__()
        if sequence_model not in _STACKS:
            raise NotImplementedError(f"Not implemented {sequence_model}")
        self.compute_dtype = compute_dtype
        self.activation = (_ACTIVATIONS[output_activate_function]
                           if output_activate_function else None)
        head_in = hidden_size * (2 if bidirectional else 1)
        for part in ("real", "imag"):
            self.add_module(f"{part}_sequence_model", _STACKS[sequence_model](
                input_size, hidden_size, num_layers, bidirectional,
                compute_dtype, gates_bytes_limit, device=device))
        for part in ("real", "imag"):
            self.add_module(f"{part}_fc_output_layer",
                            nn.Linear(head_in, output_size, device=device))

    def _head(self, fc: nn.Linear, y: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        y = F.linear(y.to(cdt), fc.weight.to(cdt), fc.bias.to(cdt)).float()
        return self.activation(y) if self.activation is not None else y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 3:
            raise ValueError(f"expected [B, 2F, T], got {tuple(x.shape)}")
        b = x.shape[0]
        real, imag = x.chunk(2, dim=1)
        both = torch.cat([real, imag], dim=0).permute(2, 0, 1)   # [T, 2B, F]
        y_real = self.real_sequence_model(both)
        y_imag = self.imag_sequence_model(both)
        real_out = y_real[:, :b] - y_imag[:, b:]                 # r2r - i2i
        imag_out = y_real[:, b:] + y_imag[:, :b]                 # i2r + r2i
        real_out = self._head(self.real_fc_output_layer, real_out)
        imag_out = self._head(self.imag_fc_output_layer, imag_out)
        return torch.cat([real_out, imag_out], dim=2).permute(1, 2, 0)
