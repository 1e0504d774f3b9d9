"""LSTM recurrence over precomputed time-major gates: CUDA kernels and their
plain PyTorch versions.

Port of the two inference kernels of generative_audio_tpu/ops/pallas_lstm.py:
  * `lstm_scan_tm` (kernel A, csrc/lstm_scan.cu `lstm_scan_fwd`) replaces
    `_lstm_pallas_call` / `_lstm_kernel`;
  * `lstm_scan_carry_tm` (kernel B, `lstm_scan_fwd_carry`) replaces
    `_lstm_pallas_call_carry` / `_lstm_carry_kernel`, and
    `lstm_layer_tm_chunked` chains it over time chunks as the JAX function
    of the same name does.

Layouts follow the JAX package: gates [T, B, 4H] in torch gate order
(i, f, g, o) with the biases already added, W_hh [H, 4H], h [T, B, H].

Dispatch is by the device of the tensors: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version. There is no fallback from
one to the other. The plain versions repeat the kernels' numerics: bf16
gates upcast to fp32, h cast to bf16 before the product with bf16 W_hh,
fp32 accumulation, fp32 c.

`launch_counts` counts kernel launches by kernel name; each wrapper adds one
exactly where it launches, so a run can show that the path went through
the kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["lstm_scan_tm", "lstm_scan_reference_tm", "lstm_scan_carry_tm",
           "lstm_scan_carry_reference_tm", "lstm_layer_tm_chunked",
           "launch_counts", "reset_launch_counts"]

launch_counts = {"lstm_scan_fwd": 0, "lstm_scan_fwd_carry": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _scan_plain(gates: torch.Tensor, w_hh: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor, reverse: bool, compute_dtype: torch.dtype,
                out_dtype: torch.dtype
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Python loop over T: -> (h sequence, h after the last step, c after it)."""
    t_len, b, g4 = gates.shape
    hsz = g4 // 4
    w = w_hh.to(compute_dtype).float()
    out = torch.empty(t_len, b, hsz, dtype=out_dtype, device=gates.device)
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        z = gates[t].float() + h.to(compute_dtype).float() @ w
        i, f, g, o = z.split(hsz, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h.to(out_dtype)
    return out, h, c


def lstm_scan_reference_tm(gates_x: torch.Tensor, w_hh: torch.Tensor,
                           reverse: bool = False,
                           compute_dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """Plain version of kernel A: gates_x [T, B, 4H], w_hh [H, 4H] -> h
    sequence [T, B, H] fp32. With compute_dtype=torch.float32 it is the
    full-precision recurrence (the JAX lax.scan path)."""
    b, hsz = gates_x.shape[1], w_hh.shape[0]
    zeros = torch.zeros(b, hsz, dtype=torch.float32, device=gates_x.device)
    return _scan_plain(gates_x, w_hh, zeros, zeros, reverse, compute_dtype,
                       torch.float32)[0]


def lstm_scan_carry_reference_tm(gates_x: torch.Tensor, w_hh: torch.Tensor,
                                 h0: torch.Tensor, c0: torch.Tensor,
                                 reverse: bool = False,
                                 out_dtype: torch.dtype = torch.float32
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain version of kernel B: as lstm_scan_reference_tm from the state
    (h0, c0) [B, H] fp32 -> (h sequence, h_T, c_T)."""
    return _scan_plain(gates_x, w_hh, h0.float(), c0.float(), reverse,
                       torch.bfloat16, out_dtype)


def _is_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check_shapes(gates: torch.Tensor, w_hh: torch.Tensor,
                  out_dtype: torch.dtype) -> Tuple[int, int, int]:
    if gates.ndim != 3 or gates.shape[-1] % 4:
        raise ValueError(f"gates must be [T, B, 4H], got {tuple(gates.shape)}")
    t_len, b, g4 = gates.shape
    hsz = g4 // 4
    if tuple(w_hh.shape) != (hsz, g4):
        raise ValueError(f"w_hh must be [{hsz}, {g4}], got {tuple(w_hh.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    return t_len, b, hsz


def _check_kernel_operand(name: str, t: torch.Tensor, dtype: torch.dtype):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel_weight(w_hh: torch.Tensor) -> torch.Tensor:
    """W_hh [H, 4H] -> the kernel's operand: [4H, H] bf16, contiguous (torch's
    weight_hh layout, so each MMA B fragment is one 32-bit load)."""
    return w_hh.t().to(torch.bfloat16).contiguous()


def _launch(fn_name: str, gates, wt, out, reverse, h0=None, c0=None,
            h_t=None, c_t=None) -> None:
    from generative_audio_torch.ops import _cuda

    lib = _cuda.load("lstm_scan")
    t_len, b, g4 = gates.shape
    out_f32 = int(out.dtype == torch.float32)
    stream = _cuda.stream_handle(gates.device)
    with torch.cuda.device(gates.device):
        if fn_name == "lstm_scan_fwd":
            err = lib.lstm_scan_fwd(gates.data_ptr(), wt.data_ptr(),
                                    out.data_ptr(), out_f32, t_len, b, g4 // 4,
                                    int(reverse), stream)
        else:
            err = lib.lstm_scan_fwd_carry(
                gates.data_ptr(), wt.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                out.data_ptr(), h_t.data_ptr(), c_t.data_ptr(), out_f32, t_len,
                b, g4 // 4, int(reverse), stream)
    _cuda.check("lstm_scan", err, fn_name)
    launch_counts[fn_name] += 1


def _check_kernel_sizes(hsz: int) -> None:
    if hsz % 16:
        raise ValueError(f"the CUDA LSTM kernel needs H % 16 == 0, got H={hsz}")


def lstm_scan_tm(gates_x: torch.Tensor, w_hh: torch.Tensor,
                 reverse: bool = False,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """LSTM recurrence, time-major: gates_x [T, B, 4H] (cast to bf16 as the
    kernel's input), w_hh [H, 4H] -> h sequence [T, B, H] in out_dtype.
    h and c start at zero. CUDA tensors run kernel A."""
    t_len, b, hsz = _check_shapes(gates_x, w_hh, out_dtype)
    gates = gates_x.to(torch.bfloat16)
    if not _is_cuda(gates, w_hh):
        return lstm_scan_reference_tm(gates, w_hh, reverse).to(out_dtype)
    _check_kernel_sizes(hsz)
    _check_kernel_operand("gates_x", gates, torch.bfloat16)
    out = torch.empty(t_len, b, hsz, dtype=out_dtype, device=gates.device)
    if t_len and b:
        _launch("lstm_scan_fwd", gates, _kernel_weight(w_hh), out, reverse)
    return out


def lstm_scan_carry_tm(gates_x: torch.Tensor, w_hh: torch.Tensor,
                       h0: torch.Tensor, c0: torch.Tensor,
                       reverse: bool = False,
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One time chunk with explicit state: gates_x [T, B, 4H], h0, c0 [B, H]
    fp32 -> (h sequence [T, B, H] out_dtype, h_T, c_T fp32). With
    reverse=True the chunk is consumed back to front and (h0, c0) is the
    state arriving from the later chunk. CUDA tensors run kernel B."""
    t_len, b, hsz = _check_shapes(gates_x, w_hh, out_dtype)
    if tuple(h0.shape) != (b, hsz) or tuple(c0.shape) != (b, hsz):
        raise ValueError(f"h0 and c0 must be [{b}, {hsz}]")
    gates = gates_x.to(torch.bfloat16)
    if not _is_cuda(gates, w_hh, h0, c0):
        return lstm_scan_carry_reference_tm(gates, w_hh, h0, c0, reverse,
                                            out_dtype)
    _check_kernel_sizes(hsz)
    _check_kernel_operand("gates_x", gates, torch.bfloat16)
    _check_kernel_operand("h0", h0, torch.float32)
    _check_kernel_operand("c0", c0, torch.float32)
    out = torch.empty(t_len, b, hsz, dtype=out_dtype, device=gates.device)
    if not (t_len and b):
        return out, h0.clone(), c0.clone()
    h_t = torch.empty_like(h0)
    c_t = torch.empty_like(c0)
    _launch("lstm_scan_fwd_carry", gates, _kernel_weight(w_hh), out, reverse,
            h0, c0, h_t, c_t)
    return out, h_t, c_t


def lstm_layer_tm_chunked(x_tm: torch.Tensor, w_ih: torch.Tensor,
                          w_hh: torch.Tensor, bias: torch.Tensor,
                          reverse: bool = False, t_chunk: int = 128,
                          out_dtype: torch.dtype = torch.bfloat16,
                          proj_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Whole LSTM layer, time-major, with the input projection hoisted one
    time chunk at a time: x_tm [T, B, F], w_ih [F, 4H], w_hh [H, 4H],
    bias [4H] -> [T, B, H]. Only one chunk's [t_chunk, B, 4H] gates exist
    at a time. The projection runs in proj_dtype (default: bf16 on CUDA,
    float32 on the CPU, as the JAX function's TPU and interpret modes do);
    the gates enter the scan as bf16 either way, so for the same gates the
    result is bit-identical to lstm_scan_tm."""
    t_len, b, _ = x_tm.shape
    hsz = w_hh.shape[0]
    pdt = proj_dtype or (torch.bfloat16 if x_tm.is_cuda else torch.float32)
    h = torch.zeros(b, hsz, dtype=torch.float32, device=x_tm.device)
    c = torch.zeros_like(h)
    out = torch.empty(t_len, b, hsz, dtype=out_dtype, device=x_tm.device)
    starts = list(range(0, t_len, t_chunk))
    if reverse:              # the state flows from the later chunk backwards
        starts = starts[::-1]
    w_p, b_p = w_ih.t().to(pdt), bias.to(pdt)
    for s in starts:
        e = min(s + t_chunk, t_len)
        gates = F.linear(x_tm[s:e].to(pdt), w_p, b_p)
        out[s:e], h, c = lstm_scan_carry_tm(gates, w_hh, h, c, reverse,
                                            out_dtype)
    return out
