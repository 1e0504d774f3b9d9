"""LSTM recurrence over precomputed time-major gates: CUDA kernels, their
plain PyTorch versions, and the autograd Function that trains through them.

Port of four kernels of generative_audio_tpu/ops/pallas_lstm.py:
  * `lstm_scan_tm` without grad (kernel A, csrc/lstm_scan.cu `lstm_scan_fwd`)
    replaces `_lstm_pallas_call` / `_lstm_kernel`;
  * `lstm_scan_carry_tm` (kernel B, `lstm_scan_fwd_carry`) replaces
    `_lstm_pallas_call_carry` / `_lstm_carry_kernel`, and
    `lstm_layer_tm_chunked` chains it over time chunks as the JAX function
    of the same name does;
  * `lstm_scan_train_tm` (kernel C, `lstm_scan_fwd_train`) replaces
    `_lstm_pallas_call_train` / `_lstm_train_kernel`: kernel A that also
    writes the bf16 c sequence;
  * `lstm_scan_bwd_tm` (kernel D, csrc/lstm_scan_bwd.cu `lstm_scan_bwd`)
    replaces `_lstm_pallas_call_bwd` / `_lstm_bwd_kernel`: the reverse-time
    backward that recomputes the gates and emits bf16 dgates.
`LSTMScan` is the counterpart of the JAX custom VJP (`_lstm_fwd` /
`_lstm_bwd`): forward = kernel C, backward = kernel D plus dW_hh as one
contraction outside the kernel. `lstm_scan_tm` goes through it whenever
autograd is recording and an input requires grad.

Layouts follow the JAX package: gates [T, B, 4H] in torch gate order
(i, f, g, o) with the biases already added, W_hh [H, 4H], h [T, B, H].

Dispatch is by the device of the tensors: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version. There is no fallback from
one to the other. The plain versions repeat the kernels' numerics: bf16
gates upcast to fp32, h cast to bf16 before the product with bf16 W_hh,
fp32 accumulation, fp32 c, dh and dc; bf16 h_seq, c_seq, gout and dgates.

`launch_counts` counts kernel launches by kernel name; `_launch` adds one
exactly where it launches, so a run can show that the path went through
the kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["lstm_scan_tm", "lstm_scan_reference_tm", "lstm_scan_carry_tm",
           "lstm_scan_carry_reference_tm", "lstm_scan_train_tm",
           "lstm_scan_train_reference_tm", "lstm_scan_bwd_tm",
           "lstm_scan_bwd_reference_tm", "LSTMScan", "lstm_layer_tm_chunked",
           "launch_counts", "reset_launch_counts"]

# kernel entry -> the csrc source that holds it
_SOURCE_OF = {"lstm_scan_fwd": "lstm_scan", "lstm_scan_fwd_carry": "lstm_scan",
              "lstm_scan_fwd_train": "lstm_scan",
              "lstm_scan_bwd": "lstm_scan_bwd"}
launch_counts = dict.fromkeys(_SOURCE_OF, 0)


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _scan_plain(gates: torch.Tensor, w_hh: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor, reverse: bool, compute_dtype: torch.dtype,
                out_dtype: torch.dtype, c_seq: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Python loop over T: -> (h sequence, h after the last step, c after it).
    With c_seq [T, B, H], c_t is also written there, rounded to its dtype."""
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
        if c_seq is not None:
            c_seq[t] = c.to(c_seq.dtype)
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


def lstm_scan_train_reference_tm(gates: torch.Tensor, w_hh: torch.Tensor,
                                 reverse: bool = False
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel C: bf16 gates [T, B, 4H], w_hh [H, 4H] ->
    (h_seq, c_seq) [T, B, H] bf16. h_seq is lstm_scan_reference_tm's result
    rounded to bf16; c_seq is the fp32 cell state rounded once per step."""
    t_len, b, hsz = gates.shape[0], gates.shape[1], w_hh.shape[0]
    zeros = torch.zeros(b, hsz, dtype=torch.float32, device=gates.device)
    c_seq = torch.empty(t_len, b, hsz, dtype=torch.bfloat16,
                        device=gates.device)
    h_seq = _scan_plain(gates, w_hh, zeros, zeros, reverse, torch.bfloat16,
                        torch.bfloat16, c_seq)[0]
    return h_seq, c_seq


def lstm_scan_bwd_reference_tm(gates: torch.Tensor, h_seq: torch.Tensor,
                               c_seq: torch.Tensor, gout: torch.Tensor,
                               w_hh: torch.Tensor, reverse: bool = False
                               ) -> torch.Tensor:
    """Plain version of kernel D. gates [T, B, 4H], h_seq, c_seq, gout
    [T, B, H], all bf16, w_hh [H, 4H] -> dgates [T, B, 4H] bf16: the
    cotangent of the gates for the cotangent gout of h_seq. Walks the
    forward's processing positions from the last to the first with dh and dc
    in fp32, recomputing each step's gates from h one processing step
    earlier (zero before the first)."""
    t_len, b, g4 = gates.shape
    hsz = g4 // 4
    w = w_hh.to(torch.bfloat16).float()
    zeros = torch.zeros(b, hsz, dtype=torch.float32, device=gates.device)
    dh, dc = zeros, zeros
    dgates = torch.empty(t_len, b, g4, dtype=torch.bfloat16,
                         device=gates.device)
    for p in range(t_len - 1, -1, -1):
        t = t_len - 1 - p if reverse else p
        t_prev = t + 1 if reverse else t - 1
        h_prev = h_seq[t_prev].float() if p > 0 else zeros
        c_prev = c_seq[t_prev].float() if p > 0 else zeros
        z = gates[t].float() + h_prev @ w
        i, f, g, o = z.split(hsz, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        tanh_c = torch.tanh(c_seq[t].float())
        dh_tot = gout[t].float() + dh
        dc_tot = dc + dh_tot * o * (1.0 - tanh_c * tanh_c)
        dg = torch.cat([dc_tot * g * i * (1.0 - i),
                        dc_tot * c_prev * f * (1.0 - f),
                        dc_tot * i * (1.0 - g * g),
                        dh_tot * tanh_c * o * (1.0 - o)],
                       dim=-1).to(torch.bfloat16)
        dgates[t] = dg
        dc = dc_tot * f
        dh = dg.float() @ w.t()
    return dgates


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
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _kernel_weight(w_hh: torch.Tensor) -> torch.Tensor:
    """W_hh [H, 4H] -> the kernel's operand: [4H, H] bf16, contiguous (torch's
    weight_hh layout, so each MMA B fragment is one 32-bit load)."""
    return w_hh.t().to(torch.bfloat16).contiguous()


def _launch(fn_name: str, *args) -> None:
    """Launch csrc entry `fn_name` on the tensors' device and current stream.
    `args` are the C function's arguments in order, without the stream:
    tensors (passed as their data pointers) and ints."""
    from generative_audio_torch.ops import _cuda

    source = _SOURCE_OF[fn_name]
    lib = _cuda.load(source)
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    raw = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
           for a in args]
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(*raw, _cuda.stream_handle(device))
    _cuda.check(source, err, fn_name)
    launch_counts[fn_name] += 1


def _check_kernel_sizes(hsz: int) -> None:
    if hsz % 16:
        raise ValueError(f"the CUDA LSTM kernel needs H % 16 == 0, got H={hsz}")


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_scan_tm(gates_x: torch.Tensor, w_hh: torch.Tensor,
                 reverse: bool = False,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """LSTM recurrence, time-major: gates_x [T, B, 4H] (cast to bf16 as the
    kernel's input), w_hh [H, 4H] -> h sequence [T, B, H] in out_dtype.
    h and c start at zero. CUDA tensors run kernel A; when autograd records
    and an input requires grad, the call goes through LSTMScan (kernels C
    and D) instead, on either device."""
    t_len, b, hsz = _check_shapes(gates_x, w_hh, out_dtype)
    if _wants_grad(gates_x, w_hh):
        return LSTMScan.apply(gates_x, w_hh, reverse, out_dtype)
    gates = gates_x.to(torch.bfloat16)
    if not _is_cuda(gates, w_hh):
        return lstm_scan_reference_tm(gates, w_hh, reverse).to(out_dtype)
    _check_kernel_sizes(hsz)
    _check_kernel_operand("gates_x", gates, torch.bfloat16)
    out = torch.empty(t_len, b, hsz, dtype=out_dtype, device=gates.device)
    if t_len and b:
        _launch("lstm_scan_fwd", gates, _kernel_weight(w_hh), out,
                out_dtype == torch.float32, t_len, b, hsz, reverse)
    return out


def lstm_scan_carry_tm(gates_x: torch.Tensor, w_hh: torch.Tensor,
                       h0: torch.Tensor, c0: torch.Tensor,
                       reverse: bool = False,
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One time chunk with explicit state: gates_x [T, B, 4H], h0, c0 [B, H]
    fp32 -> (h sequence [T, B, H] out_dtype, h_T, c_T fp32). With
    reverse=True the chunk is consumed back to front and (h0, c0) is the
    state arriving from the later chunk. CUDA tensors run kernel B. Not
    differentiable: under grad, lstm_layer_tm_chunked takes LSTMScan."""
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
    _launch("lstm_scan_fwd_carry", gates, _kernel_weight(w_hh), h0, c0, out,
            h_t, c_t, out_dtype == torch.float32, t_len, b, hsz, reverse)
    return out, h_t, c_t


def lstm_scan_train_tm(gates: torch.Tensor, w_hh: torch.Tensor,
                       reverse: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: bf16 gates [T, B, 4H], w_hh [H, 4H] ->
    (h_seq, c_seq) [T, B, H] bf16, the residuals lstm_scan_bwd_tm needs.
    h_seq equals lstm_scan_tm's bf16 output bit for bit. CUDA tensors run
    kernel C."""
    t_len, b, hsz = _check_shapes(gates, w_hh, torch.bfloat16)
    if not _is_cuda(gates, w_hh):
        return lstm_scan_train_reference_tm(gates.to(torch.bfloat16), w_hh,
                                            reverse)
    _check_kernel_sizes(hsz)
    _check_kernel_operand("gates", gates, torch.bfloat16)
    h_seq = torch.empty(t_len, b, hsz, dtype=torch.bfloat16,
                        device=gates.device)
    c_seq = torch.empty_like(h_seq)
    if t_len and b:
        _launch("lstm_scan_fwd_train", gates, _kernel_weight(w_hh), h_seq,
                c_seq, t_len, b, hsz, reverse)
    return h_seq, c_seq


def lstm_scan_bwd_tm(gates: torch.Tensor, h_seq: torch.Tensor,
                     c_seq: torch.Tensor, gout: torch.Tensor,
                     w_hh: torch.Tensor, reverse: bool = False
                     ) -> torch.Tensor:
    """The backward scan: bf16 gates [T, B, 4H], the residuals h_seq and
    c_seq of lstm_scan_train_tm and the cotangent gout of h_seq, all
    [T, B, H] bf16, w_hh [H, 4H] -> dgates [T, B, 4H] bf16. CUDA tensors run
    kernel D."""
    t_len, b, hsz = _check_shapes(gates, w_hh, torch.bfloat16)
    for name, x in (("h_seq", h_seq), ("c_seq", c_seq), ("gout", gout)):
        if tuple(x.shape) != (t_len, b, hsz):
            raise ValueError(f"{name} must be [{t_len}, {b}, {hsz}], got "
                             f"{tuple(x.shape)}")
    if not _is_cuda(gates, h_seq, c_seq, gout, w_hh):
        return lstm_scan_bwd_reference_tm(
            gates.to(torch.bfloat16), h_seq.to(torch.bfloat16),
            c_seq.to(torch.bfloat16), gout.to(torch.bfloat16), w_hh, reverse)
    _check_kernel_sizes(hsz)
    for name, x in (("gates", gates), ("h_seq", h_seq), ("c_seq", c_seq),
                    ("gout", gout)):
        _check_kernel_operand(name, x, torch.bfloat16)
    dgates = torch.empty_like(gates)
    if t_len and b:
        # W_hh in both layouts: [4H, H] for the gates recompute, [H, 4H]
        # (the 4H axis contiguous) for dgates @ W_hh^T
        _launch("lstm_scan_bwd", gates, h_seq, c_seq, gout,
                _kernel_weight(w_hh), w_hh.to(torch.bfloat16).contiguous(),
                dgates, t_len, b, hsz, reverse)
    return dgates


def _contract_rows_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, P], b [N, Q], both bf16 -> a^T @ b [P, Q] in fp32: bf16 operands,
    fp32 accumulation and fp32 output (a plain matmul outside the kernels)."""
    if a.is_cuda:
        return torch.mm(a.t(), b, out_dtype=torch.float32)
    return a.float().t() @ b.float()


class LSTMScan(torch.autograd.Function):
    """lstm_scan_tm with a gradient: (gates_x [T, B, 4H], w_hh [H, 4H],
    reverse, out_dtype) -> h sequence [T, B, H] in out_dtype.

    Forward is lstm_scan_train_tm (kernel C) and saves the bf16 gates, W_hh
    and the bf16 h and c sequences. Backward is lstm_scan_bwd_tm (kernel D)
    on the cotangent rounded to bf16, then dW_hh = sum_t h_prev[t]^T @
    dgates[t] with h_prev one processing step earlier (the first processed
    step saw h = 0 and adds nothing), as one contraction with fp32 output.
    Returns dgates in gates_x's dtype and dW_hh in w_hh's. On CPU tensors
    both kernels are their plain versions. (torch.autograd.gradcheck does
    not apply: the bf16 roundings make the function piecewise constant at
    gradcheck's step sizes.)"""

    @staticmethod
    def forward(ctx, gates_x, w_hh, reverse, out_dtype):
        gates = gates_x.to(torch.bfloat16).contiguous()
        h_seq, c_seq = lstm_scan_train_tm(gates, w_hh, reverse)
        ctx.save_for_backward(gates, w_hh, h_seq, c_seq)
        ctx.reverse = reverse
        ctx.gates_dtype = gates_x.dtype
        return h_seq.to(out_dtype)

    @staticmethod
    def backward(ctx, gout):
        gates, w_hh, h_seq, c_seq = ctx.saved_tensors
        dgates = lstm_scan_bwd_tm(gates, h_seq, c_seq,
                                  gout.to(torch.bfloat16).contiguous(), w_hh,
                                  ctx.reverse)
        dw_hh = None
        if ctx.needs_input_grad[1]:
            if ctx.reverse:                 # processed t = T-1 .. 0
                h_prev, dg = h_seq[1:], dgates[:-1]
            else:                           # processed t = 0 .. T-1
                h_prev, dg = h_seq[:-1], dgates[1:]
            hsz = w_hh.shape[0]
            dw_hh = _contract_rows_f32(h_prev.reshape(-1, hsz),
                                       dg.reshape(-1, 4 * hsz)).to(w_hh.dtype)
        return dgates.to(ctx.gates_dtype), dw_hh, None, None


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
    result is bit-identical to lstm_scan_tm. Under grad the backward needs
    the whole gates buffer anyway, so the call takes the full hoisted
    projection and LSTMScan, as the JAX function's VJP does."""
    t_len, b, _ = x_tm.shape
    hsz = w_hh.shape[0]
    pdt = proj_dtype or (torch.bfloat16 if x_tm.is_cuda else torch.float32)
    w_p, b_p = w_ih.t().to(pdt), bias.to(pdt)
    if _wants_grad(x_tm, w_ih, w_hh, bias):
        gates = F.linear(x_tm.to(pdt), w_p, b_p)
        return LSTMScan.apply(gates, w_hh, reverse, out_dtype)
    h = torch.zeros(b, hsz, dtype=torch.float32, device=x_tm.device)
    c = torch.zeros_like(h)
    out = torch.empty(t_len, b, hsz, dtype=out_dtype, device=x_tm.device)
    starts = list(range(0, t_len, t_chunk))
    if reverse:              # the state flows from the later chunk backwards
        starts = starts[::-1]
    for s in starts:
        e = min(s + t_chunk, t_len)
        gates = F.linear(x_tm[s:e].to(pdt), w_p, b_p)
        out[s:e], h, c = lstm_scan_carry_tm(gates, w_hh, h, c, reverse,
                                            out_dtype)
    return out
