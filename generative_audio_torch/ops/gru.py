"""GRU recurrence over precomputed time-major x-side gates: CUDA kernels,
their plain PyTorch versions, and the autograd Function that trains through
them.

Port of three kernels of generative_audio_tpu/ops/pallas_lstm.py:
  * `gru_scan_tm` without grad (csrc/gru_scan.cu `gru_scan_fwd`) replaces
    `_gru_pallas_call` / `_gru_kernel`;
  * `gru_scan_carry_tm` (`gru_scan_fwd_carry`, the same template) replaces
    `_gru_pallas_call_carry` / `_gru_carry_kernel`, and
    `gru_layer_tm_chunked` chains it over time chunks as the JAX function of
    the same name does;
  * `gru_scan_bwd_tm` (csrc/gru_scan_bwd.cu) replaces `_gru_pallas_call_bwd`
    / `_gru_bwd_kernel`: the reverse-time backward that recomputes the
    h-side gates from the bf16 h sequence and emits bf16 dgates_x, dW_hh and
    db_hh. The TPU kernel accumulates dW_hh and db_hh in its own body, one
    partial per batch block; here `gru_scan_bwd` (wrapper
    `gru_scan_bwd_streams_tm`) writes the dgates streams and db_hh partials
    per 16-row block, a second hand-written kernel (`gru_scan_bwd_dwhh`,
    wrapper `gru_dwhh`) contracts the h sequence, shifted by one processing
    step, against the h-side dgates into dW_hh partials per slice of rows,
    and each wrapper sums its kernel's partials, as the JAX caller sums its
    blocks.
`GRUScan` is the counterpart of the JAX custom VJP (`_gru_fwd` / `_gru_bwd`):
forward = the forward kernel with bf16 output (the only residual beside the
inputs), backward = the two backward kernels. `gru_scan_tm` goes through it
whenever autograd is recording and an input requires grad.

Layouts follow the JAX package: gates_x [T, B, 3H] in torch gate order
(r, z, n) with b_ih already added, W_hh [H, 3H], b_hh [3H], h [T, B, H].
b_hh cannot be folded into gates_x, because the candidate gate is
n = tanh(x_n + r * (h @ W_hn + b_hn)).

Dispatch is by the device of the tensors: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version. There is no fallback from
one to the other. The plain versions repeat the kernels' numerics: bf16
gates upcast to fp32, fp32 h on chip, cast to bf16 only as the operand of
the product with bf16 W_hh, fp32 accumulation, fp32 b_hh; in the backward
bf16 h_seq, gout and dgates streams, fp32 dh, dW_hh and db_hh.

The launch counts are those of ops/lstm.py, and so is the launch helper;
`_launch` here appends the launch plan of the two forward entries, which
run as thread-block clusters: `plan_scan` picks the cluster size and the
rows per cluster from H, the row count, the shared-memory limit and the
card's `cudaOccupancyMaxActiveClusters`. `plan_dwhh` cuts the contraction's
rows into slices. Both planners are plain Python.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from generative_audio_torch.ops.lstm import (
    _PAD, SMEM_LIMIT, _check_kernel_operand, _check_kernel_sizes, _is_cuda,
    _kernel_operand, _wants_grad)
from generative_audio_torch.ops.lstm import _launch as _launch_entry

__all__ = ["gru_scan_tm", "gru_scan_reference_tm", "gru_scan_carry_tm",
           "gru_scan_carry_reference_tm", "gru_scan_bwd_streams_tm",
           "gru_scan_bwd_streams_reference_tm", "gru_dwhh",
           "gru_dwhh_reference", "shifted_rows", "gru_scan_bwd_tm",
           "gru_scan_bwd_reference_tm", "GRUScan", "gru_layer_tm_chunked",
           "ScanPlan", "scan_smem_bytes", "scan_step_us", "plan_scan",
           "card_scan_plan",
           "DwhhPlan", "plan_dwhh"]

# Batch rows per block of the backward scan, which writes one db_hh partial
# per block: the kernel is told the number of partials and refuses another
# count than its own grid.
_ROWS_PER_BLOCK = 16
_MAX_WARPS = 18            # warps per CTA of the forward scan, at most
# scan_step_us's parts (microseconds), fitted to the cluster scan's steps on
# an H100 SXM at 700 W: a step with one round of items, each further round
# of the busiest warp, and one 16-byte store of the h exchange.
_STEP_US, _ROUND_US, _STORE_US = 2.1, 2.7, 2.2e-3
# CTAs per cluster of the forward scan: 8 is the portable limit; the kernel
# opts in to 16, which an H100 allows.
CLUSTER_SIZES = (8, 16)
# The forward entries, whose C functions end in the launch plan.
_CLUSTER_ENTRIES = ("gru_scan_fwd", "gru_scan_fwd_carry")
# SMs of an H100 SXM: the contraction's tiles x slices fill about one wave.
H100_SMS = 132
# The contraction's output tile (csrc/gru_scan_bwd.cu DW_TM x DW_TN) and the
# rows of one pipeline stage, on which every slice begins (DW_TK).
_DW_TILE_ROWS, _DW_TILE_COLS, _DW_STAGE_ROWS = 128, 256, 64
# A slice of the contraction reads at least 8 times the bytes its fp32
# partial writes: rows * 4H * 2 B >= 8 * H * 3H * 4 B, so rows >= 12 H.
_DW_ROWS_PER_UNIT = 12


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """Launch plan of the forward scan (csrc/gru_scan.cu): clusters of
    `cluster` CTAs, each CTA owning H / cluster units, over `rows` batch
    rows per cluster (whole m16 tiles)."""
    cluster: int          # CTAs per cluster
    rows: int             # batch rows per cluster
    clusters: int         # clusters in the grid
    active: int           # clusters the card runs at once (occupancy)
    waves: int            # rounds of clusters, one after another
    smem_bytes: int       # dynamic shared memory of one CTA

    @property
    def launch_args(self) -> Tuple[int, int, int]:
        """The C entries' last arguments before the stream."""
        return self.cluster, self.rows, self.smem_bytes


def scan_smem_bytes(hsz: int, cluster: int, rows: int) -> int:
    """Shared memory of one CTA of the forward scan (csrc/gru_scan.cu
    `cluster_smem`): the W_hh^T slice [3U][H + 8] and two bf16 h buffers
    [rows][H + 8], the CTA's fp32 h [rows][U], its x-side gates of two
    steps [2][rows][3U] bf16 and b_hh slice [3U] fp32, with U = H / cluster
    units."""
    units, stride = hsz // cluster, hsz + _PAD
    return ((3 * units + 2 * rows) * stride * 2 + rows * units * 4
            + 2 * rows * 3 * units * 2 + 3 * units * 4)


def scan_step_us(hsz: int, cluster: int, rows: int) -> float:
    """Modelled time of one step of one wave of the forward scan: a step
    whose warps each take one m16 x 8-unit item (products, cell, cluster
    barrier, gates), each further round of items of the busiest warp (at
    most _MAX_WARPS warps), and the 16-byte stores of the h exchange (a CTA
    sends rows * U / 8 of them to each of its cluster - 1 peers)."""
    groups = hsz // cluster // 8
    rounds = -(-(rows // 16 * groups) // _MAX_WARPS)
    stores = rows * groups * (cluster - 1)
    return _STEP_US + (rounds - 1) * _ROUND_US + stores * _STORE_US


def plan_scan(hsz: int, batch: int, max_clusters: Callable[[int, int], int]
              ) -> ScanPlan:
    """The forward scan's cluster shape for `batch` rows at H = hsz.

    For each cluster size C of CLUSTER_SIZES that splits H into groups of 8
    units, and each row count R (whole m16 tiles) whose CTA fits in
    SMEM_LIMIT bytes, the clusters are balanced over the rows and
    `max_clusters(C, R)` (the card's cudaOccupancyMaxActiveClusters) says
    how many run at once. The plan minimises waves x scan_step_us; ties go
    to the smaller cluster, then to fewer clusters. Raises ValueError with
    each size's reason when nothing fits."""
    if batch < 1:
        raise ValueError(f"the scan needs at least one row, got {batch}")
    tiles = -(-batch // 16)
    best, refused = None, []
    for cluster in CLUSTER_SIZES:
        if hsz % (8 * cluster):
            refused.append(f"C={cluster}: H={hsz} is no multiple of "
                           f"{8 * cluster}")
            continue
        if scan_smem_bytes(hsz, cluster, 16) > SMEM_LIMIT:
            refused.append(f"C={cluster}: {scan_smem_bytes(hsz, cluster, 16)} "
                           f"bytes of shared memory at 16 rows, over "
                           f"{SMEM_LIMIT}")
            continue
        for per_cluster in range(1, tiles + 1):
            clusters = -(-tiles // per_cluster)
            rows = 16 * -(-tiles // clusters)        # balanced over clusters
            smem = scan_smem_bytes(hsz, cluster, rows)
            if smem > SMEM_LIMIT:
                break
            active = max_clusters(cluster, rows)
            if active < 1:
                refused.append(f"C={cluster}, R={rows}: the card runs no "
                               f"such cluster")
                continue
            waves = -(-clusters // active)
            key = (waves * scan_step_us(hsz, cluster, rows), cluster, clusters)
            if best is None or key < best[0]:
                best = (key, ScanPlan(cluster, rows, clusters, active, waves,
                                      smem))
    if best is None:
        raise ValueError(f"no cluster plan for the GRU scan at H={hsz}, "
                         f"{batch} rows: " + "; ".join(refused))
    return best[1]


@functools.lru_cache(maxsize=None)
def _max_clusters(device_index: int, out_f32: bool, carry: bool, hsz: int,
                  cluster: int, rows: int) -> int:
    """cudaOccupancyMaxActiveClusters of a forward scan instance on the card
    (csrc/gru_scan.cu `gru_scan_max_clusters`)."""
    from generative_audio_torch.ops import _cuda
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _cuda.load("gru_scan").gru_scan_max_clusters(
            int(out_f32), int(carry), hsz, cluster, rows, ctypes.byref(n))
    _cuda.check("gru_scan", err, "gru_scan_max_clusters")
    return n.value


@functools.lru_cache(maxsize=None)
def card_scan_plan(device: torch.device, hsz: int, batch: int,
                   out_dtype: torch.dtype = torch.bfloat16,
                   carry: bool = False) -> ScanPlan:
    """The plan the forward scan launches with on `device` (a CUDA device)
    for `batch` rows at H = hsz."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return plan_scan(hsz, batch, functools.partial(
        _max_clusters, index, out_dtype == torch.float32, carry, hsz))


def _launch(fn_name: str, *args) -> None:
    """Launch csrc entry `fn_name` through the port's launch helper. The
    forward entries are cluster launches: their arguments end in (out_f32,
    T, B, H, reverse), and card_scan_plan's plan for (H, B) on the tensors'
    card is appended to them."""
    if fn_name in _CLUSTER_ENTRIES:
        out_f32, _, b, hsz, _ = args[-5:]
        plan = card_scan_plan(args[0].device, hsz, b,
                              torch.float32 if out_f32 else torch.bfloat16,
                              fn_name == "gru_scan_fwd_carry")
        args = (*args, *plan.launch_args)
    _launch_entry(fn_name, *args)


@dataclasses.dataclass(frozen=True)
class DwhhPlan:
    """How the dW_hh contraction (csrc/gru_scan_bwd.cu) cuts its N rows:
    slice z takes rows [z * rows_per_slice, (z + 1) * rows_per_slice) of
    the first N (whole 64-row stages; the last slice may be shorter), one
    CTA per 128 x 256 output tile and slice."""
    tiles: int
    slices: int
    rows_per_slice: int


def plan_dwhh(n: int, hsz: int) -> DwhhPlan:
    """The contraction's slices over n >= 1 rows at H = hsz: as many as keep
    tiles x slices within one wave of H100_SMS and every slice at least
    12 H rows long, and at least one. Slices begin on whole stages and none
    is empty: rows_per_slice is what the kernel takes for the count,
    ceil(ceil(n / slices) / 64) * 64."""
    def per_slice(slices):
        return -(-(-(-n // slices)) // _DW_STAGE_ROWS) * _DW_STAGE_ROWS

    tiles = -(-hsz // _DW_TILE_ROWS) * (-(-2 * hsz // _DW_TILE_COLS)
                                       + -(-hsz // _DW_TILE_COLS))
    slices = max(1, min(H100_SMS // tiles, n // (_DW_ROWS_PER_UNIT * hsz)))
    slices = -(-n // per_slice(slices))           # no empty slice
    return DwhhPlan(tiles, slices, per_slice(slices))


def _scan_plain(gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                h: torch.Tensor, reverse: bool, compute_dtype: torch.dtype,
                out_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Python loop over T: -> (h sequence, h after the last step)."""
    t_len, b, g3 = gates.shape
    hsz = g3 // 3
    w = w_hh.to(compute_dtype).float()
    bias = b_hh.float()
    out = torch.empty(t_len, b, hsz, dtype=out_dtype, device=gates.device)
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        gates_h = h.to(compute_dtype).float() @ w + bias
        xr, xz, xn = gates[t].float().split(hsz, dim=-1)
        hr, hz, hn = gates_h.split(hsz, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        out[t] = h.to(out_dtype)
    return out, h


def gru_scan_reference_tm(gates_x: torch.Tensor, w_hh: torch.Tensor,
                          b_hh: torch.Tensor, reverse: bool = False,
                          compute_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """Plain version of the forward kernel: gates_x [T, B, 3H], w_hh [H, 3H],
    b_hh [3H] -> h sequence [T, B, H] fp32. With compute_dtype=torch.float32
    it is the full-precision recurrence (the JAX lax.scan path)."""
    b, hsz = gates_x.shape[1], w_hh.shape[0]
    zeros = torch.zeros(b, hsz, dtype=torch.float32, device=gates_x.device)
    return _scan_plain(gates_x, w_hh, b_hh, zeros, reverse, compute_dtype,
                       torch.float32)[0]


def gru_scan_carry_reference_tm(gates_x: torch.Tensor, w_hh: torch.Tensor,
                                b_hh: torch.Tensor, h0: torch.Tensor,
                                reverse: bool = False,
                                out_dtype: torch.dtype = torch.float32
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the carry kernel: as gru_scan_reference_tm from the
    state h0 [B, H] fp32 -> (h sequence, h_T)."""
    return _scan_plain(gates_x, w_hh, b_hh, h0.float(), reverse,
                       torch.bfloat16, out_dtype)


def gru_scan_bwd_streams_reference_tm(gates: torch.Tensor,
                                      h_seq: torch.Tensor,
                                      gout: torch.Tensor, w_hh: torch.Tensor,
                                      b_hh: torch.Tensor,
                                      reverse: bool = False
                                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """Plain version of `gru_scan_bwd`: -> (dgx [T, B, 3H] bf16, dhn
    [T, B, H] bf16, db_hh [3H] fp32). dgx = [dgr, dgz, dxn] is the cotangent
    of gates_x; the h-side dgates are [dgr, dgz, dhn]. Walks the forward's
    processing positions from the last to the first with dh in fp32,
    recomputing each step's h-side gates from h one processing step earlier
    (zero before the first)."""
    t_len, b, g3 = gates.shape
    hsz = g3 // 3
    w = w_hh.to(torch.bfloat16).float()
    bias = b_hh.float()
    zeros = torch.zeros(b, hsz, dtype=torch.float32, device=gates.device)
    dh = zeros
    dgx = torch.empty(t_len, b, g3, dtype=torch.bfloat16, device=gates.device)
    dhn_seq = torch.empty(t_len, b, hsz, dtype=torch.bfloat16,
                          device=gates.device)
    db = torch.zeros(g3, dtype=torch.float32, device=gates.device)
    for p in range(t_len - 1, -1, -1):
        t = t_len - 1 - p if reverse else p
        t_prev = t + 1 if reverse else t - 1
        h_prev = h_seq[t_prev].float() if p > 0 else zeros
        gates_h = h_prev @ w + bias
        xr, xz, xn = gates[t].float().split(hsz, dim=-1)
        hr, hz, hn = gates_h.split(hsz, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dh_tot = gout[t].float() + dh
        dn = dh_tot * (1.0 - z)
        dz = dh_tot * (h_prev - n)
        dxn = dn * (1.0 - n * n)
        dgr = dxn * hn * r * (1.0 - r)
        dgz = dz * z * (1.0 - z)
        dhn = dxn * r
        dgx[t] = torch.cat([dgr, dgz, dxn], dim=-1).to(torch.bfloat16)
        dgates_h = torch.cat([dgr, dgz, dhn], dim=-1)
        dhn_seq[t] = dhn.to(torch.bfloat16)
        db = db + dgates_h.sum(dim=0)
        dh = dgates_h.to(torch.bfloat16).float() @ w.t() + dh_tot * z
    return dgx, dhn_seq, db


def gru_dwhh_reference(h_prev: torch.Tensor, dgx: torch.Tensor,
                       dhn: torch.Tensor) -> torch.Tensor:
    """Plain version of `gru_scan_bwd_dwhh`: h_prev [N, H], dgx [N, 3H], dhn
    [N, H], all bf16 -> h_prev^T @ [dgx[:, :2H], dhn] as fp32 [H, 3H]."""
    hsz = h_prev.shape[-1]
    dgates_h = torch.cat([dgx[:, :2 * hsz], dhn], dim=-1)
    return h_prev.float().t() @ dgates_h.float()


def shifted_rows(h_seq: torch.Tensor, dgx: torch.Tensor, dhn: torch.Tensor,
                 reverse: bool):
    """The rows the dW_hh contraction pairs up: h one processing step
    earlier against the h-side dgates of every step but the first processed
    (which saw h = 0 and adds nothing). Contiguous slices, flattened to
    (h_prev [N, H], dgx [N, 3H], dhn [N, H]) with N = (T - 1) * B."""
    hsz = h_seq.shape[-1]
    if reverse:                         # processed t = T-1 .. 0
        h_prev, dg, dn = h_seq[1:], dgx[:-1], dhn[:-1]
    else:                               # processed t = 0 .. T-1
        h_prev, dg, dn = h_seq[:-1], dgx[1:], dhn[1:]
    return (h_prev.reshape(-1, hsz), dg.reshape(-1, 3 * hsz),
            dn.reshape(-1, hsz))


def gru_scan_bwd_reference_tm(gates: torch.Tensor, h_seq: torch.Tensor,
                              gout: torch.Tensor, w_hh: torch.Tensor,
                              b_hh: torch.Tensor, reverse: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of the whole backward. gates [T, B, 3H], h_seq and gout
    [T, B, H], all bf16, w_hh [H, 3H], b_hh [3H] -> (dgx [T, B, 3H] bf16,
    dW_hh [H, 3H] fp32, db_hh [3H] fp32): the cotangents of gates_x, w_hh
    and b_hh for the cotangent gout of h_seq."""
    dgx, dhn, db = gru_scan_bwd_streams_reference_tm(gates, h_seq, gout, w_hh,
                                                     b_hh, reverse)
    dw = gru_dwhh_reference(*shifted_rows(h_seq, dgx, dhn, reverse))
    return dgx, dw, db


def _check_shapes(gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  out_dtype: torch.dtype) -> Tuple[int, int, int]:
    if gates.ndim != 3 or gates.shape[-1] % 3:
        raise ValueError(f"gates must be [T, B, 3H], got {tuple(gates.shape)}")
    t_len, b, g3 = gates.shape
    hsz = g3 // 3
    if tuple(w_hh.shape) != (hsz, g3):
        raise ValueError(f"w_hh must be [{hsz}, {g3}], got {tuple(w_hh.shape)}")
    if b_hh.numel() != g3:
        raise ValueError(f"b_hh must hold {g3} values, got {tuple(b_hh.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    return t_len, b, hsz


def _kernel_weight(w_hh: torch.Tensor) -> torch.Tensor:
    """W_hh [H, 3H] -> the kernels' operand: [3H, H] bf16, contiguous (torch's
    weight_hh layout, so each MMA B fragment is one 32-bit load)."""
    return _kernel_operand(w_hh.t(), torch.bfloat16)


def _kernel_bias(b_hh: torch.Tensor) -> torch.Tensor:
    return _kernel_operand(b_hh.reshape(-1), torch.float32)


def gru_scan_tm(gates_x: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                reverse: bool = False,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """GRU recurrence, time-major: gates_x [T, B, 3H] (cast to bf16 as the
    kernel's input), w_hh [H, 3H], b_hh [3H] -> h sequence [T, B, H] in
    out_dtype. h starts at zero. CUDA tensors run the forward kernel; when
    autograd records and an input requires grad, the call goes through
    GRUScan instead, on either device."""
    t_len, b, hsz = _check_shapes(gates_x, w_hh, b_hh, out_dtype)
    if _wants_grad(gates_x, w_hh, b_hh):
        return GRUScan.apply(gates_x, w_hh, b_hh, reverse, out_dtype)
    gates = gates_x.to(torch.bfloat16)
    if not _is_cuda(gates, w_hh, b_hh):
        return gru_scan_reference_tm(gates, w_hh, b_hh, reverse).to(out_dtype)
    _check_kernel_sizes(hsz)
    _check_kernel_operand("gates_x", gates, torch.bfloat16)
    out = torch.empty(t_len, b, hsz, dtype=out_dtype, device=gates.device)
    if t_len and b:
        _launch("gru_scan_fwd", gates, _kernel_weight(w_hh),
                _kernel_bias(b_hh), out, out_dtype == torch.float32, t_len, b,
                hsz, reverse)
    return out


def gru_scan_carry_tm(gates_x: torch.Tensor, w_hh: torch.Tensor,
                      b_hh: torch.Tensor, h0: torch.Tensor,
                      reverse: bool = False,
                      out_dtype: torch.dtype = torch.bfloat16
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One time chunk with explicit state: gates_x [T, B, 3H], h0 [B, H]
    fp32 -> (h sequence [T, B, H] out_dtype, h_T fp32). With reverse=True
    the chunk is consumed back to front and h0 is the state arriving from
    the later chunk. CUDA tensors run the carry kernel. Not differentiable:
    under grad, gru_layer_tm_chunked takes GRUScan."""
    t_len, b, hsz = _check_shapes(gates_x, w_hh, b_hh, out_dtype)
    if tuple(h0.shape) != (b, hsz):
        raise ValueError(f"h0 must be [{b}, {hsz}], got {tuple(h0.shape)}")
    gates = gates_x.to(torch.bfloat16)
    if not _is_cuda(gates, w_hh, b_hh, h0):
        return gru_scan_carry_reference_tm(gates, w_hh, b_hh, h0, reverse,
                                           out_dtype)
    _check_kernel_sizes(hsz)
    _check_kernel_operand("gates_x", gates, torch.bfloat16)
    _check_kernel_operand("h0", h0, torch.float32)
    out = torch.empty(t_len, b, hsz, dtype=out_dtype, device=gates.device)
    if not (t_len and b):
        return out, h0.clone()
    h_t = torch.empty_like(h0)
    _launch("gru_scan_fwd_carry", gates, _kernel_weight(w_hh),
            _kernel_bias(b_hh), h0, out, h_t, out_dtype == torch.float32,
            t_len, b, hsz, reverse)
    return out, h_t


def gru_scan_bwd_streams_tm(gates: torch.Tensor, h_seq: torch.Tensor,
                            gout: torch.Tensor, w_hh: torch.Tensor,
                            b_hh: torch.Tensor, reverse: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The backward scan: bf16 gates [T, B, 3H], the forward's bf16 h_seq and
    the cotangent gout of h_seq, both [T, B, H] bf16, w_hh [H, 3H], b_hh [3H]
    -> (dgx [T, B, 3H] bf16, dhn [T, B, H] bf16, db_hh [3H] fp32). CUDA
    tensors run `gru_scan_bwd`, which writes one db_hh partial per 16-row
    block; the partials are summed here."""
    t_len, b, hsz = _check_shapes(gates, w_hh, b_hh, torch.bfloat16)
    for name, x in (("h_seq", h_seq), ("gout", gout)):
        if tuple(x.shape) != (t_len, b, hsz):
            raise ValueError(f"{name} must be [{t_len}, {b}, {hsz}], got "
                             f"{tuple(x.shape)}")
    if not _is_cuda(gates, h_seq, gout, w_hh, b_hh):
        return gru_scan_bwd_streams_reference_tm(
            gates.to(torch.bfloat16), h_seq.to(torch.bfloat16),
            gout.to(torch.bfloat16), w_hh, b_hh, reverse)
    _check_kernel_sizes(hsz)
    for name, x in (("gates", gates), ("h_seq", h_seq), ("gout", gout)):
        _check_kernel_operand(name, x, torch.bfloat16)
    dgx, dhn = torch.empty_like(gates), torch.empty_like(h_seq)
    if not (t_len and b):
        return dgx, dhn, torch.zeros(3 * hsz, device=gates.device)
    db_blocks = torch.empty(-(-b // _ROWS_PER_BLOCK), 3 * hsz,
                            dtype=torch.float32, device=gates.device)
    # W_hh in both layouts: [3H, H] for the gates recompute, [H, 3H] (the 3H
    # axis contiguous) for dgates_h @ W_hh^T
    _launch("gru_scan_bwd", gates, h_seq, gout, _kernel_weight(w_hh),
            _kernel_operand(w_hh, torch.bfloat16), _kernel_bias(b_hh), dgx,
            dhn, db_blocks, db_blocks.shape[0], t_len, b, hsz, reverse)
    return dgx, dhn, db_blocks.sum(dim=0)


def gru_dwhh(h_prev: torch.Tensor, dgx: torch.Tensor, dhn: torch.Tensor
             ) -> torch.Tensor:
    """The dW_hh contraction: h_prev [N, H], dgx [N, 3H], dhn [N, H], all
    bf16 (see shifted_rows) -> h_prev^T @ [dgx[:, :2H], dhn] as fp32
    [H, 3H]. CUDA tensors run `gru_scan_bwd_dwhh`, which writes one partial
    per slice of the N rows (plan_dwhh); the partials are summed here in a
    fixed order, so a result repeats bit for bit. The kernel reads its
    operands through TMA descriptors: they must be contiguous and 16-byte
    aligned, as shifted_rows' views of contiguous streams are."""
    n, hsz = h_prev.shape
    if tuple(dgx.shape) != (n, 3 * hsz) or tuple(dhn.shape) != (n, hsz):
        raise ValueError(f"dgx must be [{n}, {3 * hsz}] and dhn [{n}, {hsz}], "
                         f"got {tuple(dgx.shape)} and {tuple(dhn.shape)}")
    if not _is_cuda(h_prev, dgx, dhn):
        return gru_dwhh_reference(h_prev, dgx, dhn)
    if not n:
        return torch.zeros(hsz, 3 * hsz, device=h_prev.device)
    _check_kernel_sizes(hsz)
    for name, x in (("h_prev", h_prev), ("dgx", dgx), ("dhn", dhn)):
        _check_kernel_operand(name, x, torch.bfloat16)
    plan = plan_dwhh(n, hsz)
    slices = torch.empty(plan.slices, hsz, 3 * hsz, dtype=torch.float32,
                         device=h_prev.device)
    _launch("gru_scan_bwd_dwhh", h_prev, dgx, dhn, slices, n, hsz,
            plan.slices)
    return slices.sum(dim=0)


def gru_scan_bwd_tm(gates: torch.Tensor, h_seq: torch.Tensor,
                    gout: torch.Tensor, w_hh: torch.Tensor,
                    b_hh: torch.Tensor, reverse: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole backward: operands as gru_scan_bwd_streams_tm -> (dgx
    [T, B, 3H] bf16, dW_hh [H, 3H] fp32, db_hh [3H] fp32): the scan, then
    the contraction of its streams with the shifted h sequence. With T = 1
    the only step saw h = 0, dW_hh is zero and nothing is contracted."""
    dgx, dhn, db = gru_scan_bwd_streams_tm(gates, h_seq, gout, w_hh, b_hh,
                                           reverse)
    return dgx, gru_dwhh(*shifted_rows(h_seq, dgx, dhn, reverse)), db


class GRUScan(torch.autograd.Function):
    """gru_scan_tm with a gradient: (gates_x [T, B, 3H], w_hh [H, 3H], b_hh
    [3H], reverse, out_dtype) -> h sequence [T, B, H] in out_dtype.

    Forward is the forward kernel with bf16 output and saves the bf16 gates,
    W_hh, b_hh and that h sequence. Backward is gru_scan_bwd_tm on the
    cotangent rounded to bf16. Returns dgates in gates_x's dtype, dW_hh in
    w_hh's and db_hh in b_hh's. On CPU tensors the kernels are their plain
    versions. (torch.autograd.gradcheck does not apply: the bf16 roundings
    make the function piecewise constant at gradcheck's step sizes.)"""

    @staticmethod
    def forward(ctx, gates_x, w_hh, b_hh, reverse, out_dtype):
        gates = gates_x.to(torch.bfloat16).contiguous()
        h_seq = gru_scan_tm(gates, w_hh, b_hh, reverse, torch.bfloat16)
        ctx.save_for_backward(gates, w_hh, b_hh, h_seq)
        ctx.reverse = reverse
        ctx.gates_dtype = gates_x.dtype
        return h_seq.to(out_dtype)

    @staticmethod
    def backward(ctx, gout):
        gates, w_hh, b_hh, h_seq = ctx.saved_tensors
        dgx, dw_hh, db_hh = gru_scan_bwd_tm(
            gates, h_seq, gout.to(torch.bfloat16).contiguous(), w_hh, b_hh,
            ctx.reverse)
        return (dgx.to(ctx.gates_dtype), dw_hh.to(w_hh.dtype),
                db_hh.reshape(b_hh.shape).to(b_hh.dtype), None, None)


def gru_layer_tm_chunked(x_tm: torch.Tensor, w_ih: torch.Tensor,
                         w_hh: torch.Tensor, b_ih: torch.Tensor,
                         b_hh: torch.Tensor, reverse: bool = False,
                         t_chunk: int = 128,
                         out_dtype: torch.dtype = torch.bfloat16,
                         proj_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Whole GRU layer, time-major, with the input projection hoisted one
    time chunk at a time: x_tm [T, B, F], w_ih [F, 3H], w_hh [H, 3H], b_ih,
    b_hh [3H] -> [T, B, H]. Only one chunk's [t_chunk, B, 3H] gates exist at
    a time. The projection runs in proj_dtype (default: bf16 on CUDA, float32
    on the CPU, as the JAX function's TPU and interpret modes do); the gates
    enter the scan as bf16 either way, so for the same gates the result is
    bit-identical to gru_scan_tm. Under grad the backward needs the whole
    gates buffer anyway, so the call takes the full hoisted projection and
    GRUScan, as the JAX function's VJP does."""
    t_len, b, _ = x_tm.shape
    hsz = w_hh.shape[0]
    pdt = proj_dtype or (torch.bfloat16 if x_tm.is_cuda else torch.float32)
    w_p, b_p = w_ih.t().to(pdt), b_ih.to(pdt)
    if _wants_grad(x_tm, w_ih, w_hh, b_ih, b_hh):
        gates = F.linear(x_tm.to(pdt), w_p, b_p)
        return GRUScan.apply(gates, w_hh, b_hh, reverse, out_dtype)
    h = torch.zeros(b, hsz, dtype=torch.float32, device=x_tm.device)
    out = torch.empty(t_len, b, hsz, dtype=out_dtype, device=x_tm.device)
    starts = list(range(0, t_len, t_chunk))
    if reverse:              # the state flows from the later chunk backwards
        starts = starts[::-1]
    for s in starts:
        e = min(s + t_chunk, t_len)
        gates = F.linear(x_tm[s:e].to(pdt), w_p, b_p)
        out[s:e], h = gru_scan_carry_tm(gates, w_hh, b_hh, h, reverse,
                                        out_dtype)
    return out
