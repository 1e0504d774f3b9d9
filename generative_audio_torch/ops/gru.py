"""GRU recurrence over precomputed time-major x-side gates: CUDA kernels,
their plain PyTorch versions, and the autograd Function that trains through
them.

Port of three kernels of generative_audio_tpu/ops/pallas_lstm.py:
  * `gru_scan_tm` without grad (csrc/gru_scan.cu `gru_scan_fwd`; at the
    sub-band batch csrc/gru_scan_wide.cu `gru_scan_fwd_wide`) replaces
    `_gru_pallas_call` / `_gru_kernel`;
  * `gru_scan_carry_tm` (`gru_scan_fwd_carry`, the same template, or
    `gru_scan_fwd_carry_wide`) replaces
    `_gru_pallas_call_carry` / `_gru_carry_kernel`, and
    `gru_layer_tm_chunked` chains it over time chunks as the JAX function of
    the same name does;
  * `gru_scan_bwd_tm` (csrc/gru_scan_bwd.cu; at the sub-band batch
    csrc/gru_scan_bwd_wide.cu `gru_scan_bwd_wide`, above H = 512
    csrc/scan_bwd_stream.cu `gru_scan_bwd_stream`) replaces
    `_gru_pallas_call_bwd` / `_gru_bwd_kernel`: the reverse-time backward
    that recomputes the h-side gates from the bf16 h sequence and emits
    bf16 dgates_x, dW_hh and db_hh. The TPU kernel accumulates dW_hh and db_hh in its own body, one
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
run as thread-block clusters: `plan_scan` (ops/lstm.py's
`plan_cluster_scan` with this kernel's layout and step model) picks the
cluster size and the rows per cluster from H, the row count, the
shared-memory limit and the card's `cudaOccupancyMaxActiveClusters`.
Where a resident cluster holds H, the forwards have a second design, the
wide cluster (csrc/gru_scan_wide.cu, entries ending in `_wide`: kernel
A's wide design of csrc/lstm_scan_wide.cu with the GRU cell, each step's
product on wgmma with a fourth gate row of zeros a unit, W_hh^T streamed
from L2 through a ring, so that up to 160 rows fit a cluster), the same
bits; the route takes whichever has the least modelled waves x step on the
card (`plan_gru_wide_scan`, `card_gru_wide_plan`, `gru_wide_step_us`), and
ops/lstm.py's `wide_forwards()` / `resident_forwards()` force either here
too. The wrapper packs W_hh for the plan (ops/lstm.py `_wide_weight` with
three gates) and `_launch` appends it.
The backward scan runs as a thread-block cluster, as the single-block
design, up to H = 512 as a wide cluster (csrc/gru_scan_bwd_wide.cu
`gru_scan_bwd_wide`: both products on wgmma with a warpgroup a 64 rows,
the dgh exchange read back from L2 by TMA, h_prev, the dgh pieces and
both W_hh operands through one ring, so that up to 192 rows fit a cluster
of 8; its own plan, `GruBwdWidePlan`, `plan_bwd_wide_scan`, and packers,
`_wide_bwd_weights`) or, above H = 512, as a streamed cluster
(csrc/scan_bwd_stream.cu `gru_scan_bwd_stream`), all the same bits,
whichever ops/lstm.py `plan_bwd` models fastest on the card: the wrapper
asks `card_bwd_scan_plan` first and packs W_hh for a wide or streamed
plan; `_launch` appends the plan. `wide_backwards()` and
`resident_backwards()` of ops/lstm.py force either design here too.
`plan_dwhh` cuts the contraction's rows into slices by a model of the
card (`dwhh_us`), `plan_dwhh_first` as the first design did. The planners
are plain Python.

Any H runs on the card, as for the LSTM: the wrappers zero-pad H to the
units their kernel takes (`scan_hidden` for the cluster forward, whole
16-deep k-steps for the backward and the contraction; nothing at H = 384
and 512) and slice the result back; above H = 640, where no cluster holds
W_hh's slice, the forward takes ops/lstm.py `plan_forward`'s route: the
streamed variant of the cluster (csrc/gru_scan.cu, entries ending in
`_stream`, plan `plan_stream_scan` / `card_stream_plan`) or the single
block (csrc/gru_scan_block.cu, at H padded to 16), whichever has the least
waves x modelled step; the backward scan's streamed cluster runs at H
padded to `stream_hidden`, up to H = 2304. A padded unit sees zero gates,
weights
and b_hh, so n = tanh(0 + r * 0) = 0 and it stays at h = 0, adds exact
zeros to the real units' sums and gets zero dgates.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from generative_audio_torch.ops.lstm import (
    _BWD_RESIDENT_MAX, _PAD, _ROWS, _STEP_UNITS, CLUSTER_SIZES, H100_SMS,
    SMEM_LIMIT, BwdPlan, BwdStreamPlan, ScanPlan, StreamBwdClusters,
    StreamPlan, WideBwdClusters, WidePlan, _bwd_design, _bwd_hidden,
    _card_stream_bwd_clusters, _check_kernel_operand, _device_index,
    _device_sms, _fragment_weight, _is_cuda, _kernel_operand,
    _kernel_weight, _max_clusters, _on_card, _pad_gates, _pad_units,
    _padded_weight, _wide_args,
    _resident_occupancy, _route_weight, _stream_args, _stream_dh_weight,
    _stream_weight, _unpad_gates, _unpad_units, _wants_grad,
    block_forward_step_us, bwd_cluster_smem_bytes, bwd_cluster_step_us,
    bwd_stream_cluster_step_us, card_bwd_plan, card_plan, card_stream,
    bwd_stream_cluster_smem_bytes,
    cluster_hidden, cluster_step_us, mixed_gates, plan_bwd,
    plan_bwd_stream, plan_cluster_scan,
    plan_forward, plan_stream, plan_wide_scan, resident_backwards, sm_blocks,
    stream_cluster_step_us, stream_fixed_bytes, wide_smem_bytes, wide_step_us)
from generative_audio_torch.ops.lstm import _launch as _launch_entry

__all__ = ["gru_scan_tm", "gru_scan_reference_tm", "gru_scan_carry_tm",
           "gru_scan_carry_reference_tm", "gru_scan_bwd_streams_tm",
           "gru_scan_bwd_streams_reference_tm", "gru_dwhh",
           "gru_dwhh_reference", "shifted_rows", "gru_scan_bwd_tm",
           "gru_scan_bwd_reference_tm", "GRUScan", "gru_layer_tm_chunked",
           "ScanPlan", "scan_smem_bytes", "scan_step_us", "plan_scan",
           "scan_hidden", "card_scan_plan", "DwhhPlan", "plan_dwhh",
           "gru_scan_bwd_streams_planned_tm", "bwd_block_smem_bytes",
           "bwd_smem_bytes_cluster", "bwd_step_us", "plan_bwd_scan",
           "card_bwd_scan_plan", "block_smem_bytes", "stream_smem_bytes",
           "stream_step_us", "plan_stream_scan", "card_stream_plan",
           "block_step_us", "BwdStreamPlan", "bwd_stream_smem_bytes",
           "bwd_stream_step_us", "plan_bwd_stream_scan",
           "card_bwd_stream_plan", "bwd_wide_smem_bytes", "bwd_wide_step_us",
           "plan_bwd_wide_scan", "card_bwd_wide_plan", "GruBwdWidePlan",
           "bwd_wide_hidden", "dwhh_us",
           "plan_dwhh_first", "WidePlan", "gru_wide_smem_bytes",
           "gru_wide_step_us", "plan_gru_wide_scan", "card_gru_wide_plan"]

# Batch rows per block of the backward scan, which writes one db_hh partial
# per block: the kernel is told the number of partials and refuses another
# count than its own grid.
_ROWS_PER_BLOCK = 16
# scan_step_us's parts (microseconds), fitted to the cluster scan's steps on
# an H100 SXM at 700 W: a step with one round of items, each further round
# of the busiest warp, and one 16-byte store of the h exchange.
_STEP_US, _ROUND_US, _STORE_US = 2.1, 2.7, 2.2e-3
# The forward entries, whose C functions end in the launch plan, and their
# streamed variants, whose C functions end in a StreamPlan's.
_CLUSTER_ENTRIES = ("gru_scan_fwd", "gru_scan_fwd_carry")
_STREAM_ENTRIES = ("gru_scan_fwd_stream", "gru_scan_fwd_carry_stream")
# The wide cluster's entries, whose C functions end in a WidePlan's (three
# gates).
_WIDE_ENTRIES = ("gru_scan_fwd_wide", "gru_scan_fwd_carry_wide")
# gru_wide_step_us's parts (ops/lstm.py wide_step_us: step, CTA, cell,
# exchange KB, kilobyte, latency; microseconds): a least-squares fit to the
# steps of 114 one-cluster plans (H = 384 at C = 8 and 16, H = 512 at C =
# 16; 16-160 rows; no ring and rings of 2-6 stages) on an H100 SXM at 700 W
# (generative_audio_torch/scripts/perf_wide_scan.py --kind gru), off by at
# most 1.44 us a step and 0.38 in the mean. With them the route takes the
# wide cluster at every row count of FullSubNet v1-GRU's paths, the faster
# design at each as measured there.
_GRU_WIDE_PARTS = (2.69036, 0.02889, 0.32044, 0.04523, 0.0295, 0.78)
# The streamed variant's step model (ops/lstm.py stream_cluster_step_us:
# step, store, kilobyte, latency; microseconds): a least-squares fit to the
# steps of 39 one-cluster plans (H = 768, 1024; C = 8 x 16 rows, C = 16 x
# 16-48 rows; rings of 1-8 stages) on an H100 SXM at 700 W
# (generative_audio_torch/scripts/perf_stream_scan.py), off by at most 1.50
# us a step and 0.44 in the mean.
_STREAM_PARTS = (3.6217, 1.9986e-3, 0.0106, 0.29)
# The single-block forward's step model (ops/lstm.py block_forward_step_us:
# step, fragment round, megabyte), fitted as the LSTM's to its steps at 18
# and 2056 rows (H = 768, 1024) in the same sweep.
_BLOCK_PARTS = (10.932, 0.43134, 0.58021)
# The cluster backward's step model (ops/lstm.py bwd_cluster_step_us): a
# step, a KB of the dgh exchange, a k-step of the second product, an item
# and the stream term of an item (microseconds), fitted to the steps of five
# one-cluster plans on an H100 SXM at 700 W (as the LSTM's); and a step of
# the single-block scan, 152 us at H = 384 (29.67 ms over T = 195) and 140
# at H = 512, taken to grow with H.
_BWD_PARTS = (2.66, 0.0305, 0.018, 0.177, 0.097)
_BWD_BLOCK_US = 152.0
# The streamed cluster backward's parts beyond the resident cluster's step
# (ops/lstm.py bwd_stream_cluster_step_us: step, kilobyte, latency,
# remote; microseconds): a least-squares fit to the steps of 43 one-cluster
# plans on an H100 SXM at 700 W (as the LSTM's), off by at most 11.5 us a
# step and 3.4 in the mean.
_BWD_STREAM_PARTS = (7.09412, 0.00812, 0.59754, 0.05541)
# The wide backward scan on wgmma (csrc/gru_scan_bwd_wide.cu): its
# instances' units a CTA (16, 32, 48: the accumulators, 2U registers a
# thread, fit the 152 a thread of three warpgroups takes), its rows a
# cluster (one to three warpgroups of 64 rows: wgmma's M), and the depths
# of its ring, which carries both products' operands and the cell's (a
# slot goes back once the next stage's products are issued, so a ring
# holds two slots at least).
BWD_WIDE_UNITS = (16, 32, 48)
BWD_WIDE_ROWS = (64, 128, 192)
BWD_WIDE_STAGES = (2, 3, 4, 5, 6)
# bwd_wide_step_us's parts (microseconds, but the knee): a step; each 1000
# m64n8k16 blocks of a CTA's products (both; the cell's (row, unit) pairs
# grow with them and are in this part); and a copy's latency for each ring
# stage a slot serves in a step (the cell's U / 8 blocks of operands, the
# H / 64 boxes and the 3H / 64 dgh pieces over the ring's slots) beyond the
# knee, below which the products and the cell hide the copies. A
# least-squares fit (the knee by a search over whole stages) to the steps
# of 40 one-cluster plans (H = 384 at C = 8, H = 512 at C = 16; 64, 128 and
# 192 rows; rings of 2-6 slots) on an H100 SXM at 700 W
# (generative_audio_torch/scripts/perf_bwd_scan.py --wide --kind gru), off
# by at most 2.76 us a step and 1.06 in the mean. No deeper ring measured
# slower than a shallower one, so the planner's ties go to the deeper; and
# as the model is of one CTA an SM (two CTAs of 64 rows sharing an SM ran
# 19 us a step where one ran 15), the planner runs no more clusters at
# once than that allows.
_BWD_WIDE_PARTS = (12.0411, 4.02332, 1.61067, 10.0)
# The contraction's output tile (csrc/gru_scan_bwd.cu DW_TM x DW_TN) and the
# rows of one pipeline stage, on which every slice begins (DW_TK).
_DW_TILE_ROWS, _DW_TILE_COLS, _DW_STAGE_ROWS = 128, 256, 64
# dwhh_us's parts: a 64-row stage of a full tile's products (2 x 128 x 256
# x 64 operations; 0.56 us at one SM's share of the 989 TFLOP/s bf16 peak)
# where few CTAs run, the microseconds each working CTA above a knee adds
# to every CTA's stage (the card's shared rate), the knee, and one MB of a
# fp32 partial written by the kernel and read back by the sum (2 MB of
# traffic at 3.35 TB/s). The first three fitted to the contraction at N =
# 446 976, H = 384 cut into 1-9 slices (15-132 CTAs) on an H100 SXM at 700
# W (generative_audio_torch/scripts/perf_bwd_scan.py --dwhh): 0.578 us a
# stage at 15 CTAs, 0.768 at 132, off by at most 0.025 us a stage.
_DW_STAGE_US, _DW_SHARED_US, _DW_FREE_CTAS = 0.5783, 0.002498, 56.0
_DW_PARTIAL_US_PER_MB = 0.597
# A stage of a tile of at most 128 columns (m64n128k16, half the products,
# four boxes of six) against a full tile's: 0.72 where the narrow tiles'
# run bound the contraction at 126 CTAs (9 slices, 6 for the narrow tiles;
# chip_smoke.py phase 28 on an H100 SXM at 700 W).
_DW_HALF_SHARE = 0.72
# The first design's slices: each at least 12 H rows long (it reads 8
# times the bytes its fp32 partial writes: rows * 4H * 2 B >= 8 * H * 3H *
# 4 B), tiles x slices within one wave.
_DW_ROWS_PER_UNIT = 12


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
    """Modelled time of one step of one wave of the forward scan
    (ops/lstm.py cluster_step_us with this kernel's fitted parts)."""
    return cluster_step_us(hsz, cluster, rows, (_STEP_US, _ROUND_US, _STORE_US))


def plan_scan(hsz: int, batch: int, max_clusters: Callable[[int, int], int]
              ) -> ScanPlan:
    """The forward scan's cluster shape for `batch` rows at H = hsz (ops/
    lstm.py plan_cluster_scan with this kernel's layout and step model).
    Raises ValueError with each cluster size's reason when nothing fits."""
    return plan_cluster_scan("GRU", hsz, batch, max_clusters,
                             scan_smem_bytes, scan_step_us)


def scan_hidden(hsz: int) -> int:
    """The H the forward scan runs a layer of hsz units at (ops/lstm.py
    cluster_hidden)."""
    return cluster_hidden(hsz, scan_smem_bytes)


def block_smem_bytes(hsz: int) -> int:
    """Shared memory of one block of the single-block forward
    (csrc/gru_scan_block.cu): two bf16 h tiles [16][H + 8], fp32 h [16][H]
    and b_hh [3H]."""
    return 2 * _ROWS * (hsz + _PAD) * 2 + _ROWS * hsz * 4 + 3 * hsz * 4


def stream_smem_bytes(hsz: int, cluster: int, rows: int, resident: int,
                      stages: int) -> int:
    """Shared memory of one CTA of the streamed forward (csrc/gru_scan.cu
    `stream_smem`): the ring of `stages` k-pairs and the `resident` k-steps
    of the W_hh^T slice in fragment order (3U x 16 bf16 a k-step), the h
    buffers, the CTA's fp32 h and gates (ops/lstm.py stream_fixed_bytes),
    its b_hh slice [3U] fp32 and the ring's two mbarriers a stage, with
    U = H / cluster units."""
    units = hsz // cluster
    return ((2 * stages + resident) * 3 * units * 32
            + stream_fixed_bytes(hsz, cluster, rows, 3, 3 * units * 4)
            + 16 * stages)


def stream_step_us(hsz: int, cluster: int, rows: int, resident: int,
                   stages: int) -> float:
    """Modelled time of one step of one wave of the streamed forward (ops/
    lstm.py stream_cluster_step_us with its fitted parts)."""
    return stream_cluster_step_us(hsz, cluster, rows, resident, stages, 3,
                                  _STREAM_PARTS)


def plan_stream_scan(hsz: int, batch: int,
                     max_clusters: Callable[[int, int, int, int, int], int],
                     resident: Optional[int] = None) -> StreamPlan:
    """The streamed forward's plan for `batch` rows of a layer of hsz units
    (ops/lstm.py plan_stream with its layout and step model)."""
    return plan_stream("GRU", hsz, batch, stream_smem_bytes, max_clusters,
                       stream_step_us, resident)


@functools.lru_cache(maxsize=None)
def card_stream_plan(device: torch.device, hsz: int, batch: int,
                     instance: Tuple[int, int] = (0, 0),
                     resident: Optional[int] = None) -> StreamPlan:
    """The streamed plan the forward launches with on `device` (a CUDA
    device) for `batch` rows of a layer of hsz units; instance (out_f32,
    carry) as card_scan_plan's flags (occupancy from csrc/gru_scan.cu
    `gru_scan_stream_max_clusters`)."""
    return card_stream("gru_scan", plan_stream_scan, device, hsz, batch,
                       instance, resident)


def block_step_us(hsz: int, blocks: int) -> float:
    """Modelled step of the single-block forward (csrc/gru_scan_block.cu;
    ops/lstm.py block_forward_step_us with its parts)."""
    return block_forward_step_us(hsz, blocks, 3, _BLOCK_PARTS)


def gru_wide_smem_bytes(hsz: int, cluster: int, rows: int, resident: int,
                        stages: int) -> int:
    """Shared memory of one CTA of the wide forward (csrc/scan_fwd_wide.cuh
    `wide_smem` with three gate boxes; ops/lstm.py wide_smem_bytes)."""
    return wide_smem_bytes(hsz, cluster, rows, resident, stages, 3)


def gru_wide_step_us(hsz: int, cluster: int, rows: int, resident: int,
                     stages: int) -> float:
    """Modelled time of one step of one wave of the wide forward (ops/
    lstm.py wide_step_us with this kernel's fitted parts)."""
    return wide_step_us(hsz, cluster, rows, resident, stages,
                        _GRU_WIDE_PARTS)


def plan_gru_wide_scan(hsz: int, batch: int,
                       max_clusters: Callable[[int, int, int, int, int], int],
                       resident: Optional[int] = None) -> WidePlan:
    """The wide forward's plan for `batch` rows of a layer of hsz units
    (ops/lstm.py plan_wide_scan with three gates and this kernel's step
    model); raises ValueError with each cluster size's reason when nothing
    fits."""
    return plan_wide_scan(hsz, batch, max_clusters, resident, "GRU", 3,
                          gru_wide_step_us)


@functools.lru_cache(maxsize=None)
def card_gru_wide_plan(device: torch.device, hsz: int, batch: int,
                       resident: Optional[int] = None) -> WidePlan:
    """The wide plan both forward entries launch with on `device` (a CUDA
    device) for `batch` rows of a layer of hsz units (occupancy from
    csrc/gru_scan_wide.cu `gru_scan_wide_max_clusters`; one instance serves
    both entries and both output types)."""
    index = _device_index(device)
    return plan_gru_wide_scan(
        hsz, batch, lambda h, c, r, res, stages: _max_clusters(
            "gru_scan_wide", index, (res, stages), h, c, r), resident)


def _forward_route(hsz: int, batch: int, device: torch.device,
                   instance: Tuple[int, int] = (0, 0)
                   ) -> Tuple[int, str, Optional[Union[StreamPlan, WidePlan]]]:
    """(H, entry suffix, plan) of the forward for `batch` rows of a layer of
    hsz units on `device` (ops/lstm.py plan_forward with this kernel's
    layouts, step models, the card's occupancy of the streamed instance,
    the wide cluster's plan and, on a card, the modelled time of the
    instance's resident cluster; instance (out_f32, carry)); raises when
    nothing fits. On CPU tensors the route weighs no wide cluster unless
    wide_forwards() forces it."""
    wide = lambda: card_gru_wide_plan(device, hsz, batch)
    resident = None
    if _on_card(device):
        dtype = torch.float32 if instance[0] else torch.bfloat16

        def resident(hp):
            plan = card_scan_plan(device, hp, batch, dtype, bool(instance[1]))
            return plan.waves * scan_step_us(hp, plan.cluster, plan.rows)
    return plan_forward(
        "GRU", hsz, batch, scan_smem_bytes, block_smem_bytes, block_step_us,
        lambda res: card_stream_plan(device, hsz, batch, instance, res),
        _device_sms(device), wide_plan=wide, resident_us=resident)


@functools.lru_cache(maxsize=None)
def card_scan_plan(device: torch.device, hsz: int, batch: int,
                   out_dtype: torch.dtype = torch.bfloat16,
                   carry: bool = False) -> ScanPlan:
    """The plan the forward scan launches with on `device` (a CUDA device)
    for `batch` rows at H = hsz (occupancy from csrc/gru_scan.cu
    `gru_scan_max_clusters`)."""
    return card_plan("gru_scan", plan_scan, device, hsz, batch,
                     (int(out_dtype == torch.float32), int(carry)))


def bwd_block_smem_bytes(hsz: int) -> int:
    """Shared memory of one block of the single-block backward scan
    (csrc/gru_scan_bwd.cu `block_smem`): bf16 h_prev [16][H + 8] and dgh
    [16][3H + 8], fp32 dh [16][H], b_hh [3H] and db_hh [3H]."""
    return ((_ROWS * (hsz + _PAD) + _ROWS * (3 * hsz + _PAD)) * 2
            + (_ROWS * hsz + 6 * hsz) * 4)


def bwd_smem_bytes_cluster(hsz: int, cluster: int, rows: int,
                           resident: bool) -> int:
    """Shared memory of one CTA of the cluster backward scan (three gates;
    b_hh and the db_hh sums live in registers)."""
    return bwd_cluster_smem_bytes(hsz, cluster, rows, resident, 3)


def bwd_step_us(hsz: int, cluster: int, rows: int, resident: bool) -> float:
    """Modelled time of one step of one wave of the cluster backward scan
    (ops/lstm.py bwd_cluster_step_us with this kernel's fitted parts)."""
    return bwd_cluster_step_us(hsz, cluster, rows, resident, 3, _BWD_PARTS)


def bwd_stream_smem_bytes(hsz: int, cluster: int, rows: int, resident: int,
                          stages: int, tile: bool) -> int:
    """Shared memory of one CTA of the streamed cluster backward scan
    (ops/lstm.py bwd_stream_cluster_smem_bytes with three gates)."""
    return bwd_stream_cluster_smem_bytes(hsz, cluster, rows, resident, stages,
                                         tile, 3)


def bwd_stream_step_us(hsz: int, cluster: int, rows: int, resident: int,
                       stages: int, tile: bool) -> float:
    """Modelled time of one step of one wave of the streamed cluster
    backward scan (ops/lstm.py bwd_stream_cluster_step_us with this
    kernel's fitted parts)."""
    return bwd_stream_cluster_step_us(hsz, cluster, rows, resident, stages,
                                      tile, 3, _BWD_PARTS, _BWD_STREAM_PARTS)


def plan_bwd_stream_scan(hsz: int, batch: int,
                         max_clusters: StreamBwdClusters,
                         resident: Optional[int] = None) -> BwdStreamPlan:
    """The backward scan's streamed plan for `batch` rows of a layer of hsz
    units (ops/lstm.py plan_bwd_stream with its layout and step model)."""
    return plan_bwd_stream("GRU", hsz, batch, 3, max_clusters,
                           bwd_stream_step_us, resident)


@dataclasses.dataclass(frozen=True)
class GruBwdWidePlan:
    """Launch plan of the GRU backward scan's wide cluster
    (csrc/gru_scan_bwd_wide.cu `gru_scan_bwd_wide`, both products on wgmma):
    clusters of `cluster` CTAs at H = `hidden` (the layer's units
    zero-padded to bwd_wide_hidden's), each CTA owning hidden / cluster
    units, over `rows` batch rows a cluster (a consumer warpgroup of wgmma
    a 64 of them); one ring of `stages` slots carries a step's h_prev boxes
    with their W_hh^T chunks and its dgh pieces with their W_hh rows."""
    hidden: int           # H the kernel runs at
    cluster: int          # CTAs per cluster
    rows: int             # batch rows per cluster
    stages: int           # slots of the ring
    clusters: int         # clusters in the grid
    active: int           # clusters the card runs at once (occupancy)
    waves: int            # rounds of clusters, one after another
    smem_bytes: int       # dynamic shared memory of one CTA
    step_us: float        # modelled time of one step of one wave

    @property
    def design(self) -> str:
        return "wide"

    @property
    def warpgroups(self) -> int:
        """Consumer warpgroups of a CTA: one a 64 rows."""
        return self.rows // 64

    @property
    def launch_args(self) -> Tuple[int, int, int, int]:
        """The C entry's last arguments before the stream."""
        return (self.cluster, self.rows, self.stages, self.smem_bytes)


def bwd_wide_hidden(hsz: int, cluster: int) -> int:
    """The H the wide backward scan runs a layer of hsz units at with
    clusters of `cluster` CTAs: hsz padded to whole 16-unit groups a CTA
    and whole 64-column boxes."""
    unit = 16 * cluster * 64 // math.gcd(16 * cluster, 64)
    return -(-hsz // unit) * unit


def bwd_wide_smem_bytes(hsz: int, cluster: int, rows: int,
                        stages: int) -> int:
    """Shared memory of one CTA of the wide backward scan
    (csrc/gru_scan_bwd_wide.cu `wide_bwd_smem`): 1024 bytes of slack to
    align the swizzled boxes, the ring of `stages` slots (a box of `rows`
    rows x 64 bf16, or a block of the cell's operands, and a weight chunk
    of 3U rows x 64 bf16 each), the tiles' db_hh sums [rows / 16][3U] and
    dh of the warps' (row, unit) pairs [rows][U] in fp32, and the ring's
    mbarriers (two a slot), with U = H / cluster units."""
    units = hsz // cluster
    return (1024 + stages * (rows * 128 + units * 384)
            + 12 * (rows // 16) * units + 4 * rows * units + 16 * stages)


def bwd_wide_step_us(hsz: int, cluster: int, rows: int, stages: int,
                     parts: Tuple[float, ...] = _BWD_WIDE_PARTS) -> float:
    """Modelled time of one step of one wave of the wide backward scan, from
    `parts` (_BWD_WIDE_PARTS): a step, the CTA's wgmma products (the
    recompute's 3U columns over H and dh's U columns over 3H, m64n8k16
    blocks of each warpgroup), and a copy's latency for each stage a ring
    slot serves in a step (U / 8 + 4H / 64 stages over the slots) beyond
    the knee."""
    step_us, cta_us, latency_us, knee = parts
    units = hsz // cluster
    blocks = rows // 64 * 2 * (hsz // 16) * (3 * units // 8)
    served = (units // 8 + 4 * hsz // 64) / stages
    return (step_us + blocks / 1000 * cta_us
            + max(served - knee, 0.0) * latency_us)


def plan_bwd_wide_scan(hsz: int, batch: int, max_clusters: WideBwdClusters,
                       sms: int = H100_SMS) -> GruBwdWidePlan:
    """The backward scan's wide plan for `batch` rows of a layer of hsz
    units.

    For each cluster size C of CLUSTER_SIZES at H = bwd_wide_hidden(hsz,
    C) whose CTAs hold one of BWD_WIDE_UNITS units, each row count R of
    BWD_WIDE_ROWS up to the first that holds the batch in one cluster and
    each ring depth of BWD_WIDE_STAGES whose CTA fits SMEM_LIMIT bytes,
    max_clusters runs some at once (at most one CTA on each of the card's
    `sms` SMs) over ceil(batch / R) clusters and a step takes
    bwd_wide_step_us. The occupancy callable has kernel D's signature
    (ops/lstm.py WideBwdClusters: H, cluster, rows, tiles, groups, resident
    k-steps, stages, pieces), so that one stub serves both planners; this
    design's item is a warpgroup's four m16 tiles x the CTA's U / 8 unit
    groups, with no resident k-steps and one ring of `stages` slots for
    both products. The plan minimises waves x step time; ties go to the
    smaller cluster, then to fewer clusters and the deeper ring. Raises
    ValueError with the reasons when nothing fits."""
    if batch < 1:
        raise ValueError(f"the scan needs at least one row, got {batch}")
    best, refused = None, []
    for cluster in CLUSTER_SIZES:
        hp = bwd_wide_hidden(hsz, cluster)
        units = hp // cluster
        if units not in BWD_WIDE_UNITS:
            refused.append(f"C={cluster}: {units} units a CTA (an instance "
                           f"takes {', '.join(map(str, BWD_WIDE_UNITS))})")
            continue
        fitted = idle = False
        for rows in BWD_WIDE_ROWS:
            if rows - 64 >= batch:
                break
            clusters = -(-batch // rows)
            for stages in BWD_WIDE_STAGES:
                smem = bwd_wide_smem_bytes(hp, cluster, rows, stages)
                if smem > SMEM_LIMIT:
                    break
                fitted = True
                active = min(max_clusters(hp, cluster, rows, 4, units // 8,
                                          0, stages, stages), sms // cluster)
                if active < 1:
                    idle = True
                    continue
                waves = -(-clusters // active)
                step = bwd_wide_step_us(hp, cluster, rows, stages)
                key = (waves * step, cluster, clusters, -stages)
                if best is None or key < best[0]:
                    best = (key, GruBwdWidePlan(hp, cluster, rows, stages,
                                                clusters, active, waves, smem,
                                                step))
        if idle:
            refused.append(f"C={cluster}: the card runs no such cluster")
        if not fitted:
            refused.append(
                f"C={cluster}: {bwd_wide_smem_bytes(hp, cluster, 64, 2)} B at "
                f"64 rows (at most {SMEM_LIMIT} B)")
    if best is None:
        raise ValueError(f"no wide plan for the GRU backward scan at "
                         f"H={hsz}, {batch} rows: " + "; ".join(refused))
    return best[1]


def _card_wide_bwd_occupancy(index: int) -> WideBwdClusters:
    """The card's occupancy of the wide backward scan
    (csrc/gru_scan_bwd_wide.cu `gru_scan_bwd_wide_max_clusters`, whose
    instance takes the ring's depth) behind kernel D's signature."""
    return lambda h, c, r, tiles, groups, res, stages, pieces: _max_clusters(
        "gru_scan_bwd_wide", index, (stages,), h, c, r)


@functools.lru_cache(maxsize=None)
def card_bwd_wide_plan(device: torch.device, hsz: int, batch: int
                       ) -> GruBwdWidePlan:
    """The wide plan on `device` (a CUDA device) at any H its planner holds,
    for holding it against the other designs through
    gru_scan_bwd_streams_planned_tm and timing it."""
    return plan_bwd_wide_scan(hsz, batch,
                              _card_wide_bwd_occupancy(_device_index(device)),
                              _device_sms(device))


def _wide_bwd_weights(w_hh: torch.Tensor, hp: int, cluster: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """W_hh [H, 3H] -> the wide backward scan's two wgmma B operands,
    K-major without swizzle, zero-padded to hp units (U = hp / cluster a
    CTA): the recompute's W_hh^T slice of each CTA in 64-deep chunks,
    [cluster][hp/64][8 k8 groups][3U][8] bf16, row q U + u of chunk b and
    group g holding W_hh[64 b + 8 g + j, q hp + c U + u] at j; and the
    second product's W_hh rows of each CTA's units in 64-deep chunks over
    the 3hp columns, [cluster][3hp/64][8][U][8] bf16, row u of chunk c and
    group g holding W_hh[c U + u, 64 c + 8 g + j] at j."""
    w = _padded_weight(w_hh, hp)                       # [hp, 3hp]
    units = hp // cluster
    # [b][g][j][q][C][u] -> [C][b][g][q][u][j]
    rec = w.reshape(hp // 64, 8, 8, 3, cluster, units).permute(
        4, 0, 1, 3, 5, 2).reshape(cluster, hp // 64, 8, 3 * units, 8)
    # [C][u][c][g][j] -> [C][c][g][u][j]
    dh = w.reshape(cluster, units, 3 * hp // 64, 8, 8).permute(
        0, 2, 3, 1, 4).contiguous()
    return rec, dh


def plan_bwd_scan(hsz: int, batch: int,
                  max_clusters: Callable[[int, int, bool], int],
                  sms: int = H100_SMS,
                  stream_clusters: Optional[StreamBwdClusters] = None,
                  wide_clusters: Optional[WideBwdClusters] = None
                  ) -> Union[BwdPlan, BwdStreamPlan, GruBwdWidePlan]:
    """The backward scan's plan for `batch` rows at H = hsz (a multiple of
    16): the single-block design, a resident cluster, up to H = 512 the
    wide cluster or above it the streamed cluster (ops/lstm.py plan_bwd),
    on a card of `sms` SMs; the streamed and the wide cluster's occupancy
    from `stream_clusters` and `wide_clusters` (default: the resident
    cluster's)."""
    stream_clusters = stream_clusters or _resident_occupancy(max_clusters)
    wide_clusters = wide_clusters or (
        lambda h, c, r, *plan: max_clusters(c, r, False))
    return plan_bwd("GRU", hsz, batch, max_clusters,
                    functools.partial(sm_blocks, sms=sms),
                    bwd_smem_bytes_cluster, bwd_step_us,
                    bwd_block_smem_bytes(hsz),
                    _BWD_BLOCK_US * hsz / 384,
                    lambda: plan_bwd_stream_scan(hsz, batch, stream_clusters),
                    lambda: plan_bwd_wide_scan(hsz, batch, wide_clusters,
                                               sms))


def card_bwd_scan_plan(device: torch.device, hsz: int, batch: int
                       ) -> Union[BwdPlan, BwdStreamPlan, GruBwdWidePlan]:
    """The plan the backward scan launches with on `device` (a CUDA device)
    for `batch` rows at H = hsz (occupancy from csrc/gru_scan_bwd.cu
    `gru_scan_bwd_max_clusters`, csrc/scan_bwd_stream.cu
    `gru_scan_bwd_stream_max_clusters` and csrc/gru_scan_bwd_wide.cu
    `gru_scan_bwd_wide_max_clusters`), within the design that
    wide_backwards() or resident_backwards() forces."""
    return _card_bwd_scan_plan(device, hsz, batch,
                               _bwd_design[-1] if _bwd_design else None)


@functools.lru_cache(maxsize=None)
def _card_bwd_scan_plan(device: torch.device, hsz: int, batch: int,
                        design: Optional[str]
                        ) -> Union[BwdPlan, BwdStreamPlan, GruBwdWidePlan]:
    """card_bwd_scan_plan under `design` (the forced design, part of the
    key: plan_bwd reads it)."""
    return card_bwd_plan("gru_scan_bwd", functools.partial(
        plan_bwd_scan, wide_clusters=_card_wide_bwd_occupancy(
            _device_index(device))),
        device, hsz, batch)


@functools.lru_cache(maxsize=None)
def card_bwd_stream_plan(device: torch.device, hsz: int, batch: int,
                         resident: Optional[int] = None) -> BwdStreamPlan:
    """The backward scan's streamed plan on `device` (a CUDA device) at any
    H, the resident cluster's included: for holding the streamed cluster
    against the other designs through gru_scan_bwd_streams_planned_tm."""
    return plan_bwd_stream_scan(
        hsz, batch, _card_stream_bwd_clusters("gru_scan_bwd",
                                              _device_index(device)),
        resident)


def _launch(fn_name: str, *args,
            plan: Optional[Union[BwdPlan, StreamPlan, BwdStreamPlan,
                                 GruBwdWidePlan, WidePlan, "DwhhPlan"]] = None
            ) -> None:
    """Launch csrc entry `fn_name` through the port's launch helper. The
    forward entries are cluster launches: their arguments end in (out_f32,
    T, B, H, reverse), and card_scan_plan's plan for (H, B) on the tensors'
    card is appended to them; their streamed variants take `plan` (the
    StreamPlan the wrapper packed W_hh for), and their wide ones the
    WidePlan of three gates the wrapper packed W_hh for. The backward scan's arguments
    end in (T, B, H, reverse), and `plan` (default: card_bwd_scan_plan's for
    (H, B) without the wide cluster, which takes other operands) is
    appended to them; its streamed and wide clusters' arguments end the
    same way, and `plan` (the BwdStreamPlan or GruBwdWidePlan the wrapper
    packed W_hh for) is appended to them. The contraction's arguments end
    in (N, H), and `plan` (a DwhhPlan; default plan_dwhh's for (N, H)) is
    appended to them."""
    if fn_name in _STREAM_ENTRIES:
        args = (*args, *_stream_args(fn_name, plan, args[-2]))
    elif fn_name in _WIDE_ENTRIES:
        args = (*args, *_wide_args(fn_name, plan, args[-2], 3))
    elif fn_name == "gru_scan_bwd_stream":
        args = (*args, *_stream_args(fn_name, plan, args[-2], BwdStreamPlan))
    elif fn_name == "gru_scan_bwd_wide":
        args = (*args, *_stream_args(fn_name, plan, args[-2],
                                     GruBwdWidePlan))
    elif fn_name == "gru_scan_bwd":
        b, hsz = args[-3], args[-2]
        if plan is None:        # the wrapper asked already where wide weighs
            with resident_backwards():
                plan = card_bwd_scan_plan(args[0].device, hsz, b)
        if not isinstance(plan, BwdPlan):
            raise ValueError(f"gru_scan_bwd launches with a BwdPlan, got "
                             f"{type(plan).__name__}")
        args = (*args, *plan.launch_args)
    elif fn_name == "gru_scan_bwd_dwhh":
        plan = plan or plan_dwhh(*args[-2:])
        args = (*args, *plan.launch_args)
    elif fn_name in _CLUSTER_ENTRIES:
        out_f32, _, b, hsz, _ = args[-5:]
        plan = card_scan_plan(args[0].device, hsz, b,
                              torch.float32 if out_f32 else torch.bfloat16,
                              fn_name == "gru_scan_fwd_carry")
        args = (*args, *plan.launch_args)
    _launch_entry(fn_name, *args)


@dataclasses.dataclass(frozen=True)
class DwhhPlan:
    """How the dW_hh contraction (csrc/gru_scan_bwd.cu) cuts its N rows:
    one CTA per 128 x 256 output tile and slice; slice z of a tile takes
    rows [z * rows_per_slice, (z + 1) * rows_per_slice) of the first N
    (whole 64-row stages; the last slice may be shorter), and of a narrow
    tile (fewer than 256 columns: the ragged last one of dgx's 2H or dhn's
    H) [z * narrow_rows, (z + 1) * narrow_rows) for z below narrow_slices,
    its partials beyond written zero. `in_flight` wgmma
    groups of a stage run on while the next stage's are issued (0: the
    first design's wait for every group). The caller sums the `slices`
    partials in a fixed order."""
    tiles: int
    slices: int
    rows_per_slice: int
    narrow_tiles: int = 0
    narrow_slices: int = 0
    narrow_rows: int = 0
    in_flight: int = 1
    us: float = 0.0       # dwhh_us of the plan (0 for the first design's)

    def __post_init__(self):
        if not self.narrow_slices:       # no narrow tile: as the others
            object.__setattr__(self, "narrow_slices", self.slices)
            object.__setattr__(self, "narrow_rows", self.rows_per_slice)

    @property
    def launch_args(self) -> Tuple[int, int, int]:
        """The C entry's last arguments before the stream."""
        return self.slices, self.narrow_slices, self.in_flight


def _dwhh_rows(n: int, slices: int) -> int:
    """Rows of each slice when n rows are cut into `slices` (whole 64-row
    stages), as the kernel cuts them: ceil(ceil(n / slices) / 64) * 64."""
    return -(-(-(-n // slices)) // _DW_STAGE_ROWS) * _DW_STAGE_ROWS


def _dwhh_tiles(hsz: int) -> Tuple[int, int, float]:
    """(full tiles, narrow tiles, the share of a full tile's stage a narrow
    tile's takes) of the contraction's grid at H = hsz: a tile of fewer
    than _DW_TILE_COLS columns (the ragged last one of dgx's 2H or dhn's H)
    is narrow, as csrc/gru_scan_bwd.cu decides; at most 128 columns run
    m64n128k16, whose stage takes _DW_HALF_SHARE of a full one's."""
    rows = -(-hsz // _DW_TILE_ROWS)
    cols = [min(_DW_TILE_COLS, extent - c) for extent in (2 * hsz, hsz)
            for c in range(0, extent, _DW_TILE_COLS)]
    narrow = [c for c in cols if c < _DW_TILE_COLS]
    share = max((_DW_HALF_SHARE if c <= 128 else 1.0 for c in narrow),
                default=0.0)
    return rows * (len(cols) - len(narrow)), rows * len(narrow), share


def dwhh_us(n: int, hsz: int, slices: int, narrow_slices: int,
            sms: int = H100_SMS) -> float:
    """Modelled time of the contraction over n rows at H = hsz cut into
    `slices` (narrow tiles: `narrow_slices`) on a card of `sms` SMs, the
    sum of its partials included: once per wave, the longest run of stages
    of a CTA (a narrow tile's stage its share of a full one's) at the stage
    time of as many working CTAs as the wave holds (_DW_STAGE_US, and
    _DW_SHARED_US for each above _DW_FREE_CTAS), and the fp32 partials
    written and read back (_DW_PARTIAL_US_PER_MB a MB) where there is more
    than one."""
    full, narrow, share = _dwhh_tiles(hsz)
    run = 0.0
    for tiles, count, weight in ((full, slices, 1.0),
                                 (narrow, narrow_slices, share)):
        if tiles:
            run = max(run, _dwhh_rows(n, count) // _DW_STAGE_ROWS * weight)
    working = full * slices + narrow * narrow_slices
    waves = -(-working // sms)
    stage = _DW_STAGE_US + _DW_SHARED_US * max(
        0.0, min(working, sms) - _DW_FREE_CTAS)
    partial_mb = hsz * 3 * hsz * 4 / 1e6
    return (waves * run * stage
            + (slices * partial_mb * _DW_PARTIAL_US_PER_MB
               if slices > 1 else 0.0))


@functools.lru_cache(maxsize=None)
def plan_dwhh(n: int, hsz: int, sms: int = H100_SMS) -> DwhhPlan:
    """The contraction's plan over n >= 1 rows at H = hsz on a card of
    `sms` SMs: the slices of the full tiles of least dwhh_us, weighing the
    SMs each extra slice fills against the fp32 partial it adds (ties go
    to fewer slices); the narrow tiles take as many slices, up to as many,
    as the SMs the full tiles leave hold (in the sweep of perf_bwd_scan.py
    --dwhh each slice count ran faster the more SMs it filled, up to one
    wave). Slices begin on
    whole stages and none is empty: a count is reduced to the slices its
    rows per slice make, ceil(n / rows_per_slice). One wgmma group stays in
    flight."""
    full, narrow, _ = _dwhh_tiles(hsz)
    best = None
    for slices in range(1, max(1, (sms - narrow) // max(full, 1)) + 1):
        slices = -(-n // _dwhh_rows(n, slices))        # no empty slice
        narrow_slices = (max(1, min(slices, (sms - full * slices) // narrow))
                         if narrow else slices)
        narrow_slices = -(-n // _dwhh_rows(n, narrow_slices))
        us = dwhh_us(n, hsz, slices, narrow_slices, sms)
        if best is None or (us, slices) < best[0]:
            best = ((us, slices), DwhhPlan(
                full + narrow, slices, _dwhh_rows(n, slices), narrow,
                narrow_slices, _dwhh_rows(n, narrow_slices), 1, us))
    return best[1]


def plan_dwhh_first(n: int, hsz: int) -> DwhhPlan:
    """The first design's plan, for timing against plan_dwhh's: as many
    slices as keep tiles x slices within one wave of H100_SMS and every
    slice at least 12 H rows long, and at least one, the same for every
    tile; each stage's wgmma groups waited for at once."""
    full, narrow, _ = _dwhh_tiles(hsz)
    tiles = full + narrow
    slices = max(1, min(H100_SMS // tiles, n // (_DW_ROWS_PER_UNIT * hsz)))
    slices = -(-n // _dwhh_rows(n, slices))           # no empty slice
    return DwhhPlan(tiles, slices, _dwhh_rows(n, slices), narrow, slices,
                    _dwhh_rows(n, slices), 0)


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


def _kernel_bias(b_hh: torch.Tensor, hp: int) -> torch.Tensor:
    """b_hh [3H] -> the kernels' operand: [3hp] fp32, zero-padded per gate."""
    return _kernel_operand(_pad_gates(b_hh.reshape(-1).float(), 3, hp),
                           torch.float32)


def gru_scan_tm(gates_x: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                reverse: bool = False,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """GRU recurrence, time-major: gates_x [T, B, 3H] (cast to bf16 as the
    kernel's input), w_hh [H, 3H], b_hh [3H] -> h sequence [T, B, H] in
    out_dtype. h starts at zero. CUDA tensors run the forward kernel on the
    route of _forward_route (the wide cluster where a resident cluster holds
    H and the wide one models faster on the card, W_hh packed for its
    WidePlan; else the resident cluster, the streamed cluster or the single
    block; the same h bit for bit); when
    autograd records and an input requires grad, the call goes through
    GRUScan instead, on either device."""
    t_len, b, hsz = _check_shapes(gates_x, w_hh, b_hh, out_dtype)
    if _wants_grad(gates_x, w_hh, b_hh):
        return GRUScan.apply(gates_x, w_hh, b_hh, reverse, out_dtype)
    gates = gates_x.to(torch.bfloat16)
    if not _is_cuda(gates, w_hh, b_hh):
        return gru_scan_reference_tm(gates, w_hh, b_hh, reverse).to(out_dtype)
    _check_kernel_operand("gates_x", gates, torch.bfloat16)
    out_f32 = out_dtype == torch.float32
    hp, route, plan = _forward_route(hsz, max(b, 1), gates.device,
                                     (int(out_f32), 0))
    out = torch.empty(t_len, b, hp, dtype=out_dtype, device=gates.device)
    if t_len and b:
        _launch("gru_scan_fwd" + route, _pad_gates(gates, 3, hp),
                _route_weight(w_hh, hp, plan), _kernel_bias(b_hh, hp), out,
                out_f32, t_len, b, hp, reverse, plan=plan)
    return _unpad_units(out, hsz)


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
    _check_kernel_operand("gates_x", gates, torch.bfloat16)
    _check_kernel_operand("h0", h0, torch.float32)
    if not (t_len and b):
        return (torch.empty(t_len, b, hsz, dtype=out_dtype,
                            device=gates.device), h0.clone())
    out_f32 = out_dtype == torch.float32
    hp, route, plan = _forward_route(hsz, b, gates.device, (int(out_f32), 1))
    out = torch.empty(t_len, b, hp, dtype=out_dtype, device=gates.device)
    h_t = torch.empty(b, hp, dtype=torch.float32, device=gates.device)
    _launch("gru_scan_fwd_carry" + route, _pad_gates(gates, 3, hp),
            _route_weight(w_hh, hp, plan), _kernel_bias(b_hh, hp),
            _pad_units(h0, hp), out, h_t, out_f32, t_len, b, hp, reverse,
            plan=plan)
    return _unpad_units(out, hsz), _unpad_units(h_t, hsz)


def gru_scan_bwd_streams_tm(gates: torch.Tensor, h_seq: torch.Tensor,
                            gout: torch.Tensor, w_hh: torch.Tensor,
                            b_hh: torch.Tensor, reverse: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The backward scan: bf16 gates [T, B, 3H], the forward's bf16 h_seq and
    the cotangent gout of h_seq, both [T, B, H] bf16, w_hh [H, 3H], b_hh [3H]
    -> (dgx [T, B, 3H] bf16, dhn [T, B, H] bf16, db_hh [3H] fp32). CUDA
    tensors run `gru_scan_bwd` with card_bwd_scan_plan's plan (a thread-block
    cluster, or the single-block design), or where it is the plan the wide
    cluster `gru_scan_bwd_wide` (up to H = 512; on a card the plan weighs
    it, on CPU tensors, which have no card's occupancy, only within
    wide_backwards()) or above H = 512 the streamed cluster
    `gru_scan_bwd_stream` (the same bits); each writes one db_hh partial
    per 16-row tile of the batch; the partials are summed here."""
    return _scan_bwd(gates, h_seq, gout, w_hh, b_hh, reverse)


def gru_scan_bwd_streams_planned_tm(gates: torch.Tensor, h_seq: torch.Tensor,
                                    gout: torch.Tensor, w_hh: torch.Tensor,
                                    b_hh: torch.Tensor,
                                    plan: Union[BwdPlan, BwdStreamPlan,
                                                GruBwdWidePlan],
                                    reverse: bool = False
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """gru_scan_bwd_streams_tm on CUDA tensors with a given launch plan (a
    BwdPlan for the operands' H, padded to 16, and any design, or a
    BwdStreamPlan or GruBwdWidePlan for that H padded to its units), returning
    the per-tile db_hh partials [ceil(B / 16), 3H] unsummed, for holding the
    designs against each other bit for bit and timing plans."""
    if not _is_cuda(gates, h_seq, gout, w_hh, b_hh):
        raise ValueError("a launch plan is for CUDA tensors")
    return _scan_bwd(gates, h_seq, gout, w_hh, b_hh, reverse, plan)


def _wide_bwd_hidden(hp: int, plan) -> int:
    """The H a backward runs a layer of hp units (a multiple of 16) at
    under `plan`: a wide plan's H (hp padded to bwd_wide_hidden's units;
    raises for a plan of another layer), else ops/lstm.py _bwd_hidden's."""
    if not isinstance(plan, GruBwdWidePlan):
        return _bwd_hidden(hp, plan)
    if plan.hidden != bwd_wide_hidden(hp, plan.cluster):
        raise ValueError(f"a wide plan at H={plan.hidden} is for no layer of "
                         f"{hp} units")
    return plan.hidden


def _scan_bwd(gates, h_seq, gout, w_hh, b_hh, reverse,
              plan: Optional[Union[BwdPlan, BwdStreamPlan,
                                   GruBwdWidePlan]] = None):
    t_len, b, hsz = _check_shapes(gates, w_hh, b_hh, torch.bfloat16)
    for name, x in (("h_seq", h_seq), ("gout", gout)):
        if tuple(x.shape) != (t_len, b, hsz):
            raise ValueError(f"{name} must be [{t_len}, {b}, {hsz}], got "
                             f"{tuple(x.shape)}")
    if not _is_cuda(gates, h_seq, gout, w_hh, b_hh):
        return gru_scan_bwd_streams_reference_tm(
            gates.to(torch.bfloat16), h_seq.to(torch.bfloat16),
            gout.to(torch.bfloat16), w_hh, b_hh, reverse)
    for name, x in (("gates", gates), ("h_seq", h_seq), ("gout", gout)):
        _check_kernel_operand(name, x, torch.bfloat16)
    if not (t_len and b):
        return (torch.empty_like(gates), torch.empty_like(h_seq),
                torch.zeros(3 * hsz, device=gates.device))
    partials = plan is not None      # the planned wrapper's: unsummed
    hp = -(-hsz // _STEP_UNITS) * _STEP_UNITS
    if plan is None and (hp > _BWD_RESIDENT_MAX or _on_card(gates.device)
                         or _bwd_design):
        # on a card the plan weighs the wide cluster, so the wrapper asks
        # for it first (the wide entry takes other operands)
        plan = card_bwd_scan_plan(gates.device, hp, b)
    hp = _wide_bwd_hidden(hp, plan)
    dgx = torch.empty(t_len, b, 3 * hp, dtype=torch.bfloat16,
                      device=gates.device)
    dhn = torch.empty(t_len, b, hp, dtype=torch.bfloat16, device=gates.device)
    db_blocks = torch.empty(-(-b // _ROWS_PER_BLOCK), 3 * hp,
                            dtype=torch.float32, device=gates.device)
    streams = (_pad_gates(gates, 3, hp), _pad_units(h_seq, hp),
               _pad_units(gout, hp))
    outputs = (_kernel_bias(b_hh, hp), dgx, dhn, db_blocks,
               db_blocks.shape[0], t_len, b, hp, reverse)
    if isinstance(plan, GruBwdWidePlan):
        # both W_hh operands as wgmma's B, chunk after chunk: the
        # recompute's W_hh^T slices and the second product's W_hh rows
        _launch("gru_scan_bwd_wide", *streams,
                *_wide_bwd_weights(w_hh, hp, plan.cluster), *outputs,
                plan=plan)
    elif isinstance(plan, BwdStreamPlan):
        # both W_hh operands in MMA fragment order, slot after slot: the
        # recompute's W_hh^T slices and the second product's W_hh rows
        _launch("gru_scan_bwd_stream", *streams,
                _stream_weight(w_hh, hp, plan.cluster),
                _stream_dh_weight(w_hh, hp, plan.cluster), *outputs,
                plan=plan)
    else:
        # W_hh in both layouts: [3H, H] for the gates recompute (and in
        # fragment order for the clusters'), [H, 3H] (the 3H axis
        # contiguous) for dgates_h @ W_hh^T
        wt = _kernel_weight(w_hh, hp)
        operands = (*streams, wt,
                    _kernel_operand(_padded_weight(w_hh, hp), torch.bfloat16),
                    _fragment_weight(wt), *outputs)
        if plan is None:
            _launch("gru_scan_bwd", *operands)
        else:
            _launch("gru_scan_bwd", *operands, plan=plan)
    db = db_blocks if partials else db_blocks.sum(dim=0)
    return (_unpad_gates(dgx, 3, hsz), _unpad_units(dhn, hsz),
            _unpad_gates(db, 3, hsz))


def gru_dwhh(h_prev: torch.Tensor, dgx: torch.Tensor, dhn: torch.Tensor,
             plan: Optional[DwhhPlan] = None) -> torch.Tensor:
    """The dW_hh contraction: h_prev [N, H], dgx [N, 3H], dhn [N, H], all
    bf16 (see shifted_rows) -> h_prev^T @ [dgx[:, :2H], dhn] as fp32
    [H, 3H]. CUDA tensors run `gru_scan_bwd_dwhh`, which writes one partial
    per slice of the N rows (`plan`, by default plan_dwhh's for the card's
    SMs; plan_dwhh_first's is the first design's); the partials are summed
    here in a fixed order (one slice is the result itself), so a result
    repeats bit for bit. The kernel reads its
    operands through TMA descriptors: they must be contiguous and 16-byte
    aligned, as shifted_rows' views of contiguous streams are at an H that
    needs no padding, and as the padded copies are at any other H."""
    n, hsz = h_prev.shape
    if tuple(dgx.shape) != (n, 3 * hsz) or tuple(dhn.shape) != (n, hsz):
        raise ValueError(f"dgx must be [{n}, {3 * hsz}] and dhn [{n}, {hsz}], "
                         f"got {tuple(dgx.shape)} and {tuple(dhn.shape)}")
    if not _is_cuda(h_prev, dgx, dhn):
        return gru_dwhh_reference(h_prev, dgx, dhn)
    if not n:
        return torch.zeros(hsz, 3 * hsz, device=h_prev.device)
    # the padded copies are the operands (shifted_rows' views at an H that
    # is no multiple of 16 may lie off a 16-byte boundary)
    hp = -(-hsz // _STEP_UNITS) * _STEP_UNITS
    operands = (_pad_units(h_prev, hp), _pad_gates(dgx, 3, hp),
                _pad_units(dhn, hp))
    for name, x in zip(("h_prev", "dgx", "dhn"), operands):
        _check_kernel_operand(name, x, torch.bfloat16)
    plan = plan or plan_dwhh(n, hp, _device_sms(h_prev.device))
    slices = torch.empty(plan.slices, hp, 3 * hp, dtype=torch.float32,
                         device=h_prev.device)
    _launch("gru_scan_bwd_dwhh", *operands, slices, n, hp, plan=plan)
    out = slices[0] if plan.slices == 1 else slices.sum(dim=0)
    return _unpad_gates(out[:hsz], 3, hsz)


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
                         proj_dtype: Optional[torch.dtype] = None,
                         mixed: bool = False) -> torch.Tensor:
    """Whole GRU layer, time-major, with the input projection hoisted one
    time chunk at a time: x_tm [T, B, F], w_ih [F, 3H], w_hh [H, 3H], b_ih,
    b_hh [3H] -> [T, B, H]. Only one chunk's [t_chunk, B, 3H] gates exist at
    a time. The projection runs in proj_dtype (default: bf16 on CUDA, float32
    on the CPU, as the JAX function's TPU and interpret modes do), or with
    mixed=True as ops.lstm.mixed_gates (the JAX function's projection with
    proj_dtype bf16: fp32 accumulation plus the fp32 b_ih, one rounding); the
    gates enter the scan as bf16 either way, so for the same gates the result
    is bit-identical to gru_scan_tm. Under grad the backward needs the whole
    gates buffer anyway, so the call takes the full hoisted projection and
    GRUScan, as the JAX function's VJP does."""
    t_len, b, _ = x_tm.shape
    hsz = w_hh.shape[0]
    pdt = proj_dtype or (torch.bfloat16 if x_tm.is_cuda else torch.float32)
    w_p, b_p = w_ih.t().to(pdt), b_ih.to(pdt)

    def project(x):
        return (mixed_gates(x, w_ih, b_ih, round_grads=False) if mixed
                else F.linear(x.to(pdt), w_p, b_p))

    if _wants_grad(x_tm, w_ih, w_hh, b_ih, b_hh):
        return GRUScan.apply(project(x_tm), w_hh, b_hh, reverse, out_dtype)
    h = torch.zeros(b, hsz, dtype=torch.float32, device=x_tm.device)
    out = torch.empty(t_len, b, hsz, dtype=out_dtype, device=x_tm.device)
    starts = list(range(0, t_len, t_chunk))
    if reverse:              # the state flows from the later chunk backwards
        starts = starts[::-1]
    for s in starts:
        e = min(s + t_chunk, t_len)
        out[s:e], h = gru_scan_carry_tm(project(x_tm[s:e]), w_hh, b_hh, h,
                                        reverse, out_dtype)
    return out
