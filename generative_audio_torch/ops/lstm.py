"""LSTM recurrence over precomputed time-major gates, and the LSTM layer
with the input projection inside the scan: CUDA kernels, their plain
PyTorch versions, and the autograd Functions that train through them.

Port of five kernels of generative_audio_tpu/ops/pallas_lstm.py:
  * `lstm_scan_tm` without grad (kernel A, csrc/lstm_scan.cu `lstm_scan_fwd`)
    replaces `_lstm_pallas_call` / `_lstm_kernel`;
  * `lstm_scan_carry_tm` (kernel B, `lstm_scan_fwd_carry`) replaces
    `_lstm_pallas_call_carry` / `_lstm_carry_kernel`, and
    `lstm_layer_tm_chunked` chains it over time chunks as the JAX function
    of the same name does;
  * `lstm_scan_train_tm` (kernel C, `lstm_scan_fwd_train`; at the sub-band
    training batch its wide cluster, csrc/lstm_scan_wide.cu
    `lstm_scan_fwd_train_wide`) replaces `_lstm_pallas_call_train` /
    `_lstm_train_kernel`: kernel A that also writes the bf16 c sequence;
  * `lstm_scan_bwd_tm` (kernel D, csrc/lstm_scan_bwd.cu `lstm_scan_bwd`;
    above H = 512 also its streamed cluster, csrc/scan_bwd_stream.cu
    `lstm_scan_bwd_stream`) replaces `_lstm_pallas_call_bwd` /
    `_lstm_bwd_kernel`: the reverse-time backward that recomputes the gates
    and emits bf16 dgates;
  * `lstm_layer_tm` without grad (kernel F, csrc/lstm_scan_staged.cu
    `lstm_layer_fwd`; above H = 512 its streamed cluster,
    csrc/lstm_staged_stream.cu `lstm_layer_fwd_stream`) replaces
    `_lstm_layer_pallas_call` / `_lstm_layer_kernel`: x_t @ W_ih inside the
    scan, no gates buffer; a thread-block cluster whose warps compute the
    next step's x product while they wait at the step's cluster barrier.
Two more kernels reorganise kernels A and D, bit for bit, and replace the
kernels that the JAX package keeps in scripts/: `lstm_scan_tm(...,
block_t=K)` (kernel E, csrc/lstm_scan_staged.cu `lstm_scan_fwd_unrolled`:
kernel A's cluster whose x-side gates arrive by TMA, K steps at a time;
above H = 512 its streamed cluster, csrc/lstm_staged_stream.cu
`lstm_scan_fwd_unrolled_stream`, or its single block,
csrc/lstm_scan_unrolled_block.cu `lstm_scan_fwd_unrolled_block`, equal to
`lstm_scan_fwd_block`) and
`lstm_scan_bwd_tm(..., n_chains=N)` (kernel G, csrc/lstm_scan_bwd_chains.cu
`lstm_scan_bwd_chains`: kernel D's cluster whose compute warps carry N
independent accumulator chains each; where no cluster holds H its single
block, csrc/lstm_scan_bwd.cu `lstm_scan_bwd_chains_block`: N 16-row chains
a block), each with a plan of its own (`plan_chains_scan`,
`card_chains_scan_plan`).
generative_audio_torch/scripts/ holds their entry points, named after the
JAX scripts.
`LSTMScan` is the counterpart of the JAX custom VJP (`_lstm_fwd` /
`_lstm_bwd`): forward = kernel C, backward = kernel D plus dW_hh as one
contraction outside the kernel. `lstm_scan_tm` goes through it whenever
autograd is recording and an input requires grad. `LSTMLayerScan` is the
counterpart of `_layer_fwd` / `_layer_bwd`: the hoisted projection, kernel
C, and in backward kernel D plus dx, dW_ih, db and dW_hh as contractions
with fp32 output.

Layouts follow the JAX package: gates [T, B, 4H] in torch gate order
(i, f, g, o) with the biases already added, W_hh [H, 4H], h [T, B, H].

Dispatch is by the device of the tensors: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version. There is no fallback from
one to the other. The plain versions repeat the kernels' numerics: bf16
gates upcast to fp32, h cast to bf16 before the product with bf16 W_hh,
fp32 accumulation, fp32 c, dh and dc; bf16 h_seq, c_seq, gout and dgates.

Kernels A, B and C have a third design for the sub-band batch, the wide
cluster (csrc/lstm_scan_wide.cu, entries ending in `_wide`: each step's
product on warpgroup MMA (wgmma), M the CTA's gate columns, N the cluster's
rows, one h buffer a CTA sent to the peers by bulk copies, the gates by
TMA, c in registers (kernel C stores its bf16 c from there), so that up to
160 rows fit a cluster of 8): where a resident cluster holds H,
`plan_forward` takes whichever of the two has the least modelled waves x
step on the card (`plan_wide_scan`, `card_wide_plan`; the wide one at the
8 x 10 s batch and at the 2304-row training batch, the resident one at a
clip's 257 rows). `wide_forwards()` and `resident_forwards()` force
either, for the GRU forwards' wide cluster (ops/gru.py,
csrc/gru_scan_wide.cu, the same design with a fourth gate row of zeros a
unit; csrc/scan_fwd_wide.cuh holds what both share) too. Kernel D
has a wide cluster too (csrc/lstm_scan_bwd_wide.cu `lstm_scan_bwd_wide`:
the dgates exchange read back from L2 by TMA in kernel D's k order, both
W_hh operands streamed, z, dh and dc of up to 2 x 3 m16 tiles x 8-unit
groups in a warp's registers, so that 80 rows fit a cluster of 8): where
a resident cluster holds H, `plan_bwd` weighs it against the resident
cluster by modelled waves x step on the card (`plan_bwd_wide`,
`card_bwd_wide_plan`), bit for bit the same dgates; `wide_backwards()` and
`resident_backwards()` force either, for the GRU backward scan's wide
cluster (ops/gru.py, csrc/gru_scan_bwd_wide.cu) too.

`launch_counts` counts kernel launches by kernel name, for the GRU kernels
of ops/gru.py too (one dict and one launch helper for every kernel of the
port); `_launch_kernel` adds one exactly where it launches, so a run can
show that the path went through the kernels.

Kernels A, B and C run as thread-block clusters (csrc/lstm_scan.cu), as the
GRU forward does (ops/gru.py): `_launch` appends `card_scan_plan`'s launch
plan to their arguments. `plan_cluster_scan`, the planner both cells share,
picks the cluster size and the rows per cluster from H, the row count, the
shared-memory limit, a step model fitted on the card and the card's
`cudaOccupancyMaxActiveClusters`; it is plain Python. Kernels E and F are
clusters too, each with its own layout and step model through the same
planner (`plan_unrolled`, `plan_layer`; `card_unrolled_plan`,
`card_layer_plan`), and so are their streamed variants
(`plan_unrolled_stream`, `plan_layer_stream`; `card_unrolled_stream_plan`,
`card_layer_stream_plan`). Kernel D runs as a
thread-block cluster, as the single-block design or, above H = 512, as a
streamed cluster, which give the same dgates bit for bit: `plan_bwd`,
shared with the GRU backward, weighs them by step models fitted on the
card (`card_bwd_scan_plan`); `_launch` appends the plan.

Any H runs on the card: the wrappers zero-pad H to the units their kernel
takes (`scan_hidden` for kernels A-C, `unrolled_route` for E,
`layer_route` for F, whole 16-deep k-steps for the backwards D and G) and
slice the result back; at H = 384 and 512 nothing is padded. Where no
cluster holds W_hh's slice (H above 512), kernels A-C take the route of
`plan_forward`: the streamed variant of their cluster (csrc/lstm_scan.cu,
entries ending in `_stream`: the first k-steps of each CTA's slice resident,
the rest streamed from L2 through a ring of bulk copies at every step; plan
`plan_stream_scan`, `card_stream_plan`, at H padded to `stream_hidden`) or
the single block (csrc/lstm_scan_block.cu, entries ending in `_block`, at H
padded to 16), whichever has the least waves x modelled step; so do
kernels E and F between their streamed clusters (csrc/lstm_staged_stream.cu:
the same ring, kernel E's gates by TMA K steps at a time, kernel F's x
product between the arrive and the wait of the cluster barrier) and their
single blocks (csrc/lstm_scan_unrolled_block.cu and
csrc/lstm_layer_block.cu); kernel D takes its single block (dc in registers,
H up to 1024) or its streamed cluster (csrc/scan_bwd_stream.cu: both W_hh
operands streamed, at H padded to `stream_hidden`), whichever has the
least waves x modelled step. `single_block_forwards()` and
`streamed_forwards()` force the single block and the streamed cluster at
any H, for holding them against the resident cluster, bit for bit. A
padded unit sees zero gates, zero weights and zero bias, so
it stays at h = c = 0 (g = tanh 0 = 0), adds exact zeros to the real
units' sums and gets zero dgates. What no design holds raises with the
bytes: kernels A-C, kernel D, kernel F and the GRU forwards and backward
above H = 2304 (the streamed clusters' 18 items a CTA; the single blocks
stop at 1808, 1024, 1648 and 1072, kernel F's at 1776 for F = 34), kernel
G above H = 512 (two chains) or where neither its cluster nor its single
block holds four chains, kernel E where not even one group of K steps of
gates fits beside its streamed CTA's h buffers (H above 2304 at K = 2,
above 2048 at K = 4).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
from typing import Callable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["lstm_scan_tm", "lstm_scan_reference_tm", "lstm_scan_carry_tm",
           "lstm_scan_carry_reference_tm", "lstm_scan_train_tm",
           "lstm_scan_train_reference_tm", "lstm_scan_bwd_tm",
           "lstm_scan_bwd_reference_tm", "LSTMScan", "lstm_layer_tm_chunked",
           "lstm_layer_tm", "lstm_layer_reference_tm", "LSTMLayerScan",
           "launch_counts", "reset_launch_counts", "ScanPlan",
           "scan_smem_bytes", "scan_step_us", "plan_scan", "scan_hidden",
           "card_scan_plan", "plan_cluster_scan", "cluster_hidden",
           "lstm_scan_bwd_planned_tm", "BwdPlan", "plan_bwd",
           "plan_bwd_scan", "card_bwd_scan_plan", "bwd_smem_bytes_cluster",
           "bwd_step_us", "block_smem_bytes",
           "single_block_forwards", "unrolled_smem_bytes",
           "unrolled_step_us", "plan_unrolled", "card_unrolled_plan",
           "unrolled_hidden", "lstm_scan_unrolled_planned_tm",
           "layer_smem_bytes", "layer_step_us", "plan_layer",
           "card_layer_plan", "layer_route", "layer_block_smem_bytes",
           "lstm_layer_planned_tm", "unrolled_route",
           "unrolled_block_rows", "unrolled_block_smem_bytes", "ChainsPlan",
           "plan_chains_scan", "card_chains_scan_plan", "chain_warps",
           "chains_cluster_smem_bytes", "chains_step_us", "chain_cta_warps",
           "chains_scan_plans", "MixedProjection", "mixed_gates",
           "StreamPlan", "STREAM_STAGES", "stream_hidden",
           "stream_fixed_bytes", "stream_smem_bytes", "stream_cluster_step_us",
           "stream_step_us", "plan_stream", "plan_stream_scan",
           "card_stream", "card_stream_plan", "block_forward_step_us",
           "block_step_us", "plan_forward", "streamed_forwards",
           "BwdStreamPlan", "BWD_STREAM_STAGES", "bwd_warp_items",
           "bwd_stream_cluster_smem_bytes", "bwd_stream_smem_bytes", "bwd_stream_cluster_step_us",
           "bwd_stream_step_us", "plan_bwd_stream", "plan_bwd_stream_scan",
           "card_bwd_stream_plan", "UnrolledStreamPlan",
           "UNROLL_STREAM_GROUPS", "unrolled_stream_smem_bytes",
           "layer_stream_smem_bytes", "unrolled_stream_step_us",
           "layer_stream_step_us", "plan_unrolled_stream",
           "plan_layer_stream", "card_unrolled_stream_plan",
           "card_layer_stream_plan", "layer_block_step_us", "WidePlan",
           "WIDE_ROWS", "WIDE_STAGES", "wide_hidden", "wide_smem_bytes", "wide_step_us",
           "plan_wide_scan", "card_wide_plan",
           "wide_forwards", "resident_forwards", "BwdWidePlan",
           "BWD_WIDE_ITEMS", "BWD_WIDE_STAGES", "bwd_wide_items",
           "bwd_wide_smem_bytes", "bwd_wide_step_us", "plan_bwd_wide",
           "card_bwd_wide_plan", "wide_backwards", "resident_backwards",
           "bwd_wide_cluster_smem_bytes", "bwd_wide_cluster_step_us",
           "plan_bwd_wide_cluster"]

# kernel entry -> the csrc source that holds it
_SOURCE_OF = {"lstm_scan_fwd": "lstm_scan", "lstm_scan_fwd_carry": "lstm_scan",
              "lstm_scan_fwd_train": "lstm_scan",
              "lstm_scan_fwd_block": "lstm_scan_block",
              "lstm_scan_fwd_carry_block": "lstm_scan_block",
              "lstm_scan_fwd_train_block": "lstm_scan_block",
              "lstm_scan_fwd_stream": "lstm_scan",
              "lstm_scan_fwd_carry_stream": "lstm_scan",
              "lstm_scan_fwd_train_stream": "lstm_scan",
              "lstm_scan_fwd_wide": "lstm_scan_wide",
              "lstm_scan_fwd_carry_wide": "lstm_scan_wide",
              "lstm_scan_fwd_train_wide": "lstm_scan_wide",
              "lstm_scan_fwd_unrolled": "lstm_scan_staged",
              "lstm_scan_fwd_unrolled_block": "lstm_scan_unrolled_block",
              "lstm_layer_fwd": "lstm_scan_staged",
              "lstm_layer_fwd_block": "lstm_layer_block",
              "lstm_scan_fwd_unrolled_stream": "lstm_staged_stream",
              "lstm_layer_fwd_stream": "lstm_staged_stream",
              "lstm_scan_bwd": "lstm_scan_bwd",
              "lstm_scan_bwd_chains": "lstm_scan_bwd_chains",
              "lstm_scan_bwd_chains_block": "lstm_scan_bwd",
              "gru_scan_fwd": "gru_scan", "gru_scan_fwd_carry": "gru_scan",
              "gru_scan_fwd_block": "gru_scan_block",
              "gru_scan_fwd_carry_block": "gru_scan_block",
              "gru_scan_fwd_stream": "gru_scan",
              "gru_scan_fwd_carry_stream": "gru_scan",
              "gru_scan_fwd_wide": "gru_scan_wide",
              "gru_scan_fwd_carry_wide": "gru_scan_wide",
              "gru_scan_bwd": "gru_scan_bwd",
              "gru_scan_bwd_dwhh": "gru_scan_bwd",
              "lstm_scan_bwd_stream": "scan_bwd_stream",
              "gru_scan_bwd_stream": "scan_bwd_stream",
              "lstm_scan_bwd_wide": "lstm_scan_bwd_wide",
              "gru_scan_bwd_wide": "gru_scan_bwd_wide"}
launch_counts = dict.fromkeys(_SOURCE_OF, 0)

# Dynamic shared memory a block may opt in to on sm_90 (H100): 227 KB.
SMEM_LIMIT = 232448
_PAD = 8                   # bf16 pad per shared row, as csrc/scan_common.cuh
_ROWS = 16                 # batch rows per block (per chain)
UNROLL_STEPS = (2, 4)      # kernel E's steps per staged gate tile
CHAIN_COUNTS = (2, 4)      # kernel G's accumulator chains a warp
# CTAs per cluster of the forward scans (csrc/lstm_scan.cu, csrc/gru_scan.cu):
# 8 is the portable limit; the kernels opt in to 16, which an H100 allows.
CLUSTER_SIZES = (8, 16)
_MAX_WARPS = 18            # warps per CTA of a cluster scan, at most
# The units of H the other scan kernels take: whole 16-deep MMA k-steps.
_STEP_UNITS = 16
# scan_step_us's parts (microseconds): a step with one round of items, each
# further round of the busiest warp, and one 16-byte store of the h
# exchange. The step and the store are a least-squares fit to the steps of
# eight one-cluster plans of kernel A (H = 384: C = 8 x 16, 32 rows, C = 16 x
# 16-64 rows; H = 512: C = 16 x 16, 32 rows) on an H100 SXM at 700 W, off by
# at most 0.9 us a step; the round is the GRU's (ops/gru.py), since no plan
# at H = 384 or 512 gives a warp a second item.
_STEP_US, _ROUND_US, _STORE_US = 3.3, 2.7, 1.75e-3
# Kernel E's parts, as kernel A's (step, round, store; microseconds): the
# step and the store a least-squares fit to the steps of nine one-cluster
# plans (H = 384, K = 2 and 4, C = 8 x 16 rows and C = 16 x 16-64 rows) on
# an H100 SXM at 700 W (generative_audio_torch/scripts/perf_staged_scan.py),
# off by at most 0.4 us a step; the round is kernel A's (no plan at H = 384
# gives a warp a second item). Kernel F's (step, store, and one x k-step of
# one item, W_ih^T's fragments from L2): a least-squares fit to the steps of
# 18 one-cluster plans of the same sweep (F = 34 and 384, C = 8 and 16,
# 16-96 rows), off by at most 2.7 us a step and 1.0 us in the mean, whose
# least modelled waves x step is the measured best plan at both sub-band
# layers.
_UNROLL_PARTS = (3.06, 2.7, 1.62e-3)
_LAYER_PARTS = (5.52, 1.13e-3, 0.0291)
# The forward entries, whose C functions end in the launch plan.
_CLUSTER_ENTRIES = ("lstm_scan_fwd", "lstm_scan_fwd_carry",
                    "lstm_scan_fwd_train")
# Their streamed variants (csrc/lstm_scan.cu lstm_stream_kernel), whose C
# functions end in a StreamPlan's launch arguments.
_STREAM_ENTRIES = ("lstm_scan_fwd_stream", "lstm_scan_fwd_carry_stream",
                   "lstm_scan_fwd_train_stream")

# The ring depths (slots of one k-pair: two 16-deep k-steps of a CTA's W_hh^T
# slice) the planner of the streamed forwards weighs, and the most (m16 tile,
# 8 units) items a CTA of them takes: one consumer warp each.
STREAM_STAGES = (1, 2, 3, 4, 6, 8)
_STREAM_MAX_ITEMS = 18
# stream_step_us's parts (microseconds): a step, one 16-byte store of the h
# exchange, and, for each k-pair a CTA streams a step, the larger of its
# kilobytes' time (bulk copies from L2 at about 95 GB/s an SM) and the copy
# latency over the ring's stages. A least-squares fit to the steps of 57
# one-cluster plans (H = 640, 768, 1024; C = 8 x 16 rows and C = 16 x 16-48
# rows; rings of 1-8 stages; 0 to the most resident k-steps) on an H100 SXM
# at 700 W (generative_audio_torch/scripts/perf_stream_scan.py), off by at
# most 1.55 us a step and 0.45 in the mean; at each cluster shape its pick
# was within 6% of the measured best.
_STREAM_PARTS = (3.7616, 2.0149e-3, 0.0104, 0.36)
# block_step_us's parts (microseconds): a step of the single-block forward
# (csrc/lstm_scan_block.cu), each (round of a warp's 8-unit groups x 16-deep
# k-step) of its dependent W_hh^T fragment loads from L2 (H^2 / 1024 of
# them), or, where more, each MB of W_hh^T that the blocks of a wave read
# from L2 a step. The first two a least-squares fit to its steps at 18 rows
# (H = 640, 768, 1024), the last the most that its steps at 2056 rows (129
# blocks a wave) need, on an H100 SXM at 700 W (the same sweep).
_BLOCK_PARTS = (17.627, 0.33618, 0.35841)
# Kernels E and F as streamed clusters (csrc/lstm_staged_stream.cu): the
# gate-ring depths (K-step groups) kernel E's planner weighs, and the parts
# of their step models (microseconds): stream_cluster_step_us's four (step,
# store, kilobyte, latency), then kernel E's copy latency of a group of
# gates where the ring holds one (over its K steps), and kernel F's x
# k-step of one item (layer_step_us's term). Least-squares fits to the
# steps of one-cluster plans at T = 192 (H = 640-2048; C = 8 x 16 rows and
# C = 16 x 16-48 rows; rings of 1-8 stages, 0 to the most resident k-steps;
# E at K = 2 and 4 with one and two gate groups, 264 plans; F at F = 34 and
# F = H, 182 plans) on an H100 SXM at 700 W
# (generative_audio_torch/scripts/perf_staged_scan.py --stream), off by 1.7
# and 2.9 us a step in the mean; the most (18 and 24 us) at H = 2048 with a
# ring of one stage, which the copy latency bounds harder than the model.
UNROLL_STREAM_GROUPS = (2, 1)
_UNROLL_STREAM_PARTS = (1.3956, 1.6442e-3, 0.0142, 0.65, 0.7715)
_LAYER_STREAM_PARTS = (4.5232, 9.045e-4, 0.0178, 0.89, 0.02728)
# SMs of an H100 SXM, and the shared memory of one of them (228 KB).
H100_SMS = 132
_SM_SHARED = 233472
# Warps of a CTA of the cluster backwards (csrc/lstm_scan_bwd.cu and
# csrc/gru_scan_bwd.cu BWD_WARPS): two per (16-row tile, 8 units) item, one
# for the elementwise part and the second product, one for the recompute.
BWD_WARPS = 16
# The LSTM cluster backward's step model (bwd_cluster_step_us): a step, a
# KB of the dgates exchange, a k-step of the second product, an item and
# the stream term of an item (microseconds), fitted to the steps of five
# one-cluster plans on an H100 SXM at 700 W (H = 384: C = 8 x 16 rows, C =
# 16 x 16 resident and streamed, C = 16 x 32; H = 512: C = 16 x 16; the
# sweep of generative_audio_torch/scripts/perf_bwd_scan.py), within 0.02
# us; and a step of the single-block design, 198 us at H = 384 (38.62 ms
# over T = 195) and 190 at H = 512, taken to grow with H.
_BWD_PARTS = (4.12, 0.0435, 0.0, 0.163, 0.247)
_BWD_BLOCK_US = 198.0
# The streamed cluster backwards (csrc/scan_bwd_stream.cu): the ring depths
# the planner weighs; the (m16 tile, 8 units) items a warp carries, the
# warps of each role (compute, recompute) and the items of a CTA, at most;
# and the H up to which a resident cluster or the single block is the route
# (above it, where only the single block held H before, the planner weighs
# the streamed cluster too).
BWD_STREAM_STAGES = (1, 2, 3, 4, 6, 8)
_BWD_ITEMS_PER_WARP, _BWD_ROLE_WARPS, _BWD_STREAM_MAX_ITEMS = 3, 7, 18
_BWD_RESIDENT_MAX = 512
# bwd_stream_step_us's parts beyond the resident cluster's step
# (microseconds): a step; for each streamed slot, each KB of both rings'
# slots and a copy's latency over the stages; and each k-step of the second
# product whose A is pulled from the owners' slices (the dgates tile not
# held whole). A least-squares fit to the steps of 31 one-cluster plans (H
# = 768, 1024, 1536, 2304; C = 8 and 16; 16 and 32 rows; the whole tile and
# the slices; rings of 1-8 stages, 0 to the most resident slots) on an H100
# SXM at 700 W (generative_audio_torch/scripts/perf_bwd_scan.py --stream),
# off by at most 12.6 us a step and 4.8 in the mean.
_BWD_STREAM_PARTS = (9.62842, 0.0056, 0.5507, 0.10394)
# Kernel G's cluster step model (chains_step_us): kernel D's step model plus
# three parts (microseconds): a step, each k-step of the second product for
# each chain a warp carries beyond its first, and each m16 row tile of the
# cluster beyond its first; a least-squares fit to the steps of eight
# one-cluster plans on an H100 SXM at 700 W (2 and 4 chains; H = 384: C = 8
# x 16, C = 16 x 16 resident and streamed, C = 16 x 32 in both
# arrangements; H = 512: C = 16 x 16; the sweep of
# generative_audio_torch/scripts/perf_lstm_chains.py), off by at most 0.67
# us. Kernel G's single block: a step of 154 us at H = 384 (30.007 ms over T
# = 195 with two chains in the same sweep), taken to grow with H.
_CHAINS_PARTS = (0.415, 0.0147, 4.93)
_CHAINS_BLOCK_US = 154.0


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _cell(z: torch.Tensor, c: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LSTM cell on fp32 pre-activations z [B, 4H] (gate order i, f, g,
    o) and the state c [B, H] -> (h, c)."""
    i, f, g, o = z.split(c.shape[-1], dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


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
        h, c = _cell(z, c)
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


def lstm_layer_reference_tm(x_tm: torch.Tensor, w_ih: torch.Tensor,
                            w_hh: torch.Tensor, bias: torch.Tensor,
                            reverse: bool = False,
                            compute_dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """Plain version of kernel F: x_tm [T, B, F], w_ih [F, 4H], w_hh [H, 4H],
    bias [4H] -> h sequence [T, B, H] fp32. Each step computes z = x_t @ W_ih
    + bf16(h) @ W_hh + bias with x and both weights rounded to
    compute_dtype, fp32 products and sums, fp32 bias and c. With
    compute_dtype=torch.float32 it is the float32 layer: the projection of
    the JAX `_layer_reference` and a float32 recurrence (`_layer_reference`
    itself runs the recurrence at lstm_scan_reference_tm's default bf16)."""
    t_len, b, _ = x_tm.shape
    hsz = w_hh.shape[0]
    x = x_tm.to(compute_dtype).float()
    w_i, w = w_ih.to(compute_dtype).float(), w_hh.to(compute_dtype).float()
    bias = bias.float()
    h = torch.zeros(b, hsz, dtype=torch.float32, device=x_tm.device)
    c = torch.zeros_like(h)
    out = torch.empty(t_len, b, hsz, dtype=torch.float32, device=x_tm.device)
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        h, c = _cell(x[t] @ w_i + h.to(compute_dtype).float() @ w + bias, c)
        out[t] = h
    return out


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


def _kernel_operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in dtype, contiguous and on a 16-byte boundary: a view that lies off
    one (a slice of a packed buffer) is copied, since the kernels read
    operands in pieces of up to 16 bytes."""
    t = t.to(dtype).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _pad_units(x: torch.Tensor, hp: int) -> torch.Tensor:
    """x [..., H] -> [..., hp] with zero units appended (x itself when
    hp == H)."""
    hsz = x.shape[-1]
    return x if hsz == hp else F.pad(x, (0, hp - hsz))


def _pad_gates(x: torch.Tensor, n: int, hp: int) -> torch.Tensor:
    """x [..., n*H], n gate blocks of H units -> [..., n*hp], each block
    with zero units appended (x itself when hp == H)."""
    hsz = x.shape[-1] // n
    if hsz == hp:
        return x
    return F.pad(x.unflatten(-1, (n, hsz)), (0, hp - hsz)).flatten(-2)


def _unpad_units(x: torch.Tensor, hsz: int) -> torch.Tensor:
    """The first hsz units of x [..., hp], contiguous."""
    return x if x.shape[-1] == hsz else x[..., :hsz].contiguous()


def _unpad_gates(x: torch.Tensor, n: int, hsz: int) -> torch.Tensor:
    """The first hsz units of each of the n gate blocks of x [..., n*hp]."""
    hp = x.shape[-1] // n
    if hp == hsz:
        return x
    return x.unflatten(-1, (n, hp))[..., :hsz].flatten(-2)


def _padded_weight(w_hh: torch.Tensor, hp: int) -> torch.Tensor:
    """W_hh [H, n*H] in bf16 with zero units up to hp: [hp, n*hp], zero rows
    for the padded units' h and zero columns in each gate block."""
    w = w_hh.to(torch.bfloat16)
    hsz = w.shape[0]
    if hsz == hp:
        return w
    return F.pad(_pad_gates(w, w.shape[1] // hsz, hp), (0, 0, 0, hp - hsz))


def _fragment_weight(wt: torch.Tensor) -> torch.Tensor:
    """The kernel operand wt [n*H, H] in the MMA fragment order the cluster
    backwards read (csrc `wf`): [n][H/8][H/32][32 lanes][8] bf16, where lane
    (grp, tq) of 8-unit group G holds the B fragments (b0, b1) of k-steps 2p
    and 2p + 1 of row 8G + grp: columns 32p + 16kk + 8half + 2tq + e in the
    order (kk, half, e): _fragment_rows's order. wt itself where H % 32 != 0
    (no cluster plan takes such an H; the single block reads wt)."""
    return wt if wt.shape[1] % 32 else _fragment_rows(wt)


def _fragment_rows(w: torch.Tensor) -> torch.Tensor:
    """w [N, K] bf16 (N % 8 == 0, K % 32 == 0), rows of mma.sync B operands,
    in MMA fragment order: [N/8][K/32][32 lanes][8], where lane (grp, tq) of
    row group G holds the B fragments (b0, b1) of k-steps 2p and 2p + 1 of
    row 8G + grp: columns 32p + 16kk + 8half + 2tq + e in the order
    (kk, half, e)."""
    n, k = w.shape
    return w.reshape(n // 8, 8, k // 32, 2, 2, 4, 2).permute(
        0, 2, 1, 5, 3, 4, 6).contiguous()


def _kernel_weight(w_hh: torch.Tensor, hp: Optional[int] = None
                   ) -> torch.Tensor:
    """W_hh [H, n*H] -> the kernels' operand: [n*hp, hp] bf16, contiguous
    (torch's weight_hh layout, so each MMA B fragment is one 32-bit load),
    zero-padded to hp units (default: H, no padding)."""
    return _kernel_operand(_padded_weight(w_hh, hp or w_hh.shape[0]).t(),
                           torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """Launch plan of a cluster forward scan (csrc/lstm_scan.cu,
    csrc/gru_scan.cu, csrc/lstm_scan_staged.cu): clusters of `cluster` CTAs, each CTA owning
    H / cluster units, over `rows` batch rows per cluster (whole m16
    tiles)."""
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


SmemBytes = Callable[[int, int, int], int]      # (H, cluster, rows) -> bytes


def cluster_step_us(hsz: int, cluster: int, rows: int,
                    parts: Tuple[float, float, float]) -> float:
    """Modelled time of one step of one wave of a cluster scan, from parts
    (step, round, store) in microseconds fitted to the kernel: a step whose
    warps each take one m16 x 8-unit item (products, cell, cluster barrier,
    gates), each further round of items of the busiest warp (at most
    _MAX_WARPS warps), and the 16-byte stores of the h exchange (a CTA sends
    rows * U / 8 of them to each of its cluster - 1 peers)."""
    step_us, round_us, store_us = parts
    groups = hsz // cluster // 8
    rounds = -(-(rows // 16 * groups) // _MAX_WARPS)
    stores = rows * groups * (cluster - 1)
    return step_us + (rounds - 1) * round_us + stores * store_us


def plan_cluster_scan(what: str, hsz: int, batch: int,
                      max_clusters: Callable[[int, int], int],
                      smem_bytes: SmemBytes,
                      step_us: Callable[[int, int, int], float],
                      max_items: Optional[int] = None) -> ScanPlan:
    """A cluster scan's shape for `batch` rows at H = hsz, given its layout
    (`smem_bytes`) and step model (`step_us`, both of (H, cluster, rows)).

    For each cluster size C of CLUSTER_SIZES that splits H into groups of 8
    units, and each row count R (whole m16 tiles) whose CTA fits in
    SMEM_LIMIT bytes (and, with max_items, gives a CTA at most that many
    (m16 tile, 8 units) items), the clusters are balanced over the rows and
    `max_clusters(C, R)` (the card's cudaOccupancyMaxActiveClusters) says
    how many run at once. The plan minimises waves x step_us; ties go to
    the smaller cluster, then to fewer clusters. Raises ValueError with each
    size's reason when nothing fits."""
    if batch < 1:
        raise ValueError(f"the scan needs at least one row, got {batch}")
    tiles = -(-batch // 16)
    best, refused = None, []
    for cluster in CLUSTER_SIZES:
        if hsz % (8 * cluster):
            refused.append(f"C={cluster}: H={hsz} is no multiple of "
                           f"{8 * cluster}")
            continue
        if smem_bytes(hsz, cluster, 16) > SMEM_LIMIT:
            refused.append(f"C={cluster}: {smem_bytes(hsz, cluster, 16)} "
                           f"bytes of shared memory at 16 rows, over "
                           f"{SMEM_LIMIT}")
            continue
        for per_cluster in range(1, tiles + 1):
            clusters = -(-tiles // per_cluster)
            rows = 16 * -(-tiles // clusters)        # balanced over clusters
            smem = smem_bytes(hsz, cluster, rows)
            if smem > SMEM_LIMIT:
                break
            if max_items and rows // 16 * (hsz // cluster // 8) > max_items:
                if rows == 16:
                    refused.append(f"C={cluster}: more than {max_items} "
                                   f"items at 16 rows")
                break
            active = max_clusters(cluster, rows)
            if active < 1:
                refused.append(f"C={cluster}, R={rows}: the card runs no "
                               f"such cluster")
                continue
            waves = -(-clusters // active)
            key = (waves * step_us(hsz, cluster, rows), cluster, clusters)
            if best is None or key < best[0]:
                best = (key, ScanPlan(cluster, rows, clusters, active, waves,
                                      smem))
    if best is None:
        raise ValueError(f"no cluster plan for the {what} scan at H={hsz}, "
                         f"{batch} rows: " + "; ".join(refused))
    return best[1]


def cluster_hidden(hsz: int, smem_bytes: SmemBytes) -> int:
    """The H a cluster scan runs a layer of hsz units at: the least multiple
    of 8 C (C of CLUSTER_SIZES) at or above hsz whose CTA of 16 rows fits
    SMEM_LIMIT bytes. hsz itself when it is such a multiple (384 and 512
    are). Raises ValueError when no cluster holds the layer's W_hh slice
    (plan_forward then weighs the streamed cluster and the single block)."""
    hp = _cluster_fit(hsz, smem_bytes)
    if hp is None:
        need = ", ".join(
            f"C={c}: {smem_bytes(p, c, 16)} B at H={p}"
            for c, p in ((c, -(-hsz // (8 * c)) * 8 * c)
                         for c in CLUSTER_SIZES))
        raise ValueError(f"H={hsz} is too large for the cluster scan: no "
                         f"cluster of {CLUSTER_SIZES} holds its W_hh slice in "
                         f"{SMEM_LIMIT} B of shared memory ({need}, 16 rows)")
    return hp


def _cluster_fit(hsz: int, smem_bytes: SmemBytes) -> Optional[int]:
    for cluster in CLUSTER_SIZES:           # the smaller multiple first
        hp = -(-hsz // (8 * cluster)) * 8 * cluster
        if smem_bytes(hp, cluster, 16) <= SMEM_LIMIT:
            return hp
    return None


_single_block = [False]       # set by single_block_forwards()


@contextlib.contextmanager
def single_block_forwards():
    """Within the block, the forward wrappers of both modules take the
    single-block entries at any H: for holding them against the cluster
    entries, which they equal bit for bit where both run."""
    _single_block[0] = True
    try:
        yield
    finally:
        _single_block[0] = False


@functools.lru_cache(maxsize=None)
def _max_clusters(source: str, device_index: int, instance: Tuple[int, ...],
                  hsz: int, cluster: int, rows: int, query: str = "") -> int:
    """cudaOccupancyMaxActiveClusters of a cluster scan instance on the card
    (`query`, by default `<source>_max_clusters`, of csrc/<source>.cu, with
    the instance's flags)."""
    from generative_audio_torch.ops import _cuda
    n = ctypes.c_int(0)
    query = query or f"{source}_max_clusters"
    with torch.cuda.device(device_index):
        err = getattr(_cuda.load(source), query)(*instance, hsz, cluster,
                                                 rows, ctypes.byref(n))
    _cuda.check(source, err, query)
    return n.value


def card_plan(source: str, plan: Callable, device: torch.device, hsz: int,
              batch: int, instance: Tuple[int, ...]) -> ScanPlan:
    """`plan(hsz, batch, max_clusters)` with the occupancy of `source`'s
    instance on `device` (a CUDA device)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return plan(hsz, batch, functools.partial(_max_clusters, source, index,
                                              instance, hsz))


def scan_smem_bytes(hsz: int, cluster: int, rows: int) -> int:
    """Shared memory of one CTA of kernels A-C (csrc/lstm_scan.cu
    `cluster_smem`): the W_hh^T slice [4U][H + 8] and two bf16 h buffers
    [rows][H + 8], the CTA's fp32 c [rows][U] and its x-side gates of two
    steps [2][rows][4U] bf16, with U = H / cluster units."""
    units, stride = hsz // cluster, hsz + _PAD
    return ((4 * units + 2 * rows) * stride * 2 + rows * units * 4
            + 2 * rows * 4 * units * 2)


def scan_step_us(hsz: int, cluster: int, rows: int) -> float:
    """Modelled time of one step of one wave of kernels A-C
    (cluster_step_us with this kernel's fitted parts)."""
    return cluster_step_us(hsz, cluster, rows, (_STEP_US, _ROUND_US, _STORE_US))


def plan_scan(hsz: int, batch: int, max_clusters: Callable[[int, int], int]
              ) -> ScanPlan:
    """Kernels A-C's cluster shape for `batch` rows at H = hsz (see
    plan_cluster_scan)."""
    return plan_cluster_scan("LSTM", hsz, batch, max_clusters,
                             scan_smem_bytes, scan_step_us)


def scan_hidden(hsz: int) -> int:
    """The H kernels A-C run a layer of hsz units at (cluster_hidden)."""
    return cluster_hidden(hsz, scan_smem_bytes)


def block_smem_bytes(hsz: int) -> int:
    """Shared memory of one block of the single-block forward
    (csrc/lstm_scan_block.cu): two bf16 h tiles [16][H + 8] and fp32 c
    [16][H]."""
    return 2 * _ROWS * (hsz + _PAD) * 2 + _ROWS * hsz * 4


@functools.lru_cache(maxsize=None)
def card_scan_plan(device: torch.device, hsz: int, batch: int,
                   out_dtype: torch.dtype = torch.bfloat16,
                   carry: bool = False, train: bool = False) -> ScanPlan:
    """The plan kernels A (neither flag), B (carry) and C (train, bf16 out)
    launch with on `device` (a CUDA device) for `batch` rows at H = hsz."""
    return card_plan("lstm_scan", plan_scan, device, hsz, batch,
                     (int(out_dtype == torch.float32), int(carry), int(train)))


# ---- the streamed cluster forwards and the route of a forward --------------

@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Launch plan of the streamed variant of a cluster forward
    (csrc/lstm_scan.cu and csrc/gru_scan.cu, entries ending in `_stream`):
    clusters of `cluster` CTAs at H = `hidden` (the layer's units zero-padded
    to stream_hidden's), each CTA owning hidden / cluster units, over `rows`
    batch rows per cluster; the first `resident` 16-deep k-steps of each
    CTA's W_hh^T slice stay in shared memory, the others stream from L2
    through a ring of `stages` slots of two k-steps at every step."""
    hidden: int           # H the kernel runs at
    cluster: int          # CTAs per cluster
    rows: int             # batch rows per cluster
    resident: int         # k-steps of the slice in shared memory (even)
    stages: int           # slots of the ring, a k-pair each
    clusters: int         # clusters in the grid
    active: int           # clusters the card runs at once (occupancy)
    waves: int            # rounds of clusters, one after another
    smem_bytes: int       # dynamic shared memory of one CTA
    step_us: float        # modelled time of one step of one wave

    @property
    def launch_args(self) -> Tuple[int, int, int, int, int]:
        """The C entries' last arguments before the stream."""
        return (self.cluster, self.rows, self.resident, self.stages,
                self.smem_bytes)


# (H, cluster, rows, resident k-steps, stages) -> shared bytes of one CTA
StreamSmemBytes = Callable[[int, int, int, int, int], int]


def stream_hidden(hsz: int, cluster: int) -> int:
    """The H a streamed cluster of `cluster` CTAs runs a layer of hsz units
    at: hsz padded to whole groups of 8 units a CTA and whole k-pairs."""
    unit = 8 * cluster * 32 // math.gcd(8 * cluster, 32)
    return -(-hsz // unit) * unit


def stream_fixed_bytes(hsz: int, cluster: int, rows: int, n_gates: int,
                       extra: int = 0) -> int:
    """Shared bytes of one CTA of a streamed forward besides its slice and
    ring: two bf16 h buffers [rows][H + 8], the CTA's fp32 state [rows][U]
    and x-side gates of two steps [2][rows][n U] bf16, plus `extra`."""
    units, stride = hsz // cluster, hsz + _PAD
    return (2 * rows * stride * 2 + rows * units * 4
            + 2 * rows * n_gates * units * 2 + extra)


def stream_smem_bytes(hsz: int, cluster: int, rows: int, resident: int,
                      stages: int) -> int:
    """Shared memory of one CTA of kernels A-C's streamed variant
    (csrc/lstm_scan.cu `stream_smem`): the ring of `stages` k-pairs and the
    `resident` k-steps of the W_hh^T slice in fragment order (4U x 16 bf16
    a k-step), the h buffers, c and gates (stream_fixed_bytes) and the
    ring's two mbarriers a stage, with U = H / cluster units."""
    units = hsz // cluster
    return ((2 * stages + resident) * 4 * units * 32
            + stream_fixed_bytes(hsz, cluster, rows, 4) + 16 * stages)


def stream_cluster_step_us(hsz: int, cluster: int, rows: int, resident: int,
                           stages: int, n_gates: int,
                           parts: Tuple[float, float, float, float]) -> float:
    """Modelled time of one step of one wave of a streamed forward, from
    parts (step, store, kilobyte, latency) in microseconds: a step
    (products, cell, cluster barrier, gates), the 16-byte stores of the h
    exchange (rows * U / 8 to each of cluster - 1 peers), and for each
    k-pair the CTA streams the larger of its kilobytes' copy time and a
    copy's latency shared by the ring's stages."""
    step_us, store_us, kb_us, latency_us = parts
    units = hsz // cluster
    pairs = hsz // 32 - resident // 2
    return (step_us + rows * units // 8 * (cluster - 1) * store_us
            + pairs * max(n_gates * units * 64 / 1024 * kb_us,
                          latency_us / stages))


def stream_step_us(hsz: int, cluster: int, rows: int, resident: int,
                   stages: int) -> float:
    """Modelled time of one step of one wave of kernels A-C's streamed
    variant (stream_cluster_step_us with its fitted parts)."""
    return stream_cluster_step_us(hsz, cluster, rows, resident, stages, 4,
                                  _STREAM_PARTS)


def _stream_resident(hsz: int, cluster: int, rows: int, stages: int,
                     smem_bytes: StreamSmemBytes,
                     resident: Optional[int]) -> Optional[int]:
    """The resident k-steps of a streamed CTA: `resident` where it is even,
    leaves a k-pair streamed and fits SMEM_LIMIT with the ring, else (when
    None) the most that do; None when none does."""
    ksteps = hsz // 16
    if resident is not None:
        ok = (resident >= 0 and resident % 2 == 0 and resident < ksteps
              and smem_bytes(hsz, cluster, rows, resident, stages)
              <= SMEM_LIMIT)
        return resident if ok else None
    least = smem_bytes(hsz, cluster, rows, 0, stages)
    if least > SMEM_LIMIT:
        return None
    pair = smem_bytes(hsz, cluster, rows, 2, stages) - least
    return 2 * min((SMEM_LIMIT - least) // pair, ksteps // 2 - 1)


def plan_stream(what: str, hsz: int, batch: int,
                smem_bytes: StreamSmemBytes,
                max_clusters: Callable[[int, int, int, int, int], int],
                step_us: Callable[[int, int, int, int, int], float],
                resident: Optional[int] = None) -> StreamPlan:
    """A streamed forward's launch plan for `batch` rows of a layer of hsz
    units.

    For each cluster size C of CLUSTER_SIZES at H = stream_hidden(hsz, C),
    each row count R (whole m16 tiles, balanced over the clusters) that
    gives a CTA at most _STREAM_MAX_ITEMS (m16 tile, 8 units) items, and
    each ring depth of STREAM_STAGES no deeper than the streamed k-pairs,
    the CTA keeps the most resident k-steps that fit SMEM_LIMIT bytes
    (`resident` itself where given), `max_clusters(H, C, R, resident,
    stages)` (the card's cudaOccupancyMaxActiveClusters) run at once and a
    step takes `step_us(H, C, R, resident, stages)`. The plan minimises
    waves x step time; ties go to the smaller cluster, then to fewer
    clusters and to the shallower ring. Raises ValueError with the reasons
    when nothing fits."""
    if batch < 1:
        raise ValueError(f"the scan needs at least one row, got {batch}")
    tiles = -(-batch // 16)
    best, refused = None, []
    for cluster in CLUSTER_SIZES:
        hp = stream_hidden(hsz, cluster)
        groups = hp // cluster // 8
        if groups > _STREAM_MAX_ITEMS:
            refused.append(f"C={cluster}: {groups} items at 16 rows, over "
                           f"{_STREAM_MAX_ITEMS}")
            continue
        for per_cluster in range(1, tiles + 1):
            clusters = -(-tiles // per_cluster)
            rows = 16 * -(-tiles // clusters)        # balanced over clusters
            if rows // 16 * groups > _STREAM_MAX_ITEMS:
                break
            for stages in STREAM_STAGES:
                res = _stream_resident(hp, cluster, rows, stages, smem_bytes,
                                       resident)
                if res is None:
                    if rows == 16:
                        least = smem_bytes(hp, cluster, rows, resident or 0,
                                           stages)
                        refused.append(f"C={cluster}, {stages} stages: "
                                       f"{least} B at 16 rows")
                    continue
                if stages > hp // 32 - res // 2:
                    continue
                active = max_clusters(hp, cluster, rows, res, stages)
                if active < 1:
                    refused.append(f"C={cluster}, R={rows}: the card runs no "
                                   f"such cluster")
                    continue
                waves = -(-clusters // active)
                step = step_us(hp, cluster, rows, res, stages)
                key = (waves * step, cluster, clusters, stages)
                if best is None or key < best[0]:
                    best = (key, StreamPlan(
                        hp, cluster, rows, res, stages, clusters, active,
                        waves, smem_bytes(hp, cluster, rows, res, stages),
                        step))
    if best is None:
        raise ValueError(f"no streamed plan for the {what} scan at H={hsz}, "
                         f"{batch} rows: " + "; ".join(refused))
    return best[1]


def plan_stream_scan(hsz: int, batch: int,
                     max_clusters: Callable[[int, int, int, int, int], int],
                     resident: Optional[int] = None) -> StreamPlan:
    """Kernels A-C's streamed plan for `batch` rows of a layer of hsz units
    (plan_stream with their layout and step model)."""
    return plan_stream("LSTM", hsz, batch, stream_smem_bytes, max_clusters,
                       stream_step_us, resident)


def card_stream(source: str, plan: Callable, device: torch.device,
                hsz: int, batch: int, instance: Tuple[int, ...],
                resident: Optional[int]) -> StreamPlan:
    """`plan(hsz, batch, max_clusters, resident)` with the occupancy of
    `source`'s streamed instance on `device` (`<source>_stream_max_clusters`
    of csrc/<source>.cu)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return plan(hsz, batch, lambda h, c, r, res, stages: _max_clusters(
        source, index, (*instance, res, stages), h, c, r,
        f"{source}_stream_max_clusters"), resident)


@functools.lru_cache(maxsize=None)
def card_stream_plan(device: torch.device, hsz: int, batch: int,
                     instance: Tuple[int, int, int] = (0, 0, 0),
                     resident: Optional[int] = None) -> StreamPlan:
    """The streamed plan kernels A-C launch with on `device` (a CUDA device)
    for `batch` rows of a layer of hsz units; instance (out_f32, carry,
    train) as card_scan_plan's flags."""
    return card_stream("lstm_scan", plan_stream_scan, device, hsz, batch,
                       instance, resident)


def block_forward_step_us(hsz: int, blocks: int, n_gates: int,
                          parts: Tuple[float, float, float]) -> float:
    """Modelled time of one step of a wave of `blocks` blocks of a
    single-block forward at H = hsz, from parts (step, fragment round,
    megabyte) in microseconds: a step, each round of a warp's 8-unit groups
    and 16-deep k-step (its dependent W_hh^T fragment loads from L2), or,
    where more, each MB of W_hh^T that the wave's blocks read from L2."""
    step_us, round_us, mb_us = parts
    rounds = -(-hsz // 64) * (hsz // 16)
    megabytes = blocks * n_gates * hsz * hsz * 2 / 1e6
    return step_us + max(rounds * round_us, megabytes * mb_us)


def plan_forward(what: str, hsz: int, batch: int, smem_bytes: SmemBytes,
                 block_smem: Callable[[int], int],
                 block_step: Callable[[int, int], float],
                 stream_plan: Callable[[Optional[int]], StreamPlan],
                 sms: int = H100_SMS,
                 block_rows: Callable[[int], int] = lambda hb: _ROWS,
                 wide_plan: Optional[Callable[[], "WidePlan"]] = None,
                 resident_us: Optional[Callable[[int], float]] = None
                 ) -> Tuple[int, str, Optional[Union[StreamPlan, "WidePlan"]]]:
    """(H, entry suffix, plan) of a forward scan for `batch` rows of a layer
    of hsz units: the resident cluster ("", its plan appended at the launch)
    at cluster_hidden's H where a cluster holds the layer's W_hh slice; else
    the streamed cluster ("_stream", `stream_plan(None)`) or the single
    block ("_block", H padded to 16, ceil(batch / block_rows(H)) blocks of
    block_smem(H) bytes, sm_blocks of them at once, block_step(H, blocks of
    a wave) a step), whichever has the least waves x modelled step. Within
    single_block_forwards() the single block, within streamed_forwards() the
    streamed cluster (with its resident k-steps), at any H. The resident
    cluster does the streamed cluster's work without the stream, and the
    single block's modelled step is over 5x the resident cluster's at any H
    that both hold, so where it fits it is not weighed.
    Kernels A, B and C and the GRU forwards have a third design, the wide
    cluster ("_wide", `wide_plan()`): where a resident cluster holds the
    slice, the route is
    whichever of the two has the least modelled waves x step
    (`resident_us(H)` for the resident cluster on the card; without it, as
    for CPU tensors, which have no card's occupancy to weigh, the resident
    cluster). Within wide_forwards() the wide cluster at any H its planner
    holds, within resident_forwards() the resident cluster wherever it
    fits. Kernels A-C, the GRU forwards and kernels E and F take their
    routes here."""
    force = ("_block" if _single_block[0]
             else "_stream" if _streamed else None)
    design = _design[-1] if _design and wide_plan is not None else None
    if force is None and design == "_wide":
        plan = wide_plan()
        return plan.hidden, "_wide", plan
    if force is None:
        hp = _cluster_fit(hsz, smem_bytes)
        if hp is not None:
            if wide_plan is None or resident_us is None or design == "":
                return hp, "", None
            try:
                plan = wide_plan()
            except ValueError:
                return hp, "", None
            if plan.waves * plan.step_us < resident_us(hp):
                return plan.hidden, "_wide", plan
            return hp, "", None
    options, refused = [], []
    if force != "_block":
        try:
            plan = stream_plan(_streamed[-1] if _streamed else None)
            options.append((plan.waves * plan.step_us, 0,
                            (plan.hidden, "_stream", plan)))
        except ValueError as e:
            refused.append(str(e))
    hb = -(-hsz // _STEP_UNITS) * _STEP_UNITS
    smem = block_smem(hb)
    if force != "_stream":
        if smem <= SMEM_LIMIT:
            tiles = -(-batch // block_rows(hb))
            active = sm_blocks(smem, sms)
            waves = -(-tiles // active)
            options.append((waves * block_step(hb, min(tiles, active)), 1,
                            (hb, "_block", None)))
        else:
            refused.append(f"the single block needs {smem} B of shared "
                           f"memory, more than the {SMEM_LIMIT} B a block "
                           f"may use")
    if not options:
        raise ValueError(f"no forward for the {what} scan at H={hsz}: "
                         + "; ".join(refused))
    return min(options, key=lambda o: o[:2])[2]


_streamed: List[Optional[int]] = []   # set by streamed_forwards()


_design: List[str] = []   # set by wide_forwards() and resident_forwards()


@contextlib.contextmanager
def wide_forwards():
    """Within the block, kernels A, B and C (lstm_scan_tm without grad,
    lstm_scan_carry_tm, lstm_scan_train_tm and so LSTMScan's forward) and
    the GRU forward and carry (ops/gru.py) take the wide cluster at any H
    its planner holds: for holding it against the resident cluster, which
    it equals bit for bit."""
    _design.append("_wide")
    try:
        yield
    finally:
        _design.pop()


@contextlib.contextmanager
def resident_forwards():
    """Within the block, kernels A, B and C and the GRU forward and carry
    take the resident cluster wherever a cluster holds H, whatever the wide
    cluster's model says: for holding the wide cluster against it and
    timing both."""
    _design.append("")
    try:
        yield
    finally:
        _design.pop()


@contextlib.contextmanager
def streamed_forwards(resident_ksteps: Optional[int] = None):
    """Within the block, the forward wrappers of both modules (kernels A-C,
    E and F and the GRU forwards) take the streamed cluster at any H, with
    `resident_ksteps` resident (an even number; None: the planner's): for
    holding it against the resident cluster, which it equals bit for bit
    where both run."""
    _streamed.append(resident_ksteps)
    try:
        yield
    finally:
        _streamed.pop()


def block_step_us(hsz: int, blocks: int) -> float:
    """Modelled step of the LSTM single-block forward
    (csrc/lstm_scan_block.cu; block_forward_step_us with its parts)."""
    return block_forward_step_us(hsz, blocks, 4, _BLOCK_PARTS)


def _forward_route(hsz: int, batch: int, device: torch.device,
                   instance: Tuple[int, int, int] = (0, 0, 0)
                   ) -> Tuple[int, str, Optional[Union[StreamPlan,
                                                       "WidePlan"]]]:
    """(H, entry suffix, plan) of kernels A-C for `batch` rows of a layer of
    hsz units on `device` (plan_forward with their layouts, step models and
    the card's occupancy of the streamed instance, the wide cluster's plan
    and, on a card, the modelled time of the instance's resident cluster;
    instance (out_f32, carry, train)); raises when nothing fits. The wide
    plan is one for all three kernels: kernel C adds no shared bytes to
    kernel A's layout."""
    wide = lambda: card_wide_plan(device, hsz, batch)
    resident = None
    if _on_card(device):
        dtype = torch.float32 if instance[0] else torch.bfloat16

        def resident(hp):
            plan = card_scan_plan(device, hp, batch, dtype, bool(instance[1]),
                                  bool(instance[2]))
            return plan.waves * scan_step_us(hp, plan.cluster, plan.rows)
    return plan_forward(
        "LSTM", hsz, batch, scan_smem_bytes, block_smem_bytes, block_step_us,
        lambda res: card_stream_plan(device, hsz, batch, instance, res),
        _device_sms(device), wide_plan=wide, resident_us=resident)


def _on_card(device: torch.device) -> bool:
    """True for a CUDA device, whose occupancy the route can weigh; False
    for the CPU (the wrappers' kernel branch on CPU tensors, as the tests
    take it)."""
    return torch.device(device).type == "cuda"


def _device_sms(device: torch.device) -> int:
    """The SMs of a CUDA device; H100_SMS for the CPU (the wrappers' kernel
    branch on CPU tensors, as the tests take it)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return H100_SMS
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream_weight(w_hh: torch.Tensor, hp: int, cluster: int) -> torch.Tensor:
    """W_hh [H, n*H] -> the streamed entries' operand: zero-padded to hp
    units, each CTA's W_hh^T slice (rows q*hp + k*U + u of the kernel weight,
    U = hp / cluster) in MMA fragment order, k-pair after k-pair:
    [cluster][hp/32][n][U/8][32 lanes][8] bf16 (lane (grp, tq) of unit group
    g holds the B fragments (b0, b1) of k-steps 2p and 2p + 1 of row 8g +
    grp: columns 32p + 16kk + 8half + 2tq + e in the order (kk, half, e), as
    _fragment_rows)."""
    wt = _kernel_weight(w_hh, hp)                      # [n*hp, hp]
    n = wt.shape[0] // hp
    units = hp // cluster
    w = wt.reshape(n, cluster, units, hp).transpose(0, 1)   # [C][n][U][hp]
    return w.reshape(cluster, n * units // 8, 8, hp // 32, 2, 2, 4, 2).permute(
        0, 3, 1, 2, 6, 4, 5, 7).contiguous()


# ---- the wide cluster forwards (kernels A-C, csrc/lstm_scan_wide.cu) ----

@dataclasses.dataclass(frozen=True)
class WidePlan:
    """Launch plan of the wide cluster forwards (csrc/lstm_scan_wide.cu,
    `lstm_scan_fwd_wide`, `lstm_scan_fwd_carry_wide`,
    `lstm_scan_fwd_train_wide`: one layout for all three; with `gates` 3,
    csrc/gru_scan_wide.cu's `gru_scan_fwd_wide` and
    `gru_scan_fwd_carry_wide`): clusters of
    `cluster` CTAs at H = `hidden` (the layer's units zero-padded to
    wide_hidden's), each CTA owning hidden / cluster units (a warpgroup of
    wgmma a 16 of them), over `rows` batch rows a cluster (wgmma's N);
    the first `resident` 16-deep k-steps of each CTA's W_hh^T slice stay in
    shared memory, the others stream from L2 through a ring of `stages`
    slots of two k-steps (no ring, 0 stages, where the whole slice is
    resident). `gates` is the cell's: 4 for the LSTM, 3 for the GRU, whose
    W_hh^T is packed with a fourth gate row of zeros a unit (_wide_weight)
    and whose x-side gates are three boxes a step."""
    hidden: int           # H the kernel runs at
    cluster: int          # CTAs per cluster
    rows: int             # batch rows per cluster
    resident: int         # k-steps of the slice in shared memory (even)
    stages: int           # slots of the ring, a k-pair each
    clusters: int         # clusters in the grid
    active: int           # clusters the card runs at once (occupancy)
    waves: int            # rounds of clusters, one after another
    smem_bytes: int       # dynamic shared memory of one CTA
    step_us: float        # modelled time of one step of one wave
    gates: int = 4        # the cell's gates (4 LSTM, 3 GRU)

    @property
    def warpgroups(self) -> int:
        """Consumer warpgroups of a CTA: one a 16 units (64 gate columns)."""
        return self.hidden // self.cluster // 16

    @property
    def launch_args(self) -> Tuple[int, int, int, int, int]:
        """The C entries' last arguments before the stream."""
        return (self.cluster, self.rows, self.resident, self.stages,
                self.smem_bytes)


# The kernel's instances, rows a cluster (wgmma's N: multiples of 16 whose
# accumulators and c, rows / 2 + rows / 8 registers a thread, fit the 152 a
# thread of three warpgroups and the producer leave), and its consumer
# warpgroups a CTA, at most, as csrc/lstm_scan_wide.cu.
WIDE_ROWS = (16, 32, 48, 64, 80, 96, 112, 128, 144, 160)
_WIDE_MAX_WARPGROUPS = 3
# Depths of the wide ring: a slot goes back to the producer once the next
# k-pair's products are issued, so a ring holds two slots at least.
WIDE_STAGES = (2, 3, 4, 6, 8)
# wide_step_us's parts (microseconds): a step; each 1000 m64n8k16 blocks of
# a CTA's wgmma products; each 8-row chunk a thread's cell takes (one cell,
# two shuffles); each KB of the h exchange a CTA sends (bulk copies); and,
# for each k-pair a CTA streams, the larger of its kilobytes' time and a
# copy's latency over the ring's stages. A least-squares fit to the steps of
# 109 one-cluster plans (H = 384 at C = 8 and 16, H = 512 at C = 16; 16-160
# rows; no ring and rings of 2-6 stages) on an H100 SXM at 700 W
# (generative_audio_torch/scripts/perf_wide_scan.py), off by at most 2.53
# us a step and 0.55 in the mean. The products, the cell and the exchange
# all grow with the rows, and the sweep's two CTA layouts do not tell them
# apart: the fit puts the products' time in the cell's part (the clock64
# trace of the script measures the split).
_WIDE_PARTS = (3.24517, 0.0345, 0.38219, 0.0417, 0.0295, 0.8)
# The ops of the wide entries, whose C functions end in a WidePlan's launch
# arguments.
_WIDE_ENTRIES = ("lstm_scan_fwd_wide", "lstm_scan_fwd_carry_wide",
                 "lstm_scan_fwd_train_wide")


def wide_hidden(hsz: int, cluster: int) -> int:
    """The H a wide cluster of `cluster` CTAs runs a layer of hsz units at:
    hsz padded to whole warpgroups of 16 units a CTA (whole k-pairs)."""
    unit = 16 * cluster
    return -(-hsz // unit) * unit


def wide_smem_bytes(hsz: int, cluster: int, rows: int, resident: int,
                    stages: int, gates: int = 4) -> int:
    """Shared memory of one wide CTA (csrc/scan_fwd_wide.cuh `wide_smem`):
    128 bytes of slack to align the TMA boxes, one step of x-side gates
    [gates][rows][U] bf16, the ring of `stages` k-pairs and the `resident`
    k-steps of the W_hh^T slice (4U x 16 bf16 a k-step, the GRU's fourth
    gate row a unit zero), the bf16 h buffer [H / 8][rows][8] and the
    mbarriers (the ring's two a stage, the exchange's and the gates'), with
    U = H / cluster units."""
    units = hsz // cluster
    return (128 + 2 * gates * rows * units
            + (stages + resident // 2) * units * 256 + 2 * rows * hsz
            + 8 * (2 * stages + 2))


def wide_step_us(hsz: int, cluster: int, rows: int, resident: int,
                 stages: int, parts: Tuple[float, ...] = _WIDE_PARTS
                 ) -> float:
    """Modelled time of one step of one wave of the wide cluster, from
    `parts` (kernels A-C's _WIDE_PARTS; the GRU's own): a step, the CTA's
    wgmma products, the cell's 8-row chunks
    a thread, the KB of the bulk h exchange a CTA sends to its cluster - 1
    peers (its slice through the last row), and for each streamed k-pair
    the larger of its kilobytes' copy time and a copy's latency shared by
    the ring's stages."""
    step_us, cta_us, cell_us, x_us, kb_us, latency_us = parts
    units, ksteps = hsz // cluster, hsz // 16
    cta = units // 16 * (rows // 8) * ksteps / 1000
    sent = rows * units * 2 * (cluster - 1) / 1024
    pairs = hsz // 32 - resident // 2
    stream = pairs * max(units * 256 / 1024 * kb_us,
                         latency_us / stages) if pairs else 0.0
    return (step_us + cta * cta_us + rows // 8 * cell_us + sent * x_us
            + stream)


def _wide_resident(hsz: int, cluster: int, rows: int, stages: int,
                   resident: Optional[int], gates: int = 4) -> Optional[int]:
    """The resident k-steps of a wide CTA of a `gates`-gate cell with a
    ring of `stages`: all of
    them with no ring (stages 0); else `resident` where it is even, leaves
    a k-pair streamed and fits SMEM_LIMIT, else (None) the most that do;
    None when none does."""
    ksteps = hsz // 16
    smem = functools.partial(wide_smem_bytes, hsz, cluster, rows,
                             gates=gates)
    if stages == 0:
        ok = resident in (None, ksteps) and smem(ksteps, 0) <= SMEM_LIMIT
        return ksteps if ok else None
    if resident is not None:
        ok = (resident >= 0 and resident % 2 == 0 and resident < ksteps
              and smem(resident, stages) <= SMEM_LIMIT)
        return resident if ok else None
    least = smem(0, stages)
    if least > SMEM_LIMIT:
        return None
    pair = smem(2, stages) - least
    return 2 * min((SMEM_LIMIT - least) // pair, ksteps // 2 - 1)


def plan_wide_scan(hsz: int, batch: int,
                   max_clusters: Callable[[int, int, int, int, int], int],
                   resident: Optional[int] = None, what: str = "LSTM",
                   gates: int = 4,
                   step_us: Callable[..., float] = wide_step_us) -> WidePlan:
    """The wide cluster's launch plan for `batch` rows of a layer of hsz
    units of the `what` scan, whose cell has `gates` gates (the layout's
    bytes, wide_smem_bytes) and whose step `step_us` models (kernels A-C's
    by default; the GRU's, ops/gru.py gru_wide_step_us).

    For each cluster size C of CLUSTER_SIZES at H = wide_hidden(hsz, C)
    whose CTAs need at most _WIDE_MAX_WARPGROUPS warpgroups (16 units
    each), each row count R of WIDE_ROWS up to the first that holds the
    batch in one cluster, and each ring (none, with the whole slice
    resident, or a depth of WIDE_STAGES no deeper than the streamed
    k-pairs, with the most resident k-steps that fit, or `resident` itself
    where given), whose CTA fits SMEM_LIMIT bytes, `max_clusters(H, C, R,
    resident, stages)` (the card's cudaOccupancyMaxActiveClusters) run at
    once over ceil(batch / R) clusters and a step takes step_us. The
    plan minimises waves x step time; ties go to the smaller cluster, then
    to fewer clusters and the shallower ring. Raises ValueError with the
    reasons when nothing fits."""
    if batch < 1:
        raise ValueError(f"the scan needs at least one row, got {batch}")
    best, refused = None, []
    for cluster in CLUSTER_SIZES:
        hp = wide_hidden(hsz, cluster)
        units = hp // cluster
        if units // 16 > _WIDE_MAX_WARPGROUPS:
            refused.append(f"C={cluster}: {units} units a CTA need "
                           f"{units // 16} warpgroups of 16 (at most "
                           f"{_WIDE_MAX_WARPGROUPS})")
            continue
        fitted = idle = False
        for rows in WIDE_ROWS:
            if rows - 16 >= batch:
                break
            clusters = -(-batch // rows)
            for stages in (0, *WIDE_STAGES):
                res = _wide_resident(hp, cluster, rows, stages, resident,
                                     gates)
                if res is None or (stages and stages > hp // 32 - res // 2):
                    continue
                fitted = True
                active = max_clusters(hp, cluster, rows, res, stages)
                if active < 1:
                    idle = True
                    continue
                waves = -(-clusters // active)
                step = step_us(hp, cluster, rows, res, stages)
                key = (waves * step, cluster, clusters, stages)
                if best is None or key < best[0]:
                    best = (key, WidePlan(
                        hp, cluster, rows, res, stages, clusters, active,
                        waves, wide_smem_bytes(hp, cluster, rows, res,
                                               stages, gates), step, gates))
        if idle:
            refused.append(f"C={cluster}: the card runs no such cluster")
        if not fitted:
            refused.append(f"C={cluster}: "
                           f"{wide_smem_bytes(hp, cluster, 16, 0, 2, gates)} "
                           f"B at 16 rows (at most {SMEM_LIMIT} B)")
    if best is None:
        raise ValueError(f"no wide plan for the {what} scan at H={hsz}, "
                         f"{batch} rows: " + "; ".join(refused))
    return best[1]


@functools.lru_cache(maxsize=None)
def card_wide_plan(device: torch.device, hsz: int, batch: int,
                   resident: Optional[int] = None) -> WidePlan:
    """The wide plan kernels A, B and C launch with on `device` (a CUDA
    device) for `batch` rows of a layer of hsz units
    (lstm_scan_wide_max_clusters of csrc/lstm_scan_wide.cu; one instance
    serves the three entries and both output types, and kernel C's c
    sequence, stored from registers, adds no shared bytes, so the occupancy
    and the cache key are the same for all)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return plan_wide_scan(
        hsz, batch, lambda h, c, r, res, stages: _max_clusters(
            "lstm_scan_wide", index, (res, stages), h, c, r), resident)


def _wide_weight(w_hh: torch.Tensor, hp: int, cluster: int) -> torch.Tensor:
    """W_hh [H, 4H] (or a GRU's [H, 3H]) -> the wide entries' operand:
    zero-padded to hp units,
    each CTA's W_hh^T slice (rows q*hp + k*U + u of the kernel weight, U =
    hp / cluster) k-pair after k-pair as wgmma's K-major A operand:
    [cluster][hp/32][4 k8 groups][4U rows][8] bf16, row m = 64 wg + 16 w +
    8 hi + r holding gate q = 2 hi + (r & 1) of unit u = 16 wg + 4 w + r // 2
    (csrc/lstm_scan_wide.cu), columns 32p + 8 kg .. + 7. A GRU's gates r, z,
    n take q = 0, 1, 2 and q = 3 is a row of zeros (csrc/gru_scan_wide.cu)."""
    wt = _kernel_weight(w_hh, hp)                      # [n*hp, hp]
    if wt.shape[0] == 3 * hp:                          # the GRU: (r, z, n, 0)
        wt = torch.cat([wt, wt.new_zeros(hp, hp)])
    units = hp // cluster
    # [hi][rb][C][wg][w][r2][p][kg][j] -> [C][p][kg][wg][w][hi][r2][rb][j]
    w = wt.reshape(2, 2, cluster, units // 16, 4, 4, hp // 32, 4, 8)
    return w.permute(2, 6, 7, 3, 4, 0, 5, 1, 8).reshape(
        cluster, hp // 32, 4, 4 * units, 8).contiguous()


def unrolled_smem_bytes(hsz: int, cluster: int, rows: int, k: int) -> int:
    """Shared memory of one CTA of kernel E (csrc/lstm_scan_staged.cu
    `unrolled_smem`): the TMA ring of two groups of k steps' x-side gates
    [2][4][k][rows][U] bf16 (128 bytes of slack to align it), the W_hh^T
    slice [4U][H + 8] and two bf16 h buffers [rows][H + 8], the CTA's fp32
    c [rows][U] and the ring's two mbarriers, with U = H / cluster units."""
    units, stride = hsz // cluster, hsz + _PAD
    return (2 * 4 * k * rows * units * 2 + (4 * units + 2 * rows) * stride * 2
            + rows * units * 4 + 16 + 128)


def unrolled_step_us(hsz: int, cluster: int, rows: int) -> float:
    """Modelled time of one step of one wave of kernel E (cluster_step_us
    with its own parts: kernel A's step, with the gates from shared memory
    instead of each thread's cp.async)."""
    return cluster_step_us(hsz, cluster, rows, _UNROLL_PARTS)


def plan_unrolled(hsz: int, batch: int, k: int,
                  max_clusters: Callable[[int, int], int]) -> ScanPlan:
    """Kernel E's cluster shape for `batch` rows at H = hsz with k steps a
    group (plan_cluster_scan with its layout and step model)."""
    return plan_cluster_scan(
        f"LSTM unrolled (K={k})", hsz, batch, max_clusters,
        lambda h, c, r: unrolled_smem_bytes(h, c, r, k), unrolled_step_us)


def unrolled_block_smem_bytes(hsz: int, rows: int, k: int) -> int:
    """Shared memory of one block of kernel E's single-block route
    (csrc/lstm_scan_unrolled_block.cu `unrolled_block_smem`): two bf16 h
    tiles [16][H + 8], fp32 c [rows][H] and the gates of k steps
    [k][rows][4H] bf16."""
    return (2 * _ROWS * (hsz + _PAD) * 2 + rows * hsz * 4
            + k * rows * 4 * hsz * 2)


UNROLLED_BLOCK_ROWS = (16, 8, 4)   # rows a block of kernel E's single block


def unrolled_block_rows(hsz: int, k: int) -> int:
    """The rows a block of kernel E's single-block route takes at H = hsz
    (padded to 16) with k steps staged: the most of UNROLLED_BLOCK_ROWS
    whose block fits SMEM_LIMIT. Raises ValueError with the bytes where
    none does."""
    for rows in UNROLLED_BLOCK_ROWS:
        if unrolled_block_smem_bytes(hsz, rows, k) <= SMEM_LIMIT:
            return rows
    rows = UNROLLED_BLOCK_ROWS[-1]
    raise ValueError(
        f"lstm_scan_fwd_unrolled_block at H={hsz}, K={k} needs "
        f"{unrolled_block_smem_bytes(hsz, rows, k)} B of shared memory at "
        f"{rows} rows a block, more than the {SMEM_LIMIT} B a block may use")


def unrolled_route(hsz: int, k: int, batch: int = 1,
                   device: Optional[torch.device] = None
                   ) -> Tuple[int, str, Optional["UnrolledStreamPlan"]]:
    """(H, entry suffix, streamed plan) kernel E runs `batch` rows of a
    layer of hsz units with, k steps a group: plan_forward with kernel E's
    layouts, so the cluster ("") where one holds the slice beside the gates
    ring (up to H = 512), else the streamed cluster ("_stream",
    csrc/lstm_staged_stream.cu, at H padded to stream_hidden's units) or the
    single block ("_block", csrc/lstm_scan_unrolled_block.cu, at H padded to
    16, unrolled_block_rows a block), whichever has the least modelled
    waves x step. The streamed plan takes the occupancy of the card of
    `device`; without a device, one cluster at a time (the layouts alone,
    as the wrappers check what a CPU tensor asks for). Raises, naming the
    bytes, where none holds the layer (H above 2048 at K = 4, above 2304
    at K = 2)."""
    def stream_plan(resident):
        if device is None:
            return plan_unrolled_stream(hsz, batch, k, lambda *a: 1, resident)
        return card_unrolled_stream_plan(device, hsz, batch, k, resident)

    return plan_forward(
        f"LSTM unrolled (K={k})", hsz, batch,
        lambda h, c, r: unrolled_smem_bytes(h, c, r, k),
        lambda hb: unrolled_block_smem_bytes(hb, _unrolled_rows(hb, k), k),
        block_step_us, stream_plan,
        H100_SMS if device is None else _device_sms(device),
        lambda hb: _unrolled_rows(hb, k))


def _unrolled_rows(hsz: int, k: int) -> int:
    """unrolled_block_rows, or the fewest rows where no block fits (whose
    bytes plan_forward then names)."""
    try:
        return unrolled_block_rows(hsz, k)
    except ValueError:
        return UNROLLED_BLOCK_ROWS[-1]


def unrolled_hidden(hsz: int, k: int) -> int:
    """The H kernel E runs a layer of hsz units at (unrolled_route's, the
    layouts alone); raises where no design holds it."""
    return unrolled_route(hsz, k)[0]


@functools.lru_cache(maxsize=None)
def card_unrolled_plan(device: torch.device, hsz: int, batch: int,
                       k: int) -> ScanPlan:
    """The plan kernel E launches with on `device` (a CUDA device) for
    `batch` rows at H = hsz, k steps a group (occupancy from
    csrc/lstm_scan_staged.cu `lstm_scan_staged_max_clusters`)."""
    return card_plan("lstm_scan_staged",
                     lambda h, b, m: plan_unrolled(h, b, k, m), device, hsz,
                     batch, (k, 0))


def layer_smem_bytes(hsz: int, cluster: int, rows: int) -> int:
    """Shared memory of one CTA of kernel F (csrc/lstm_scan_staged.cu
    `layer_smem`): the W_hh^T slice [4U][H + 8] and two bf16 h buffers
    [rows][H + 8], with U = H / cluster units. c and the x product's
    accumulators live in registers, W_ih^T's fragments come from L2."""
    units, stride = hsz // cluster, hsz + _PAD
    return (4 * units + 2 * rows) * stride * 2


def layer_step_us(hsz: int, cluster: int, rows: int, f: int) -> float:
    """Modelled time of one step of one wave of kernel F, from its parts
    (step, store, x k-step) in microseconds: a step (h product, cell,
    cluster barrier), the 16-byte stores of the h exchange (rows * U / 8 to
    each of cluster - 1 peers), and the x product's ceil(f / 16) k-steps for
    each of the CTA's (m16 tile, 8 units) items, whose x and W_ih^T fragment
    loads share the SM."""
    step, store_us, kx_us = _LAYER_PARTS
    groups = hsz // cluster // 8
    items = rows // 16 * groups
    return (step + rows * groups * (cluster - 1) * store_us
            + -(-f // 16) * items * kx_us)


def plan_layer(hsz: int, batch: int, f: int,
               max_clusters: Callable[[int, int], int]) -> ScanPlan:
    """Kernel F's launch plan for `batch` rows at H = hsz and f input
    features: plan_cluster_scan with its layout and step model and at most
    _MAX_WARPS items a CTA (one warp each)."""
    return plan_cluster_scan(
        f"LSTM layer (F={f})", hsz, batch, max_clusters, layer_smem_bytes,
        lambda h, c, r: layer_step_us(h, c, r, f), max_items=_MAX_WARPS)


@functools.lru_cache(maxsize=None)
def card_layer_plan(device: torch.device, hsz: int, batch: int, f: int,
                    out_dtype: torch.dtype = torch.bfloat16) -> ScanPlan:
    """The plan kernel F launches with on `device` (a CUDA device) for
    `batch` rows at H = hsz and f input features, occupancy from
    csrc/lstm_scan_staged.cu `lstm_scan_staged_max_clusters` for the
    output type's instance."""
    return card_plan("lstm_scan_staged",
                     lambda h, b, m: plan_layer(h, b, f, m), device, hsz,
                     batch, (1, int(out_dtype == torch.float32)))


def layer_block_smem_bytes(hsz: int, f: int) -> int:
    """Shared memory of one block of kernel F's single-block route
    (csrc/lstm_layer_block.cu `layer_block_smem`): two bf16 h tiles
    [16][H + 8], fp32 c [16][H] and two x tiles [16][F16 + 8] (F16: f
    rounded up to 16)."""
    return (2 * _ROWS * (hsz + _PAD) * 2 + _ROWS * hsz * 4
            + 2 * _ROWS * (-(-f // 16) * 16 + _PAD) * 2)


def layer_block_step_us(hsz: int, blocks: int, f: int) -> float:
    """Modelled step of kernel F's single block (csrc/lstm_layer_block.cu):
    block_step_us's parts, with the x product's ceil(f / 16) k-steps of
    W_ih^T fragment loads added to each 8-unit group's rounds and W_ih^T's
    bytes to the wave's reads."""
    step_us, round_us, mb_us = _BLOCK_PARTS
    rounds = -(-hsz // 64) * (hsz // 16 + -(-f // 16))
    megabytes = blocks * 4 * hsz * (hsz + f) * 2 / 1e6
    return step_us + max(rounds * round_us, megabytes * mb_us)


def layer_route(hsz: int, f: int, batch: int = 1,
                device: Optional[torch.device] = None,
                out_dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[int, str, Optional[StreamPlan]]:
    """(H, entry suffix, streamed plan) kernel F runs `batch` rows of a
    layer of hsz units and f (even) input features with: plan_forward with
    kernel F's layouts, so the cluster ("") up to H = 512, else the
    streamed cluster ("_stream", csrc/lstm_staged_stream.cu, at H padded to
    stream_hidden's units) or the single block ("_block",
    csrc/lstm_layer_block.cu, at H padded to 16), whichever has the least
    modelled waves x step; the occupancy as unrolled_route's. Raises,
    naming the bytes, where none holds the layer (H above 2304)."""
    def stream_plan(resident):
        if device is None:
            return plan_layer_stream(hsz, batch, f, lambda *a: 1, resident)
        return card_layer_stream_plan(device, hsz, batch, f, out_dtype,
                                      resident)

    return plan_forward(
        f"LSTM layer (F={f})", hsz, batch, layer_smem_bytes,
        lambda hb: layer_block_smem_bytes(hb, f),
        lambda hb, blocks: layer_block_step_us(hb, blocks, f), stream_plan,
        H100_SMS if device is None else _device_sms(device))


# ---- kernels E and F as streamed clusters (csrc/lstm_staged_stream.cu) -----

@dataclasses.dataclass(frozen=True)
class UnrolledStreamPlan(StreamPlan):
    """Launch plan of kernel E's streamed cluster (`lstm_scan_fwd_unrolled_
    stream`): a StreamPlan whose CTAs also hold `groups` K-step groups of
    x-side gates in a TMA ring (two: the copies run K to 2K steps ahead;
    one: each group's copy waits under the exchange)."""
    groups: int = 2       # K-step groups of gates in the ring

    @property
    def launch_args(self) -> Tuple[int, int, int, int, int, int]:
        """The C entry's last arguments before the stream."""
        return (self.cluster, self.rows, self.resident, self.stages,
                self.groups, self.smem_bytes)


def unrolled_stream_smem_bytes(hsz: int, cluster: int, rows: int, k: int,
                               resident: int, stages: int, groups: int
                               ) -> int:
    """Shared memory of one CTA of kernel E streamed
    (csrc/lstm_staged_stream.cu `unrolled_stream_smem`): the TMA ring of
    `groups` groups of k steps' gates [groups][4][k][rows][U] bf16 (128
    bytes of slack to align it), the ring of `stages` k-pairs and the
    `resident` k-steps of the W_hh^T slice in fragment order (4U x 16 bf16 a
    k-step), two bf16 h buffers [rows][H + 8] and the mbarriers (two a
    stage, one a group), with U = H / cluster units. c lives in registers."""
    units, stride = hsz // cluster, hsz + _PAD
    return (groups * 4 * k * rows * units * 2
            + (2 * stages + resident) * 4 * units * 32
            + 2 * rows * stride * 2 + 16 * stages + 8 * groups + 128)


def layer_stream_smem_bytes(hsz: int, cluster: int, rows: int,
                            resident: int, stages: int) -> int:
    """Shared memory of one CTA of kernel F streamed
    (csrc/lstm_staged_stream.cu `layer_stream_smem`): the ring and the
    resident k-steps of the W_hh^T slice, two bf16 h buffers [rows][H + 8]
    and the ring's mbarriers. c and the accumulators live in registers,
    W_ih^T's fragments come from L2."""
    units, stride = hsz // cluster, hsz + _PAD
    return ((2 * stages + resident) * 4 * units * 32 + 2 * rows * stride * 2
            + 16 * stages)


def unrolled_stream_step_us(hsz: int, cluster: int, rows: int, resident: int,
                            stages: int, k: int, groups: int) -> float:
    """Modelled time of one step of one wave of kernel E streamed:
    stream_cluster_step_us with its own parts, plus, where the ring holds
    one group of gates, a group's copy latency over its k steps."""
    *parts, group_us = _UNROLL_STREAM_PARTS
    return (stream_cluster_step_us(hsz, cluster, rows, resident, stages, 4,
                                   tuple(parts))
            + (group_us / k if groups == 1 else 0.0))


def layer_stream_step_us(hsz: int, cluster: int, rows: int, resident: int,
                         stages: int, f: int) -> float:
    """Modelled time of one step of one wave of kernel F streamed:
    stream_cluster_step_us with its own parts, plus the x product's
    ceil(f / 16) k-steps for each of the CTA's items (layer_step_us's
    term)."""
    *parts, kx_us = _LAYER_STREAM_PARTS
    items = rows // 16 * (hsz // cluster // 8)
    return (stream_cluster_step_us(hsz, cluster, rows, resident, stages, 4,
                                   tuple(parts))
            + -(-f // 16) * items * kx_us)


# (H, cluster, rows, resident k-steps, stages, groups) -> clusters at once
UnrolledStreamClusters = Callable[[int, int, int, int, int, int], int]


def plan_unrolled_stream(hsz: int, batch: int, k: int,
                         max_clusters: UnrolledStreamClusters,
                         resident: Optional[int] = None
                         ) -> UnrolledStreamPlan:
    """Kernel E's streamed plan for `batch` rows of a layer of hsz units, k
    steps a group: plan_stream with its layout and step model for each gate
    ring of UNROLL_STREAM_GROUPS groups, the least modelled waves x step
    (ties to the deeper ring). Raises ValueError with the bytes where not
    even one group fits."""
    best, refused = None, []
    for groups in UNROLL_STREAM_GROUPS:
        try:
            plan = plan_stream(
                f"LSTM unrolled (K={k}, {groups} gate group(s))", hsz, batch,
                lambda h, c, r, res, st: unrolled_stream_smem_bytes(
                    h, c, r, k, res, st, groups),
                lambda h, c, r, res, st: max_clusters(h, c, r, res, st,
                                                      groups),
                lambda h, c, r, res, st: unrolled_stream_step_us(
                    h, c, r, res, st, k, groups), resident)
        except ValueError as e:
            refused.append(str(e))
            continue
        if best is None or plan.waves * plan.step_us < (
                best.waves * best.step_us):
            best = UnrolledStreamPlan(**dataclasses.asdict(plan),
                                      groups=groups)
    if best is None:
        raise ValueError("; ".join(refused))
    return best


def plan_layer_stream(hsz: int, batch: int, f: int,
                      max_clusters: Callable[[int, int, int, int, int], int],
                      resident: Optional[int] = None) -> StreamPlan:
    """Kernel F's streamed plan for `batch` rows of a layer of hsz units and
    f input features (plan_stream with its layout and step model)."""
    return plan_stream(f"LSTM layer (F={f})", hsz, batch,
                       layer_stream_smem_bytes, max_clusters,
                       lambda h, c, r, res, st: layer_stream_step_us(
                           h, c, r, res, st, f), resident)


_STAGED_STREAM = "lstm_staged_stream"


@functools.lru_cache(maxsize=None)
def card_unrolled_stream_plan(device: torch.device, hsz: int, batch: int,
                              k: int, resident: Optional[int] = None
                              ) -> UnrolledStreamPlan:
    """The streamed plan kernel E launches with on `device` (a CUDA device)
    for `batch` rows of a layer of hsz units, k steps a group (occupancy
    from csrc/lstm_staged_stream.cu `lstm_staged_stream_max_clusters` with
    (k, 0, resident, stages, groups))."""
    index = _device_index(device)
    return plan_unrolled_stream(
        hsz, batch, k, lambda h, c, r, res, stages, groups: _max_clusters(
            _STAGED_STREAM, index, (k, 0, res, stages, groups), h, c, r),
        resident)


@functools.lru_cache(maxsize=None)
def card_layer_stream_plan(device: torch.device, hsz: int, batch: int, f: int,
                           out_dtype: torch.dtype = torch.bfloat16,
                           resident: Optional[int] = None) -> StreamPlan:
    """The streamed plan kernel F launches with on `device` for `batch` rows
    of a layer of hsz units and f input features, occupancy from
    `lstm_staged_stream_max_clusters` with (1, out_f32, resident, stages,
    0)."""
    index = _device_index(device)
    out_f32 = int(out_dtype == torch.float32)
    return plan_layer_stream(
        hsz, batch, f, lambda h, c, r, res, stages: _max_clusters(
            _STAGED_STREAM, index, (1, out_f32, res, stages, 0), h, c, r),
        resident)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """Launch plan of a backward scan (csrc/lstm_scan_bwd.cu `lstm_scan_bwd`,
    csrc/gru_scan_bwd.cu `gru_scan_bwd`): the single-block design (cluster
    1: 16 rows a block, both W_hh layouts read from L2 every step) or a
    thread-block cluster of `cluster` CTAs over `rows` batch rows, each CTA
    owning H / cluster units, with the gates recompute's W_hh^T slice in
    shared memory when `resident` (else read from L2)."""
    cluster: int          # CTAs per cluster; 1 for the single-block design
    rows: int             # batch rows per cluster (block)
    resident: bool        # the recompute's W_hh^T slice in shared memory
    clusters: int         # clusters (blocks) in the grid
    active: int           # clusters (blocks) the card runs at once
    waves: int            # rounds of clusters, one after another
    smem_bytes: int       # dynamic shared memory of one CTA
    step_us: float        # modelled time of one step of one wave

    @property
    def design(self) -> str:
        return "block" if self.cluster == 1 else "cluster"

    @property
    def launch_args(self) -> Tuple[int, int, int, int]:
        """The C entry's last arguments before the stream."""
        return self.cluster, self.rows, int(self.resident), self.smem_bytes


# (H, cluster, rows, resident) -> shared bytes of one CTA of a cluster backward
BwdSmemBytes = Callable[[int, int, int, bool], int]


def bwd_slice_stride(units: int, n_gates: int) -> int:
    """Row stride (bf16) of one CTA's slice of a cluster backward's dgates
    tile (csrc `slice_stride`): its n U gate columns and a pad of 8, or 16
    where n U is no multiple of 16, so the eight rows of an MMA fragment
    fall in different banks."""
    return n_gates * units + (8 if n_gates * units % 16 == 0 else 16)


def bwd_cluster_smem_bytes(hsz: int, cluster: int, rows: int, resident: bool,
                           n_gates: int) -> int:
    """Shared memory of one CTA of a cluster backward (csrc/lstm_scan_bwd.cu
    and csrc/gru_scan_bwd.cu `bwd_cluster_smem`) with n gate columns a unit:
    the recompute's W_hh^T slice [n U][H] (fragment order) when resident,
    the W_hh slice [U][n H + 8], h_prev [rows][H + 8] and the dgates tile
    laid out by owner [cluster][rows][bwd_slice_stride], all bf16; what the
    recompute warps
    hand the elementwise part, 22 bytes a (row, unit) in both kernels (LSTM:
    z [rows][4U] fp32 and c_t, c_prev, gout [3][rows][U] bf16; GRU: gh
    [rows][3U] fp32, the x-side gates [rows][3U], gout and h_prev [rows][U]
    bf16); the second product's k-step table [n H / 16] of int2 and the
    exchange's mbarrier (16 bytes); with U = H / cluster units."""
    units, hs, gs = hsz // cluster, hsz + _PAD, n_gates * hsz + _PAD
    sw = bwd_slice_stride(units, n_gates)
    return (((n_gates * units * hsz if resident else 0) + units * gs
             + rows * hs + cluster * rows * sw) * 2
            + 22 * rows * units + n_gates * hsz // 16 * 8 + 16)


def bwd_cluster_step_us(hsz: int, cluster: int, rows: int, resident: bool,
                        n_gates: int,
                        parts: Tuple[float, float, float, float, float]
                        ) -> float:
    """Modelled time of one step of one wave of a cluster backward, from
    parts (step, kilobyte, k-step, item, stream) in microseconds: the
    barriers and waits of a step; each KB a CTA sends to its cluster - 1
    peers by bulk copies (rows of its dgates slice); each of the second
    product's n H / 16 dependent k-steps; and each (16-row tile, 8 units)
    item of a CTA, scaled by H / 384 (its recompute, elementwise part and
    products share the SM), plus the stream term an item when the
    recompute's W_hh^T slice is read from L2."""
    step_us, kb_us, kstep_us, item_us, stream_us = parts
    units = hsz // cluster
    kbytes = rows * bwd_slice_stride(units, n_gates) * 2 * (cluster - 1) / 1024
    items = rows // 16 * (units // 8)
    return (step_us + kbytes * kb_us + n_gates * hsz // 16 * kstep_us
            + items * hsz / 384 * (item_us + (0.0 if resident else stream_us)))


def plan_bwd(what: str, hsz: int, batch: int,
             max_clusters: Callable[[int, int, bool], int],
             max_blocks: Callable[[int], int], smem_bytes: BwdSmemBytes,
             step_us: Callable[[int, int, int, bool], float],
             block_smem: int, block_step_us: float,
             stream_plan: Optional[Callable[[], "BwdStreamPlan"]] = None,
             wide_plan: Optional[Callable[[], "BwdWidePlan"]] = None
             ) -> Union[BwdPlan, "BwdStreamPlan", "BwdWidePlan"]:
    """A backward scan's launch plan for `batch` rows at H = hsz: the
    single-block design, every resident cluster shape, up to H = 512 the
    wide cluster (kernel D's or the GRU's) and above it the streamed
    cluster, by modelled time.

    The single-block design takes ceil(batch / 16) blocks of block_smem
    bytes, of which `max_blocks(block_smem)` run at once, each step taking
    block_step_us. A cluster of C CTAs (C of CLUSTER_SIZES that splits H
    into groups of 8 units) over R rows (whole m16 tiles, balanced over the
    clusters, two warps for each item of a 16-row tile and 8 units, at most
    BWD_WARPS a CTA) whose CTA fits SMEM_LIMIT bytes, with the recompute's
    slice resident or not, runs `max_clusters(C, R, resident)` (the card's
    cudaOccupancyMaxActiveClusters) at once and takes step_us(H, C, R,
    resident) a step. Above H = 512, where no resident cluster holds H,
    `stream_plan()` (plan_bwd_stream's best, at H padded to its units) is
    weighed too; up to H = 512, where a resident cluster holds H,
    `wide_plan()` (the wide planner's best, plan_bwd_wide_cluster, at H
    padded to its units) where given. The plan minimises waves x step time;
    ties go to the single block, then to the smaller cluster, to fewer
    clusters and to the resident cluster. Every design gives the same bits.
    Within wide_backwards() the wide plan at any H it holds, within
    resident_backwards() no wide plan. Raises ValueError when none fits."""
    if batch < 1:
        raise ValueError(f"the scan needs at least one row, got {batch}")
    design = _bwd_design[-1] if _bwd_design and wide_plan is not None else None
    if design == "_wide":
        return wide_plan()
    tiles = -(-batch // 16)
    best, refused = None, []

    def offer(key, plan):
        nonlocal best
        if best is None or key < best[0]:
            best = (key, plan)

    if block_smem > SMEM_LIMIT:
        refused.append(f"a block needs {block_smem} B of shared memory, "
                       f"over {SMEM_LIMIT}")
    elif max_blocks(block_smem) >= 1:
        active = max_blocks(block_smem)
        waves = -(-tiles // active)
        offer((waves * block_step_us, 1, tiles),
              BwdPlan(1, 16, False, tiles, active, waves, block_smem,
                      block_step_us))
    for cluster in CLUSTER_SIZES:
        if hsz % (8 * cluster):
            continue
        groups = hsz // cluster // 8
        for resident in (True, False):
            for per_cluster in range(1, tiles + 1):
                clusters = -(-tiles // per_cluster)
                rows = 16 * -(-tiles // clusters)     # balanced over clusters
                smem = smem_bytes(hsz, cluster, rows, resident)
                if 2 * rows // 16 * groups > BWD_WARPS or smem > SMEM_LIMIT:
                    break
                active = max_clusters(cluster, rows, resident)
                if active < 1:
                    continue
                waves = -(-clusters // active)
                step = step_us(hsz, cluster, rows, resident)
                offer((waves * step, cluster, clusters),
                      BwdPlan(cluster, rows, resident, clusters, active, waves,
                              smem, step))
    if stream_plan is not None and hsz > _BWD_RESIDENT_MAX:
        try:
            plan = stream_plan()
            offer((plan.waves * plan.step_us, plan.cluster, plan.clusters, 1),
                  plan)
        except ValueError as e:
            refused.append(str(e))
    if (wide_plan is not None and design is None and hsz <= _BWD_RESIDENT_MAX
            and any(hsz % (8 * c) == 0 for c in CLUSTER_SIZES)):
        try:
            plan = wide_plan()
            offer((plan.waves * plan.step_us, plan.cluster, plan.clusters, 2),
                  plan)
        except ValueError as e:
            refused.append(str(e))
    if best is None:
        refused.append("no resident cluster holds it")
        raise ValueError(f"no plan for the {what} backward scan at H={hsz}: "
                         + "; ".join(refused))
    return best[1]


def sm_blocks(smem: int, sms: int = H100_SMS) -> int:
    """Blocks of 256 threads and `smem` dynamic shared bytes that `sms` SMs
    run at once (228 KB of shared memory an SM, 1 KB of it reserved per
    block; at most 8 blocks of 256 threads)."""
    return sms * min(8, _SM_SHARED // (smem + 1024))


def bwd_smem_bytes_cluster(hsz: int, cluster: int, rows: int,
                           resident: bool) -> int:
    """Shared memory of one CTA of the LSTM cluster backward (four gates)."""
    return bwd_cluster_smem_bytes(hsz, cluster, rows, resident, 4)


def bwd_step_us(hsz: int, cluster: int, rows: int, resident: bool) -> float:
    """Modelled time of one step of one wave of the LSTM cluster backward
    (bwd_cluster_step_us with this kernel's fitted parts)."""
    return bwd_cluster_step_us(hsz, cluster, rows, resident, 4, _BWD_PARTS)


# (H, cluster, rows, resident slots, stages, tile) -> clusters at once
StreamBwdClusters = Callable[[int, int, int, int, int, bool], int]


def _resident_occupancy(max_clusters: Callable[[int, int, bool], int]
                        ) -> StreamBwdClusters:
    """The streamed backward's occupancy where the caller gives only the
    resident cluster's: the same clusters at once (one CTA an SM either
    way)."""
    return lambda h, c, r, res, stages, tile: max_clusters(c, r, False)


def plan_bwd_scan(hsz: int, batch: int,
                  max_clusters: Callable[[int, int, bool], int],
                  sms: int = H100_SMS,
                  stream_clusters: Optional[StreamBwdClusters] = None,
                  wide_clusters: Optional[WideBwdClusters] = None
                  ) -> Union[BwdPlan, "BwdStreamPlan", "BwdWidePlan"]:
    """Kernel D's plan for `batch` rows at H = hsz (a multiple of 16): the
    single-block design, a resident cluster, up to H = 512 the wide cluster
    or above it the streamed cluster (plan_bwd), on a card of `sms` SMs; the
    streamed and the wide cluster's occupancy from `stream_clusters` and
    `wide_clusters` (default: the resident cluster's)."""
    stream_clusters = stream_clusters or _resident_occupancy(max_clusters)
    wide_clusters = wide_clusters or (
        lambda h, c, r, *plan: max_clusters(c, r, False))
    return plan_bwd("LSTM", hsz, batch, max_clusters,
                    functools.partial(sm_blocks, sms=sms),
                    bwd_smem_bytes_cluster, bwd_step_us, bwd_smem_bytes(hsz),
                    _BWD_BLOCK_US * hsz / 384,
                    lambda: plan_bwd_stream_scan(hsz, batch, stream_clusters),
                    lambda: plan_bwd_wide(hsz, batch, wide_clusters))


def _card_stream_bwd_clusters(source: str, index: int) -> StreamBwdClusters:
    """The card's occupancy of `source`'s streamed backward
    (`<source>_stream_max_clusters` of csrc/scan_bwd_stream.cu)."""
    return lambda h, c, r, res, stages, tile: _max_clusters(
        "scan_bwd_stream", index, (int(tile), res, stages), h, c, r,
        f"{source}_stream_max_clusters")


def _device_index(device: torch.device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def card_bwd_plan(source: str, plan: Callable, device: torch.device,
                  hsz: int, batch: int) -> Union[BwdPlan, "BwdStreamPlan"]:
    """`plan(hsz, batch, max_clusters, sms, stream_clusters)` with the
    occupancy of `source`'s cluster backward and of its streamed cluster
    and the SMs of `device` (a CUDA device)."""
    index = _device_index(device)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return plan(hsz, batch, lambda c, r, resident: _max_clusters(
        source, index, (int(resident),), hsz, c, r), sms,
        _card_stream_bwd_clusters(source, index))


def card_bwd_scan_plan(device: torch.device, hsz: int, batch: int
                       ) -> Union[BwdPlan, "BwdStreamPlan", "BwdWidePlan"]:
    """The plan kernel D launches with on `device` (a CUDA device) for
    `batch` rows at H = hsz (occupancy from csrc/lstm_scan_bwd.cu
    `lstm_scan_bwd_max_clusters`, csrc/scan_bwd_stream.cu
    `lstm_scan_bwd_stream_max_clusters` and csrc/lstm_scan_bwd_wide.cu
    `lstm_scan_bwd_wide_max_clusters`), within the design that
    wide_backwards() or resident_backwards() forces."""
    return _card_bwd_scan_plan(device, hsz, batch,
                               _bwd_design[-1] if _bwd_design else None)


@functools.lru_cache(maxsize=None)
def _card_bwd_scan_plan(device: torch.device, hsz: int, batch: int,
                        design: Optional[str]
                        ) -> Union[BwdPlan, "BwdStreamPlan", "BwdWidePlan"]:
    """card_bwd_scan_plan under `design` (the forced design, part of the
    key: plan_bwd reads it)."""
    index = _device_index(device)
    return card_bwd_plan("lstm_scan_bwd", functools.partial(
        plan_bwd_scan, wide_clusters=_card_wide_bwd_clusters(index)),
        device, hsz, batch)


# ---- the streamed cluster backwards ----------------------------------------

@dataclasses.dataclass(frozen=True)
class BwdStreamPlan:
    """Launch plan of a streamed cluster backward (csrc/scan_bwd_stream.cu
    `lstm_scan_bwd_stream`, `gru_scan_bwd_stream`): clusters of `cluster`
    CTAs at H = `hidden` (the layer's units zero-padded to stream_hidden's),
    each CTA owning hidden / cluster units, over `rows` batch rows per
    cluster. Both weight operands (the recompute's W_hh^T slice and the
    second product's W_hh slice) come in hidden / 32 slots of n U 64 bytes;
    the first `resident` slots of each stay in shared memory, the others
    stream from L2 through a ring of `stages` slots each at every step. With
    `tile` every CTA holds the whole dgates tile (the peers' slices arrive
    by bulk copies), else only its own slice, which the peers read in
    place."""
    hidden: int           # H the kernel runs at
    cluster: int          # CTAs per cluster
    rows: int             # batch rows per cluster
    resident: int         # slots of each operand in shared memory
    stages: int           # slots of each ring
    tile: bool            # the whole dgates tile in each CTA
    clusters: int         # clusters in the grid
    active: int           # clusters the card runs at once (occupancy)
    waves: int            # rounds of clusters, one after another
    smem_bytes: int       # dynamic shared memory of one CTA
    step_us: float        # modelled time of one step of one wave

    @property
    def design(self) -> str:
        return "stream"

    @property
    def launch_args(self) -> Tuple[int, int, int, int, int, int]:
        """The C entries' last arguments before the stream."""
        return (self.cluster, self.rows, self.resident, self.stages,
                int(self.tile), self.smem_bytes)


def bwd_warp_items(tiles: int, groups: int) -> int:
    """(m16 tile, 8 units) items a warp of the streamed backwards carries
    for `tiles` row tiles of `groups` unit groups a CTA (csrc
    `warp_items`): the fewest that leave each role at most _BWD_ROLE_WARPS
    warps; 0 where none does or the CTA has more than _BWD_STREAM_MAX_ITEMS
    items."""
    if tiles * groups > _BWD_STREAM_MAX_ITEMS:
        return 0
    for items in range(1, _BWD_ITEMS_PER_WARP + 1):
        if tiles * -(-groups // items) <= _BWD_ROLE_WARPS:
            return items
    return 0


def bwd_stream_cluster_smem_bytes(hsz: int, cluster: int, rows: int,
                                  resident: int, stages: int, tile: bool,
                                  n_gates: int) -> int:
    """Shared memory of one CTA of a streamed backward (csrc/
    scan_bwd_stream.cu `stream_bwd_smem`) with n gate columns a unit: two
    rings of `stages` slots and `resident` slots of each operand (n U 64
    bytes a slot), h_prev [rows][H + 8] bf16, the dgates tile [cluster][rows]
    [bwd_slice_stride] (tile) or the CTA's slice [rows][bwd_slice_stride]
    and a slot's A operand pulled from the owners' slices, double buffered
    [2][rows][32 n + 8], bf16, the recompute's hand-over (22 bytes a (row,
    unit)), the second product's k-step table (8 bytes a k-step) and the
    mbarriers (16 + 32 stages bytes), with U = H / cluster units."""
    units = hsz // cluster
    return (2 * (stages + resident) * n_gates * units * 64
            + rows * (hsz + _PAD) * 2
            + (cluster if tile else 1) * rows
            * bwd_slice_stride(units, n_gates) * 2
            + (0 if tile else 2) * rows * (32 * n_gates + _PAD) * 2
            + 22 * rows * units + n_gates * hsz // 16 * 8 + 16 + 32 * stages)


def bwd_stream_cluster_step_us(hsz: int, cluster: int, rows: int,
                               resident: int, stages: int, tile: bool,
                               n_gates: int,
                               cluster_parts: Tuple[float, ...],
                               stream_parts: Tuple[float, ...]) -> float:
    """Modelled time of one step of one wave of a streamed backward: the
    resident cluster's step (bwd_cluster_step_us with cluster_parts, its
    exchange only with the whole tile) plus stream_parts (step, kilobyte,
    latency, remote; microseconds): a step, for each streamed slot of the
    rings both rings' kilobytes' copy time and a copy's latency shared by
    the stages, and without the tile each of the second product's n H / 16
    k-steps that read the owners' slices in place."""
    step_us, kb_us, latency_us, remote_us = stream_parts
    parts = cluster_parts if tile else (cluster_parts[0], 0.0,
                                        *cluster_parts[2:])
    units = hsz // cluster
    streamed = hsz // 32 - resident
    return (bwd_cluster_step_us(hsz, cluster, rows, True, n_gates, parts)
            + step_us + (0.0 if tile else n_gates * hsz // 16 * remote_us)
            + streamed * (2 * n_gates * units * 64 / 1024 * kb_us
                          + latency_us / stages))


def bwd_stream_smem_bytes(hsz: int, cluster: int, rows: int, resident: int,
                          stages: int, tile: bool) -> int:
    """Shared memory of one CTA of kernel D's streamed cluster (four
    gates)."""
    return bwd_stream_cluster_smem_bytes(hsz, cluster, rows, resident, stages,
                                         tile, 4)


def bwd_stream_step_us(hsz: int, cluster: int, rows: int, resident: int,
                       stages: int, tile: bool) -> float:
    """Modelled time of one step of one wave of kernel D's streamed cluster
    (bwd_stream_cluster_step_us with its fitted parts)."""
    return bwd_stream_cluster_step_us(hsz, cluster, rows, resident, stages,
                                      tile, 4, _BWD_PARTS, _BWD_STREAM_PARTS)


def _bwd_stream_resident(hsz: int, cluster: int, rows: int, stages: int,
                         tile: bool, n_gates: int,
                         resident: Optional[int]) -> Optional[int]:
    """The resident slots of a streamed backward's CTA: `resident` where it
    leaves a slot streamed and fits SMEM_LIMIT with the rings, else (when
    None) the most that do; None when none does."""
    def smem(res):
        return bwd_stream_cluster_smem_bytes(hsz, cluster, rows, res, stages,
                                             tile, n_gates)

    slots = hsz // 32
    if resident is not None:
        ok = 0 <= resident < slots and smem(resident) <= SMEM_LIMIT
        return resident if ok else None
    if smem(0) > SMEM_LIMIT:
        return None
    return min((SMEM_LIMIT - smem(0)) // (smem(1) - smem(0)), slots - 1)


def plan_bwd_stream(what: str, hsz: int, batch: int, n_gates: int,
                    max_clusters: StreamBwdClusters,
                    step_us: Callable[[int, int, int, int, int, bool], float],
                    resident: Optional[int] = None) -> BwdStreamPlan:
    """A streamed backward's launch plan for `batch` rows of a layer of hsz
    units, n gate columns a unit.

    For each cluster size C of CLUSTER_SIZES at H = stream_hidden(hsz, C),
    each row count R (whole m16 tiles, balanced over the clusters) that
    bwd_warp_items takes, the whole dgates tile or each CTA's slice, and
    each ring depth of BWD_STREAM_STAGES no deeper than the streamed slots,
    the CTA keeps the most resident slots that fit SMEM_LIMIT bytes
    (`resident` itself where given), `max_clusters(H, C, R, resident,
    stages, tile)` (the card's cudaOccupancyMaxActiveClusters) run at once
    and a step takes `step_us(H, C, R, resident, stages, tile)`. The plan
    minimises waves x step time; ties go to the smaller cluster, to fewer
    clusters, to the shallower ring and to the whole tile. Raises
    ValueError with the reasons when nothing fits (above H = 2304 no
    cluster takes a layer: more than _BWD_STREAM_MAX_ITEMS items a CTA)."""
    if batch < 1:
        raise ValueError(f"the scan needs at least one row, got {batch}")
    tiles = -(-batch // 16)
    best, refused = None, []
    for cluster in CLUSTER_SIZES:
        hp = stream_hidden(hsz, cluster)
        groups = hp // cluster // 8
        if not bwd_warp_items(1, groups):
            refused.append(f"C={cluster}: {groups} items at 16 rows, over "
                           f"{_BWD_STREAM_MAX_ITEMS}")
            continue
        for per_cluster in range(1, tiles + 1):
            clusters = -(-tiles // per_cluster)
            rows = 16 * -(-tiles // clusters)        # balanced over clusters
            if not bwd_warp_items(rows // 16, groups):
                break
            for tile in (True, False):
                for stages in BWD_STREAM_STAGES:
                    res = _bwd_stream_resident(hp, cluster, rows, stages, tile,
                                               n_gates, resident)
                    if res is None:
                        if rows == 16 and stages == 1:
                            least = bwd_stream_cluster_smem_bytes(
                                hp, cluster, rows, resident or 0, stages,
                                tile, n_gates)
                            refused.append(
                                f"C={cluster}, {'tile' if tile else 'slice'}"
                                f": {least} B at 16 rows")
                        continue
                    if stages > hp // 32 - res:
                        continue
                    active = max_clusters(hp, cluster, rows, res, stages, tile)
                    if active < 1:
                        refused.append(f"C={cluster}, R={rows}: the card runs "
                                       f"no such cluster")
                        continue
                    waves = -(-clusters // active)
                    step = step_us(hp, cluster, rows, res, stages, tile)
                    key = (waves * step, cluster, clusters, stages, not tile)
                    if best is None or key < best[0]:
                        best = (key, BwdStreamPlan(
                            hp, cluster, rows, res, stages, tile, clusters,
                            active, waves,
                            bwd_stream_cluster_smem_bytes(
                                hp, cluster, rows, res, stages, tile,
                                n_gates),
                            step))
    if best is None:
        raise ValueError(f"no streamed plan for the {what} backward scan at "
                         f"H={hsz}, {batch} rows: " + "; ".join(refused))
    return best[1]


def plan_bwd_stream_scan(hsz: int, batch: int, max_clusters: StreamBwdClusters,
                         resident: Optional[int] = None) -> BwdStreamPlan:
    """Kernel D's streamed plan for `batch` rows of a layer of hsz units
    (plan_bwd_stream with its layout and step model)."""
    return plan_bwd_stream("LSTM", hsz, batch, 4, max_clusters,
                           bwd_stream_step_us, resident)


@functools.lru_cache(maxsize=None)
def card_bwd_stream_plan(device: torch.device, hsz: int, batch: int,
                         resident: Optional[int] = None) -> BwdStreamPlan:
    """Kernel D's streamed plan on `device` (a CUDA device) at any H, the
    resident cluster's included: for holding the streamed cluster against
    the other designs through lstm_scan_bwd_planned_tm."""
    return plan_bwd_stream_scan(
        hsz, batch, _card_stream_bwd_clusters("lstm_scan_bwd",
                                              _device_index(device)),
        resident)


def _stream_dh_weight(w_hh: torch.Tensor, hp: int, cluster: int
                      ) -> torch.Tensor:
    """W_hh [H, n*H] -> the second product's operand of the streamed
    backwards: zero-padded to hp units, the rows of each CTA's units (U =
    hp / cluster) in MMA fragment order, k-pair after k-pair over the n hp
    columns: [cluster][n hp/32][U/8][32 lanes][8] bf16 (lane (grp, tq) of
    unit group g holds the B fragments (b0, b1) of k-steps 2p and 2p + 1 of
    row 8g + grp: columns 32p + 16kk + 8half + 2tq + e in the order (kk,
    half, e), as _fragment_rows). n consecutive k-pairs make one slot, as
    one k-pair of _stream_weight's does."""
    w = _padded_weight(w_hh, hp)                       # [hp, n*hp]
    k = w.shape[1]
    units = hp // cluster
    return w.reshape(cluster, units // 8, 8, k // 32, 2, 2, 4, 2).permute(
        0, 3, 1, 2, 6, 4, 5, 7).contiguous()


# ---- kernel D as a wide cluster (csrc/lstm_scan_bwd_wide.cu) ---------------

@dataclasses.dataclass(frozen=True)
class BwdWidePlan:
    """Launch plan of kernel D's wide cluster (csrc/lstm_scan_bwd_wide.cu
    `lstm_scan_bwd_wide`): clusters of `cluster` CTAs at H = `hidden` (the
    layer's units zero-padded to stream_hidden's), each CTA owning hidden /
    cluster units, over `rows` batch rows a cluster; a warp's item is
    `tiles` m16 row tiles x `groups` 8-unit groups; the first `resident`
    16-deep k-steps of the recompute's W_hh^T slice stay in shared memory,
    the others stream from L2 through a ring of `stages` k-pairs (no ring,
    0 stages, where the whole slice is resident); the second product's ring
    holds `pieces` pieces of 64 dgates columns (read back from L2 by TMA)
    and the W_hh rows of their k-steps."""
    hidden: int           # H the kernel runs at
    cluster: int          # CTAs per cluster
    rows: int             # batch rows per cluster
    tiles: int            # m16 row tiles of a warp's item
    groups: int           # 8-unit groups of a warp's item
    resident: int         # k-steps of the W_hh^T slice in shared memory
    stages: int           # slots of the recompute's ring, a k-pair each
    pieces: int           # slots of the second product's ring
    clusters: int         # clusters in the grid
    active: int           # clusters the card runs at once (occupancy)
    waves: int            # rounds of clusters, one after another
    smem_bytes: int       # dynamic shared memory of one CTA
    step_us: float        # modelled time of one step of one wave

    @property
    def design(self) -> str:
        return "wide"

    @property
    def launch_args(self) -> Tuple[int, int, int, int, int, int, int, int]:
        """The C entry's last arguments before the stream."""
        return (self.cluster, self.rows, self.tiles, self.groups,
                self.resident, self.stages, self.pieces, self.smem_bytes)


# A wide backward warp's items, (m16 row tiles, 8-unit groups) (the
# kernel's instances), and the consumer warps of a CTA each takes at most
# (with the two producers, so that a thread holds the item's z, dh and dc
# in registers: 255 of them for 2 x 3, 168 for 1 x 3, 128 for 1 x 2); the
# second product's ring depths the planner weighs; the largest TMA box
# side (the units of a CTA and its rows, at most), as
# csrc/lstm_scan_bwd_wide.cu.
BWD_WIDE_ITEMS = ((1, 2), (1, 3), (2, 3))
_BWD_WIDE_MAX_ITEMS = {(1, 2): 14, (1, 3): 10, (2, 3): 6}
BWD_WIDE_STAGES = (1, 2, 3, 4, 6)
_BWD_WIDE_BOX = 256
# bwd_wide_step_us's parts (microseconds): a step; each 1000 m16n8k16
# products of the CTA and of its busiest warp (both products); and a
# copy's latency, shared by the stages of its ring, for each streamed slot
# of both rings. A least-squares fit to the steps of 238 one-cluster plans
# (H = 384, 512; C = 8 and 16; 16-96 rows; items 1 x 2, 1 x 3, 2 x 3;
# rings of 1-4 pieces, recompute rings of none, 1 and 3 stages) on an H100
# SXM at 700 W (generative_audio_torch/scripts/perf_bwd_scan.py --wide),
# off by at most 4.09 us a step and 0.90 in the mean. (A term for the KB a
# CTA reads from L2 fitted at -0.0016 us a KB and is left out.)
_BWD_WIDE_PARTS = (4.97593, 1.39495, 4.42631, 0.34941)
# (H, cluster, rows, tiles, groups, resident k-steps, stages, pieces) ->
# clusters at once
WideBwdClusters = Callable[[int, int, int, int, int, int, int, int], int]


def bwd_wide_items(hsz: int, cluster: int, rows: int, tiles: int,
                   groups: int) -> int:
    """Consumer warps of a wide backward CTA: one per item of `tiles` m16
    tiles x `groups` 8-unit groups."""
    return rows // 16 // tiles * (hsz // cluster // 8 // groups)


def bwd_wide_cluster_smem_bytes(hsz: int, cluster: int, rows: int,
                                resident: int, stages: int, pieces: int,
                                n_gates: int) -> int:
    """Shared memory of one CTA of a wide backward of kernel D's design
    with n gate columns a unit (csrc/lstm_scan_bwd_wide.cu
    `wide_bwd_smem`): 1024 bytes of slack to align the swizzled boxes,
    h_prev [H/64][rows][64] bf16, the second product's ring of `pieces`
    slots (a dgates piece [rows][64] and the W_hh rows of its k-steps
    [U][64], bf16), the recompute's ring of `stages` k-pairs and its
    `resident` k-steps of the W_hh^T slice in fragment order (n U x 32 bf16
    a k-pair), the cell's operands [n + 3][rows][U] bf16 (LSTM: 4 gates,
    c_t, c_prev, gout; n = 3: [n + 2], 3 gates, gout, h_prev) and the
    mbarriers (both rings' two a slot, the h tile's and the operands' two
    each), with U = H / cluster units."""
    units = hsz // cluster
    operands = n_gates + (3 if n_gates == 4 else 2)
    return (1024 + rows * 128 * (hsz // 64 + pieces) + pieces * units * 128
            + (stages + resident // 2) * units * 64 * n_gates
            + 2 * operands * rows * units + 8 * (2 * stages + 2 * pieces + 4))


def bwd_wide_smem_bytes(hsz: int, cluster: int, rows: int, resident: int,
                        stages: int, pieces: int) -> int:
    """Shared memory of one CTA of kernel D's wide cluster
    (bwd_wide_cluster_smem_bytes with four gates)."""
    return bwd_wide_cluster_smem_bytes(hsz, cluster, rows, resident, stages,
                                       pieces, 4)


def bwd_wide_cluster_step_us(hsz: int, cluster: int, rows: int, tiles: int,
                             groups: int, resident: int, stages: int,
                             pieces: int, n_gates: int,
                             parts: Tuple[float, float, float, float]
                             ) -> float:
    """Modelled time of one step of one wave of a wide backward with n gate
    columns a unit, from parts (step, CTA, warp, latency; microseconds): a
    step, each 1000 m16n8k16 products (both: the recompute's n U columns
    over H and dh's U columns over n H) of the CTA and of its busiest warp,
    and a copy's latency over the ring's depth for each streamed k-pair of
    the recompute's ring and each dgates piece of the second product's."""
    step_us, cta_us, warp_us, latency_us = parts
    units, ksteps = hsz // cluster, hsz // 16
    cta = rows // 16 * (units // 8) * 2 * n_gates * ksteps / 1000
    warp = tiles * groups * 2 * n_gates * ksteps / 1000
    streamed = hsz // 32 - resident // 2
    slots = ((streamed / stages if streamed else 0.0)
             + n_gates * hsz // 64 / pieces)
    return step_us + cta * cta_us + warp * warp_us + slots * latency_us


def bwd_wide_step_us(hsz: int, cluster: int, rows: int, tiles: int,
                     groups: int, resident: int, stages: int,
                     pieces: int) -> float:
    """Modelled time of one step of one wave of kernel D's wide cluster
    (bwd_wide_cluster_step_us with four gates and _BWD_WIDE_PARTS)."""
    return bwd_wide_cluster_step_us(hsz, cluster, rows, tiles, groups,
                                    resident, stages, pieces, 4,
                                    _BWD_WIDE_PARTS)


# (H, cluster, rows, resident k-steps, stages, pieces) -> shared bytes
WideBwdSmemBytes = Callable[[int, int, int, int, int, int], int]


def _bwd_wide_resident(hsz: int, cluster: int, rows: int, stages: int,
                       pieces: int, resident: Optional[int],
                       smem_bytes: WideBwdSmemBytes = bwd_wide_smem_bytes
                       ) -> Optional[int]:
    """The resident k-steps of a wide backward CTA (layout `smem_bytes`,
    kernel D's by default) with rings of `stages` and `pieces`: all of them
    with no recompute ring (stages 0); else `resident` where it is even,
    leaves a k-pair streamed and fits SMEM_LIMIT, else (None) the most that
    do; None when none does."""
    ksteps = hsz // 16

    def smem(res, st):
        return smem_bytes(hsz, cluster, rows, res, st, pieces)

    if stages == 0:
        ok = resident in (None, ksteps) and smem(ksteps, 0) <= SMEM_LIMIT
        return ksteps if ok else None
    if resident is not None:
        ok = (resident >= 0 and resident % 2 == 0 and resident < ksteps
              and smem(resident, stages) <= SMEM_LIMIT)
        return resident if ok else None
    least = smem(0, stages)
    if least > SMEM_LIMIT:
        return None
    pair = smem(2, stages) - least
    return 2 * min((SMEM_LIMIT - least) // pair, ksteps // 2 - 1)


def plan_bwd_wide_cluster(what: str, hsz: int, batch: int,
                          max_clusters: WideBwdClusters,
                          smem_bytes: WideBwdSmemBytes,
                          step_us: Callable[..., float],
                          resident: Optional[int] = None) -> BwdWidePlan:
    """A wide backward's launch plan for `batch` rows of a layer of hsz
    units, with its layout `smem_bytes` and step model `step_us` (H,
    cluster, rows, tiles, groups, resident, stages, pieces).

    For each cluster size C of CLUSTER_SIZES at H = stream_hidden(hsz, C)
    whose CTAs hold at most _BWD_WIDE_BOX units, each item of
    BWD_WIDE_ITEMS (m16 tiles, 8-unit groups) that divides the CTA's unit
    groups, each row count R (a multiple of the item's rows, at most
    _BWD_WIDE_BOX) that gives a CTA at most the item's consumer warps, each
    recompute ring (none, with the whole slice resident, or a depth of
    STREAM_STAGES no deeper than the streamed k-pairs, with the most
    resident k-steps that fit, or `resident` itself where given) and each
    second ring of BWD_WIDE_STAGES pieces, whose CTA fits SMEM_LIMIT bytes,
    `max_clusters(H, C, R, tiles, groups, resident, stages, pieces)` (the
    card's cudaOccupancyMaxActiveClusters) run at once over ceil(batch / R)
    clusters and a step takes step_us. The plan minimises waves x step
    time; ties go to the smaller cluster, then to fewer clusters, the
    shallower rings and the smaller item. Raises ValueError with the
    reasons when nothing fits."""
    if batch < 1:
        raise ValueError(f"the scan needs at least one row, got {batch}")
    best, refused = None, []
    for cluster in CLUSTER_SIZES:
        hp = stream_hidden(hsz, cluster)
        units = hp // cluster
        items = [(t, g) for t, g in BWD_WIDE_ITEMS if units // 8 % g == 0]
        if not items or units > _BWD_WIDE_BOX:
            refused.append(f"C={cluster}: {units} units a CTA (whole items "
                           f"of {sorted({g for _, g in BWD_WIDE_ITEMS})} "
                           f"8-unit groups, at most {_BWD_WIDE_BOX})")
            continue
        fitted = idle = False
        for tiles, groups in items:
            for rows in range(16 * tiles, _BWD_WIDE_BOX + 1, 16 * tiles):
                if (bwd_wide_items(hp, cluster, rows, tiles, groups)
                        > _BWD_WIDE_MAX_ITEMS[tiles, groups]
                        or rows - 16 * tiles >= batch):
                    break
                clusters = -(-batch // rows)
                for pieces in BWD_WIDE_STAGES:
                    for stages in (0, *STREAM_STAGES):
                        res = _bwd_wide_resident(hp, cluster, rows, stages,
                                                 pieces, resident, smem_bytes)
                        if res is None or (stages and stages >
                                           hp // 32 - res // 2):
                            continue
                        fitted = True
                        active = max_clusters(hp, cluster, rows, tiles,
                                              groups, res, stages, pieces)
                        if active < 1:
                            idle = True
                            continue
                        waves = -(-clusters // active)
                        step = step_us(hp, cluster, rows, tiles, groups, res,
                                       stages, pieces)
                        key = (waves * step, cluster, clusters, stages,
                               pieces, tiles * groups)
                        if best is None or key < best[0]:
                            best = (key, BwdWidePlan(
                                hp, cluster, rows, tiles, groups, res,
                                stages, pieces, clusters, active, waves,
                                smem_bytes(hp, cluster, rows, res, stages,
                                           pieces),
                                step))
        if idle:
            refused.append(f"C={cluster}: the card runs no such cluster")
        if not fitted:
            t, g = items[0]
            refused.append(f"C={cluster}: "
                           f"{smem_bytes(hp, cluster, 16 * t, 0, 1, 1)}"
                           f" B and {bwd_wide_items(hp, cluster, 16 * t, t, g)}"
                           f" items at {16 * t} rows (at most {SMEM_LIMIT} B "
                           f"and {_BWD_WIDE_MAX_ITEMS[t, g]} items)")
    if best is None:
        raise ValueError(f"no wide plan for the {what} backward scan at "
                         f"H={hsz}, {batch} rows: " + "; ".join(refused))
    return best[1]


def plan_bwd_wide(hsz: int, batch: int, max_clusters: WideBwdClusters,
                  resident: Optional[int] = None) -> BwdWidePlan:
    """Kernel D's wide plan for `batch` rows of a layer of hsz units
    (plan_bwd_wide_cluster with its layout and step model)."""
    return plan_bwd_wide_cluster("LSTM", hsz, batch, max_clusters,
                                 bwd_wide_smem_bytes, bwd_wide_step_us,
                                 resident)


def _card_wide_bwd_clusters(index: int) -> WideBwdClusters:
    """The card's occupancy of kernel D's wide cluster
    (`lstm_scan_bwd_wide_max_clusters` of csrc/lstm_scan_bwd_wide.cu)."""
    return lambda h, c, r, tiles, groups, res, stages, pieces: _max_clusters(
        "lstm_scan_bwd_wide", index, (tiles, groups, res, stages, pieces), h,
        c, r)


@functools.lru_cache(maxsize=None)
def card_bwd_wide_plan(device: torch.device, hsz: int, batch: int,
                       resident: Optional[int] = None) -> BwdWidePlan:
    """Kernel D's wide plan on `device` (a CUDA device) at any H its planner
    holds, for holding it against the other designs through
    lstm_scan_bwd_planned_tm and timing it."""
    return plan_bwd_wide(hsz, batch,
                         _card_wide_bwd_clusters(_device_index(device)),
                         resident)


_bwd_design: List[str] = []   # set by wide_backwards(), resident_backwards()


@contextlib.contextmanager
def wide_backwards():
    """Within the block, kernel D (lstm_scan_bwd_tm, LSTMScan's backward)
    and the GRU backward scan (ops/gru.py gru_scan_bwd_streams_tm, GRUScan's
    backward) take their wide cluster at any H its planner holds: for
    holding it against the resident cluster, which it equals bit for
    bit."""
    _bwd_design.append("_wide")
    try:
        yield
    finally:
        _bwd_design.pop()


@contextlib.contextmanager
def resident_backwards():
    """Within the block, the plans of kernel D and of the GRU backward scan
    weigh no wide cluster (the single block, the resident cluster and,
    above H = 512, the streamed cluster, as before it): for holding the
    wide cluster against it and timing both."""
    _bwd_design.append("")
    try:
        yield
    finally:
        _bwd_design.pop()


@dataclasses.dataclass(frozen=True)
class ChainsPlan:
    """Launch plan of kernel G with `chains` chains a warp: its cluster
    (csrc/lstm_scan_bwd_chains.cu `lstm_scan_bwd_chains`: kernel D's cluster
    of `cluster` CTAs over `rows` rows, the recompute's W_hh^T slice
    resident or not, each compute warp carrying up to `chains` (m16 tile, 8
    units) items: row tiles of one unit group (arrangement 0) or unit groups
    of one row tile (arrangement 1)), or its single block (cluster 1,
    csrc/lstm_scan_bwd.cu `lstm_scan_bwd_chains_block`: chains x 16 rows a
    block)."""
    chains: int           # independent accumulator chains a warp, 2 or 4
    cluster: int          # CTAs per cluster; 1 for the single block
    rows: int             # batch rows per cluster (block)
    resident: bool        # the recompute's W_hh^T slice in shared memory
    arrangement: int      # 0: a warp's chains are row tiles; 1: unit groups
    clusters: int         # clusters (blocks) in the grid
    active: int           # clusters (blocks) the card runs at once
    waves: int            # rounds of clusters, one after another
    smem_bytes: int       # dynamic shared memory of one CTA
    step_us: float        # modelled time of one step of one wave

    @property
    def design(self) -> str:
        return "block" if self.cluster == 1 else "cluster"

    @property
    def launch_args(self) -> Tuple[int, ...]:
        """The C entry's last arguments before the stream: the cluster's
        plan, or the single block's shared bytes."""
        if self.cluster == 1:
            return (self.smem_bytes,)
        return (self.cluster, self.rows, int(self.resident),
                self.arrangement, self.smem_bytes)


CHAIN_ARRANGEMENTS = (0, 1)        # kernel G: chains of row tiles, of units


def chain_cta_warps(n_chains: int) -> int:
    """Warps of a CTA of kernel G's cluster with n_chains chains a compute
    warp (csrc/lstm_scan_bwd_chains.cu `chain_cta_warps`)."""
    return 12 if n_chains == 2 else 8


def chain_warps(tiles: int, groups: int, n_chains: int,
                arrangement: int) -> Tuple[int, int]:
    """(compute warps, most chains a warp carries) of a CTA of kernel G's
    cluster with `tiles` m16 row tiles and `groups` groups of 8 units
    (csrc/lstm_scan_bwd_chains.cu `compute_warps`)."""
    if arrangement == 0:
        return -(-tiles // n_chains) * groups, min(n_chains, tiles)
    return tiles * -(-groups // n_chains), min(n_chains, groups)


def chains_cluster_smem_bytes(hsz: int, cluster: int, rows: int,
                              resident: bool) -> int:
    """Shared memory of one CTA of kernel G's cluster
    (csrc/lstm_scan_bwd_chains.cu `chains_cluster_smem`): kernel D's
    cluster layout."""
    return bwd_smem_bytes_cluster(hsz, cluster, rows, resident)


def chains_step_us(hsz: int, cluster: int, rows: int, resident: bool,
                   n_chains: int) -> float:
    """Modelled time of one step of one wave of kernel G's cluster: kernel
    D's step model for the same cluster (bwd_step_us) plus _CHAINS_PARTS: a
    step, each of the second product's 4H / 16 k-steps for each chain a
    warp carries beyond its first (its mma.sync, its fragment loads and its
    share of the elementwise part, in the same warp), and each m16 row tile
    beyond the first."""
    step_us, chain_us, tile_us = _CHAINS_PARTS
    return (bwd_step_us(hsz, cluster, rows, resident) + step_us
            + (n_chains - 1) * 4 * hsz // 16 * chain_us
            + (rows // 16 - 1) * tile_us)


def chains_block_step_us(hsz: int) -> float:
    """Modelled step of kernel G's single block: _CHAINS_BLOCK_US at H = 384,
    taken to grow with H."""
    return _CHAINS_BLOCK_US * hsz / 384


def chains_scan_plans(hsz: int, batch: int, n_chains: int,
                      max_clusters: Callable[[int, int, bool, int], int],
                      sms: int = H100_SMS
                      ) -> Tuple[List[ChainsPlan], List[str]]:
    """Every launch plan of kernel G for `batch` rows at H = hsz (a multiple
    of 16) with n_chains chains a warp, with the reasons for what fits
    nowhere: (plans, refusals).

    The cluster: C of CLUSTER_SIZES that splits H into groups of 8 units, R
    rows (whole m16 tiles, balanced over the clusters), the recompute's
    slice resident or not, and an arrangement in which a warp carries all
    n_chains chains (kernel G never runs fewer), whose CTA fits SMEM_LIMIT
    bytes and chain_cta_warps warps (ceil(items / n_chains) compute warps
    and one recompute warp an item); `max_clusters(C, R, resident,
    arrangement)` (the card's cudaOccupancyMaxActiveClusters) of them run
    at once, each step taking chains_step_us. The single block: n_chains x
    16 rows a block where its shared memory fits and its warps' registers
    hold dc (H <= 1024 / n_chains), sm_blocks of them at once, each step
    chains_block_step_us."""
    tiles = -(-batch // 16)
    plans, refused = [], []
    for cluster in CLUSTER_SIZES:
        if hsz % (8 * cluster):
            refused.append(f"C={cluster}: H={hsz} is no multiple of "
                           f"{8 * cluster}")
            continue
        groups = hsz // cluster // 8
        least = chains_cluster_smem_bytes(hsz, cluster, 16, False)
        if least > SMEM_LIMIT:
            refused.append(f"C={cluster}: {least} B at 16 rows")
            continue
        for resident in (True, False):
            for arrangement in CHAIN_ARRANGEMENTS:
                for per_cluster in range(1, tiles + 1):
                    clusters = -(-tiles // per_cluster)
                    rows = 16 * -(-tiles // clusters)
                    smem = chains_cluster_smem_bytes(hsz, cluster, rows,
                                                     resident)
                    warps, chains = chain_warps(rows // 16, groups, n_chains,
                                                arrangement)
                    if (smem > SMEM_LIMIT
                            or warps + rows // 16 * groups
                            > chain_cta_warps(n_chains)):
                        break
                    if chains < n_chains:
                        continue
                    active = max_clusters(cluster, rows, resident,
                                          arrangement)
                    if active < 1:
                        continue
                    plans.append(ChainsPlan(
                        n_chains, cluster, rows, resident, arrangement,
                        clusters, active, -(-clusters // active), smem,
                        chains_step_us(hsz, cluster, rows, resident,
                                       n_chains)))
    block = bwd_smem_bytes(hsz, n_chains)
    if block > SMEM_LIMIT or hsz > 1024 // n_chains:
        refused.append(f"single block: {block} B")
    else:
        blocks = -(-batch // (16 * n_chains))
        active = sm_blocks(block, sms)
        plans.append(ChainsPlan(n_chains, 1, 16 * n_chains, False, 0, blocks,
                                active, -(-blocks // active), block,
                                chains_block_step_us(hsz)))
    return plans, refused


def plan_chains_scan(hsz: int, batch: int, n_chains: int,
                     max_clusters: Callable[[int, int, bool, int], int],
                     sms: int = H100_SMS) -> ChainsPlan:
    """Kernel G's launch plan for `batch` rows at H = hsz (a multiple of 16)
    with n_chains chains a warp: of chains_scan_plans', the least waves x
    step time; ties go to the cluster, then to the smaller cluster, to
    fewer clusters, and to chains of unit groups (at C=16 x 32, H=384, the
    whole batch ran 11.30 us a step a wave with chains of units and 17.21
    with chains of row tiles: perf_lstm_chains.py --sweep). Raises
    ValueError, with the bytes, when no design holds the chains."""
    if n_chains not in CHAIN_COUNTS:
        raise ValueError(f"n_chains must be one of {CHAIN_COUNTS}, got "
                         f"{n_chains}")
    if batch < 1:
        raise ValueError(f"the scan needs at least one row, got {batch}")
    plans, refused = chains_scan_plans(hsz, batch, n_chains, max_clusters,
                                       sms)
    if not plans:
        raise ValueError(f"no plan for the chains backward (kernel G) with "
                         f"{n_chains} chains at H={hsz}: " + "; ".join(refused)
                         + f"; a block may use {SMEM_LIMIT} B")
    return min(plans, key=lambda p: (p.waves * p.step_us, p.cluster == 1,
                                     p.cluster, p.clusters, -p.arrangement))


@functools.lru_cache(maxsize=None)
def card_chains_scan_plan(device: torch.device, hsz: int, batch: int,
                          n_chains: int) -> ChainsPlan:
    """The plan kernel G launches with on `device` (a CUDA device) for
    `batch` rows at H = hsz with n_chains chains (occupancy from
    csrc/lstm_scan_bwd_chains.cu `lstm_scan_bwd_chains_max_clusters` for the
    instance, SMs from the device)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return plan_chains_scan(
        hsz, batch, n_chains,
        lambda c, r, resident, arrangement: _max_clusters(
            "lstm_scan_bwd_chains", index,
            (n_chains, arrangement, int(resident)), hsz, c, r), sms)


def _launch(fn_name: str, *args,
            plan: Optional[Union[ScanPlan, BwdPlan, StreamPlan,
                                 BwdStreamPlan, WidePlan, BwdWidePlan]] = None
            ) -> None:
    """Launch csrc entry `fn_name` (see _launch_kernel), of this module or
    of ops/gru.py (whose own _launch has appended any plan). Kernels A-C are
    cluster launches: their arguments end in (T, B, H, reverse), and
    card_scan_plan's plan for (H, B) on the tensors' card is appended to
    them. Kernel D's arguments end the same way, and `plan` (default:
    card_bwd_scan_plan's for (H, B) without the wide cluster, which takes
    other operands) is appended to them; so are kernel G's
    cluster's (arguments ending in T, B, H, n_chains; default
    card_chains_scan_plan's) and kernel E's
    (arguments ending in T, B, H, k; default card_unrolled_plan's) and
    kernel F's (ending in T, B, F, H, reverse; default card_layer_plan's
    for the output type). The streamed variants of A-C take `plan` (the
    StreamPlan the wrapper packed W_hh for; no default), and so do kernel
    D's streamed cluster (the BwdStreamPlan) and kernels E's and F's
    (an UnrolledStreamPlan, a StreamPlan), the wide entries of A, B
    and C (the WidePlan the wrapper packed W_hh for) and kernel D's wide
    cluster (the BwdWidePlan). Raises first,
    before any plan asks the card and
    before anything is built, for a tensor off a 16-byte boundary: the
    wrappers hand every kernel aligned operands, and a misaligned read
    would end the CUDA context."""
    for i, a in enumerate(args):
        if isinstance(a, torch.Tensor) and a.data_ptr() % 16:
            raise ValueError(f"argument {i} of {fn_name} lies off a 16-byte "
                             f"boundary")
    if fn_name == "lstm_scan_fwd_unrolled":
        b, hsz, k = args[-3:]
        plan = plan or card_unrolled_plan(args[0].device, hsz, b, k)
        args = (*args, *plan.launch_args)
    elif fn_name == "lstm_layer_fwd":
        out_f32, b, f, hsz = args[-6], args[-4], args[-3], args[-2]
        plan = plan or card_layer_plan(
            args[0].device, hsz, b, f,
            torch.float32 if out_f32 else torch.bfloat16)
        args = (*args, *plan.launch_args)
    elif fn_name == "lstm_scan_bwd":
        b, hsz = args[-3], args[-2]
        if plan is None:        # the wrapper asked already where wide weighs
            with resident_backwards():
                plan = card_bwd_scan_plan(args[0].device, hsz, b)
        if not isinstance(plan, BwdPlan):
            raise ValueError(f"lstm_scan_bwd launches with a BwdPlan, got "
                             f"{type(plan).__name__}")
        args = (*args, *plan.launch_args)
    elif fn_name == "lstm_scan_bwd_chains":
        b, hsz, n_chains = args[-3:]
        plan = plan or card_chains_scan_plan(args[0].device, hsz, b, n_chains)
        args = (*args, *plan.launch_args)
    elif fn_name in _CLUSTER_ENTRIES:
        train = fn_name == "lstm_scan_fwd_train"
        b, hsz = args[-3], args[-2]
        out_f32 = not train and bool(args[-5])
        plan = card_scan_plan(args[0].device, hsz, b,
                              torch.float32 if out_f32 else torch.bfloat16,
                              fn_name == "lstm_scan_fwd_carry", train)
        args = (*args, *plan.launch_args)
    elif fn_name in _STREAM_ENTRIES:
        args = (*args, *_stream_args(fn_name, plan, args[-2]))
    elif fn_name in _WIDE_ENTRIES:
        args = (*args, *_wide_args(fn_name, plan, args[-2], 4))
    elif fn_name == "lstm_scan_bwd_stream":
        args = (*args, *_stream_args(fn_name, plan, args[-2], BwdStreamPlan))
    elif fn_name == "lstm_scan_bwd_wide":
        args = (*args, *_stream_args(fn_name, plan, args[-2], BwdWidePlan))
    elif fn_name == "lstm_scan_fwd_unrolled_stream":
        args = (*args, *_stream_args(fn_name, plan, args[-2],
                                     UnrolledStreamPlan))
    elif fn_name == "lstm_layer_fwd_stream":
        args = (*args, *_stream_args(fn_name, plan, args[-2]))
    _launch_kernel(fn_name, *args)


def _stream_args(fn_name: str, plan, hsz: int,
                 kind: type = StreamPlan) -> Tuple[int, ...]:
    """A streamed entry's plan arguments; the wrappers hand the plan (a
    `kind`) they packed W_hh for, at the H it gives."""
    if not isinstance(plan, kind) or plan.hidden != hsz:
        raise ValueError(f"{fn_name} launches with the {kind.__name__} its "
                         f"weight was packed for, at H={hsz}")
    return plan.launch_args


def _wide_args(fn_name: str, plan, hsz: int, gates: int) -> Tuple[int, ...]:
    """A wide entry's plan arguments: the WidePlan of a `gates`-gate cell
    the wrapper packed W_hh for, at the H it gives (an LSTM's plan never
    launches the GRU's entry, nor the other way round)."""
    args = _stream_args(fn_name, plan, hsz, WidePlan)
    if plan.gates != gates:
        raise ValueError(f"{fn_name} launches with a WidePlan of {gates} "
                         f"gates, got {plan.gates}")
    return args


def _launch_kernel(fn_name: str, *args) -> None:
    """Launch csrc entry `fn_name` on the tensors' device and current stream.
    `args` are the C function's arguments in order, without the stream:
    tensors (passed as their data pointers, aligned: _launch checks them)
    and ints."""
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


def bwd_smem_bytes(hsz: int, n_chains: int = 1) -> int:
    """Shared memory of one block of the single-block backward
    (csrc/lstm_scan_bwd.cu `block_smem` a chain): per 16-row chain the bf16
    h_prev and dgates tiles and fp32 dh (dc lives in registers)."""
    return n_chains * ((_ROWS * (hsz + _PAD) + _ROWS * (4 * hsz + _PAD)) * 2
                       + _ROWS * hsz * 4)


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_unrolled(t_len: int, hsz: int, block_t: int, reverse: bool,
                    out_dtype: torch.dtype, grad: bool) -> None:
    """Kernel E runs the forward inference scan with bf16 output only, over
    whole groups of block_t steps, at an H that its cluster or its single
    block holds (on either device, as the kernel it reorganises)."""
    if block_t not in UNROLL_STEPS:
        raise ValueError(f"block_t must be 1 or one of {UNROLL_STEPS}, got "
                         f"{block_t}")
    if reverse or out_dtype != torch.bfloat16 or grad:
        raise ValueError("block_t > 1 runs the forward scan with bf16 output "
                         "and no gradient")
    if t_len % block_t:
        raise ValueError(f"T={t_len} is no multiple of block_t={block_t}")
    unrolled_hidden(hsz, block_t)


def lstm_scan_tm(gates_x: torch.Tensor, w_hh: torch.Tensor,
                 reverse: bool = False,
                 out_dtype: torch.dtype = torch.bfloat16,
                 block_t: int = 1) -> torch.Tensor:
    """LSTM recurrence, time-major: gates_x [T, B, 4H] (cast to bf16 as the
    kernel's input), w_hh [H, 4H] -> h sequence [T, B, H] in out_dtype.
    h and c start at zero. CUDA tensors run kernel A, or with block_t = 2
    or 4 kernel E (forward, bf16 output, T a multiple of block_t; the same
    h bit for bit; H zero-padded to unrolled_route's units: the cluster up
    to H = 512, above it the streamed cluster or the single block); when
    autograd
    records and an input requires grad, the call goes through LSTMScan
    (kernels C and D) instead, on either device."""
    t_len, b, hsz = _check_shapes(gates_x, w_hh, out_dtype)
    grad = _wants_grad(gates_x, w_hh)
    if block_t != 1:
        _check_unrolled(t_len, hsz, block_t, reverse, out_dtype, grad)
    if grad:
        return LSTMScan.apply(gates_x, w_hh, reverse, out_dtype)
    gates = gates_x.to(torch.bfloat16)
    if not _is_cuda(gates, w_hh):
        return lstm_scan_reference_tm(gates, w_hh, reverse).to(out_dtype)
    _check_kernel_operand("gates_x", gates, torch.bfloat16)
    if block_t != 1:
        return _scan_unrolled(gates, w_hh, block_t)
    out_f32 = out_dtype == torch.float32
    hp, route, plan = _forward_route(hsz, max(b, 1), gates.device,
                                     (int(out_f32), 0, 0))
    out = torch.empty(t_len, b, hp, dtype=out_dtype, device=gates.device)
    if t_len and b:
        _launch("lstm_scan_fwd" + route, _pad_gates(gates, 4, hp),
                _route_weight(w_hh, hp, plan), out, out_f32, t_len, b, hp,
                reverse, plan=plan)
    return _unpad_units(out, hsz)


def _route_weight(w_hh: torch.Tensor, hp: int,
                  plan: Optional[Union[StreamPlan, WidePlan]]
                  ) -> torch.Tensor:
    """The forward entries' W_hh operand at hp units (both modules): packed
    for the streamed cluster of `plan` (fragment order) or the wide one
    (wgmma's order; raises where the plan is for another cell's gates),
    else the kernel weight [n*hp, hp]."""
    if plan is None:
        return _kernel_weight(w_hh, hp)
    if isinstance(plan, WidePlan):
        gates = w_hh.shape[1] // w_hh.shape[0]
        if plan.gates != gates:
            raise ValueError(f"a WidePlan of {plan.gates} gates packs no "
                             f"W_hh of {gates} gates")
        return _wide_weight(w_hh, hp, plan.cluster)
    return _stream_weight(w_hh, hp, plan.cluster)


def _scan_unrolled(gates: torch.Tensor, w_hh: torch.Tensor, block_t: int,
                   plan: Optional[Union[ScanPlan, UnrolledStreamPlan]] = None
                   ) -> torch.Tensor:
    """Kernel E on bf16 CUDA gates [T, B, 4H]: unrolled_route's design at
    its H (zero-padded), or the design of a given plan (a ScanPlan: the
    cluster; an UnrolledStreamPlan: the streamed cluster at its H)."""
    t_len, b, g4 = gates.shape
    hsz = g4 // 4
    if plan is None:
        hp, route, plan = unrolled_route(hsz, block_t, max(b, 1),
                                         gates.device)
    elif isinstance(plan, UnrolledStreamPlan):
        hp, route = plan.hidden, "_stream"
    else:
        hp, route = _staged_cluster_hidden(
            "E", hsz, lambda h, c, r: unrolled_smem_bytes(h, c, r, block_t)), ""
    out = torch.empty(t_len, b, hp, dtype=torch.bfloat16, device=gates.device)
    if t_len and b:
        tail = (out, t_len, b, hp, block_t)
        if route == "_block":
            rows = unrolled_block_rows(hp, block_t)
            _launch("lstm_scan_fwd_unrolled_block", _pad_gates(gates, 4, hp),
                    _kernel_weight(w_hh, hp), *tail, rows,
                    unrolled_block_smem_bytes(hp, rows, block_t))
        else:
            _launch("lstm_scan_fwd_unrolled" + route,
                    _pad_gates(gates, 4, hp),
                    _route_weight(w_hh, hp, plan if route else None), *tail,
                    plan=plan)
    return _unpad_units(out, hsz)


def _staged_cluster_hidden(kernel: str, hsz: int, smem_bytes: SmemBytes
                           ) -> int:
    """The H kernel E's or F's resident cluster runs a layer of hsz units
    at, for a given cluster plan; raises where no cluster holds it."""
    hp = _cluster_fit(hsz, smem_bytes)
    if hp is None:
        raise ValueError(f"no cluster of kernel {kernel} takes H={hsz}")
    return hp


def lstm_scan_unrolled_planned_tm(gates: torch.Tensor, w_hh: torch.Tensor,
                                  plan: Union[ScanPlan, UnrolledStreamPlan],
                                  block_t: int) -> torch.Tensor:
    """lstm_scan_tm(..., block_t) on CUDA tensors with a given launch plan
    of kernel E: a ScanPlan of plan_unrolled's layout (the cluster, at H
    padded to its units) or an UnrolledStreamPlan (the streamed cluster, at
    the plan's H), for holding the plans against kernel A and timing
    them."""
    t_len, _, hsz = _check_shapes(gates, w_hh, torch.bfloat16)
    _check_unrolled(t_len, hsz, block_t, False, torch.bfloat16, False)
    if not _is_cuda(gates, w_hh):
        raise ValueError("a launch plan is for CUDA tensors")
    gates = gates.to(torch.bfloat16)
    _check_kernel_operand("gates_x", gates, torch.bfloat16)
    return _scan_unrolled(gates, w_hh, block_t, plan)


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
    _check_kernel_operand("gates_x", gates, torch.bfloat16)
    _check_kernel_operand("h0", h0, torch.float32)
    _check_kernel_operand("c0", c0, torch.float32)
    if not (t_len and b):
        return (torch.empty(t_len, b, hsz, dtype=out_dtype,
                            device=gates.device), h0.clone(), c0.clone())
    out_f32 = out_dtype == torch.float32
    hp, route, plan = _forward_route(hsz, b, gates.device,
                                     (int(out_f32), 1, 0))
    out = torch.empty(t_len, b, hp, dtype=out_dtype, device=gates.device)
    h_t = torch.empty(b, hp, dtype=torch.float32, device=gates.device)
    c_t = torch.empty_like(h_t)
    _launch("lstm_scan_fwd_carry" + route, _pad_gates(gates, 4, hp),
            _route_weight(w_hh, hp, plan), _pad_units(h0, hp),
            _pad_units(c0, hp), out, h_t, c_t, out_f32, t_len, b, hp, reverse,
            plan=plan)
    return (_unpad_units(out, hsz), _unpad_units(h_t, hsz),
            _unpad_units(c_t, hsz))


def lstm_scan_train_tm(gates: torch.Tensor, w_hh: torch.Tensor,
                       reverse: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: bf16 gates [T, B, 4H], w_hh [H, 4H] ->
    (h_seq, c_seq) [T, B, H] bf16, the residuals lstm_scan_bwd_tm needs.
    h_seq equals lstm_scan_tm's bf16 output bit for bit. CUDA tensors run
    kernel C on the route of _forward_route: its wide cluster
    (`lstm_scan_fwd_train_wide`, W_hh^T packed for the WidePlan, which the
    entry is handed) where a resident cluster holds H and the wide one
    models faster on the card (the 2304-row sub-band training batch), else
    the resident cluster, the streamed cluster or the single block; the
    same h_seq and c_seq bit for bit. CPU tensors never weigh the wide
    cluster unless wide_forwards() forces it."""
    t_len, b, hsz = _check_shapes(gates, w_hh, torch.bfloat16)
    if not _is_cuda(gates, w_hh):
        return lstm_scan_train_reference_tm(gates.to(torch.bfloat16), w_hh,
                                            reverse)
    _check_kernel_operand("gates", gates, torch.bfloat16)
    hp, route, plan = _forward_route(hsz, max(b, 1), gates.device, (0, 0, 1))
    h_seq = torch.empty(t_len, b, hp, dtype=torch.bfloat16,
                        device=gates.device)
    c_seq = torch.empty_like(h_seq)
    if t_len and b:
        _launch("lstm_scan_fwd_train" + route, _pad_gates(gates, 4, hp),
                _route_weight(w_hh, hp, plan), h_seq, c_seq, t_len, b, hp,
                reverse, plan=plan)
    return _unpad_units(h_seq, hsz), _unpad_units(c_seq, hsz)


def lstm_scan_bwd_tm(gates: torch.Tensor, h_seq: torch.Tensor,
                     c_seq: torch.Tensor, gout: torch.Tensor,
                     w_hh: torch.Tensor, reverse: bool = False,
                     n_chains: int = 1) -> torch.Tensor:
    """The backward scan: bf16 gates [T, B, 4H], the residuals h_seq and
    c_seq of lstm_scan_train_tm and the cotangent gout of h_seq, all
    [T, B, H] bf16, w_hh [H, 4H] -> dgates [T, B, 4H] bf16. CUDA tensors run
    kernel D with card_bwd_scan_plan's plan (a thread-block cluster, the
    single-block design, up to H = 512 the wide cluster or above it the
    streamed cluster: the same dgates bit for bit; on a card the plan
    weighs the wide cluster, on CPU tensors, which have no card's occupancy,
    only within wide_backwards()), or with n_chains = 2 or 4 kernel G with
    card_chains_scan_plan's (a forward that was not reversed; its cluster,
    or its single block where no cluster holds H; the same dgates bit for
    bit). Both zero-pad H to whole 16-deep k-steps (the streamed cluster to
    its plan's H). Raises where no design holds H: kernel D above H = 2304,
    kernel G above H = 512 (two chains) or where no cluster and no single
    block holds four chains (ValueError with the bytes)."""
    return _scan_bwd(gates, h_seq, c_seq, gout, w_hh, reverse, n_chains)


def lstm_scan_bwd_planned_tm(gates: torch.Tensor, h_seq: torch.Tensor,
                             c_seq: torch.Tensor, gout: torch.Tensor,
                             w_hh: torch.Tensor,
                             plan: Union[BwdPlan, BwdStreamPlan, BwdWidePlan,
                                         ChainsPlan],
                             reverse: bool = False) -> torch.Tensor:
    """lstm_scan_bwd_tm on CUDA tensors with a given launch plan: of kernel
    D (a BwdPlan for the operands' H, padded to 16, and any design; a
    BwdStreamPlan or a BwdWidePlan at its H) or of kernel G (a ChainsPlan,
    whose chains it runs), for holding the designs against each other and
    timing plans."""
    if not _is_cuda(gates, h_seq, c_seq, gout, w_hh):
        raise ValueError("a launch plan is for CUDA tensors")
    n_chains = plan.chains if isinstance(plan, ChainsPlan) else 1
    return _scan_bwd(gates, h_seq, c_seq, gout, w_hh, reverse, n_chains, plan)


def _scan_bwd(gates: torch.Tensor, h_seq: torch.Tensor, c_seq: torch.Tensor,
              gout: torch.Tensor, w_hh: torch.Tensor, reverse: bool,
              n_chains: int,
              plan: Optional[Union[BwdPlan, ChainsPlan, BwdStreamPlan,
                                   BwdWidePlan]] = None
              ) -> torch.Tensor:
    t_len, b, hsz = _check_shapes(gates, w_hh, torch.bfloat16)
    for name, x in (("h_seq", h_seq), ("c_seq", c_seq), ("gout", gout)):
        if tuple(x.shape) != (t_len, b, hsz):
            raise ValueError(f"{name} must be [{t_len}, {b}, {hsz}], got "
                             f"{tuple(x.shape)}")
    if n_chains != 1 and (n_chains not in CHAIN_COUNTS or reverse):
        raise ValueError(f"n_chains must be 1 or, for a forward that was not "
                         f"reversed, one of {CHAIN_COUNTS}; got {n_chains} "
                         f"with reverse={reverse}")
    if not _is_cuda(gates, h_seq, c_seq, gout, w_hh):
        return lstm_scan_bwd_reference_tm(
            gates.to(torch.bfloat16), h_seq.to(torch.bfloat16),
            c_seq.to(torch.bfloat16), gout.to(torch.bfloat16), w_hh, reverse)
    hp = -(-hsz // _STEP_UNITS) * _STEP_UNITS
    if n_chains != 1 and t_len and b:
        plan = plan or card_chains_scan_plan(gates.device, hp, b, n_chains)
    elif plan is None and t_len and b and (
            hp > _BWD_RESIDENT_MAX or _on_card(gates.device) or _bwd_design):
        # on a card the plan weighs the wide cluster, so the wrapper asks
        # for it first (the wide entry takes other operands)
        plan = card_bwd_scan_plan(gates.device, hp, b)
    hp = _bwd_hidden(hp, plan)
    for name, x in (("gates", gates), ("h_seq", h_seq), ("c_seq", c_seq),
                    ("gout", gout)):
        _check_kernel_operand(name, x, torch.bfloat16)
    dgates = torch.empty(t_len, b, 4 * hp, dtype=torch.bfloat16,
                         device=gates.device)
    if not (t_len and b):
        return _unpad_gates(dgates, 4, hsz)
    streams = (_pad_gates(gates, 4, hp), _pad_units(h_seq, hp),
               _pad_units(c_seq, hp), _pad_units(gout, hp))
    shape = (t_len, b, hp)
    if isinstance(plan, (BwdStreamPlan, BwdWidePlan)):
        # both W_hh operands in MMA fragment order, slot after slot: the
        # recompute's W_hh^T slices and the second product's W_hh rows
        _launch("lstm_scan_bwd_" + plan.design, *streams,
                _stream_weight(w_hh, hp, plan.cluster),
                _stream_dh_weight(w_hh, hp, plan.cluster), dgates, *shape,
                reverse, plan=plan)
        return _unpad_gates(dgates, 4, hsz)
    # W_hh in both layouts: [4H, H] for the gates recompute (and in fragment
    # order for the clusters'), [H, 4H] (the 4H axis contiguous) for
    # dgates @ W_hh^T
    wt = _kernel_weight(w_hh, hp)
    w = _kernel_operand(_padded_weight(w_hh, hp), torch.bfloat16)
    if n_chains == 1:
        operands = (*streams, wt, w, _fragment_weight(wt), dgates, *shape,
                    reverse)
        if plan is None:
            _launch("lstm_scan_bwd", *operands)
        else:
            _launch("lstm_scan_bwd", *operands, plan=plan)
    elif plan.design == "block":
        _launch("lstm_scan_bwd_chains_block", *streams, wt, w, dgates,
                *shape, n_chains, *plan.launch_args)
    else:
        _launch("lstm_scan_bwd_chains", *streams, w, _fragment_weight(wt),
                dgates, *shape, n_chains, plan=plan)
    return _unpad_gates(dgates, 4, hsz)


def _bwd_hidden(hp: int, plan) -> int:
    """The H a backward runs a layer of hp units (a multiple of 16) at: hp,
    or a streamed or wide plan's H (hp padded to stream_hidden's units;
    raises for a plan of another layer)."""
    if not isinstance(plan, (BwdStreamPlan, BwdWidePlan)):
        return hp
    if plan.hidden != stream_hidden(hp, plan.cluster):
        raise ValueError(f"a {plan.design} plan at H={plan.hidden} is for no "
                         f"layer of {hp} units")
    return plan.hidden


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, P] @ b [P, Q], both bf16 -> [N, Q] in fp32: bf16 operands, fp32
    accumulation and fp32 output (a plain matmul outside the kernels)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _dw_hh(h_seq: torch.Tensor, dgates: torch.Tensor, reverse: bool
           ) -> torch.Tensor:
    """dW_hh = sum_t h_prev[t]^T @ dgates[t] [H, 4H] fp32, with h_prev one
    processing step earlier (the first processed step saw h = 0 and adds
    nothing), as one contraction with fp32 output."""
    if reverse:                     # processed t = T-1 .. 0
        h_prev, dg = h_seq[1:], dgates[:-1]
    else:                           # processed t = 0 .. T-1
        h_prev, dg = h_seq[:-1], dgates[1:]
    return _mm_f32(h_prev.reshape(-1, h_seq.shape[-1]).t(),
                   dg.reshape(-1, dgates.shape[-1]))


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
            dw_hh = _dw_hh(h_seq, dgates, ctx.reverse).to(w_hh.dtype)
        return dgates.to(ctx.gates_dtype), dw_hh, None, None


# fp32 bytes of one block of MixedProjection's forward: the float32 product
# exists one block at a time, so the route's peak is the bf16 gates plus one
# block (the whole product would be twice the gates: 7.9 GB at 8 x 10 s x
# 257 bins, H=384).
_MIXED_BLOCK_BYTES = 256 << 20


class MixedProjection(torch.autograd.Function):
    """The hoisted input projection of a float32 model's recurrent layer on
    the JAX package's TPU route: (x [..., F], w [F, G], bias [G]) -> gates
    [..., G] bf16 = bf16(bf16(x) @ bf16(w) accumulated in fp32 + bias), the
    fp32 bias added to the fp32 product and the sum rounded once, as
    `jnp.einsum(..., preferred_element_type=float32) + bias` then
    `.astype(bfloat16)` does. The product is computed in row blocks of
    _MIXED_BLOCK_BYTES of fp32.

    Backward, for the bf16 cotangent the scans return: dx = dgates @ bf16(w)^T
    and dW = bf16(x)^T @ dgates with fp32 accumulation, returned in x's and
    w's dtype; with round_grads each is first rounded to bf16, as the
    transpose of the JAX einsum rounds to its bf16 operand's dtype (the
    hoisted route; the JAX chunked layers' VJPs keep them fp32); dbias = the
    fp32 sum of dgates."""

    @staticmethod
    def forward(ctx, x, w, bias, round_grads=True):
        f, g = w.shape
        xb = x.to(torch.bfloat16).reshape(-1, f)
        wb = w.to(torch.bfloat16)
        gates = torch.empty(xb.shape[0], g, dtype=torch.bfloat16,
                            device=x.device)
        bias32 = bias.float()
        rows = max(1, _MIXED_BLOCK_BYTES // (4 * g))
        for s in range(0, xb.shape[0], rows):
            gates[s:s + rows] = _mm_f32(xb[s:s + rows], wb) + bias32
        ctx.save_for_backward(xb, wb)
        ctx.x_shape, ctx.dtypes = x.shape, (x.dtype, w.dtype, bias.dtype)
        ctx.grad_dtype = torch.bfloat16 if round_grads else torch.float32
        return gates.reshape(*x.shape[:-1], g)

    @staticmethod
    def backward(ctx, dgates):
        xb, wb = ctx.saved_tensors
        x_dtype, w_dtype, b_dtype = ctx.dtypes
        dg = dgates.to(torch.bfloat16).reshape(-1, wb.shape[1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (_mm_f32(dg, wb.t()).to(ctx.grad_dtype).to(x_dtype)
                  .reshape(ctx.x_shape))
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(xb.t(), dg).to(ctx.grad_dtype).to(w_dtype)
        if ctx.needs_input_grad[2]:
            db = dg.sum(0, dtype=torch.float32).to(b_dtype)
        return dx, dw, db, None


def mixed_gates(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                round_grads: bool = True) -> torch.Tensor:
    """MixedProjection: x [..., F], w [F, G], bias [G] -> bf16 gates
    [..., G], the fp32-accumulated projection plus the fp32 bias rounded to
    bf16 once (the JAX TPU route of a float32 model)."""
    return MixedProjection.apply(x, w, bias, round_grads)


def _check_layer_shapes(x_tm: torch.Tensor, w_ih: torch.Tensor,
                        w_hh: torch.Tensor, bias: torch.Tensor,
                        out_dtype: torch.dtype) -> Tuple[int, int, int, int]:
    if x_tm.ndim != 3:
        raise ValueError(f"x_tm must be [T, B, F], got {tuple(x_tm.shape)}")
    t_len, b, f = x_tm.shape
    hsz = w_hh.shape[0]
    shapes = {"w_ih": (w_ih, (f, 4 * hsz)), "w_hh": (w_hh, (hsz, 4 * hsz)),
              "bias": (bias, (4 * hsz,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    return t_len, b, f, hsz


def _kernel_input_weight(w_ih: torch.Tensor, f_pad: int) -> torch.Tensor:
    """W_ih [F, 4H] -> kernel F's operand: [4H, F_pad] bf16, contiguous, with
    zero columns from F to F_pad (a multiple of 16: whole MMA k-steps; of 32
    for the cluster's fragment order)."""
    w = w_ih.t().to(torch.bfloat16)
    return _kernel_operand(F.pad(w, (0, f_pad - w.shape[1])), torch.bfloat16)


def lstm_layer_tm(x_tm: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                  bias: torch.Tensor, reverse: bool = False,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Whole LSTM layer, time-major, projection inside the scan: x_tm
    [T, B, F], w_ih [F, 4H], w_hh [H, 4H], bias [4H] -> [T, B, H] in
    out_dtype. CUDA tensors run kernel F, which computes x_t @ W_ih inside
    the scan, so the [T, B, 4H] gates never exist: at H zero-padded to
    layer_route's units, the cluster up to H = 512, above it the streamed
    cluster (`lstm_layer_fwd_stream`, up to H = 2304) or the single block
    (`lstm_layer_fwd_block`); CPU tensors run the plain version. When
    autograd records and an input requires grad, the call goes through
    LSTMLayerScan (hoisted projection, kernels C and D), as the JAX
    function's VJP does. The JAX function's `block_b` and `interpret` are
    TPU knobs and are not carried over."""
    _check_layer_shapes(x_tm, w_ih, w_hh, bias, out_dtype)
    if _wants_grad(x_tm, w_ih, w_hh, bias):
        return LSTMLayerScan.apply(x_tm, w_ih, w_hh, bias, reverse, out_dtype)
    if not _is_cuda(x_tm, w_ih, w_hh, bias):
        return lstm_layer_reference_tm(x_tm, w_ih, w_hh, bias,
                                       reverse).to(out_dtype)
    return _layer_fwd(x_tm, w_ih, w_hh, bias, reverse, out_dtype)


def lstm_layer_planned_tm(x_tm: torch.Tensor, w_ih: torch.Tensor,
                          w_hh: torch.Tensor, bias: torch.Tensor,
                          plan: Union[ScanPlan, StreamPlan],
                          reverse: bool = False,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """lstm_layer_tm on CUDA tensors without grad, with a given launch plan
    of kernel F: a ScanPlan (the cluster, at H padded to its units) or a
    StreamPlan (the streamed cluster, at the plan's H), for holding the
    plans against the single block and timing them."""
    _check_layer_shapes(x_tm, w_ih, w_hh, bias, out_dtype)
    if not _is_cuda(x_tm, w_ih, w_hh, bias):
        raise ValueError("a launch plan is for CUDA tensors")
    return _layer_fwd(x_tm, w_ih, w_hh, bias, reverse, out_dtype, plan)


def _layer_fwd(x_tm: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
               bias: torch.Tensor, reverse: bool, out_dtype: torch.dtype,
               plan: Optional[Union[ScanPlan, StreamPlan]] = None
               ) -> torch.Tensor:
    """Kernel F on CUDA tensors: layer_route's design (or a given plan's),
    W_ih, W_hh and the bias zero-padded to its units, x with an even F."""
    t_len, b, f = x_tm.shape
    hsz = w_hh.shape[0]
    x = x_tm.to(torch.bfloat16)
    if f % 2:                   # the kernels read x rows in 4-byte pieces
        x = F.pad(x, (0, 1))
    x = x.contiguous()
    f_even = x.shape[-1]
    if plan is None:
        hp, route, plan = layer_route(hsz, f_even, max(b, 1), x.device,
                                      out_dtype)
    elif isinstance(plan, StreamPlan):
        hp, route = plan.hidden, "_stream"
    else:
        hp, route = _staged_cluster_hidden("F", hsz, layer_smem_bytes), ""
    _check_kernel_operand("x_tm", x, torch.bfloat16)
    w_i = _pad_gates(w_ih, 4, hp)
    out = torch.empty(t_len, b, hp, dtype=out_dtype, device=x.device)
    if t_len and b:
        tail = (_route_weight(w_hh, hp, plan if route == "_stream" else None),
                _kernel_operand(_pad_gates(bias, 4, hp), torch.float32), out,
                out_dtype == torch.float32, t_len, b, f_even, hp, reverse)
        if route == "_block":
            _launch("lstm_layer_fwd_block", x,
                    _kernel_input_weight(w_i, -(-f_even // 16) * 16), *tail)
        else:
            _launch("lstm_layer_fwd" + route, x, _fragment_rows(
                _kernel_input_weight(w_i, -(-f_even // 32) * 32)), *tail,
                plan=plan)
    return _unpad_units(out, hsz)


class LSTMLayerScan(torch.autograd.Function):
    """lstm_layer_tm with a gradient: (x_tm [T, B, F], w_ih [F, 4H], w_hh
    [H, 4H], bias [4H], reverse, out_dtype) -> h sequence [T, B, H].

    Forward, as the JAX `_layer_fwd`: the hoisted projection x @ W_ih in
    bf16 with fp32 output, plus the fp32 bias, rounded once to bf16 gates;
    then lstm_scan_train_tm (kernel C). Backward, as `_layer_bwd`:
    lstm_scan_bwd_tm (kernel D) on the cotangent rounded to bf16, then dx =
    dgates @ W_ih^T, dW_ih = x^T @ dgates, db = sum of dgates and dW_hh, each
    with fp32 output and cast to its input's dtype. On CPU tensors both
    kernels are their plain versions."""

    @staticmethod
    def forward(ctx, x_tm, w_ih, w_hh, bias, reverse, out_dtype):
        t_len, b, f = x_tm.shape
        x = x_tm.to(torch.bfloat16).contiguous()
        gates = (_mm_f32(x.reshape(-1, f), w_ih.to(torch.bfloat16))
                 + bias.float()).to(torch.bfloat16).reshape(t_len, b, -1)
        h_seq, c_seq = lstm_scan_train_tm(gates, w_hh, reverse)
        ctx.save_for_backward(x, w_ih, w_hh, bias, gates, h_seq, c_seq)
        ctx.reverse = reverse
        ctx.x_dtype = x_tm.dtype
        return h_seq.to(out_dtype)

    @staticmethod
    def backward(ctx, gout):
        x, w_ih, w_hh, bias, gates, h_seq, c_seq = ctx.saved_tensors
        dgates = lstm_scan_bwd_tm(gates, h_seq, c_seq,
                                  gout.to(torch.bfloat16).contiguous(), w_hh,
                                  ctx.reverse)
        dg = dgates.reshape(-1, dgates.shape[-1])
        need = ctx.needs_input_grad
        dx = dw_ih = dw_hh = db = None
        if need[0]:
            dx = _mm_f32(dg, w_ih.to(torch.bfloat16).t()).reshape(
                x.shape).to(ctx.x_dtype)
        if need[1]:
            dw_ih = _mm_f32(x.reshape(-1, x.shape[-1]).t(),
                            dg).to(w_ih.dtype)
        if need[2]:
            dw_hh = _dw_hh(h_seq, dgates, ctx.reverse).to(w_hh.dtype)
        if need[3]:
            db = dg.float().sum(0).to(bias.dtype)
        return dx, dw_ih, dw_hh, db, None, None


def lstm_layer_tm_chunked(x_tm: torch.Tensor, w_ih: torch.Tensor,
                          w_hh: torch.Tensor, bias: torch.Tensor,
                          reverse: bool = False, t_chunk: int = 128,
                          out_dtype: torch.dtype = torch.bfloat16,
                          proj_dtype: Optional[torch.dtype] = None,
                          mixed: bool = False) -> torch.Tensor:
    """Whole LSTM layer, time-major, with the input projection hoisted one
    time chunk at a time: x_tm [T, B, F], w_ih [F, 4H], w_hh [H, 4H],
    bias [4H] -> [T, B, H]. Only one chunk's [t_chunk, B, 4H] gates exist
    at a time. The projection runs in proj_dtype (default: bf16 on CUDA,
    float32 on the CPU, as the JAX function's TPU and interpret modes do),
    or with mixed=True as mixed_gates (the JAX function's projection with
    proj_dtype bf16: fp32 accumulation plus the fp32 bias, one rounding);
    the gates enter the scan as bf16 either way, so for the same gates the
    result is bit-identical to lstm_scan_tm. Under grad the backward needs
    the whole gates buffer anyway, so the call takes the full hoisted
    projection and LSTMScan, as the JAX function's VJP does."""
    t_len, b, _ = x_tm.shape
    hsz = w_hh.shape[0]
    pdt = proj_dtype or (torch.bfloat16 if x_tm.is_cuda else torch.float32)
    w_p, b_p = w_ih.t().to(pdt), bias.to(pdt)

    def project(x):
        return (mixed_gates(x, w_ih, bias, round_grads=False) if mixed
                else F.linear(x.to(pdt), w_p, b_p))

    if _wants_grad(x_tm, w_ih, w_hh, bias):
        return LSTMScan.apply(project(x_tm), w_hh, reverse, out_dtype)
    h = torch.zeros(b, hsz, dtype=torch.float32, device=x_tm.device)
    c = torch.zeros_like(h)
    out = torch.empty(t_len, b, hsz, dtype=out_dtype, device=x_tm.device)
    starts = list(range(0, t_len, t_chunk))
    if reverse:              # the state flows from the later chunk backwards
        starts = starts[::-1]
    for s in starts:
        e = min(s + t_chunk, t_len)
        out[s:e], h, c = lstm_scan_carry_tm(project(x_tm[s:e]), w_hh, h, c,
                                            reverse, out_dtype)
    return out
