#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (generative_audio_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Two models are driven at full width, FullSubNet+ (TCN towers, sub-band LSTM)
and FullSubNet v1 with the GRU body (full-band GRU H=512, sub-band GRU
H=384), each through the serving and the training entry point. Phases, each
of which fails the run (non-zero exit, no result line):
  1. the card (name, power limit, torch and CUDA versions) and the build of
     every CUDA kernel from generative_audio_torch/csrc, with the registers
     ptxas reports for every instance;
  2. the two inference kernels (A and B, cluster scans) against their plain
     PyTorch versions at the serving shape (T=628 frames, H=384, 2056 rows =
     batch 8 x 257 bins, and a ragged row count; forward and reverse), the
     chunked kernel against the unchunked one bit for bit, and each
     kernel's time and microseconds a step beside its bound, its plain
     version's time and a cuDNN LSTM's time, also at 257 rows (one 10 s
     clip), with the launch plan ops.lstm.card_scan_plan picks (cluster
     size, rows per cluster, clusters, the card's occupancy, waves, shared
     bytes) and the instances' registers;
  3. the two training kernels at the training shape (T=195 frames, 2304 rows
     = batch 18 x 128 bins after drop_band, and a ragged row count; forward
     and reverse): the training forward's h against the inference kernel's
     bit for bit, its c sequence and the backward scan's dgates against
     their plain versions, the backward's launch plan (a thread-block
     cluster) against its single-block design bit for bit (and, first, every
     plan of both backward scans at small shapes, scripts/perf_bwd_scan.py),
     the whole LSTMScan gradient against autograd through the float32
     recurrence, and the times (both designs of the backward), plans and
     registers as in phase 2 (the library call is a cuDNN LSTM's forward and
     backward);
  4. the serving path at FullSubNet+'s full width (random weights from a
     numpy seed in the JAX param layout, carried across by
     utils/convert.py), bf16: a 1 s clip against the float32 model on the
     CPU, then three single requests (3 s, 7.5 s, 10 s) and one batched
     enhance_dir of 8 x 10 s clips;
  5. a 30 s request with a lowered gates limit, so the sub-band LSTM takes
     the time-chunked path, against the same request unchunked;
  6. the training path at full width: EnhanceTrainConfig() defaults (batch
     18 x 3.072 s, bf16, Adam 1e-3, clip 10), five steps of EnhanceTrainer
     on one fixed batch of seeded noise, with the launch counts of every
     step, the time per step and the peak memory; then a batch of 4 x 1 s
     whose bf16 loss and gradients on the card are held against the float32
     model on the CPU;
  7. torch.profiler breakdowns by kernel of one batch-8 x 10 s forward and
     of one training step;
  8. the three LSTM scan kernels once more at FullSubNet v1's full-band
     shape (H=512, T=195, 18 rows and 1 row, forward and reverse; the
     backward's cluster against its single block bit for bit), with kernel
     A's and the backward's times (both designs), plans and registers at 18
     rows; then every scan wrapper of the model paths (LSTM forward, carry,
     training forward and backward; GRU forward, carry and backward) and
     the LSTM layer with the projection inside (lstm_layer_tm) at H=100
     and 200, which the wrappers zero-pad to the kernels' units, against its
     plain version; then the single-block forwards the wrappers take where
     no cluster holds H: against the clusters bit for bit at LSTM H=512 and
     GRU H=640, every such wrapper at LSTM H=640 and 768 (lstm_layer_tm's
     lstm_layer_fwd_block among them) and GRU H=768 against its plain
     version, and each scan entry's time at H=768; then LSTMScan at H=768
     and 1024 (kernel D's single block, dc in registers) against autograd
     through the float32 recurrence, and kernel D's single block at H=1024
     timed;
  9. the GRU forward and carry kernels against their plain versions at the
     sub-band serving shape (T=628, H=384, 2056 rows and a ragged count) and
     the full-band shape (H=512, 8 rows and 1 row), chunked against unchunked
     bit for bit, times beside the bound, the plain version and a cuDNN GRU;
 10. the GRU backward (the scan and the dW_hh contraction) at the training
     shape (T=195, H=384, 2304 rows and a ragged count; H=512, 18 rows):
     the forward as GRUScan launches it, dgates, dW_hh and db_hh against
     their plain versions, the scan's plan (a cluster) against its single
     block bit for bit (dgx, dhn and every db_hh partial), the contraction
     alone against a float32 matmul, GRUScan's three gradients against
     autograd through the float32 recurrence, and the times, the scan's at
     both shapes and in both designs (the library call is a cuDNN GRU's
     forward and backward, and one torch.mm for the contraction);
 11. phases 4-7 again for FullSubNet v1-GRU (mode full_band_crm_mask; model
     type "fullsubnet"), plus the 1 s clip for v1-LSTM;
 12. the LSTM layer and scan variants, each through its own entry point: the
     layer with the projection inside the scan (ops.lstm.lstm_layer_tm) over
     FullSubNet+'s real sub-band stack (the model's layer-1 input of one
     batch-8 x 10 s request, its own weights), against its plain version at
     both layers, forward and reverse, and at a ragged row count, and both
     layers against the model's own hoisted stack; the cluster against its
     single block (lstm_layer_fwd_block, the first design) bit for bit at
     both layers, the ragged count and H=512; LSTMLayerScan's four
     gradients at the training shape against autograd through the float32
     recurrence, with its exact launches; the chains backward
     (scripts.perf_lstm_chains, kernel G, 2 and 4 chains) bit for bit
     against kernel D at the script's shape, the training shape, a ragged
     row count and H=100, 200 (its single block) and 512, and the K-step
     unrolled forward (scripts.perf_lstm_unroll) bit for bit against kernel
     A (also at H=100 and 200, and through its single block at H=640 and
     768 against lstm_scan_fwd_block); and their times beside bound, plain
     version and library (kernel G's beside kernel D's in alternating
     rounds, the layer's beside its single block's), with the plans and
     registers of the staged kernels and of kernel G, and kernel D's
     cluster registers against their recorded counts.
 13. the rest of serving at FullSubNet+'s full width, bf16, phase 4's
     weights: overlapped_chunk (spectral, 4 s chunks: 64 256 samples, 252
     frames, 257 rows) on a 10 s clip against the float32 model on the CPU;
     StreamingEnhancer at K = 1 and 8 streams, async_depth 0 and 2, fed
     pieces of seeded sizes, bit for bit against overlapped_chunk run with
     as many rows, and each of the 8 rows against its single stream; the
     sub-band mode (SequenceModel(31, 2, 384), 257 rows) and the modes mag,
     scaled_mask, complex_full_band_crm_mask and time_domain around a
     full-band LSTM (H=512), card against CPU; the batched enhance_dir over
     mixed buckets (8 x 10 s, 5 x 7.5 s) against the serial path (and
     where a batch and its first clip part: the full-band towers, while the
     sub-band model's rows stay bit for bit), and one real halving of a
     batch of 30 s clips under a lowered memory limit; the
     inference CLI in process (JSON config, a .pth, three wavs) on the card
     and on the CPU; each with its exact launches; then the streaming
     readings (the chunk's time on the card, feed-to-finalized latency p50,
     aggregate x realtime) at K = 1, 8 and 16, 4 s and 1 s chunks.
The launch counts are set to 0 just before each model's serving phases and
read just after, again around each model's five training steps, around
each variant's own path in phase 12 and around phase 13 (whose launches
add to kernel A's). The second-to-last line of stdout is
the `kernels` JSON, the last line the device JSON. Exits non-zero without a
CUDA device.
"""
import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from generative_audio_torch.utils.device import cuda_ms  # noqa: E402

T_FRAMES, HIDDEN, ROWS, RAGGED_ROWS = 628, 384, 8 * 257, 2047
T_CHUNK = 64
# The training shape: 3.072 s clips give 193 frames + 2 look-ahead; batch 18
# x 257 bins, drop_band keeps 128 of them per clip.
TRAIN_T, TRAIN_ROWS, TRAIN_RAGGED_ROWS = 195, 18 * 128, 18 * 128 - 9
TRAIN_BATCH, TRAIN_SAMPLES, TRAIN_STEPS = 18, 49152, 5
# FullSubNet v1's full-band model: H=512 over as many rows as clips.
FB_HIDDEN, FB_SERVE_ROWS = 512, 8
SEED = 0
# Lowered gates limit of phase 4: a 30 s clip's gates (1.48 GB) exceed it.
LONG_CLIP_GATES_LIMIT = 256 << 20
# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Tolerances. Kernel vs plain version: both accumulate in fp32 over bf16
# operands in another order, and a float32 difference that moves h across a
# bf16 rounding step changes the next product by up to one bf16 step. On an
# H100 the largest difference over the 8e8 outputs of a T=628, 2056-row
# scan measured 3.4e-4 and the mean 2.2e-6 (h lies in (-1, 1)); the limits
# keep a margin of about 15x over those.
KERNEL_MAX_ABS, KERNEL_MEAN_ABS = 5e-3, 3e-5
# Backward scan vs its plain version, as a share of the largest |dgates|:
# the same one-bf16-step differences (2^-8 of a value), which dh carries on
# to earlier steps. On an H100 at T=195, 2304 rows the largest measured
# 3.8e-3 of the peak (one bf16 step of a value above 2) and the mean 7.5e-7.
# The whole LSTMScan gradient vs autograd through the float32 recurrence
# measures what the bf16 streams cost: its limits are shares of the exact
# gradient's peak (dgates; measured 2.9e-3 max, 3.0e-5 mean) and of its
# Frobenius norm (dW_hh; measured 2.3e-3). Margins of about 15x.
# LSTMLayerScan's dW_ih, dW_hh and db measured 2.5e-3, 3.1e-3 and 1.2e-3 of
# their norms and its dx 2.5e-3 max of its peak, under the same limits.
BWD_MAX_REL, BWD_MEAN_REL = 5e-2, 2e-5
GRAD_MAX_REL, GRAD_MEAN_REL, GRAD_DW_REL = 5e-2, 5e-4, 3e-2
# LSTMLayerScan's dx is a contraction over 4H of the bf16 dgates, so each
# rounding adds up: at T=195, 2304 rows, F=34 its mean error measured 3.4e-4
# of its peak on an H100, too close to GRAD_MEAN_REL, so dx has its own mean
# limit, 2.9x over that reading. The run also reads two faulty dx, and fails
# unless the limits reject them: dgates without the forget gate's derivative
# measured a mean of 7.4e-3 (7.4x over the limit); one of the 195 steps lost
# a max of 0.79 (16x over GRAD_MAX_REL) and a mean of 1.04e-3.
DX_MEAN_REL = 1e-3
# The GRU forward vs its plain version: the same one-bf16-step differences,
# but the update h = (1 - z) n + z h_prev hands a moved h on to later steps
# where the LSTM's output gate damps it, so the mean is higher: on an H100 at
# T=628 the largest difference measured 8.9e-4 and the mean 2.1e-5 (2.5e-5 at
# H=512). The maximum keeps the LSTM's limit, the mean gets its own, 8x over.
GRU_FWD_MEAN_ABS = 2e-4
# The GRU backward's dW_hh and db_hh against the plain version, as a share
# of the plain result's Frobenius norm: both contract the same bf16 streams
# up to the one-bf16-step differences above, in another order (measured
# 5.4e-4 and 1.1e-4). The dW_hh contraction alone, on the very same bf16
# inputs, against a float32 matmul differs only by the order of its fp32
# sums, which grows with the rows summed: measured 3.2e-5 at N = 446 976 rows
# and 3.7e-7 at N = 3492; a wrong fragment layout would give O(1).
BWD_DW_REL, DWHH_ALONE_REL = 1e-2, 1e-3
# Training on the card in bf16 vs the float32 model on the CPU, 4 x 1 s:
# relative loss error (measured 2.0e-4), and per parameter tensor (those
# whose gradient norm is above 1e-3 of the largest) the cosine (measured
# 0.9972 at the lowest) and the ratio of the norms (measured 0.985-1.028).
TRAIN_LOSS_REL, TRAIN_GRAD_COS, TRAIN_GRAD_RATIO = 5e-3, 0.95, 0.15
# Whole path: bf16 on the card against float32 on the CPU, and chunked
# against unchunked projections (cuBLAS may round a chunk's bf16 gates
# differently), both as a share of the output's peak.
PATH_REL = 5e-2
# The two sub-band layers through lstm_layer_tm against the model's own
# hoisted stack, bf16 h: the hoisted path rounds every gate to bf16, the
# projection inside the scan keeps it in fp32, and layer 2 sees layer 1's
# differences. On an H100 the largest difference measured 1.95e-3 (one bf16
# step of an h in [0.25, 0.5)) and the mean 7.9e-5; margins of 5x and 6x.
LAYER_PATH_MAX_ABS, LAYER_PATH_MEAN_ABS = 1e-2, 5e-4
# The sub-band model's input width: 31 neighbour bins + 3 full-band outputs.
SB_FEATURES = 34
# Hidden sizes the kernels do not take as they are: the wrappers pad them.
PADDED_HIDDEN = (100, 200)
# Hidden sizes no cluster holds (LSTM above 512, GRU above 640): the
# forwards take the single-block route. The GRU runs at the last.
BLOCK_HIDDEN = (640, 768)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()]


def bound(t, rows, h, extra_bytes=0, streams=5, products=1, gates=4):
    """Least time (ms) for one scan with `gates` gates (4: LSTM, 3: GRU), as
    a function of its inputs and outputs, whatever scratch a kernel adds.
    Bytes: `streams` bf16 [T, rows, H] arrays each read or written once (the
    LSTM forward: 4 of gates in, 1 of h out) and W_hh in bf16 once.
    Operations: `products` [rows, H] x [H, gates*H] products per step on the
    bf16 tensor cores."""
    bytes_ = t * rows * streams * h * 2 + gates * h * h * 2 + extra_bytes
    flops = products * 2 * t * rows * h * gates * h
    return _larger(bytes_, flops)


def _larger(bytes_, flops):
    by_bytes, by_ops = bytes_ / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase_build():
    """Builds every source and prints ptxas's report of each instance.
    Returns the registers of the instances of kernels A-C by name (kernel
    and output type), empty for a library that was built before."""
    from generative_audio_torch.ops import _cuda
    t0 = time.perf_counter()
    reports = _cuda.build(list(_cuda.SOURCES))
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_cuda.NVCC_FLAGS)})")
    for name, report in reports.items():
        for line in report.splitlines():
            if "entry function" in line or "registers" in line:
                log(f"  ptxas {name}: {line.strip()}")
    for name in _cuda.SOURCES:
        _cuda.load(name)
    return {**_cluster_registers(reports.get("lstm_scan", "")),
            **_bwd_registers(reports), **_staged_registers(reports),
            **_chains_registers(reports.get("lstm_scan_bwd_chains", ""))}


def _cluster_registers(report):
    """{"A bf16": registers, ...} from ptxas's report of lstm_scan.cu: the
    instance lstm_cluster_kernel<OutT, CARRY, STREAM_C> is kernel A
    (neither flag), B (CARRY) or C (STREAM_C)."""
    found, name = {}, None
    for line in report.splitlines():
        entry = re.search(r"lstm_cluster_kernelI(13__nv_bfloat16|f)"
                          r"Lb([01])ELb([01])E", line)
        if entry:
            out, carry, train = entry.groups()
            kernel = "C" if train == "1" else "B" if carry == "1" else "A"
            name = f"{kernel} {'fp32' if out == 'f' else 'bf16'}"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name], name = int(used.group(1)), None
    return found


def _bwd_registers(reports):
    """{"D cluster, slice resident": "... registers, ... spilled", ...} for
    the cluster instances of the two backward scans (lstm_bwd_cluster_kernel
    and gru_bwd_cluster_kernel <RESIDENT>), from ptxas's reports."""
    found, name, spill = {}, None, ""
    for line in "\n".join(reports.get(s, "") for s in (
            "lstm_scan_bwd", "gru_scan_bwd")).splitlines():
        entry = re.search(r"(lstm|gru)_bwd_cluster_kernelILb([01])E", line)
        if "Compiling entry function" in line:
            name = None
            if entry:
                kind = "D" if entry.group(1) == "lstm" else "GRU backward"
                name = (f"{kind} cluster, slice "
                        f"{'resident' if entry.group(2) == '1' else 'streamed'}")
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           line)
        if stores and name:
            spill = f"{stores.group(1)}/{stores.group(2)} B spilled"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name], name = f"{used.group(1)} registers, {spill}", None
    return found


def _staged_registers(reports):
    """{"E K=2": "... registers, ... spilled", "F bf16": ...,
    "F block fp32": ..., "E block K=4": ...} for the instances of kernels E
    and F (lstm_scan_staged.cu) and of their single blocks
    (lstm_layer_block.cu, lstm_scan_unrolled_block.cu), from ptxas's
    reports."""
    found, name, spill = {}, None, ""
    out_type = {"13__nv_bfloat16": "bf16", "f": "fp32"}
    for line in "\n".join(reports.get(s, "") for s in (
            "lstm_scan_staged", "lstm_layer_block",
            "lstm_scan_unrolled_block")).splitlines():
        if "Compiling entry function" in line:
            name, spill = None, ""
            e = re.search(r"lstm_unrolled_kernelILi(\d)E", line)
            eb = re.search(r"lstm_unrolled_block_kernelILi(\d)E", line)
            f = re.search(r"lstm_layer_cluster_kernelI(13__nv_bfloat16|f)E",
                          line)
            b = re.search(r"lstm_layer_block_kernelI(13__nv_bfloat16|f)E",
                          line)
            if e:
                name = f"E K={e.group(1)}"
            elif eb:
                name = f"E block K={eb.group(1)}"
            elif f:
                name = f"F {out_type[f.group(1)]}"
            elif b:
                name = f"F block {out_type[b.group(1)]}"
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           line)
        if stores and name:
            spill = f"{stores.group(1)}/{stores.group(2)} B spilled"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name], name = f"{used.group(1)} registers, {spill}", None
    return found


def _chains_registers(report):
    """{"G N=2 units streamed": "... registers, ... spilled", ...} for the
    instances lstm_chains_cluster_kernel<N, ARRANGE, RESIDENT> of kernel G
    (lstm_scan_bwd_chains.cu), from ptxas's report."""
    found, name, spill = {}, None, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name, spill = None, ""
            g = re.search(r"lstm_chains_cluster_kernelILi(\d)ELi(\d)ELb([01])E",
                          line)
            if g:
                name = (f"G N={g.group(1)} "
                        f"{'rows' if g.group(2) == '0' else 'units'} "
                        f"{'resident' if g.group(3) == '1' else 'streamed'}")
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           line)
        if stores and name:
            spill = f"{stores.group(1)}/{stores.group(2)} B spilled"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name], name = f"{used.group(1)} registers, {spill}", None
    return found


def _registers_line(registers, kernels):
    """The registers of the named kernels' instances, for a phase's log."""
    return ", ".join(f"{k} {n}" for k, n in sorted(registers.items())
                     if k[0] in kernels) or "not rebuilt in this run"


def phase_kernels(dev, registers):
    from generative_audio_torch.ops import lstm as L
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = HIDDEN
    bound_w = h ** -0.5
    w_hh = (torch.rand(h, 4 * h, generator=gen, device=dev) * 2 - 1) * bound_w
    results = {}
    max_a = max_b = 0.0
    for rows in (ROWS, RAGGED_ROWS):
        gates = torch.randn(T_FRAMES, rows, 4 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        log(f"kernel A plan at rows={rows}: "
            f"{_plan_line(L, dev, h, rows, out_dtype=torch.float32)}")
        log(f"kernel B plan at rows={rows}: "
            f"{_plan_line(L, dev, h, rows, carry=True)}")
        for reverse in (False, True):
            got = L.lstm_scan_tm(gates, w_hh, reverse, torch.float32)
            want = L.lstm_scan_reference_tm(gates, w_hh, reverse)
            torch.cuda.synchronize()
            err = (got - want).abs()
            log(f"kernel A rows={rows} reverse={reverse}: max|err| "
                f"{err.max().item():.3e} mean {err.mean().item():.3e}")
            check(torch.isfinite(got).all().item(), "kernel A output finite")
            check(err.max().item() < KERNEL_MAX_ABS
                  and err.mean().item() < KERNEL_MEAN_ABS,
                  f"kernel A vs plain within {KERNEL_MAX_ABS}/{KERNEL_MEAN_ABS}")
            max_a = max(max_a, err.max().item())

            # kernel B over 64-frame chunks (the last one ragged) == kernel A
            for out_dtype in (torch.bfloat16, torch.float32):
                whole = L.lstm_scan_tm(gates, w_hh, reverse, out_dtype)
                hs = torch.zeros(rows, h, device=dev)
                cs = torch.zeros_like(hs)
                chunked = torch.empty_like(whole)
                starts = list(range(0, T_FRAMES, T_CHUNK))
                for s in (starts[::-1] if reverse else starts):
                    e = min(s + T_CHUNK, T_FRAMES)
                    chunked[s:e], hs, cs = L.lstm_scan_carry_tm(
                        gates[s:e], w_hh, hs, cs, reverse, out_dtype)
                check(torch.equal(chunked, whole),
                      f"kernel B in chunks == kernel A bitwise "
                      f"(rows={rows} reverse={reverse} {out_dtype})")
            log(f"kernel B chunks of {T_CHUNK} == kernel A bitwise "
                f"(rows={rows} reverse={reverse}, bf16 and fp32 out)")

            # kernel B against its plain version from a non-zero state
            h0 = torch.rand(rows, h, generator=gen, device=dev) * 2 - 1
            c0 = torch.randn(rows, h, generator=gen, device=dev)
            seq, h_t, c_t = L.lstm_scan_carry_tm(gates[:T_CHUNK], w_hh, h0, c0,
                                                 reverse, torch.float32)
            p_seq, p_h, p_c = L.lstm_scan_carry_reference_tm(
                gates[:T_CHUNK], w_hh, h0, c0, reverse)
            err_b = max((seq - p_seq).abs().max().item(),
                        (h_t - p_h).abs().max().item(),
                        (c_t - p_c).abs().max().item())
            log(f"kernel B rows={rows} reverse={reverse} from (h0, c0): "
                f"max|err| {err_b:.3e}")
            check(err_b < KERNEL_MAX_ABS, "kernel B vs plain")
            max_b = max(max_b, err_b)
        del gates

    # times at the serving shape, bf16 out as the path runs them
    gates = torch.randn(T_FRAMES, ROWS, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    ms_a = cuda_ms(lambda: L.lstm_scan_tm(gates, w_hh), iters=5)
    zeros = torch.zeros(ROWS, h, device=dev)

    def chunked_run():
        hs, cs = zeros, zeros
        for s in range(0, T_FRAMES, T_CHUNK):
            _, hs, cs = L.lstm_scan_carry_tm(gates[s:s + T_CHUNK], w_hh, hs,
                                             cs)

    ms_b = cuda_ms(chunked_run, iters=5)
    # the same work in one chunk, and kernel A at one 10 s clip's 257 rows:
    # separates the cost of chunking from that of the kernel, and of the
    # serial time loop from that of the rows
    ms_b_one = cuda_ms(lambda: L.lstm_scan_carry_tm(gates, w_hh, zeros, zeros),
                       iters=5)
    one_clip = gates[:, :257].contiguous()
    ms_a_257 = cuda_ms(lambda: L.lstm_scan_tm(one_clip, w_hh), iters=5)
    library_257 = library_lstm_ms(one_clip, w_hh)
    plain_a = cuda_ms(lambda: L.lstm_scan_reference_tm(gates, w_hh), iters=2)
    plain_b = cuda_ms(lambda: [L.lstm_scan_carry_reference_tm(
        gates[s:s + T_CHUNK], w_hh, zeros, zeros)
        for s in range(0, T_FRAMES, T_CHUNK)], iters=2)
    library = library_lstm_ms(gates, w_hh)
    n_chunks = -(-T_FRAMES // T_CHUNK)
    b_a, by_a = bound(T_FRAMES, ROWS, h)
    b_b, by_b = bound(T_FRAMES, ROWS, h, extra_bytes=n_chunks * 4 * ROWS * h * 4)
    card = card_line()
    log(f"kernel A at T={T_FRAMES} rows={ROWS} H={h}: {ms_a:.3f} ms, "
        f"{1e3 * ms_a / T_FRAMES:.2f} us a step (bound {b_a:.3f} ms by {by_a}; "
        f"plain {plain_a:.3f} ms; cuDNN LSTM {library:.3f} ms) on {card}")
    log(f"  plan: {_plan_line(L, dev, h, ROWS)}")
    log(f"kernel B, {n_chunks} chunks of {T_CHUNK}: {ms_b:.3f} ms, "
        f"{1e3 * ms_b / T_FRAMES:.2f} us a step (bound {b_b:.3f} ms by {by_b}; "
        f"plain {plain_b:.3f} ms) on {card}")
    log(f"  plan: {_plan_line(L, dev, h, ROWS, carry=True)}")
    log(f"kernel B in one chunk of {T_FRAMES}: {ms_b_one:.3f} ms; kernel A at "
        f"257 rows (one 10 s clip): {ms_a_257:.3f} ms, "
        f"{1e3 * ms_a_257 / T_FRAMES:.2f} us a step (bound "
        f"{bound(T_FRAMES, 257, h)[0]:.3f} ms; cuDNN LSTM {library_257:.3f} "
        f"ms) on {card}")
    log(f"  plan at 257 rows: {_plan_line(L, dev, h, 257)}")
    log(f"  registers of kernels A and B: {_registers_line(registers, 'AB')}")
    log("  (the cuDNN LSTM is nn.LSTM(4H, H) with W_ih = I and zero bias: the "
        "same recurrence plus one extra [T*rows, 4H] x [4H, 4H] projection)")
    results["lstm_scan_fwd"] = dict(
        max_abs_err=max_a, ms=ms_a, plain_ms=plain_a, bound_ms=b_a,
        bound_by=by_a, library_ms=library, plan=_plan_json(L, dev, h, ROWS))
    results["lstm_scan_fwd_carry"] = dict(
        max_abs_err=max_b, ms=ms_b, plain_ms=plain_b, bound_ms=b_b,
        bound_by=by_b, library_ms=library,
        plan=_plan_json(L, dev, h, ROWS, carry=True))
    return results


def library_lstm_ms(gates, w_hh):
    """cuDNN's LSTM on the same gates: W_ih = I, zero biases, so each step
    computes gates_t + h_{t-1} W_hh^T as the kernels do. Timed only."""
    h = w_hh.shape[0]
    lstm = torch.nn.LSTM(4 * h, h, device=gates.device, dtype=torch.bfloat16)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * h))
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
        return cuda_ms(lambda: lstm(gates), iters=5)


def library_lstm_train_ms(gates, w_hh, gout):
    """cuDNN's LSTM as in library_lstm_ms, in training mode: the forward
    alone (it keeps its reserve space for a backward), and the forward plus
    the backward to the gates and the weights. Timed only."""
    h = w_hh.shape[0]
    lstm = torch.nn.LSTM(4 * h, h, device=gates.device, dtype=torch.bfloat16)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * h))
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    x = gates.detach().requires_grad_()

    def both():
        lstm(x)[0].backward(gout)
        x.grad = None
        lstm.zero_grad(set_to_none=True)

    return cuda_ms(lambda: lstm(x), iters=5), cuda_ms(both, iters=5)


def phase_train_kernels(dev, registers):
    """Kernels C (training forward) and D (backward scan) at the training
    shape, and the LSTMScan gradient as a whole."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.scripts import perf_bwd_scan as PB
    # every plan of both backward scans (cluster sizes, rows, the
    # recompute's slice resident or streamed) == the single block, bit for
    # bit, at small ragged shapes, forward and reverse
    check(PB.check(dev) == 0, "every backward plan == the single block "
          "bitwise (scripts/perf_bwd_scan.py check)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    h, t_len = HIDDEN, TRAIN_T
    w_hh = (torch.rand(h, 4 * h, generator=gen, device=dev) * 2 - 1) * h ** -0.5
    max_c = max_d = 0.0
    for rows, reverse in ((TRAIN_ROWS, False), (TRAIN_ROWS, True),
                          (TRAIN_RAGGED_ROWS, False), (TRAIN_RAGGED_ROWS, True)):
        gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        gout = torch.randn(t_len, rows, h, generator=gen,
                           device=dev).to(torch.bfloat16)
        tag = f"rows={rows} reverse={reverse}"
        if not reverse:
            log(f"kernel C plan at rows={rows}: "
                f"{_plan_line(L, dev, h, rows, train=True)}")
        with torch.no_grad():
            h_a = L.lstm_scan_tm(gates, w_hh, reverse)
        h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh, reverse)
        p_h, p_c = L.lstm_scan_train_reference_tm(gates, w_hh, reverse)
        torch.cuda.synchronize()
        check(torch.equal(h_seq, h_a), f"kernel C h == kernel A h bitwise ({tag})")
        err_c = (c_seq.float() - p_c.float()).abs()
        err_h = (h_seq.float() - p_h.float()).abs()
        log(f"kernel C {tag}: h == kernel A bitwise; c_seq max|err| "
            f"{err_c.max().item():.3e} mean {err_c.mean().item():.3e} (peak |c| "
            f"{p_c.float().abs().max().item():.2f}); h_seq max|err| "
            f"{err_h.max().item():.3e}")
        check(torch.isfinite(c_seq.float()).all().item(), "kernel C c finite")
        # c is O(1) where h is below 1, and it is rounded to bf16 (2^-8 of
        # its value) on both sides, so its limits are those of h times 8
        check(err_c.max().item() < 8 * KERNEL_MAX_ABS
              and err_c.mean().item() < 8 * KERNEL_MEAN_ABS
              and err_h.max().item() < 8 * KERNEL_MAX_ABS,
              f"kernel C vs plain within {8 * KERNEL_MAX_ABS}/"
              f"{8 * KERNEL_MEAN_ABS} ({tag})")
        max_c = max(max_c, err_c.max().item())

        dg = L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh, reverse)
        p_dg = L.lstm_scan_bwd_reference_tm(gates, h_seq, c_seq, gout, w_hh,
                                            reverse)
        torch.cuda.synchronize()
        err_d = (dg.float() - p_dg.float()).abs()
        peak = p_dg.float().abs().max().item()
        log(f"kernel D {tag}: dgates max|err| {err_d.max().item():.3e} mean "
            f"{err_d.mean().item():.3e} (peak |dgates| {peak:.3f})")
        check(torch.isfinite(dg.float()).all().item(), "kernel D output finite")
        check(err_d.max().item() < BWD_MAX_REL * peak
              and err_d.mean().item() < BWD_MEAN_REL * peak,
              f"kernel D vs plain within {BWD_MAX_REL}/{BWD_MEAN_REL} of the "
              f"peak ({tag})")
        max_d = max(max_d, err_d.max().item())
        # the card's plan (a cluster) against the single-block design
        dg_block = L.lstm_scan_bwd_planned_tm(gates, h_seq, c_seq, gout, w_hh,
                                              _block_bwd_plan(L, dev, h, rows),
                                              reverse)
        torch.cuda.synchronize()
        check(torch.equal(dg, dg_block),
              f"kernel D's plan == the single block bitwise ({tag})")
        log(f"kernel D {tag}: plan {_bwd_plan_line(L, dev, h, rows)}; == the "
            f"single block bitwise over {dg.numel()} outputs")
        del dg_block

        # LSTMScan as a whole against autograd through the fp32 recurrence
        _lstm_scan_grads_vs_float32(L, gates, w_hh, gout, reverse, tag)
        del gates, gout

    # times at the training shape
    rows = TRAIN_ROWS
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh)
    with torch.no_grad():
        ms_a = cuda_ms(lambda: L.lstm_scan_tm(gates, w_hh), iters=5)
    ms_c = cuda_ms(lambda: L.lstm_scan_train_tm(gates, w_hh), iters=5)
    # one 16-row block per SM: what the 144 blocks' second wave costs
    one_wave = 16 * torch.cuda.get_device_properties(dev).multi_processor_count
    part = gates[:, :one_wave].contiguous()
    ms_c_wave = cuda_ms(lambda: L.lstm_scan_train_tm(part, w_hh), iters=5)
    ms_d = cuda_ms(lambda: L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh),
                   iters=5)
    block = _block_bwd_plan(L, dev, h, rows)
    ms_d_block = cuda_ms(lambda: L.lstm_scan_bwd_planned_tm(
        gates, h_seq, c_seq, gout, w_hh, block), iters=3)
    plain_c = cuda_ms(lambda: L.lstm_scan_train_reference_tm(gates, w_hh),
                      iters=2)
    plain_d = cuda_ms(lambda: L.lstm_scan_bwd_reference_tm(
        gates, h_seq, c_seq, gout, w_hh), iters=2)
    lib_fwd, lib_both = library_lstm_train_ms(gates, w_hh, gout)
    # C: gates in, h and c out. D: gates, h, c, gout in, dgates out, two
    # products per step (its second layout of W_hh is the wrapper's copy).
    b_c, by_c = bound(t_len, rows, h, streams=6)
    b_d, by_d = bound(t_len, rows, h, streams=11, products=2)
    card = card_line()
    log(f"kernel C at T={t_len} rows={rows} H={h}: {ms_c:.3f} ms, "
        f"{1e3 * ms_c / t_len:.2f} us a step (kernel A on the same gates "
        f"{ms_a:.3f} ms; bound {b_c:.3f} ms by {by_c}; plain {plain_c:.3f} ms; "
        f"cuDNN LSTM forward, training mode, {lib_fwd:.3f} ms) on {card}")
    log(f"  plan: {_plan_line(L, dev, h, rows, train=True)}; registers "
        f"{_registers_line(registers, 'C')}")
    log(f"kernel C at {one_wave} rows (16 a SM): {ms_c_wave:.3f} ms on {card}")
    log(f"  plan: {_plan_line(L, dev, h, one_wave, train=True)}")
    log(f"kernel D at T={t_len} rows={rows} H={h}: {ms_d:.3f} ms, "
        f"{1e3 * ms_d / t_len:.2f} us a step (the single-block design "
        f"{ms_d_block:.3f} ms; bound {b_d:.3f} ms by {by_d}; plain "
        f"{plain_d:.3f} ms; cuDNN LSTM backward {lib_both - lib_fwd:.3f} ms = "
        f"forward + backward {lib_both:.3f} ms less the forward) on {card}")
    log(f"  plan: {_bwd_plan_line(L, dev, h, rows)}; registers "
        f"{_registers_line(registers, 'D')}")
    return {
        "lstm_scan_fwd_train": dict(
            max_abs_err=max_c, ms=ms_c, plain_ms=plain_c, bound_ms=b_c,
            bound_by=by_c, library_ms=lib_fwd,
            plan=_plan_json(L, dev, h, rows, train=True)),
        "lstm_scan_bwd": dict(
            max_abs_err=max_d, ms=ms_d, plain_ms=plain_d, bound_ms=b_d,
            bound_by=by_d, library_ms=lib_both - lib_fwd,
            single_block_ms=ms_d_block,
            plan=dataclasses.asdict(L.card_bwd_scan_plan(dev, h, rows)))}


def _uniform(gen, dev, shape, bound):
    return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound


def _lstm_scan_grads_vs_float32(L, gates, w_hh, gout, reverse, tag):
    """LSTMScan's two gradients (bf16 gates on the card, through kernels C
    and D) for the cotangent gout against autograd through the float32
    recurrence, within GRAD_MAX_REL / GRAD_MEAN_REL of the peak (dgates)
    and GRAD_DW_REL of the norm (dW_hh)."""
    g_k = gates.clone().requires_grad_()
    w_k = w_hh.clone().requires_grad_()
    (L.lstm_scan_tm(g_k, w_k, reverse, torch.float32)
     * gout.float()).sum().backward()
    g_x = gates.float().requires_grad_()
    w_x = w_hh.clone().requires_grad_()
    (L.lstm_scan_reference_tm(g_x, w_x, reverse,
                              compute_dtype=torch.float32)
     * gout.float()).sum().backward()
    torch.cuda.synchronize()
    check(g_k.grad.dtype == torch.bfloat16
          and w_k.grad.dtype == torch.float32, "LSTMScan gradient dtypes")
    err_g = (g_k.grad.float() - g_x.grad).abs()
    peak_g = g_x.grad.abs().max().item()
    rel_w = ((w_k.grad - w_x.grad).norm() / w_x.grad.norm()).item()
    log(f"LSTMScan {tag} vs float32 autograd: d gates max|err|/peak "
        f"{err_g.max().item() / peak_g:.3e} mean/peak "
        f"{err_g.mean().item() / peak_g:.3e}; dW_hh |err|/|dW_hh| "
        f"{rel_w:.3e}")
    check(err_g.max().item() < GRAD_MAX_REL * peak_g
          and err_g.mean().item() < GRAD_MEAN_REL * peak_g
          and rel_w < GRAD_DW_REL,
          f"LSTMScan gradient vs float32 within {GRAD_MAX_REL}/"
          f"{GRAD_MEAN_REL}/{GRAD_DW_REL} ({tag})")


def phase_lstm_train_large(dev):
    """LSTMScan (kernel C's and kernel D's single blocks) at H=768 and 1024,
    which no cluster holds (kernel D's single block keeps dc in registers,
    so it holds H up to 1024): both gradients against autograd through the
    float32 recurrence, forward and reverse, with the launches counted
    around it; and kernel D's single block at H=1024 against its plain
    version and timed."""
    from generative_audio_torch.ops import lstm as L
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    t_len, rows = T_CHUNK, 40
    L.reset_launch_counts()
    for h in (BLOCK_HIDDEN[-1], 1024):
        w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
        for reverse in (False, True):
            gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                                device=dev).to(torch.bfloat16)
            gout = torch.randn(t_len, rows, h, generator=gen,
                               device=dev).to(torch.bfloat16)
            _lstm_scan_grads_vs_float32(
                L, gates, w_hh, gout, reverse,
                f"H={h} T={t_len} rows={rows} reverse={reverse}")
    launches = {k: n for k, n in L.launch_counts.items() if n}
    log(f"launches of LSTMScan at H=768 and 1024: {launches}")
    check(launches == {"lstm_scan_fwd_train_block": 4, "lstm_scan_bwd": 4},
          "LSTMScan at H=768 and 1024 runs kernel C's and kernel D's single "
          "blocks once a gradient")
    h, t_len, rows = 1024, TRAIN_T, TRAIN_BATCH
    plan = L.card_bwd_scan_plan(dev, h, rows)
    check(plan.design == "block", f"kernel D at H={h} takes its single block")
    w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh)
    dg = L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh)
    want = L.lstm_scan_bwd_reference_tm(gates, h_seq, c_seq, gout, w_hh)
    err = (dg.float() - want.float()).abs()
    peak = want.float().abs().max().item()
    check(err.max().item() < BWD_MAX_REL * peak
          and err.mean().item() < BWD_MEAN_REL * peak,
          f"kernel D's single block vs plain at H={h}")
    ms = cuda_ms(lambda: L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh),
                 iters=3)
    log(f"kernel D's single block at T={t_len} rows={rows} H={h}: {ms:.3f} ms "
        f"({plan.smem_bytes} B a block, dc in registers); max|err| "
        f"{err.max().item():.3e} mean {err.mean().item():.3e} (peak "
        f"{peak:.3f}) on {card_line()}")


def phase_lstm_h512(dev, registers):
    """The three LSTM scan kernels at FullSubNet v1's full-band shape, where
    the v1-LSTM model runs them: H=512, very few rows; kernel D's plan (a
    cluster of 16) against the single block bit for bit, and both designs'
    times at 18 rows. Returns kernel D's numbers there."""
    from generative_audio_torch.ops import lstm as L
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    h, t_len = FB_HIDDEN, TRAIN_T
    w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
    for rows in (TRAIN_BATCH, 1):
        gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        gout = torch.randn(t_len, rows, h, generator=gen,
                           device=dev).to(torch.bfloat16)
        log(f"LSTM H={h} rows={rows}: kernel A plan {_plan_line(L, dev, h, rows)}"
            f"; kernel C plan {_plan_line(L, dev, h, rows, train=True)}")
        for reverse in (False, True):
            tag = f"H={h} T={t_len} rows={rows} reverse={reverse}"
            with torch.no_grad():
                h_a = L.lstm_scan_tm(gates, w_hh, reverse, torch.float32)
            want = L.lstm_scan_reference_tm(gates, w_hh, reverse)
            h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh, reverse)
            p_h, p_c = L.lstm_scan_train_reference_tm(gates, w_hh, reverse)
            dg = L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh, reverse)
            p_dg = L.lstm_scan_bwd_reference_tm(gates, h_seq, c_seq, gout,
                                                w_hh, reverse)
            torch.cuda.synchronize()
            err_a = (h_a - want).abs()
            err_c = (c_seq.float() - p_c.float()).abs()
            err_d = (dg.float() - p_dg.float()).abs()
            peak = p_dg.float().abs().max().item()
            log(f"LSTM kernels {tag}: A max|err| {err_a.max().item():.3e} mean "
                f"{err_a.mean().item():.3e}; C h == A bitwise "
                f"{torch.equal(h_seq, h_a.to(torch.bfloat16))}, c_seq max|err| "
                f"{err_c.max().item():.3e}; D max|err| {err_d.max().item():.3e} "
                f"mean {err_d.mean().item():.3e} (peak |dgates| {peak:.3f})")
            check(all(torch.isfinite(x.float()).all().item()
                      for x in (h_a, c_seq, dg)), f"LSTM kernels finite ({tag})")
            check(err_a.max().item() < KERNEL_MAX_ABS
                  and err_a.mean().item() < KERNEL_MEAN_ABS,
                  f"kernel A vs plain ({tag})")
            check(torch.equal(h_seq, h_a.to(torch.bfloat16)),
                  f"kernel C h == kernel A h bitwise ({tag})")
            check(err_c.max().item() < 8 * KERNEL_MAX_ABS
                  and err_c.mean().item() < 8 * KERNEL_MEAN_ABS,
                  f"kernel C vs plain ({tag})")
            check(err_d.max().item() < BWD_MAX_REL * peak
                  and err_d.mean().item() < BWD_MEAN_REL * peak,
                  f"kernel D vs plain ({tag})")
            dg_block = L.lstm_scan_bwd_planned_tm(
                gates, h_seq, c_seq, gout, w_hh,
                _block_bwd_plan(L, dev, h, rows), reverse)
            torch.cuda.synchronize()
            check(torch.equal(dg, dg_block),
                  f"kernel D's plan == the single block bitwise ({tag})")
            log(f"kernel D {tag}: plan {_bwd_plan_line(L, dev, h, rows)}; == "
                f"the single block bitwise")
        del gates, gout

    # times at the full-band training shape (18 rows, one cluster)
    rows = TRAIN_BATCH
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    with torch.no_grad():
        ms_a = cuda_ms(lambda: L.lstm_scan_tm(gates, w_hh), iters=10)
    ms_c = cuda_ms(lambda: L.lstm_scan_train_tm(gates, w_hh), iters=10)
    plain_a = cuda_ms(lambda: L.lstm_scan_reference_tm(gates, w_hh), iters=2)
    lib = library_lstm_ms(gates, w_hh)
    b_a, by_a = bound(t_len, rows, h)
    log(f"kernel A at T={t_len} rows={rows} H={h} (full band, training "
        f"batch): {ms_a:.3f} ms, {1e3 * ms_a / t_len:.2f} us a step (bound "
        f"{b_a:.4f} ms by {by_a}; plain {plain_a:.3f} ms; cuDNN LSTM "
        f"{lib:.3f} ms); kernel C {ms_c:.3f} ms on {card_line()}")
    log(f"  plan: {_plan_line(L, dev, h, rows)}; registers of kernels A-C: "
        f"{_registers_line(registers, 'ABC')}")

    # kernel D at the full-band training shape: both designs, bound, plain
    # version and cuDNN's backward
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh)
    block = _block_bwd_plan(L, dev, h, rows)
    ms_d = cuda_ms(lambda: L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh),
                   iters=10)
    ms_block = cuda_ms(lambda: L.lstm_scan_bwd_planned_tm(
        gates, h_seq, c_seq, gout, w_hh, block), iters=3)
    plain_d = cuda_ms(lambda: L.lstm_scan_bwd_reference_tm(
        gates, h_seq, c_seq, gout, w_hh), iters=2)
    lib_fwd, lib_both = library_lstm_train_ms(gates, w_hh, gout)
    b_d, by_d = bound(t_len, rows, h, streams=11, products=2)
    log(f"kernel D at T={t_len} rows={rows} H={h} (full band, training "
        f"batch): {ms_d:.3f} ms, {1e3 * ms_d / t_len:.2f} us a step (the "
        f"single-block design {ms_block:.3f} ms; bound {b_d:.4f} ms by {by_d}; "
        f"plain {plain_d:.3f} ms; cuDNN LSTM backward {lib_both - lib_fwd:.3f} "
        f"ms) on {card_line()}")
    log(f"  plan: {_bwd_plan_line(L, dev, h, rows)}; registers "
        f"{_registers_line(registers, 'D')}")
    return dict(ms=ms_d, single_block_ms=ms_block, plain_ms=plain_d,
                bound_ms=b_d, bound_by=by_d, library_ms=lib_both - lib_fwd,
                plan=dataclasses.asdict(L.card_bwd_scan_plan(dev, h, rows)))


def phase_padded_hidden(dev):
    """Every scan wrapper of the model paths at hidden sizes the kernels do
    not take as they are (H=100 and 200, zero-padded by the wrappers), T=64,
    40 rows, against its plain version within the kernel limits."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    for h in PADDED_HIDDEN:
        _lstm_wrappers_vs_plain(L, dev, gen, h, T_CHUNK, 40)
        _gru_wrappers_vs_plain(G, dev, gen, h, T_CHUNK, 40)


def _lstm_wrappers_vs_plain(L, dev, gen, h, t_len, rows):
    """The LSTM forward, carry, training forward and backward wrappers at
    (H, T, rows) against their plain versions within the kernel limits, and
    C's h == A's h bit for bit."""
    tag = f"H={h} T={t_len} rows={rows}"
    w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    h0 = _uniform(gen, dev, (rows, h), 1.0)
    c0 = torch.randn(rows, h, generator=gen, device=dev)
    with torch.no_grad():
        err_a = (L.lstm_scan_tm(gates, w_hh, False, torch.float32)
                 - L.lstm_scan_reference_tm(gates, w_hh)).abs()
        h_a = L.lstm_scan_tm(gates, w_hh)
        got_b = L.lstm_scan_carry_tm(gates, w_hh, h0, c0, True,
                                     torch.float32)
    want_b = L.lstm_scan_carry_reference_tm(gates, w_hh, h0, c0, True)
    err_b = max((x - y).abs().max().item() for x, y in zip(got_b, want_b))
    h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh)
    p_c = L.lstm_scan_train_reference_tm(gates, w_hh)[1]
    err_c = (c_seq.float() - p_c.float()).abs()
    dg = L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh)
    p_dg = L.lstm_scan_bwd_reference_tm(gates, h_seq, c_seq, gout, w_hh)
    err_d = (dg.float() - p_dg.float()).abs()
    peak = p_dg.float().abs().max().item()
    # the layer with the projection inside (kernel F), sub-band input width
    x = torch.randn(t_len, rows, SB_FEATURES, generator=gen, device=dev)
    layer = (_uniform(gen, dev, (SB_FEATURES, 4 * h), h ** -0.5),
             _uniform(gen, dev, (h, 4 * h), h ** -0.5),
             _uniform(gen, dev, (4 * h,), h ** -0.5))
    with torch.no_grad():
        err_f = (L.lstm_layer_tm(x, *layer, True, torch.float32)
                 - L.lstm_layer_reference_tm(x, *layer, True)).abs()
    torch.cuda.synchronize()
    hp, route = L.forward_hidden(h, L.scan_smem_bytes)
    hf, route_f = L.layer_route(h, SB_FEATURES)
    log(f"LSTM {tag}: A max|err| {err_a.max().item():.3e} mean "
        f"{err_a.mean().item():.3e}; B (reverse, from a state) "
        f"{err_b:.3e}; C c_seq {err_c.max().item():.3e}, h == A bitwise "
        f"{torch.equal(h_seq, h_a)}; D "
        f"{err_d.max().item():.3e} mean {err_d.mean().item():.3e} (peak "
        f"{peak:.3f}); F (reverse, F={SB_FEATURES}) "
        f"{err_f.max().item():.3e} mean {err_f.mean().item():.3e}; A-C at "
        f"{hp} units ({'single blocks' if route else 'clusters'}), F at {hf} "
        f"({'single blocks' if route_f else 'clusters'}), D: "
        f"{_describe_bwd(L.card_bwd_scan_plan(dev, -(-h // 16) * 16, rows))}")
    check(err_f.max().item() < KERNEL_MAX_ABS
          and err_f.mean().item() < KERNEL_MEAN_ABS,
          f"lstm_layer_tm vs plain at {tag}")
    check(err_a.max().item() < KERNEL_MAX_ABS
          and err_a.mean().item() < KERNEL_MEAN_ABS
          and err_b < KERNEL_MAX_ABS
          and err_c.max().item() < 8 * KERNEL_MAX_ABS
          and err_c.mean().item() < 8 * KERNEL_MEAN_ABS
          and err_d.max().item() < BWD_MAX_REL * peak
          and err_d.mean().item() < BWD_MEAN_REL * peak
          and torch.equal(h_seq, h_a),
          f"LSTM kernels vs plain, and C h == A h bitwise, at {tag}")


def _gru_wrappers_vs_plain(G, dev, gen, h, t_len, rows):
    """The GRU forward, carry and backward wrappers at (H, T, rows) against
    their plain versions within the kernel limits."""
    tag = f"H={h} T={t_len} rows={rows}"
    w_g, b_g = (_uniform(gen, dev, (h, 3 * h), h ** -0.5),
                _uniform(gen, dev, (3 * h,), h ** -0.5))
    gx = torch.randn(t_len, rows, 3 * h, generator=gen,
                     device=dev).to(torch.bfloat16)
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    h0 = _uniform(gen, dev, (rows, h), 1.0)
    with torch.no_grad():
        err_f = (G.gru_scan_tm(gx, w_g, b_g, False, torch.float32)
                 - G.gru_scan_reference_tm(gx, w_g, b_g)).abs()
        got_c = G.gru_scan_carry_tm(gx, w_g, b_g, h0, True, torch.float32)
        h_g = G.gru_scan_tm(gx, w_g, b_g)
    want_c = G.gru_scan_carry_reference_tm(gx, w_g, b_g, h0, True)
    err_gc = max((x - y).abs().max().item() for x, y in zip(got_c, want_c))
    dgx, dw, db = G.gru_scan_bwd_tm(gx, h_g, gout, w_g, b_g)
    p_dgx, p_dw, p_db = G.gru_scan_bwd_reference_tm(gx, h_g, gout, w_g, b_g)
    err_g = (dgx.float() - p_dgx.float()).abs()
    peak_g = p_dgx.float().abs().max().item()
    rel_w, rel_b = _rel_norm(dw, p_dw), _rel_norm(db, p_db)
    torch.cuda.synchronize()
    hp, route = G._forward_route(h)
    log(f"GRU {tag}: forward max|err| {err_f.max().item():.3e} mean "
        f"{err_f.mean().item():.3e}; carry (reverse, from h0) "
        f"{err_gc:.3e}; backward dgx {err_g.max().item():.3e} mean "
        f"{err_g.mean().item():.3e} (peak {peak_g:.3f}), dW_hh "
        f"{rel_w:.3e}, db_hh {rel_b:.3e}; forward at {hp} units "
        f"({'single blocks' if route else 'clusters'}), backward: "
        f"{_describe_bwd(G.card_bwd_scan_plan(dev, -(-h // 16) * 16, rows))}")
    check(err_f.max().item() < KERNEL_MAX_ABS
          and err_f.mean().item() < GRU_FWD_MEAN_ABS
          and err_gc < KERNEL_MAX_ABS
          and err_g.max().item() < BWD_MAX_REL * peak_g
          and err_g.mean().item() < BWD_MEAN_REL * peak_g
          and rel_w < BWD_DW_REL and rel_b < BWD_DW_REL,
          f"GRU kernels vs plain at {tag}")


def phase_block_forwards(dev):
    """The single-block forward route (csrc/lstm_scan_block.cu,
    csrc/gru_scan_block.cu, and kernel F's csrc/lstm_layer_block.cu), which
    the wrappers take where no cluster holds H: bit for bit against the
    cluster entries where both run (LSTM H=512, GRU H=640, forward and
    reverse, bf16 and fp32 out, from a state; kernel F's in phase 12); every
    model-path scan wrapper and lstm_layer_tm at LSTM H=640 and 768 and GRU
    H=768 against its plain version within the kernel limits, with the
    launch counts set to 0 around them; and each scan entry at H=768, T=195,
    18 rows against its plain
    version, with its time beside bound, plain version and cuDNN. Returns
    the entries' numbers for the kernels line and their launches."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    t_len, rows = T_CHUNK, 40

    def both_routes(run):
        """run() on the card's route and on the single-block route."""
        with torch.no_grad():
            got = run()
            with L.single_block_forwards():
                blk = run()
        torch.cuda.synchronize()
        return got, blk

    h = FB_HIDDEN                                  # LSTM: clusters of 16
    w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    h0 = _uniform(gen, dev, (rows, h), 1.0)
    c0 = torch.randn(rows, h, generator=gen, device=dev)
    for reverse in (False, True):
        for out_dtype in (torch.bfloat16, torch.float32):
            got, blk = both_routes(lambda: (
                L.lstm_scan_tm(gates, w_hh, reverse, out_dtype),
                *L.lstm_scan_carry_tm(gates, w_hh, h0, c0, reverse, out_dtype)))
            check(all(torch.equal(x, y) for x, y in zip(got, blk)),
                  f"LSTM single-block A, B == clusters bitwise (H={h}, "
                  f"reverse={reverse}, {out_dtype})")
        got, blk = both_routes(lambda: L.lstm_scan_train_tm(gates, w_hh,
                                                            reverse))
        check(all(torch.equal(x, y) for x, y in zip(got, blk)),
              f"LSTM single-block C == cluster C bitwise (H={h}, "
              f"reverse={reverse})")
    log(f"LSTM single-block forwards (A, B from a state, C) == the clusters "
        f"bitwise at H={h} T={t_len} rows={rows}, forward and reverse, bf16 "
        f"and fp32 out")
    h = 640                                        # GRU: clusters of 16
    w_g, b_g = (_uniform(gen, dev, (h, 3 * h), h ** -0.5),
                _uniform(gen, dev, (3 * h,), h ** -0.5))
    gx = torch.randn(t_len, rows, 3 * h, generator=gen,
                     device=dev).to(torch.bfloat16)
    h0 = _uniform(gen, dev, (rows, h), 1.0)
    for reverse in (False, True):
        for out_dtype in (torch.bfloat16, torch.float32):
            got, blk = both_routes(lambda: (
                G.gru_scan_tm(gx, w_g, b_g, reverse, out_dtype),
                *G.gru_scan_carry_tm(gx, w_g, b_g, h0, reverse, out_dtype)))
            check(all(torch.equal(x, y) for x, y in zip(got, blk)),
                  f"GRU single-block forward, carry == clusters bitwise "
                  f"(H={h}, reverse={reverse}, {out_dtype})")
    log(f"GRU single-block forward and carry == the clusters bitwise at H={h} "
        f"T={t_len} rows={rows}, forward and reverse, bf16 and fp32 out; "
        f"the cluster plan there: {_plan_line(G, dev, h, rows)}")
    del gates, gx

    # the route itself: every model-path wrapper where no cluster fits
    L.reset_launch_counts()
    for h in BLOCK_HIDDEN:
        _lstm_wrappers_vs_plain(L, dev, gen, h, t_len, rows)
    _gru_wrappers_vs_plain(G, dev, gen, BLOCK_HIDDEN[-1], t_len, rows)
    launches = {k: L.launch_counts[k] for k in (
        "lstm_scan_fwd_block", "lstm_scan_fwd_carry_block",
        "lstm_scan_fwd_train_block", "lstm_layer_fwd_block",
        "gru_scan_fwd_block", "gru_scan_fwd_carry_block")}
    log(f"launches of the single-block forwards at LSTM H={BLOCK_HIDDEN} and "
        f"GRU H={BLOCK_HIDDEN[-1]}: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} launched by the wrappers at an H no cluster "
              f"holds")

    # each entry at H=768, the full-band training shape's T and rows
    h, t_len, rows = BLOCK_HIDDEN[-1], TRAIN_T, TRAIN_BATCH
    card = card_line()
    w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    zeros = torch.zeros(rows, h, device=dev)
    with torch.no_grad():
        err_a = (L.lstm_scan_tm(gates, w_hh, False, torch.float32)
                 - L.lstm_scan_reference_tm(gates, w_hh)).abs().max().item()
        err_b = max((x - y).abs().max().item() for x, y in zip(
            L.lstm_scan_carry_tm(gates, w_hh, zeros, zeros, False,
                                 torch.float32),
            L.lstm_scan_carry_reference_tm(gates, w_hh, zeros, zeros)))
    err_c = max((x.float() - y.float()).abs().max().item() for x, y in zip(
        L.lstm_scan_train_tm(gates, w_hh),
        L.lstm_scan_train_reference_tm(gates, w_hh)))
    check(err_a < KERNEL_MAX_ABS and err_b < KERNEL_MAX_ABS
          and err_c < 8 * KERNEL_MAX_ABS,
          f"LSTM single-block forwards vs plain at H={h} T={t_len} "
          f"rows={rows}")
    with torch.no_grad():
        ms_a = cuda_ms(lambda: L.lstm_scan_tm(gates, w_hh), iters=5)
        ms_b = cuda_ms(lambda: L.lstm_scan_carry_tm(gates, w_hh, zeros,
                                                    zeros), iters=5)
    ms_c = cuda_ms(lambda: L.lstm_scan_train_tm(gates, w_hh), iters=5)
    plain_a = cuda_ms(lambda: L.lstm_scan_reference_tm(gates, w_hh), iters=2)
    plain_b = cuda_ms(lambda: L.lstm_scan_carry_reference_tm(
        gates, w_hh, zeros, zeros), iters=2)
    plain_c = cuda_ms(lambda: L.lstm_scan_train_reference_tm(gates, w_hh),
                      iters=2)
    lib_a = library_lstm_ms(gates, w_hh)
    lib_c = library_lstm_train_ms(gates, w_hh, torch.randn(
        t_len, rows, h, generator=gen, device=dev).to(torch.bfloat16))[0]
    b_a, by_a = bound(t_len, rows, h)
    b_b, by_b = bound(t_len, rows, h, extra_bytes=4 * rows * h * 4)
    b_c, by_c = bound(t_len, rows, h, streams=6)
    log(f"LSTM single-block forwards at T={t_len} rows={rows} H={h}: A "
        f"{ms_a:.3f} ms (max|err| {err_a:.3e}), B in one chunk {ms_b:.3f} ms "
        f"({err_b:.3e}), C {ms_c:.3f} ms ({err_c:.3e}); bounds {b_a:.4f} / "
        f"{b_b:.4f} / {b_c:.4f} ms; plain {plain_a:.3f} / {plain_b:.3f} / "
        f"{plain_c:.3f} ms; cuDNN LSTM {lib_a:.3f} ms, training-mode forward "
        f"{lib_c:.3f} ms on {card}")
    w_g, b_g = (_uniform(gen, dev, (h, 3 * h), h ** -0.5),
                _uniform(gen, dev, (3 * h,), h ** -0.5))
    gx = torch.randn(t_len, rows, 3 * h, generator=gen,
                     device=dev).to(torch.bfloat16)
    with torch.no_grad():
        err_f = (G.gru_scan_tm(gx, w_g, b_g, False, torch.float32)
                 - G.gru_scan_reference_tm(gx, w_g, b_g)).abs().max().item()
        err_g = max((x - y).abs().max().item() for x, y in zip(
            G.gru_scan_carry_tm(gx, w_g, b_g, zeros, False, torch.float32),
            G.gru_scan_carry_reference_tm(gx, w_g, b_g, zeros)))
        ms_f = cuda_ms(lambda: G.gru_scan_tm(gx, w_g, b_g), iters=5)
        ms_g = cuda_ms(lambda: G.gru_scan_carry_tm(gx, w_g, b_g, zeros),
                       iters=5)
    check(err_f < KERNEL_MAX_ABS and err_g < KERNEL_MAX_ABS,
          f"GRU single-block forwards vs plain at H={h} T={t_len} rows={rows}")
    plain_f = cuda_ms(lambda: G.gru_scan_reference_tm(gx, w_g, b_g), iters=2)
    plain_g = cuda_ms(lambda: G.gru_scan_carry_reference_tm(gx, w_g, b_g,
                                                            zeros), iters=2)
    lib_f = library_gru_ms(gx, w_g, b_g)
    b_f, by_f = bound(t_len, rows, h, streams=4, gates=3,
                      extra_bytes=3 * h * 4)
    b_g2, by_g2 = bound(t_len, rows, h, streams=4, gates=3,
                        extra_bytes=3 * h * 4 + 2 * rows * h * 4)
    log(f"GRU single-block forwards at T={t_len} rows={rows} H={h}: forward "
        f"{ms_f:.3f} ms (max|err| {err_f:.3e}), carry in one chunk "
        f"{ms_g:.3f} ms ({err_g:.3e}); bounds {b_f:.4f} / {b_g2:.4f} ms; plain "
        f"{plain_f:.3f} / {plain_g:.3f} ms; cuDNN GRU {lib_f:.3f} ms on {card}")
    kernels = {
        "lstm_scan_fwd_block": dict(max_abs_err=err_a, ms=ms_a,
                                    plain_ms=plain_a, bound_ms=b_a,
                                    bound_by=by_a, library_ms=lib_a),
        "lstm_scan_fwd_carry_block": dict(max_abs_err=err_b, ms=ms_b,
                                          plain_ms=plain_b, bound_ms=b_b,
                                          bound_by=by_b, library_ms=lib_a),
        "lstm_scan_fwd_train_block": dict(max_abs_err=err_c, ms=ms_c,
                                          plain_ms=plain_c, bound_ms=b_c,
                                          bound_by=by_c, library_ms=lib_c),
        "gru_scan_fwd_block": dict(max_abs_err=err_f, ms=ms_f,
                                   plain_ms=plain_f, bound_ms=b_f,
                                   bound_by=by_f, library_ms=lib_f),
        "gru_scan_fwd_carry_block": dict(max_abs_err=err_g, ms=ms_g,
                                         plain_ms=plain_g, bound_ms=b_g2,
                                         bound_by=by_g2, library_ms=lib_f)}
    return kernels, launches


def _gru_library(w_hh, b_hh):
    """cuDNN's GRU on the same x-side gates: nn.GRU(3H, H) with W_ih = I and
    b_ih = 0, so each step computes what the kernels do, plus one extra
    [T*rows, 3H] x [3H, 3H] projection."""
    h = w_hh.shape[0]
    gru = torch.nn.GRU(3 * h, h, device=w_hh.device, dtype=torch.bfloat16)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.eye(3 * h))
        gru.weight_hh_l0.copy_(w_hh.t())
        gru.bias_ih_l0.zero_()
        gru.bias_hh_l0.copy_(b_hh)
    return gru


def library_gru_ms(gates, w_hh, b_hh):
    """The cuDNN GRU of _gru_library, inference. Timed only."""
    gru = _gru_library(w_hh, b_hh)
    with torch.no_grad():
        return cuda_ms(lambda: gru(gates), iters=5)


def library_gru_train_ms(gates, w_hh, b_hh, gout):
    """The cuDNN GRU of _gru_library in training mode: the forward alone,
    and the forward plus the backward to the gates and the weights. Timed
    only."""
    gru = _gru_library(w_hh, b_hh)
    x = gates.detach().requires_grad_()

    def both():
        gru(x)[0].backward(gout)
        x.grad = None
        gru.zero_grad(set_to_none=True)

    return cuda_ms(lambda: gru(x), iters=5), cuda_ms(both, iters=5)


def library_dwhh_ms(h_prev, dgates_h):
    """One torch.mm with bf16 operands and fp32 output on the rows the dW_hh
    contraction takes. Timed only."""
    return cuda_ms(lambda: torch.mm(h_prev.t(), dgates_h,
                                    out_dtype=torch.float32), iters=5)


def _gru_chunked(G, gates, w_hh, b_hh, reverse, out_dtype):
    """The carry kernel over chunks of T_CHUNK frames (the last one ragged)."""
    t_len, rows = gates.shape[:2]
    hs = torch.zeros(rows, w_hh.shape[0], device=gates.device)
    out = torch.empty(t_len, rows, w_hh.shape[0], dtype=out_dtype,
                      device=gates.device)
    starts = list(range(0, t_len, T_CHUNK))
    for s in (starts[::-1] if reverse else starts):
        e = min(s + T_CHUNK, t_len)
        out[s:e], hs = G.gru_scan_carry_tm(gates[s:e], w_hh, b_hh, hs, reverse,
                                           out_dtype)
    return out


def _plan_line(M, dev, h, rows, **instance):
    """A cluster scan's launch plan at (H, rows) on the card: M is ops.lstm
    (kernels A-C; instance flags out_dtype, carry, train) or ops.gru (the
    GRU forward; out_dtype, carry)."""
    plan = M.card_scan_plan(dev, h, rows, **instance)
    return (f"cluster C={plan.cluster} x R={plan.rows} rows, {plan.clusters} "
            f"clusters, route DSMEM, cudaOccupancyMaxActiveClusters "
            f"{plan.active}, {plan.waves} wave(s), {plan.smem_bytes} B of "
            f"shared memory a CTA")


def _bwd_plan_line(M, dev, h, rows):
    """The backward scan's launch plan at (H, rows) on the card: M is
    ops.lstm (kernel D) or ops.gru (the GRU backward scan)."""
    plan = M.card_bwd_scan_plan(dev, h, rows)
    return _describe_bwd(plan)


def _describe_bwd(plan):
    if plan.design == "block":
        return (f"single block, {plan.clusters} blocks of 16 rows, "
                f"{plan.active} at once, {plan.waves} wave(s), "
                f"{plan.smem_bytes} B of shared memory a block, modelled "
                f"{plan.step_us:.2f} us a step")
    return (f"cluster C={plan.cluster} x R={plan.rows} rows, recompute's "
            f"W_hh^T slice {'resident' if plan.resident else 'from L2'}, "
            f"{plan.clusters} clusters, cudaOccupancyMaxActiveClusters "
            f"{plan.active}, {plan.waves} wave(s), {plan.smem_bytes} B of "
            f"shared memory a CTA, modelled {plan.step_us:.2f} us a step")


def _block_bwd_plan(M, dev, h, rows):
    """The single-block design's plan at (H, rows): the planner with no
    cluster to choose from."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return M.plan_bwd_scan(h, rows, lambda c, r, resident: 0, sms)


def _plan_json(L, dev, h, rows, **instance):
    """The plan of kernels A-C at (H, rows) for the kernels line."""
    return dataclasses.asdict(L.card_scan_plan(dev, h, rows, **instance))


def phase_gru_kernels(dev):
    """The GRU forward and carry kernels at the sub-band serving shape and
    at the full-band serving and training shapes."""
    from generative_audio_torch.ops import gru as G
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    max_f = max_c = 0.0
    weights = {}
    for h, row_counts, t_len in ((HIDDEN, (ROWS, RAGGED_ROWS), T_FRAMES),
                                 (FB_HIDDEN, (FB_SERVE_ROWS, 1), T_FRAMES),
                                 (FB_HIDDEN, (TRAIN_BATCH,), TRAIN_T)):
        if h not in weights:
            weights[h] = (_uniform(gen, dev, (h, 3 * h), h ** -0.5),
                          _uniform(gen, dev, (3 * h,), h ** -0.5))
        w_hh, b_hh = weights[h]
        for rows in row_counts:
            gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                                device=dev).to(torch.bfloat16)
            for reverse in (False, True):
                tag = f"H={h} T={t_len} rows={rows} reverse={reverse}"
                got = G.gru_scan_tm(gates, w_hh, b_hh, reverse, torch.float32)
                want = G.gru_scan_reference_tm(gates, w_hh, b_hh, reverse)
                torch.cuda.synchronize()
                err = (got - want).abs()
                log(f"GRU forward {tag}: max|err| {err.max().item():.3e} mean "
                    f"{err.mean().item():.3e}")
                check(torch.isfinite(got).all().item(),
                      f"GRU forward output finite ({tag})")
                check(err.max().item() < KERNEL_MAX_ABS
                      and err.mean().item() < GRU_FWD_MEAN_ABS,
                      f"GRU forward vs plain within {KERNEL_MAX_ABS}/"
                      f"{GRU_FWD_MEAN_ABS} ({tag})")
                max_f = max(max_f, err.max().item())

                for out_dtype in (torch.bfloat16, torch.float32):
                    whole = G.gru_scan_tm(gates, w_hh, b_hh, reverse, out_dtype)
                    chunked = _gru_chunked(G, gates, w_hh, b_hh, reverse,
                                           out_dtype)
                    check(torch.equal(chunked, whole),
                          f"GRU carry in chunks == forward bitwise ({tag} "
                          f"{out_dtype})")
                log(f"GRU carry, chunks of {T_CHUNK} == forward bitwise ({tag}, "
                    f"bf16 and fp32 out)")

                # the carry kernel against its plain version from a state
                h0 = _uniform(gen, dev, (rows, h), 1.0)
                seq, h_t = G.gru_scan_carry_tm(gates[:T_CHUNK], w_hh, b_hh, h0,
                                               reverse, torch.float32)
                p_seq, p_h = G.gru_scan_carry_reference_tm(
                    gates[:T_CHUNK], w_hh, b_hh, h0, reverse)
                err_c = max((seq - p_seq).abs().max().item(),
                            (h_t - p_h).abs().max().item())
                log(f"GRU carry {tag} from h0: max|err| {err_c:.3e}")
                check(err_c < KERNEL_MAX_ABS, f"GRU carry vs plain ({tag})")
                max_c = max(max_c, err_c)
            del gates

    # times at the sub-band serving shape, bf16 out as the path runs them
    h = HIDDEN
    w_hh, b_hh = weights[h]
    gates = torch.randn(T_FRAMES, ROWS, 3 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    zeros = torch.zeros(ROWS, h, device=dev)
    ms_f = cuda_ms(lambda: G.gru_scan_tm(gates, w_hh, b_hh), iters=5)
    ms_c = cuda_ms(lambda: _gru_chunked(G, gates, w_hh, b_hh, False,
                                        torch.bfloat16), iters=5)
    ms_c_one = cuda_ms(lambda: G.gru_scan_carry_tm(gates, w_hh, b_hh, zeros),
                       iters=5)
    plain_f = cuda_ms(lambda: G.gru_scan_reference_tm(gates, w_hh, b_hh),
                      iters=2)
    plain_c = cuda_ms(lambda: [G.gru_scan_carry_reference_tm(
        gates[s:s + T_CHUNK], w_hh, b_hh, zeros)
        for s in range(0, T_FRAMES, T_CHUNK)], iters=2)
    library = library_gru_ms(gates, w_hh, b_hh)
    n_chunks = -(-T_FRAMES // T_CHUNK)
    # gates in (3 streams of H), h out (1), W_hh, b_hh; the carry also reads
    # and writes the fp32 state once per chunk
    b_f, by_f = bound(T_FRAMES, ROWS, h, streams=4, gates=3,
                      extra_bytes=3 * h * 4)
    b_c, by_c = bound(T_FRAMES, ROWS, h, streams=4, gates=3,
                      extra_bytes=3 * h * 4 + n_chunks * 2 * ROWS * h * 4)
    card = card_line()
    log(f"GRU forward at T={T_FRAMES} rows={ROWS} H={h}: {ms_f:.3f} ms, "
        f"{1e3 * ms_f / T_FRAMES:.2f} us a step (bound {b_f:.3f} ms by "
        f"{by_f}; plain {plain_f:.3f} ms; cuDNN GRU {library:.3f} ms) on {card}")
    log(f"  plan: {_plan_line(G, dev, h, ROWS)}")
    log(f"GRU carry, {n_chunks} chunks of {T_CHUNK}: {ms_c:.3f} ms, "
        f"{1e3 * ms_c / T_FRAMES:.2f} us a step (bound {b_c:.3f} ms by {by_c}; "
        f"plain {plain_c:.3f} ms); in one chunk of {T_FRAMES}: {ms_c_one:.3f} "
        f"ms on {card}")
    log(f"  plan: {_plan_line(G, dev, h, ROWS, carry=True)}")
    log("  (the cuDNN GRU is nn.GRU(3H, H) with W_ih = I and b_ih = 0: the "
        "same recurrence plus one extra [T*rows, 3H] x [3H, 3H] projection)")
    del gates
    # the full-band shapes: one cluster
    h = FB_HIDDEN
    w_hh, b_hh = weights[h]
    for rows, t_len, what in ((FB_SERVE_ROWS, T_FRAMES, "serving"),
                              (TRAIN_BATCH, TRAIN_T, "training")):
        gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        ms_fb = cuda_ms(lambda: G.gru_scan_tm(gates, w_hh, b_hh), iters=5)
        plain_fb = cuda_ms(lambda: G.gru_scan_reference_tm(gates, w_hh, b_hh),
                           iters=2)
        lib_fb = library_gru_ms(gates, w_hh, b_hh)
        b_fb, by_fb = bound(t_len, rows, h, streams=4, gates=3,
                            extra_bytes=3 * h * 4)
        log(f"GRU forward at T={t_len} rows={rows} H={h} (full band, "
            f"{what}): {ms_fb:.3f} ms, {1e3 * ms_fb / t_len:.2f} us a step "
            f"(bound {b_fb:.4f} ms by {by_fb}; plain {plain_fb:.3f} ms; cuDNN "
            f"GRU {lib_fb:.3f} ms) on {card}")
        log(f"  plan: {_plan_line(G, dev, h, rows)}")
        del gates
    return {
        "gru_scan_fwd": dict(
            max_abs_err=max_f, ms=ms_f, plain_ms=plain_f, bound_ms=b_f,
            bound_by=by_f, library_ms=library),
        "gru_scan_fwd_carry": dict(
            max_abs_err=max_c, ms=ms_c, plain_ms=plain_c, bound_ms=b_c,
            bound_by=by_c, library_ms=library)}


def _rel_norm(got, want):
    return ((got - want).norm() / want.norm()).item()


def phase_gru_train_kernels(dev, registers):
    """The GRU backward (scan + dW_hh contraction) at the training shapes,
    the scan's plan (a cluster) against the single block bit for bit (dgx,
    dhn and every db_hh partial), and the GRUScan gradient as a whole; the
    scan's times at the sub-band and full-band training shapes."""
    from generative_audio_torch.ops import gru as G
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    t_len = TRAIN_T
    max_d = max_w = 0.0
    weights = {}
    for h, rows in ((HIDDEN, TRAIN_ROWS), (HIDDEN, TRAIN_RAGGED_ROWS),
                    (FB_HIDDEN, TRAIN_BATCH)):
        if h not in weights:
            weights[h] = (_uniform(gen, dev, (h, 3 * h), h ** -0.5),
                          _uniform(gen, dev, (3 * h,), h ** -0.5))
        w_hh, b_hh = weights[h]
        for reverse in (False, True):
            gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                                device=dev).to(torch.bfloat16)
            gout = torch.randn(t_len, rows, h, generator=gen,
                               device=dev).to(torch.bfloat16)
            tag = f"H={h} rows={rows} reverse={reverse}"
            # the forward as GRUScan launches it, at this shape
            with torch.no_grad():
                h_seq = G.gru_scan_tm(gates, w_hh, b_hh, reverse)
            # against the plain version rounded to bf16 as the kernel rounds
            # its output: a difference that crosses a rounding boundary shows
            # as one bf16 step of |h| < 1 (3.9e-3), under KERNEL_MAX_ABS
            err_f = (h_seq.float() - G.gru_scan_reference_tm(
                gates, w_hh, b_hh, reverse).to(torch.bfloat16).float()).abs()
            log(f"GRU forward {tag} T={t_len}, bf16 out: max|err| "
                f"{err_f.max().item():.3e} mean {err_f.mean().item():.3e}")
            check(err_f.max().item() < KERNEL_MAX_ABS
                  and err_f.mean().item() < GRU_FWD_MEAN_ABS,
                  f"GRU forward vs plain within {KERNEL_MAX_ABS}/"
                  f"{GRU_FWD_MEAN_ABS} at the training shape ({tag})")
            del err_f
            dgx, dw, db = G.gru_scan_bwd_tm(gates, h_seq, gout, w_hh, b_hh,
                                            reverse)
            p_dgx, p_dhn, p_db = G.gru_scan_bwd_streams_reference_tm(
                gates, h_seq, gout, w_hh, b_hh, reverse)
            shifted = G.shifted_rows(h_seq, p_dgx, p_dhn, reverse)
            p_dw = G.gru_dwhh_reference(*shifted)
            # the contraction alone, on the plain version's own streams, twice
            alone = G.gru_dwhh(*shifted)
            repeats = torch.equal(alone, G.gru_dwhh(*shifted))
            torch.cuda.synchronize()
            err_d = (dgx.float() - p_dgx.float()).abs()
            peak = p_dgx.float().abs().max().item()
            rel_w, rel_b = _rel_norm(dw, p_dw), _rel_norm(db, p_db)
            rel_alone = _rel_norm(alone, p_dw)
            log(f"GRU backward {tag}: dgx max|err| {err_d.max().item():.3e} "
                f"mean {err_d.mean().item():.3e} (peak |dgx| {peak:.3f}); dW_hh "
                f"|err|/|dW_hh| {rel_w:.3e}, db_hh {rel_b:.3e}; the contraction "
                f"alone vs a float32 matmul {rel_alone:.3e} (max|err| "
                f"{(alone - p_dw).abs().max().item():.3e}), the same bits in two "
                f"runs: {repeats}")
            check(all(torch.isfinite(x.float()).all().item()
                      for x in (dgx, dw, db)), f"GRU backward finite ({tag})")
            check(err_d.max().item() < BWD_MAX_REL * peak
                  and err_d.mean().item() < BWD_MEAN_REL * peak,
                  f"GRU backward dgx vs plain within {BWD_MAX_REL}/"
                  f"{BWD_MEAN_REL} of the peak ({tag})")
            check(rel_w < BWD_DW_REL and rel_b < BWD_DW_REL,
                  f"GRU backward dW_hh, db_hh vs plain within {BWD_DW_REL} "
                  f"({tag})")
            check(rel_alone < DWHH_ALONE_REL,
                  f"dW_hh contraction vs float32 matmul within "
                  f"{DWHH_ALONE_REL} ({tag})")
            check(repeats, f"dW_hh contraction repeats bit for bit ({tag})")
            max_d = max(max_d, err_d.max().item())
            max_w = max(max_w, (alone - p_dw).abs().max().item())
            del p_dgx, p_dhn, shifted, err_d
            # the card's plan (a cluster) against the single-block design:
            # dgx, dhn and the db_hh partial of every 16-row tile
            got = G.gru_scan_bwd_streams_planned_tm(
                gates, h_seq, gout, w_hh, b_hh,
                G.card_bwd_scan_plan(dev, h, rows), reverse)
            want = G.gru_scan_bwd_streams_planned_tm(
                gates, h_seq, gout, w_hh, b_hh,
                _block_bwd_plan(G, dev, h, rows), reverse)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(got, want))
                  and torch.equal(got[0], dgx),
                  f"GRU backward scan's plan == the single block bitwise "
                  f"(dgx, dhn, {got[2].shape[0]} db_hh partials; {tag})")
            log(f"GRU backward scan {tag}: plan "
                f"{_bwd_plan_line(G, dev, h, rows)}; == the single block "
                f"bitwise (dgx, dhn, {got[2].shape[0]} db_hh partials)")
            del got, want

            # GRUScan as a whole against autograd through the fp32 recurrence
            kernel_in = [gates.clone().requires_grad_(),
                         w_hh.clone().requires_grad_(),
                         b_hh.clone().requires_grad_()]
            (G.gru_scan_tm(*kernel_in, reverse, torch.float32)
             * gout.float()).sum().backward()
            exact_in = [gates.float().requires_grad_(),
                        w_hh.clone().requires_grad_(),
                        b_hh.clone().requires_grad_()]
            (G.gru_scan_reference_tm(*exact_in, reverse,
                                     compute_dtype=torch.float32)
             * gout.float()).sum().backward()
            torch.cuda.synchronize()
            g_k, w_k, b_k = (x.grad for x in kernel_in)
            g_x, w_x, b_x = (x.grad for x in exact_in)
            check(g_k.dtype == torch.bfloat16 and w_k.dtype == torch.float32
                  and b_k.dtype == torch.float32 and b_k.shape == b_hh.shape,
                  "GRUScan gradient dtypes")
            err_g = (g_k.float() - g_x).abs()
            peak_g = g_x.abs().max().item()
            rel_w, rel_b = _rel_norm(w_k, w_x), _rel_norm(b_k, b_x)
            log(f"GRUScan {tag} vs float32 autograd: d gates max|err|/peak "
                f"{err_g.max().item() / peak_g:.3e} mean/peak "
                f"{err_g.mean().item() / peak_g:.3e}; dW_hh |err|/|dW_hh| "
                f"{rel_w:.3e}; db_hh {rel_b:.3e}")
            check(err_g.max().item() < GRAD_MAX_REL * peak_g
                  and err_g.mean().item() < GRAD_MEAN_REL * peak_g
                  and rel_w < GRAD_DW_REL and rel_b < GRAD_DW_REL,
                  f"GRUScan gradient vs float32 within {GRAD_MAX_REL}/"
                  f"{GRAD_MEAN_REL}/{GRAD_DW_REL} ({tag})")
            del kernel_in, exact_in, err_g, gates, gout

    # times at the sub-band training shape
    h, rows = HIDDEN, TRAIN_ROWS
    w_hh, b_hh = weights[h]
    gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    with torch.no_grad():
        h_seq = G.gru_scan_tm(gates, w_hh, b_hh)
        ms_f = cuda_ms(lambda: G.gru_scan_tm(gates, w_hh, b_hh), iters=5)
    dgx, dhn, _ = G.gru_scan_bwd_streams_tm(gates, h_seq, gout, w_hh, b_hh)
    ms_d = cuda_ms(lambda: G.gru_scan_bwd_streams_tm(gates, h_seq, gout, w_hh,
                                                     b_hh), iters=5)
    block = _block_bwd_plan(G, dev, h, rows)
    ms_d_block = cuda_ms(lambda: G.gru_scan_bwd_streams_planned_tm(
        gates, h_seq, gout, w_hh, b_hh, block), iters=3)
    plain_d = cuda_ms(lambda: G.gru_scan_bwd_streams_reference_tm(
        gates, h_seq, gout, w_hh, b_hh), iters=2)
    lib_fwd, lib_both = library_gru_train_ms(gates, w_hh, b_hh, gout)
    # the scan: gx (3) + h_seq + gout in, dgx (3) + dhn out, W_hh and b_hh
    # in, db_hh out; two products per step. The per-block db_hh partials and
    # the second layout of W_hh are the design's own and not counted.
    b_d, by_d = bound(t_len, rows, h, streams=9, products=2, gates=3,
                      extra_bytes=2 * 3 * h * 4)
    card = card_line()
    log(f"GRU forward at T={t_len} rows={rows} H={h} (the forward under grad): "
        f"{ms_f:.3f} ms, {1e3 * ms_f / t_len:.2f} us a step (cuDNN GRU "
        f"forward, training mode, {lib_fwd:.3f} ms) on {card}")
    log(f"  plan: {_plan_line(G, dev, h, rows)}")
    log(f"GRU backward scan at T={t_len} rows={rows} H={h}: {ms_d:.3f} ms, "
        f"{1e3 * ms_d / t_len:.2f} us a step (the single-block design "
        f"{ms_d_block:.3f} ms; bound {b_d:.3f} ms by {by_d}; plain "
        f"{plain_d:.3f} ms; cuDNN GRU backward {lib_both - lib_fwd:.3f} "
        f"ms = forward + backward {lib_both:.3f} ms less the forward, dW_hh "
        f"and db_hh included) on {card}")
    log(f"  plan: {_bwd_plan_line(G, dev, h, rows)}; registers "
        f"{_registers_line(registers, 'G')}")
    scan_plan = dataclasses.asdict(G.card_bwd_scan_plan(dev, h, rows))
    contraction = _time_dwhh(G, h_seq, dgx, dhn, card)
    del gates, gout, h_seq, dgx, dhn
    # the contraction at the full-band training shape
    h, rows = FB_HIDDEN, TRAIN_BATCH
    w_hh, b_hh = weights[h]
    gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    with torch.no_grad():
        h_seq = G.gru_scan_tm(gates, w_hh, b_hh)
    dgx, dhn, _ = G.gru_scan_bwd_streams_tm(gates, h_seq, gout, w_hh, b_hh)
    _time_dwhh(G, h_seq, dgx, dhn, card)
    # the scan at the full-band training shape: both designs, bound, plain
    # version and cuDNN's backward
    ms_fb = cuda_ms(lambda: G.gru_scan_bwd_streams_tm(gates, h_seq, gout,
                                                      w_hh, b_hh), iters=10)
    block = _block_bwd_plan(G, dev, h, rows)
    ms_fb_block = cuda_ms(lambda: G.gru_scan_bwd_streams_planned_tm(
        gates, h_seq, gout, w_hh, b_hh, block), iters=3)
    plain_fb = cuda_ms(lambda: G.gru_scan_bwd_streams_reference_tm(
        gates, h_seq, gout, w_hh, b_hh), iters=2)
    lib_fwd_fb, lib_both_fb = library_gru_train_ms(gates, w_hh, b_hh, gout)
    b_fb, by_fb = bound(t_len, rows, h, streams=9, products=2, gates=3,
                        extra_bytes=2 * 3 * h * 4)
    log(f"GRU backward scan at T={t_len} rows={rows} H={h} (full band, "
        f"training batch): {ms_fb:.3f} ms, {1e3 * ms_fb / t_len:.2f} us a step "
        f"(the single-block design {ms_fb_block:.3f} ms; bound {b_fb:.4f} ms "
        f"by {by_fb}; plain {plain_fb:.3f} ms; cuDNN GRU backward "
        f"{lib_both_fb - lib_fwd_fb:.3f} ms, dW_hh and db_hh included) on "
        f"{card}")
    log(f"  plan: {_bwd_plan_line(G, dev, h, rows)}")
    return {
        "gru_scan_bwd": dict(
            max_abs_err=max_d, ms=ms_d, plain_ms=plain_d, bound_ms=b_d,
            bound_by=by_d, library_ms=lib_both - lib_fwd,
            single_block_ms=ms_d_block, plan=scan_plan,
            full_band=dict(
                ms=ms_fb, single_block_ms=ms_fb_block, plain_ms=plain_fb,
                bound_ms=b_fb, bound_by=by_fb,
                library_ms=lib_both_fb - lib_fwd_fb,
                plan=dataclasses.asdict(G.card_bwd_scan_plan(dev, h, rows)))),
        "gru_scan_bwd_dwhh": dict(max_abs_err=max_w, **contraction)}


def _time_dwhh(G, h_seq, dgx, dhn, card):
    """The dW_hh contraction over the shifted rows of one layer's streams:
    its time (the slices' sum included), bound, plain version and one
    torch.mm."""
    h = h_seq.shape[-1]
    h_prev, dg, dn = G.shifted_rows(h_seq, dgx, dhn, False)
    n = h_prev.shape[0]
    ms_w = cuda_ms(lambda: G.gru_dwhh(h_prev, dg, dn), iters=10)
    plain_w = cuda_ms(lambda: G.gru_dwhh_reference(h_prev, dg, dn), iters=2)
    lib_w = library_dwhh_ms(h_prev, torch.cat([dg[:, :2 * h], dn], dim=-1))
    # h_prev, the 2H columns of dgx it needs and dhn in, one fp32 [H, 3H]
    # out (the per-slice partials are the design's own)
    b_w, by_w = _larger(n * 4 * h * 2 + h * 3 * h * 4, 2 * n * h * 3 * h)
    plan = G.plan_dwhh(n, h)
    log(f"GRU dW_hh contraction at H={h} over N={n} rows, {plan.tiles} tiles "
        f"x {plan.slices} slices of {plan.rows_per_slice} rows and their sum: "
        f"{ms_w:.3f} ms (bound {b_w:.3f} ms by {by_w}; plain {plain_w:.3f} ms; "
        f"torch.mm with fp32 output {lib_w:.3f} ms) on {card}")
    return dict(ms=ms_w, plain_ms=plain_w, bound_ms=b_w, bound_by=by_w,
                library_ms=lib_w)


def library_layer_ms(x, w_ih, w_hh, bias):
    """cuDNN's LSTM, nn.LSTM(F, H) in bf16, on x [T, B, F] with the layer's
    own weights (b_ih = bias, b_hh = 0): the same function as lstm_layer_tm,
    projection included. Timed only."""
    h = w_hh.shape[0]
    lstm = torch.nn.LSTM(w_ih.shape[0], h, device=x.device, dtype=torch.bfloat16)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih.t())
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.copy_(bias)
        lstm.bias_hh_l0.zero_()
        return cuda_ms(lambda: lstm(x), iters=5)


def _layer_bound(t, rows, f, h):
    """Least time (ms) of one layer with the projection inside: x and h
    streams and the weights in bf16, the fp32 bias; 2*(F + H)*4H operations
    per row and step."""
    return _larger(t * rows * (f + h) * 2 + (f + h) * 4 * h * 2 + 4 * h * 4,
                   2 * t * rows * (f + h) * 4 * h)


def _sub_band_stack(dev, path):
    """FullSubNet+'s sub-band LSTM stack on one batch-8 x 10 s request: its
    layer-1 input [T, rows, 34] (float32), the stack's own bf16 output and
    the two layers' (w_ih [F, 4H], w_hh [H, 4H], b_ih + b_hh)."""
    from generative_audio_torch.ops import prepare_input_from_waveform
    model = path.model(torch.bfloat16, dev)
    stack = model.sb_model.sequence_model
    seen = {}
    hooks = [stack.register_forward_pre_hook(
                 lambda m, args: seen.setdefault("x", args[0])),
             stack.register_forward_hook(
                 lambda m, args, y: seen.setdefault("y", y))]
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    wav = torch.randn(8, 160000, generator=gen, device=dev) * 0.1
    with torch.no_grad():
        model(*prepare_input_from_waveform(wav, 512, 256, 512)[:path.n_inputs])
        weights = [tuple(w.detach().clone() for w in (
            getattr(stack, f"weight_ih_l{i}").t(),
            getattr(stack, f"weight_hh_l{i}").t(),
            getattr(stack, f"bias_ih_l{i}") + getattr(stack, f"bias_hh_l{i}")))
            for i in range(2)]
    for hook in hooks:
        hook.remove()
    return seen["x"], seen["y"], weights


def _check_layer(L, tag, x, weights, reverse):
    """lstm_layer_fwd and its single block, lstm_layer_fwd_block (fp32 out
    both), against the plain version; (max |err| of each)."""
    want = L.lstm_layer_reference_tm(x, *weights, reverse)
    errs = []
    for name in ("lstm_layer_fwd", "lstm_layer_fwd_block"):
        with (L.single_block_forwards() if name.endswith("_block")
              else contextlib.nullcontext()):
            got = L.lstm_layer_tm(x, *weights, reverse, torch.float32)
        torch.cuda.synchronize()
        err = (got - want).abs()
        log(f"{name} {tag} reverse={reverse}: max|err| "
            f"{err.max().item():.3e} mean {err.mean().item():.3e}")
        check(torch.isfinite(got).all().item(), f"{name} finite ({tag})")
        check(err.max().item() < KERNEL_MAX_ABS
              and err.mean().item() < KERNEL_MEAN_ABS,
              f"{name} vs plain within {KERNEL_MAX_ABS}/{KERNEL_MEAN_ABS} "
              f"({tag} reverse={reverse})")
        errs.append(err.max().item())
    return tuple(errs)


def _layer_routes_agree(L, inp, weights, reverse):
    """lstm_layer_tm (fp32 out) on the card's route (the cluster) and on
    the single block (the first design of kernel F): bit for bit?"""
    with torch.no_grad():
        got = L.lstm_layer_tm(inp, *weights, reverse, torch.float32)
        with L.single_block_forwards():
            blk = L.lstm_layer_tm(inp, *weights, reverse, torch.float32)
    torch.cuda.synchronize()
    return torch.equal(got, blk)


def phase_lstm_layer(dev, path, kernel_a_ms, registers):
    """Row 4: lstm_layer_tm through FullSubNet+'s sub-band stack, its plain
    version, the model's hoisted stack, the cluster against the single block
    (`lstm_layer_fwd_block`, the first design) bit for bit, its gradient at
    the training shape, and its times beside the single block's, with its
    plans and registers."""
    from generative_audio_torch.ops import lstm as L
    x, hoisted, weights = _sub_band_stack(dev, path)
    check(tuple(x.shape) == (T_FRAMES, ROWS, SB_FEATURES),
          f"the sub-band input is [{T_FRAMES}, {ROWS}, {SB_FEATURES}] "
          f"(got {tuple(x.shape)})")

    # the path: both layers through the entry point, bf16 as a user runs it
    L.reset_launch_counts()
    with torch.no_grad():
        y1 = L.lstm_layer_tm(x, *weights[0])
        y2 = L.lstm_layer_tm(y1, *weights[1])
    torch.cuda.synchronize()
    launches = dict(L.launch_counts)
    check(launches == {**dict.fromkeys(launches, 0), "lstm_layer_fwd": 2},
          f"the two layers launched lstm_layer_fwd twice and nothing else "
          f"(got {launches})")
    err = (y2.float() - hoisted.float()).abs()
    log(f"lstm_layer_tm x 2 over FullSubNet+'s sub-band input [{T_FRAMES}, "
        f"{ROWS}, {SB_FEATURES}] vs the model's hoisted stack: max|err| "
        f"{err.max().item():.3e} mean {err.mean().item():.3e}")
    check(torch.isfinite(y2.float()).all().item()
          and err.max().item() < LAYER_PATH_MAX_ABS
          and err.mean().item() < LAYER_PATH_MEAN_ABS,
          f"lstm_layer_tm stack vs the hoisted stack within "
          f"{LAYER_PATH_MAX_ABS}/{LAYER_PATH_MEAN_ABS}")
    del err

    max_err = max_err_blk = 0.0
    with torch.no_grad():
        ragged = x[:TRAIN_T, :RAGGED_ROWS]
        for tag, inp, w in (("layer 1", x, weights[0]),
                            ("layer 2", y1, weights[1]),
                            (f"layer 1 T={TRAIN_T} rows={RAGGED_ROWS}",
                             ragged, weights[0])):
            tag = f"{tag} (F={inp.shape[-1]})"
            for reverse in (False, True):
                err, err_blk = _check_layer(L, tag, inp, w, reverse)
                max_err, max_err_blk = (max(max_err, err),
                                        max(max_err_blk, err_blk))

    # the cluster against the single block, the parent design, bit for bit
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    fb = FB_HIDDEN
    x512 = torch.randn(T_CHUNK, 40, HIDDEN, generator=gen, device=dev)
    w512 = (_uniform(gen, dev, (HIDDEN, 4 * fb), fb ** -0.5),
            _uniform(gen, dev, (fb, 4 * fb), fb ** -0.5),
            _uniform(gen, dev, (4 * fb,), fb ** -0.5))
    for tag, inp, w in (("layer 1", x, weights[0]), ("layer 2", y1, weights[1]),
                        (f"layer 1 T={TRAIN_T} rows={RAGGED_ROWS}",
                         x[:TRAIN_T, :RAGGED_ROWS], weights[0]),
                        (f"H={fb} F={HIDDEN} T={T_CHUNK} rows=40", x512,
                         w512)):
        for reverse in (False, True):
            check(_layer_routes_agree(L, inp, w, reverse),
                  f"lstm_layer_fwd == lstm_layer_fwd_block bitwise ({tag}, "
                  f"reverse={reverse})")
        log(f"lstm_layer_fwd == lstm_layer_fwd_block bitwise, fp32 out, "
            f"forward and reverse: {tag}")
    del x512, w512

    # times at both layers, on bf16 inputs as the stack hands them on: the
    # cluster and the single block in turns (cluster, block, block, cluster)
    x_bf = x.to(torch.bfloat16).contiguous()
    card = card_line()
    times, block_times = {}, {}
    with torch.no_grad():
        for name, inp, w in (("layer 1", x_bf, weights[0]),
                             ("layer 2", y1, weights[1])):
            f = inp.shape[-1]

            def block():
                with L.single_block_forwards():
                    return L.lstm_layer_tm(inp, *w)

            rounds = [cuda_ms(lambda: L.lstm_layer_tm(inp, *w), iters=5),
                      cuda_ms(block, iters=3), cuda_ms(block, iters=3),
                      cuda_ms(lambda: L.lstm_layer_tm(inp, *w), iters=5)]
            ms, ms_blk = min(rounds[0], rounds[3]), min(rounds[1:3])
            plain = cuda_ms(lambda: L.lstm_layer_reference_tm(inp, *w), iters=2)
            lib = library_layer_ms(inp, *w)
            b_ms, by = _layer_bound(T_FRAMES, ROWS, f, HIDDEN)
            plan = L.card_layer_plan(dev, L.layer_route(HIDDEN, f)[0], ROWS, f)
            times[name] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                               bound_by=by, library_ms=lib,
                               plan=dataclasses.asdict(plan))
            block_times[name] = dict(ms=ms_blk, plain_ms=plain, bound_ms=b_ms,
                                     bound_by=by, library_ms=lib)
            log(f"lstm_layer_fwd {name} at T={T_FRAMES} rows={ROWS} F={f} "
                f"H={HIDDEN}: {ms:.3f} ms, {1e3 * ms / T_FRAMES / plan.waves:.2f} "
                f"us a step a wave (modelled "
                f"{L.layer_step_us(HIDDEN, plan.cluster, plan.rows, f):.2f}); single "
                f"block (lstm_layer_fwd_block, the first design) "
                f"{ms_blk:.3f} ms (rounds {' '.join(f'{r:.3f}' for r in rounds)}); "
                f"{ms / kernel_a_ms:.2f}x kernel A's {kernel_a_ms:.3f}; bound "
                f"{b_ms:.3f} ms by {by}; plain {plain:.3f} ms; cuDNN "
                f"nn.LSTM({f}, {HIDDEN}) {lib:.3f} ms) on {card}")
            log(f"  plan: {_staged_plan_line(plan)}")
    log(f"kernel F registers: {_registers_line(registers, 'F')}")
    del x, hoisted, y1, y2, x_bf

    # under grad at the training shape: LSTMLayerScan = kernels C and D
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    xg = torch.randn(TRAIN_T, TRAIN_ROWS, SB_FEATURES, generator=gen, device=dev)
    gout = torch.randn(TRAIN_T, TRAIN_ROWS, HIDDEN, generator=gen,
                       device=dev).to(torch.bfloat16)
    kernel_in = [t.clone().requires_grad_() for t in (xg, *weights[0])]
    before = dict(L.launch_counts)
    (L.lstm_layer_tm(*kernel_in, False, torch.float32)
     * gout.float()).sum().backward()
    torch.cuda.synchronize()
    launched = {k: L.launch_counts[k] - before[k] for k in before}
    check(launched == {**dict.fromkeys(launched, 0), "lstm_scan_fwd_train": 1,
                       "lstm_scan_bwd": 1},
          f"LSTMLayerScan launched 1 lstm_scan_fwd_train and 1 lstm_scan_bwd "
          f"and nothing else (got {launched})")
    exact_in = [t.clone().requires_grad_() for t in (xg, *weights[0])]
    (L.lstm_layer_reference_tm(*exact_in, compute_dtype=torch.float32)
     * gout.float()).sum().backward()
    torch.cuda.synchronize()
    got, want = [t.grad for t in kernel_in], [t.grad for t in exact_in]
    check(all(g.dtype == torch.float32 for g in got),
          "LSTMLayerScan gradient dtypes")
    err_x = (got[0] - want[0]).abs()
    peak = want[0].abs().max().item()
    rel = [_rel_norm(g, w) for g, w in zip(got[1:], want[1:])]
    log(f"LSTMLayerScan T={TRAIN_T} rows={TRAIN_ROWS} F={SB_FEATURES} vs "
        f"float32 autograd: dx max|err|/peak {err_x.max().item() / peak:.3e} "
        f"mean/peak {err_x.mean().item() / peak:.3e}; |err|/|grad| dW_ih "
        f"{rel[0]:.3e}, dW_hh {rel[1]:.3e}, db {rel[2]:.3e}")
    check(err_x.max().item() < GRAD_MAX_REL * peak
          and err_x.mean().item() < DX_MEAN_REL * peak
          and max(rel) < GRAD_DW_REL,
          f"LSTMLayerScan gradients vs float32 within {GRAD_MAX_REL}/"
          f"{DX_MEAN_REL}/{GRAD_DW_REL}")
    # two faulty dx the limits must reject: dgates without the forget
    # gate's derivative (diffuse), and one step's dx lost (local)
    w_ih, w_hh, bias = (w.detach() for w in kernel_in[1:])
    bf16, hsz = torch.bfloat16, HIDDEN
    with torch.no_grad():
        # as LSTMLayerScan's forward: bf16 operands, fp32 sums, then bf16
        gates = (xg.to(bf16).float() @ w_ih.to(bf16).float() + bias).to(bf16)
        dgates = L.lstm_scan_bwd_tm(gates, *L.lstm_scan_train_tm(gates, w_hh),
                                    gout, w_hh)
        dgates[..., hsz:2 * hsz] = 0
        dx_f = dgates.float() @ w_ih.to(bf16).float().t()
        fault_f = (dx_f - want[0]).abs().mean().item() / peak
        dx_step = got[0].clone()
        dx_step[TRAIN_T // 2] = 0
        fault_step = (dx_step - want[0]).abs()
    log(f"faulty dx: forget-gate derivative left out, mean/peak "
        f"{fault_f:.3e}; step {TRAIN_T // 2} lost, max/peak "
        f"{fault_step.max().item() / peak:.3e} mean/peak "
        f"{fault_step.mean().item() / peak:.3e}")
    check(fault_f > DX_MEAN_REL and fault_step.max().item() > GRAD_MAX_REL * peak,
          f"the dx limits {GRAD_MAX_REL}/{DX_MEAN_REL} reject both faulty dx")
    del gates, dgates, dx_f, dx_step, fault_step
    log(f"lstm_layer_fwd launches on its path (two layers): "
        f"{launches['lstm_layer_fwd']}")
    return (dict(max_abs_err=max_err, **times["layer 1"],
                 layer_2=times["layer 2"]), launches["lstm_layer_fwd"],
            dict(max_abs_err=max_err_blk, **block_times["layer 1"],
                 layer_2=block_times["layer 2"]))


# Kernel D's cluster instances as ptxas reported them on an H100 before kernel
# G had a cluster: kernel G lives in a source of its own so that they stay.
KERNEL_D_REGISTERS = {"D cluster, slice resident": "120 registers, 0/0 B spilled",
                   "D cluster, slice streamed": "128 registers, 16/32 B spilled"}


def _chains_plan_line(plan):
    """A launch plan of kernel G (a ChainsPlan)."""
    if plan.design == "block":
        return (f"single block of {plan.rows} rows ({plan.chains} chains), "
                f"{plan.clusters} blocks, {plan.active} at once, "
                f"{plan.waves} wave(s), {plan.smem_bytes} B")
    return (f"cluster C={plan.cluster} x R={plan.rows} rows, {plan.chains} "
            f"chains of {'row tiles' if plan.arrangement == 0 else 'units'} "
            f"a warp, W_hh^T slice {'resident' if plan.resident else 'from L2'}"
            f", {plan.clusters} clusters, cudaOccupancyMaxActiveClusters "
            f"{plan.active}, {plan.waves} wave(s), {plan.smem_bytes} B a CTA, "
            f"modelled {plan.step_us:.2f} us a step")


def phase_lstm_chains(dev, library_bwd_ms, registers):
    """Row 9: the chains backward (kernel G) through scripts.perf_lstm_chains
    with 2 and 4 chains, bit for bit against kernel D at the script's shape,
    the training shape and a ragged row count (H=384; kernel G's cluster)
    and at H=100, 200 (its single block) and 512 (its cluster); against its
    plain version; its times beside kernel D's in alternating rounds, with
    µs a step a wave, its plans and registers, and kernel D's cluster
    registers against their recorded counts; its single block (its first
    design, now with dc in registers) timed at the training shape. Returns the two entries' numbers
    and their launches on this path."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.scripts import perf_lstm_chains as PC
    shapes = [(PC.T, PC.B, HIDDEN), (TRAIN_T, TRAIN_ROWS, HIDDEN),
              (TRAIN_T, TRAIN_RAGGED_ROWS, HIDDEN)]
    shapes += [(T_CHUNK, 40, h) for h in (*PADDED_HIDDEN, FB_HIDDEN)]
    expected = dict.fromkeys(("lstm_scan_bwd_chains",
                              "lstm_scan_bwd_chains_block"), 0)
    L.reset_launch_counts()
    for i, (t_len, rows, h) in enumerate(shapes):
        inputs = PC.make_inputs(t_len, rows, h, dev, seed=SEED + 14 + i)
        want = L.lstm_scan_bwd_tm(*inputs)           # kernel D, to compare
        for n in L.CHAIN_COUNTS:
            got = PC.chains_bwd(*inputs, n_chains=n)     # the path
            torch.cuda.synchronize()
            plan = L.card_chains_scan_plan(dev, -(-h // 16) * 16, rows, n)
            expected["lstm_scan_bwd_chains" + (
                "_block" if plan.design == "block" else "")] += 1
            check(torch.equal(got, want), f"kernel G ({n} chains) == "
                  f"lstm_scan_bwd bitwise (T={t_len} rows={rows} H={h})")
            log(f"kernel G, {n} chains, T={t_len} rows={rows} H={h}: == "
                f"lstm_scan_bwd over all {got.numel()} outputs; "
                f"{_chains_plan_line(plan)}")
        del inputs, got, want
    launches = {k: L.launch_counts[k] for k in expected}
    log(f"kernel G's launches on its path: {launches}")
    check(launches == expected, f"kernel G launched once a shape and chain "
          f"count, by its plan's design (expected {expected})")
    for n in L.CHAIN_COUNTS:       # above H=512 no design holds the chains
        try:
            L.plan_chains_scan(640, TRAIN_ROWS, n, lambda *a: 1)
            check(False, f"kernel G ({n} chains) has no route at H=640")
        except ValueError as e:
            log(f"above H=512 kernel G refuses, as ROADMAP.md logs: {e}")

    # at the training shape: the plain version, and D against G in turns
    card = card_line()
    inputs = PC.make_inputs(TRAIN_T, TRAIN_ROWS, HIDDEN, dev, seed=SEED + 15)
    want = PC.chains_bwd_reference(*inputs)
    peak = want.float().abs().max().item()
    max_err = {}
    for n in L.CHAIN_COUNTS:
        err = (PC.chains_bwd(*inputs, n_chains=n).float() - want.float()).abs()
        max_err[n] = err.max().item()
        log(f"kernel G ({n} chains) T={TRAIN_T} rows={TRAIN_ROWS} vs plain: "
            f"max|err| {max_err[n]:.3e} mean {err.mean().item():.3e} (peak "
            f"|dgates| {peak:.3f})")
        check(max_err[n] < BWD_MAX_REL * peak
              and err.mean().item() < BWD_MEAN_REL * peak,
              f"kernel G ({n} chains) vs plain within {BWD_MAX_REL}/"
              f"{BWD_MEAN_REL} of the peak")
        del err
    # kernel G's first design, kept as its single block: same bits, timed
    block = L.plan_chains_scan(HIDDEN, TRAIN_ROWS, 2, lambda *a: 0)
    got = L.lstm_scan_bwd_planned_tm(*inputs, block)
    err_blk = (got.float() - want.float()).abs().max().item()
    check(torch.equal(got, PC.chains_bwd(*inputs)),
          "kernel G's single block == its cluster bitwise (2 chains)")
    del got, want
    ms_blk = cuda_ms(lambda: L.lstm_scan_bwd_planned_tm(*inputs, block),
                     iters=2)
    times = PC.ab(inputs)          # best of 10 in 3 alternating rounds
    best = {k: min(v) for k, v in times.items()}
    plain = cuda_ms(lambda: PC.chains_bwd_reference(*inputs), iters=2)
    b_ms, by = bound(TRAIN_T, TRAIN_ROWS, HIDDEN, streams=11, products=2)
    plans = {n: L.card_chains_scan_plan(dev, HIDDEN, TRAIN_ROWS, n)
             for n in L.CHAIN_COUNTS}
    d_plan = L.card_bwd_scan_plan(dev, HIDDEN, TRAIN_ROWS)
    step = {k: 1e3 * best[k] / TRAIN_T / p.waves for k, p in (
        ("lstm_scan_bwd", d_plan), *((f"chains{n}", plans[n])
                                     for n in L.CHAIN_COUNTS))}
    log(f"kernel G at T={TRAIN_T} rows={TRAIN_ROWS} H={HIDDEN}: 2 chains "
        f"{best['chains2']:.3f} ms ({step['chains2']:.2f} us a step a wave), "
        f"4 chains {best['chains4']:.3f} ms ({step['chains4']:.2f}); kernel D "
        f"{best['lstm_scan_bwd']:.3f} ms ({step['lstm_scan_bwd']:.2f}) in the "
        f"same rounds ({'; '.join(k + ' ' + ' '.join(f'{t:.3f}' for t in r) for k, r in times.items())}); "
        f"bound {b_ms:.3f} ms by {by}; plain {plain:.3f} ms; cuDNN backward "
        f"{library_bwd_ms:.3f} ms; the single block (the first design, 2 chains) "
        f"{ms_blk:.3f} ms on {card}")
    for n, plan in plans.items():
        log(f"  {n} chains: {_chains_plan_line(plan)}")
    log(f"  kernel G registers: {_registers_line(registers, 'G')}")
    d_regs = {k: v for k, v in registers.items() if k.startswith("D cluster")}
    log(f"  kernel D's cluster registers {d_regs or 'not rebuilt in this run'}"
        f" (recorded: {KERNEL_D_REGISTERS}; unchanged: "
        f"{d_regs == KERNEL_D_REGISTERS if d_regs else 'not known'})")
    del inputs
    inputs = PC.make_inputs(PC.T, PC.B, HIDDEN, dev, seed=SEED + 14)
    script = {k: min(v) for k, v in PC.ab(inputs).items()}
    log(f"at the script's shape T={PC.T} rows={PC.B}: best D "
        f"{script['lstm_scan_bwd']:.3f} ms, G 2 chains {script['chains2']:.3f}"
        f" ms, 4 chains {script['chains4']:.3f} ms (bound "
        f"{bound(PC.T, PC.B, HIDDEN, streams=11, products=2)[0]:.3f} ms) on "
        f"{card}")
    del inputs
    kernels = {
        "lstm_scan_bwd_chains": dict(
            max_abs_err=max(max_err.values()), ms=best["chains2"],
            plain_ms=plain, bound_ms=b_ms, bound_by=by,
            library_ms=library_bwd_ms, chains4_ms=best["chains4"],
            kernel_d_ms=best["lstm_scan_bwd"], us_step_wave=step,
            script_shape_ms=script,
            plan={n: dataclasses.asdict(p) for n, p in plans.items()}),
        "lstm_scan_bwd_chains_block": dict(
            max_abs_err=err_blk, ms=ms_blk, plain_ms=plain, bound_ms=b_ms,
            bound_by=by, library_ms=library_bwd_ms)}
    return kernels, launches


def _staged_plan_line(plan):
    """A launch plan of kernel E or F (a ScanPlan)."""
    return (f"cluster C={plan.cluster} x R={plan.rows} rows, "
            f"{plan.clusters} clusters, cudaOccupancyMaxActiveClusters "
            f"{plan.active}, {plan.waves} wave(s), {plan.smem_bytes} B of "
            f"shared memory a CTA")


def phase_lstm_unroll(dev, registers):
    """Row 10: the K-step unrolled forward through scripts.perf_lstm_unroll,
    bit for bit against kernel A (at the script's and the serving row
    counts, and at H=100 and 200, which the wrapper pads) and, at H=640 and
    768, which no cluster holds, its single block against
    lstm_scan_fwd_block; against its plain version, and its times beside
    kernel A's (the single block's at H=768 beside lstm_scan_fwd_block),
    with its plans and registers. Returns both entries' numbers and their
    launches on this path."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.scripts import perf_lstm_unroll as PU
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    w_hh = _uniform(gen, dev, (HIDDEN, 4 * HIDDEN), HIDDEN ** -0.5)
    shapes = [(HIDDEN, T_FRAMES, rows) for rows in (TRAIN_ROWS, ROWS)]
    shapes += [(h, T_CHUNK, ROWS) for h in PADDED_HIDDEN]
    # H no cluster holds: kernel E's single block against lstm_scan_fwd_block
    shapes += [(h, T_CHUNK, 40) for h in BLOCK_HIDDEN]
    expected = dict.fromkeys(("lstm_scan_fwd_unrolled",
                              "lstm_scan_fwd_unrolled_block"), 0)
    L.reset_launch_counts()
    with torch.no_grad():
        for h, t_len, rows in shapes:
            w = w_hh if h == HIDDEN else _uniform(gen, dev, (h, 4 * h),
                                                  h ** -0.5)
            gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                                device=dev).to(torch.bfloat16)
            for k in L.UNROLL_STEPS:
                got = PU.lstm_unrolled(gates, w, block_t=k)      # the path
                want = L.lstm_scan_tm(gates, w)                  # kernel A
                torch.cuda.synchronize()
                hp, route = L.unrolled_route(h, k)
                expected["lstm_scan_fwd_unrolled" + route] += 1
                a_entry = "lstm_scan_fwd" + L._forward_route(h)[1]
                check(torch.equal(got, want), f"lstm_scan_fwd_unrolled{route} "
                      f"K={k} == {a_entry} bitwise (H={h} rows={rows})")
                where = (f"single block of {L.unrolled_block_rows(hp, k)} "
                         f"rows, {L.unrolled_block_smem_bytes(hp, L.unrolled_block_rows(hp, k), k)} B"
                         if route else _staged_plan_line(
                             L.card_unrolled_plan(dev, hp, rows, k)))
                log(f"lstm_scan_fwd_unrolled{route} K={k} H={h} T={t_len} "
                    f"rows={rows}: == {a_entry} over all {got.numel()} "
                    f"outputs; {hp} units, {where}")
            del gates, got, want
        launches = {k: L.launch_counts[k] for k in expected}
        log(f"kernel E's launches on its path: {launches}")
        check(launches == expected,
              f"kernel E launched once a shape and K, by its route "
              f"(expected {expected})")
        log(f"kernel E registers: {_registers_line(registers, 'E')}; "
            f"kernels A-C: {_registers_line(registers, 'ABC')}")

        # the single block at H=768, the full-band training shape's rows and
        # its T cut to whole groups of 4 steps, beside lstm_scan_fwd_block
        h, t_len, rows = BLOCK_HIDDEN[-1], TRAIN_T - TRAIN_T % 4, TRAIN_BATCH
        w = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
        gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        got = PU.lstm_unrolled(gates, w)
        want = PU.lstm_unrolled_reference(gates, w)
        err_blk = (got.float() - want.float()).abs()
        check(err_blk.max().item() < KERNEL_MAX_ABS
              and err_blk.mean().item() < KERNEL_MEAN_ABS,
              f"lstm_scan_fwd_unrolled_block vs plain at H={h}")
        err_blk = err_blk.max().item()
        ms_blk = {k: cuda_ms(lambda k=k: PU.lstm_unrolled(gates, w, block_t=k),
                             iters=5) for k in L.UNROLL_STEPS}
        ms_a_blk = cuda_ms(lambda: L.lstm_scan_tm(gates, w), iters=5)
        plain_blk = cuda_ms(lambda: PU.lstm_unrolled_reference(gates, w),
                            iters=2)
        lib_blk = library_lstm_ms(gates, w)
        b_blk, by_blk = bound(t_len, rows, h)
        log(f"lstm_scan_fwd_unrolled_block at T={t_len} rows={rows} H={h}: "
            f"K=2 {ms_blk[2]:.3f} ms ({L.unrolled_block_rows(h, 2)} rows a "
            f"block), K=4 {ms_blk[4]:.3f} ms ({L.unrolled_block_rows(h, 4)} "
            f"rows); lstm_scan_fwd_block {ms_a_blk:.3f} ms; max|err| "
            f"{err_blk:.3e}; bound {b_blk:.4f} ms by {by_blk}; plain "
            f"{plain_blk:.3f} ms; cuDNN LSTM {lib_blk:.3f} ms on {card_line()}")
        del gates, got, want

        # at T=628 x 2304 rows, the script's shape
        rows = TRAIN_ROWS
        gates = torch.randn(T_FRAMES, rows, 4 * HIDDEN, generator=gen,
                            device=dev).to(torch.bfloat16)
        got = PU.lstm_unrolled(gates, w_hh)
        want = PU.lstm_unrolled_reference(gates, w_hh)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        max_err = err.max().item()
        log(f"lstm_scan_fwd_unrolled K=2 T={T_FRAMES} rows={rows} vs plain, "
            f"bf16 out: max|err| {max_err:.3e} mean {err.mean().item():.3e}")
        # bf16 outputs: a difference that crosses a rounding boundary shows
        # as one bf16 step of |h| < 1, 3.9e-3 at most (measured 3.9e-3 max,
        # 2.1e-6 mean)
        check(max_err < KERNEL_MAX_ABS and err.mean().item() < KERNEL_MEAN_ABS,
              f"lstm_scan_fwd_unrolled vs plain within {KERNEL_MAX_ABS}/"
              f"{KERNEL_MEAN_ABS}")
        del got, want, err
        # the script's A/B: best of 8 in 3 rounds of alternating order
        times = PU.ab(gates, w_hh)
        ms = {k: min(rounds) for k, rounds in times.items()}
        plain = cuda_ms(lambda: PU.lstm_unrolled_reference(gates, w_hh), iters=2)
        lib = library_lstm_ms(gates, w_hh)
    b_ms, by = bound(T_FRAMES, rows, HIDDEN)
    plans = {k: L.card_unrolled_plan(dev, L.unrolled_hidden(HIDDEN, k), rows,
                                     k) for k in L.UNROLL_STEPS}
    log(f"lstm_scan_fwd_unrolled at T={T_FRAMES} rows={rows} H={HIDDEN}: K=2 "
        f"{ms[2]:.3f} ms, K=4 {ms[4]:.3f} ms; lstm_scan_fwd (K=1) {ms[1]:.3f} "
        f"ms (rounds {'; '.join(f'K={k} ' + ' '.join(f'{t:.3f}' for t in r) for k, r in times.items())}); "
        f"bound {b_ms:.3f} ms by {by}; plain {plain:.3f} ms; cuDNN LSTM "
        f"{lib:.3f} ms on {card_line()}")
    for k, plan in plans.items():
        log(f"  K={k}: {_staged_plan_line(plan)}, modelled "
            f"{L.unrolled_step_us(L.unrolled_hidden(HIDDEN, k), plan.cluster, plan.rows):.2f} us a "
            f"step; measured {1e3 * ms[k] / T_FRAMES / plan.waves:.2f} us a "
            f"step a wave")
    return ({"lstm_scan_fwd_unrolled": dict(
                max_abs_err=max_err, ms=ms[2], plain_ms=plain, bound_ms=b_ms,
                bound_by=by, library_ms=lib, kernel_a_ms=ms[1], k4_ms=ms[4],
                plan=dataclasses.asdict(plans[2])),
             "lstm_scan_fwd_unrolled_block": dict(
                max_abs_err=err_blk, ms=ms_blk[2], plain_ms=plain_blk,
                bound_ms=b_blk, bound_by=by_blk, library_ms=lib_blk,
                k4_ms=ms_blk[4], lstm_scan_fwd_block_ms=ms_a_blk)},
            launches)


@dataclasses.dataclass
class ModelPath:
    """One model of the port driven end to end: how to build it, which
    Inferencer mode and trainer model_type it takes, and which kernels a
    forward and a training step must launch."""
    name: str
    model_cls: type
    config: object
    sd: dict                    # state dict carried across from the JAX layout
    mode: str                   # Inferencer mode
    n_inputs: int               # leading outputs of the front end the model takes
    fwd: str                    # kernel entry of an unchunked forward
    carry: str                  # kernel entry of a chunked forward
    per_forward: int            # fwd launches, unchunked
    per_long_forward: int       # fwd launches on the chunked 30 s clip
    train_config: Callable      # compute_dtype -> EnhanceTrainConfig
    per_step: dict              # launches per training step

    def model(self, dtype, device, gates_bytes_limit=None):
        m = self.model_cls(self.config, compute_dtype=dtype, device=device,
                           gates_bytes_limit=gates_bytes_limit)
        m.load_state_dict(self.sd)
        return m

    def inferencer(self, model, device):
        from generative_audio_torch.eval import Inferencer, InferencerConfig
        return Inferencer(model, InferencerConfig(inference_type=self.mode),
                          device=device)


def model_paths():
    """FullSubNet+ and FullSubNet v1 (GRU, and LSTM for one reference clip)
    at full width, with random weights made with numpy from SEED in the JAX
    param layout and carried across by utils/convert.py. The v1 models serve
    with drop_band off (a batch's mask must cover the spectrum) and train
    with the default two groups."""
    from generative_audio_torch import models as M
    from generative_audio_torch.train import EnhanceTrainConfig
    from generative_audio_torch.utils import convert
    plus_cfg = M.FullSubNetPlusConfig()
    plus = ModelPath(
        name="FullSubNet+", model_cls=M.FullSubNetPlus, config=plus_cfg,
        sd=convert.convert_fullsubnet_plus(
            convert.random_fullsubnet_plus_params(plus_cfg, seed=SEED)),
        mode="mag_complex_full_band_crm_mask", n_inputs=3,
        fwd="lstm_scan_fwd", carry="lstm_scan_fwd_carry",
        per_forward=2, per_long_forward=0,
        train_config=lambda dtype: EnhanceTrainConfig(
            model=M.FullSubNetPlusConfig(num_groups_in_drop_band=2),
            compute_dtype=dtype),
        per_step={"lstm_scan_fwd_train": 2, "lstm_scan_bwd": 2})
    v1 = {}
    for kind in ("GRU", "LSTM"):
        cfg = M.FullSubNetConfig(sequence_model=kind, num_groups_in_drop_band=1)
        family = kind.lower()
        v1[kind] = ModelPath(
            name=f"FullSubNet v1-{kind}", model_cls=M.FullSubNet, config=cfg,
            sd=convert.convert_fullsubnet(
                convert.random_fullsubnet_params(cfg, seed=SEED + 11), kind),
            mode="full_band_crm_mask", n_inputs=1,
            fwd=f"{family}_scan_fwd", carry=f"{family}_scan_fwd_carry",
            # at 30 s the full-band model stays unchunked
            per_forward=4, per_long_forward=2,
            train_config=lambda dtype, kind=kind: EnhanceTrainConfig(
                model_type="fullsubnet",
                model_v1=M.FullSubNetConfig(sequence_model=kind),
                compute_dtype=dtype),
            per_step={"gru_scan_fwd": 4, "gru_scan_bwd": 4,
                      "gru_scan_bwd_dwhh": 4} if kind == "GRU" else
            {"lstm_scan_fwd_train": 4, "lstm_scan_bwd": 4})
    return plus, v1["GRU"], v1["LSTM"]


def phase_reference(dev, path, model):
    """A 1 s clip: the bf16 model on the card against the float32 model on
    the CPU (the algorithm as the CPU tests hold it against JAX)."""
    from generative_audio_torch.ops import prepare_input_from_waveform
    ref = path.model(torch.float32, "cpu")
    wav = np.random.default_rng(SEED + 1).standard_normal(16000).astype(
        np.float32) * 0.1
    inputs = prepare_input_from_waveform(torch.from_numpy(wav)[None], 512, 256,
                                         512)[:path.n_inputs]
    with torch.inference_mode():
        want = ref(*inputs)
        got = model(*(x.to(dev) for x in inputs)).float().cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"reference {path.name}: 1 s clip, bf16 cRM on the card vs float32 on "
        f"the CPU: max|err|/peak {rel:.3e} (peak {want.abs().max().item():.3f})")
    check(torch.isfinite(got).all().item() and rel < PATH_REL,
          f"{path.name}: bf16 model vs float32 reference within {PATH_REL}")
    out_gpu = path.inferencer(model, dev).enhance(wav)
    out_cpu = path.inferencer(ref, "cpu").enhance(wav)
    rel_wav = np.abs(out_gpu - out_cpu).max() / np.abs(out_cpu).max()
    log(f"reference {path.name}: 1 s clip wav to wav, card vs CPU: "
        f"max|err|/peak {rel_wav:.3e}")
    check(rel_wav < PATH_REL,
          f"{path.name}: wav vs float32 reference within {PATH_REL}")


def phase_serving(dev, path, model, counts):
    inf = path.inferencer(model, dev)
    rng = np.random.default_rng(SEED + 2)
    card = card_line()
    for seconds in (3.0, 7.5, 10.0):
        noisy = (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)
        before = counts[path.fwd]
        t0 = time.perf_counter()
        out = inf.enhance(noisy)
        wall = (time.perf_counter() - t0) * 1e3
        check(out.shape == noisy.shape and np.isfinite(out).all(),
              f"{path.name} {seconds} s request: shape and finite")
        check(counts[path.fwd] - before == path.per_forward,
              f"{path.fwd} launched {path.per_forward} times per forward")
        log(f"serve {path.name} {seconds} s clip: rtf {inf.last_rtf:.5f}, "
            f"{wall:.2f} ms per call on {card}")

    clips = [((rng.standard_normal(160000) * 0.1).astype(np.float32), f"clip{i}")
             for i in range(8)]
    before = counts[path.fwd]
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        inf.enhance_dir(clips, out_dir, log=lambda *_: None, batch_size=8)
        wall = (time.perf_counter() - t0) * 1e3
        from generative_audio_torch.data import read_wav
        for noisy, name in clips:
            sr, got = read_wav(Path(out_dir) / f"{name}.wav")
            check(sr == 16000 and got.shape == noisy.shape
                  and np.isfinite(got).all(), f"enhance_dir output {name}")
    # the bucket is warmed once at its batch outside the timed window
    check(counts[path.fwd] - before == 2 * path.per_forward,
          f"{path.fwd} launched {path.per_forward} times for each of the "
          f"batched forwards (warm-up and request)")
    log(f"serve {path.name} enhance_dir 8 x 10 s, batch 8: rtf "
        f"{inf.last_rtf:.5f}, {wall:.2f} ms on {card}")
    return inf.last_rtf


def phase_long_clip(dev, path, model, counts):
    limit = LONG_CLIP_GATES_LIMIT
    chunked_model = path.model(torch.bfloat16, dev, gates_bytes_limit=limit)
    noisy = (np.random.default_rng(SEED + 3).standard_normal(30 * 16000)
             * 0.1).astype(np.float32)
    whole = path.inferencer(model, dev).enhance(noisy)
    before = dict(counts)
    inf = path.inferencer(chunked_model, dev)
    out = inf.enhance(noisy)
    launched_c = counts[path.carry] - before[path.carry]
    check(launched_c > 0
          and counts[path.fwd] - before[path.fwd] == path.per_long_forward,
          f"{path.name}: the 30 s request took the chunked path "
          f"({path.carry}, and {path.per_long_forward} {path.fwd})")
    rel = np.abs(out - whole).max() / np.abs(whole).max()
    log(f"long clip {path.name} 30 s, gates limit {limit >> 20} MiB: "
        f"{path.carry} launched {launched_c} times, rtf {inf.last_rtf:.5f}; "
        f"chunked vs unchunked max|err|/peak {rel:.3e}")
    check(out.shape == noisy.shape and np.isfinite(out).all() and rel < PATH_REL,
          f"{path.name}: chunked vs unchunked within {PATH_REL}")


def _noise_batch(seed, batch, samples):
    """(noisy, clean) float32 [batch, samples]: seeded noise as the clean
    signal, plus seeded noise."""
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((batch, samples)) * 0.1).astype(np.float32)
    noisy = clean + (rng.standard_normal((batch, samples)) * 0.03
                     ).astype(np.float32)
    return noisy, clean


def phase_training(dev, path, counts):
    """Five steps of EnhanceTrainer at full width on one fixed batch. The
    caller has set the launch counts to 0."""
    from generative_audio_torch.train import EnhanceTrainer
    cfg = path.train_config("bfloat16")
    trainer = EnhanceTrainer(cfg, seed=SEED, pretrained_state_dict=path.sd,
                             device=dev)
    noisy, clean = (torch.from_numpy(x).to(dev) for x in
                    _noise_batch(SEED + 6, TRAIN_BATCH, TRAIN_SAMPLES))
    # step one's gradients, as they arrive: finite and not all zero
    flags, names = [], []

    def grad_arrived(name):
        def hook(param):
            names.append(name)
            flags.append(torch.isfinite(param.grad).all()
                         & (param.grad != 0).any())
        return hook

    hooks = [p.register_post_accumulate_grad_hook(grad_arrived(k))
             for k, p in trainer.state.model.named_parameters()]
    torch.cuda.reset_peak_memory_stats(dev)
    expected = {**dict.fromkeys(counts, 0), **path.per_step}
    losses, times = [], []
    for step in range(TRAIN_STEPS):
        before = dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_epoch([(noisy, clean)]))   # ends in a fetch
        times.append((time.perf_counter() - t0) * 1e3)
        launched = {k: counts[k] - before[k] for k in counts}
        check(launched == expected,
              f"{path.name} train step {step + 1} launched {path.per_step} "
              f"and nothing else (got {launched})")
        if step == 0:
            for hook in hooks:
                hook.remove()
            ok = torch.stack(flags).cpu().tolist()
            n_params = sum(1 for _ in trainer.state.model.parameters())
            bad = [k for k, good in zip(names, ok) if not good]
            check(len(ok) == n_params and not bad,
                  f"every parameter tensor got a finite non-zero gradient in "
                  f"step 1 ({len(ok)} of {n_params} arrived; failing: {bad[:5]})")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"train {path.name}: batch {TRAIN_BATCH} x {TRAIN_SAMPLES / 16000:.3f} "
        f"s, bf16, losses {' '.join(f'{x:.5f}' for x in losses)}")
    check(np.isfinite(losses).all(), "training losses finite")
    check(losses[-1] < losses[0], "the fifth loss is below the first")
    check(trainer.state.step == TRAIN_STEPS, "five optimizer steps counted")
    steady = statistics.median(times[1:])
    log(f"train {path.name}: ms per step {' '.join(f'{x:.1f}' for x in times)}; "
        f"median of steps 2-{TRAIN_STEPS} {steady:.2f} ms = "
        f"{TRAIN_BATCH / steady * 1e3:.2f} clips/s; peak memory {peak:.2f} GiB "
        f"on {card_line()}")
    return trainer


def phase_training_reference(dev, path):
    """A batch of 4 x 1 s: the bf16 loss and gradients on the card against
    the float32 model on the CPU."""
    import torch.nn.functional as F
    from generative_audio_torch.train import (
        enhance_loss_fn, init_enhance_state)
    noisy, clean = (torch.from_numpy(x) for x in
                    _noise_batch(SEED + 7, 4, 16000))
    grads, losses = {}, {}
    for name, device, dtype in (("card", dev, "bfloat16"),
                                ("cpu", "cpu", "float32")):
        cfg = path.train_config(dtype)
        state = init_enhance_state(cfg, SEED, device)
        state.model.load_state_dict(path.sd)
        loss = enhance_loss_fn(state.model, noisy.to(device), clean.to(device),
                               cfg)
        loss.backward()
        losses[name] = loss.item()
        grads[name] = {k: p.grad.float().cpu()
                       for k, p in state.model.named_parameters()}
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    top = max(g.norm().item() for g in grads["cpu"].values())
    rows = []
    for k, want in grads["cpu"].items():
        got = grads["card"][k]
        cos = F.cosine_similarity(got.flatten(), want.flatten(), dim=0).item()
        rows.append((cos, got.norm().item() / max(want.norm().item(), 1e-30),
                     want.norm().item() / top, k))
    carrying = [r for r in rows if r[2] > 1e-3]
    worst = min(carrying)
    log(f"train reference {path.name}: 4 x 1 s, bf16 on the card vs float32 on "
        f"the CPU: loss {losses['card']:.6f} vs {losses['cpu']:.6f} (rel "
        f"{rel:.3e}); of {len(rows)} parameter tensors {len(carrying)} carry "
        f"the gradient (norm above 1e-3 of the largest): lowest cosine "
        f"{worst[0]:.4f} ({worst[3]}), norm ratios "
        f"{min(r[1] for r in carrying):.3f}-{max(r[1] for r in carrying):.3f}")
    for cos, ratio, share, k in rows:
        if ".sequence_model.weight_ih" in k or ".sequence_model.bias" in k \
                or ".sequence_model.weight_hh" in k:
            log(f"  {k}: cosine {cos:.5f}, norm ratio {ratio:.4f}, "
                f"norm/largest {share:.2e}")
    check(rel < TRAIN_LOSS_REL, f"bf16 loss vs float32 within {TRAIN_LOSS_REL}")
    check(worst[0] > TRAIN_GRAD_COS
          and all(abs(r[1] - 1) < TRAIN_GRAD_RATIO for r in carrying),
          f"bf16 gradients vs float32: cosine above {TRAIN_GRAD_COS}, norms "
          f"within {TRAIN_GRAD_RATIO}")


def _profile(fn, what):
    """torch.profiler's device time by kernel for one call of fn, against
    its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    check(busy > 0, f"torch.profiler recorded device time for {what}")
    log(f"profile: {what}, wall {wall:.2f} ms (profiled), "
        f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%), on {card_line()}")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {key[:90]}")


def phase_profile(dev, path, model, trainer):
    """Where the time goes on the card, by kernel: one batch-8 x 10 s model
    forward and one training step. Run after the launch counts are read."""
    from generative_audio_torch.ops import prepare_input_from_waveform
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    wav = torch.randn(8, 160000, generator=gen, device=dev) * 0.1
    inputs = prepare_input_from_waveform(wav, 512, 256, 512)[:path.n_inputs]
    with torch.inference_mode():
        _profile(lambda: model(*inputs), f"{path.name} batch 8 x 10 s forward")
    del inputs, wav
    noisy, clean = (torch.from_numpy(x).to(dev) for x in
                    _noise_batch(SEED + 6, TRAIN_BATCH, TRAIN_SAMPLES))
    _profile(lambda: trainer.train_epoch([(noisy, clean)]),
             f"{path.name} training step, batch {TRAIN_BATCH} x "
             f"{TRAIN_SAMPLES / 16000:.3f} s")


def drive(dev, path, kernels_of_path):
    """One model's main path: the serving entry point (single requests, a
    batch, a long clip), then the training entry point, each with the launch
    counts set to 0 just before and read just after. Returns the launches of
    the path's kernels, serving plus training, and the batched RTF."""
    from generative_audio_torch.ops import lstm as L
    model = path.model(torch.bfloat16, dev)
    phase_reference(dev, path, model)

    L.reset_launch_counts()
    batched_rtf = phase_serving(dev, path, model, L.launch_counts)
    phase_long_clip(dev, path, model, L.launch_counts)
    serving = dict(L.launch_counts)
    log(f"launches on the serving path of {path.name}: {serving}")

    L.reset_launch_counts()
    trainer = phase_training(dev, path, L.launch_counts)
    training = dict(L.launch_counts)
    log(f"launches on the training path of {path.name}: {training}")
    for name, per_step in path.per_step.items():
        check(training[name] == per_step * TRAIN_STEPS,
              f"{name} launched {per_step} times per step on the training path")
    launched = {k: serving[k] + training[k] for k in serving}
    for name in launched:
        if name in kernels_of_path:
            check(launched[name] > 0, f"{name} launched on {path.name}'s path")
        else:
            check(launched[name] == 0,
                  f"{name} is not on {path.name}'s path (got {launched[name]})")
    phase_training_reference(dev, path)
    phase_profile(dev, path, model, trainer)
    return {k: launched[k] for k in kernels_of_path}, batched_rtf


# Phase 13: the rest of serving at FullSubNet+'s full width.
CHUNK_SECONDS = 4            # overlapped_chunk: 64 256 samples in, 252 frames
STREAM_SECONDS = 10          # the clip the chunked and streamed paths serve
STREAM_KS = (1, 8, 16)       # streams of the latency and throughput readings
FEED_SAMPLES = 1600          # 100 ms feeds of those readings
MODE_SECONDS = 3             # the four modes' and the sub-band mode's clip
OOM_BATCH, OOM_SECONDS = 8, 30


def _count(counts, fn, expected, what):
    """fn(), checked to launch exactly `expected` ({entry: launches})."""
    before = dict(counts)
    out = fn()
    launched = {k: counts[k] - before[k] for k in counts
                if counts[k] != before[k]}
    check(launched == expected,
          f"{what} launched {expected} and nothing else (got {launched})")
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _noise(seed, *shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1
            ).astype(np.float32)


def _streamed(stream, noisy, seed, low=1, high=24000):
    """Feed `noisy` ([L] or [K, L]) in pieces of seeded random sizes and
    flush: the concatenated output."""
    rng = np.random.default_rng(seed)
    pieces, pos = [], 0
    while pos < noisy.shape[-1]:
        n = int(rng.integers(low, high))
        pieces.append(stream.feed(noisy[..., pos:pos + n]))
        pos += n
    pieces.append(stream.flush())
    return np.concatenate(pieces, axis=-1)


class _Reshaped(torch.nn.Module):
    """A full-band SequenceModel (LSTM, FB_HIDDEN) behind the reshapes of
    one inference mode's convention."""

    def __init__(self, mode, dtype, device):
        from generative_audio_torch.nn.recurrent import SequenceModel
        super().__init__()
        f = 257
        n_in, n_out, act = {"mag": (f, f, "ReLU"),
                            "scaled_mask": (f, 2 * f, "Tanh"),
                            "complex_full_band_crm_mask": (2 * f, 2 * f, "Tanh"),
                            "time_domain": (250, 250, "Tanh")}[mode]
        self.mode = mode
        self.seq = SequenceModel(n_in, n_out, FB_HIDDEN, sequence_model="LSTM",
                                 output_activate_function=act,
                                 compute_dtype=dtype, device=device)

    def forward(self, x):
        b = x.shape[0]
        if self.mode == "time_domain":    # frames of 250 (a bucket divides)
            y = self.seq(x.reshape(b, -1, 250).transpose(1, 2))
            return y.transpose(1, 2).reshape(b, -1)
        y = self.seq(x.reshape(b, -1, x.shape[-1]))
        return y.reshape(b, 1 if self.mode == "mag" else 2, 257, -1)


def _card_and_cpu(make, seed):
    """The same weights (torch's initialisers drawn from `seed`) in a bf16
    model, for the card, and a float32 one, for the CPU."""
    torch.manual_seed(seed)
    ref = make(torch.float32, "cpu")
    model = make(torch.bfloat16, "cpu")
    model.load_state_dict(ref.state_dict())
    return model, ref


def _serve_modes(dev, counts, card):
    """The sub-band mode (FullSubNet's sub-band width: SequenceModel(31, 2,
    HIDDEN), 257 rows) and the four modes around a full-band LSTM, one 3 s
    clip each, card against CPU."""
    from generative_audio_torch.eval import Inferencer, InferencerConfig
    from generative_audio_torch.nn.recurrent import SequenceModel
    noisy = _noise(SEED + 20, MODE_SECONDS * 16000)
    models = {"sub_band_crm_mask": lambda dtype, device: SequenceModel(
        31, 2, HIDDEN, num_layers=2, sequence_model="LSTM",
        output_activate_function=None, compute_dtype=dtype, device=device)}
    for mode in ("mag", "scaled_mask", "complex_full_band_crm_mask",
                 "time_domain"):
        models[mode] = lambda dtype, device, mode=mode: _Reshaped(
            mode, dtype, device)
    for i, (mode, make) in enumerate(models.items()):
        model, ref = _card_and_cpu(make, SEED + 21 + i)
        cfg = InferencerConfig(inference_type=mode)
        inf = Inferencer(model, cfg, device=dev)
        got = _count(counts, lambda: inf.enhance(noisy), {"lstm_scan_fwd": 2},
                     f"mode {mode}")
        want = Inferencer(ref, cfg, device="cpu").enhance(noisy)
        rel = _rel(got, want)
        log(f"mode {mode}: {MODE_SECONDS} s clip, rtf {inf.last_rtf:.5f}; card "
            f"(bf16) vs CPU (float32) max|err|/peak {rel:.3e} on {card}")
        check(got.shape == noisy.shape and np.isfinite(got).all()
              and rel < PATH_REL, f"mode {mode}: card vs CPU within {PATH_REL}")


def _chunks_and_streams(dev, model, ref, counts, card):
    """overlapped_chunk (4 s chunks) against the float32 model on the CPU;
    StreamingEnhancer at K = 1 and 8, async_depth 0 and 2, against it bit
    for bit; each of the 8 rows against its single stream."""
    from generative_audio_torch.eval import (
        Inferencer, InferencerConfig, StreamingEnhancer)
    cfg = InferencerConfig(inference_type="overlapped_chunk",
                           chunk_model="spectral",
                           chunk_length_seconds=CHUNK_SECONDS)
    inf = Inferencer(model, cfg, device=dev)
    chunk = cfg.sr * CHUNK_SECONDS
    n_chunks = int(STREAM_SECONDS * cfg.sr / (chunk // 2)) + 1
    per_run = {"lstm_scan_fwd": 2 * n_chunks}
    noisy = _noise(SEED + 30, 8, STREAM_SECONDS * cfg.sr)
    got = _count(counts, lambda: inf.enhance(noisy[0]), per_run,
                 "overlapped_chunk")
    want = Inferencer(ref, cfg, device="cpu").enhance(noisy[0])
    rel = _rel(got, want)
    log(f"overlapped_chunk: {STREAM_SECONDS} s clip, {n_chunks} chunks of "
        f"{chunk + 256} samples ({(chunk + 256) // 256 + 1} frames), rtf "
        f"{inf.last_rtf:.5f}; card (bf16) vs CPU (float32) max|err|/peak "
        f"{rel:.3e} on {card}")
    check(got.shape == (STREAM_SECONDS * cfg.sr,) and np.isfinite(got).all()
          and rel < PATH_REL, f"overlapped_chunk vs the CPU within {PATH_REL}")
    offline = {1: got}
    offline[8] = _count(counts, lambda: inf.overlapped_chunk(noisy), per_run,
                        "overlapped_chunk, 8 rows")
    for k in (1, 8):
        rows = noisy[0] if k == 1 else noisy
        for depth in (0, 2):
            stream = StreamingEnhancer(inf, n_streams=k, async_depth=depth)
            out = _count(counts,
                         lambda: _streamed(stream, rows, SEED + k + depth),
                         per_run, f"stream K={k} depth {depth}")
            check(np.array_equal(out, offline[k]),
                  f"K={k} streams, async_depth {depth} == overlapped_chunk of "
                  f"{k} rows bit for bit")
    worst = 0.0
    for row in range(8):
        single = _streamed(StreamingEnhancer(inf), noisy[row], SEED + 40 + row)
        worst = max(worst, _rel(offline[8][row], single))
    log(f"stream: K=1 and 8 at async_depth 0 and 2 == overlapped_chunk of as "
        f"many rows bit for bit; the 8 rows vs their single streams max|err|/"
        f"peak {worst:.3e}")
    check(worst < PATH_REL, f"K=8 rows vs single streams within {PATH_REL}")


def _stream_readings(dev, model, card):
    """Per-chunk time on the card, feed-to-finalized latency and aggregate
    x realtime at K = 1, 8, 16 streams, 100 ms feeds, 4 s and 1 s chunks."""
    from generative_audio_torch.eval import (
        Inferencer, InferencerConfig, StreamingEnhancer)
    for seconds in (CHUNK_SECONDS, 1):
        cfg = InferencerConfig(chunk_model="spectral",
                               chunk_length_seconds=seconds)
        inf = Inferencer(model, cfg, device=dev)
        n_in = cfg.sr * seconds + 256
        program = inf._chunk_program()
        for k in STREAM_KS:
            x = torch.randn(k, n_in, device=dev) * 0.1
            with torch.inference_mode():
                chunk_ms = cuda_ms(lambda: program(x), 10, warmup=3)
            wavs = _noise(SEED + 50 + k, k, STREAM_SECONDS * cfg.sr)
            for depth in (0, 2):
                stream = StreamingEnhancer(inf, n_streams=k, async_depth=depth)
                stream.feed(wavs[:, :n_in])     # warm the shapes
                stream.flush()
                finalize_ms = []
                t0 = time.perf_counter()
                for pos in range(0, wavs.shape[-1], FEED_SAMPLES):
                    f0 = time.perf_counter()
                    out = stream.feed(wavs[:, pos:pos + FEED_SAMPLES])
                    if out.shape[-1]:
                        finalize_ms.append((time.perf_counter() - f0) * 1e3)
                stream.flush()
                wall = time.perf_counter() - t0
                log(f"stream {seconds} s chunks ({n_in // 256 + 1} frames), "
                    f"K={k}, async_depth {depth}: chunk {chunk_ms:.3f} ms on "
                    f"the card (CUDA events); feed-to-finalized p50 "
                    f"{statistics.median(finalize_ms):.2f} ms over "
                    f"{len(finalize_ms)} feeds; aggregate "
                    f"{k * STREAM_SECONDS / wall:.1f}x realtime "
                    f"({STREAM_SECONDS / wall:.1f}x a stream); on {card}")


def _batched_dir(dev, inf, counts, card, phase4_rtf):
    """enhance_dir over mixed buckets (8 x 10 s, 5 x 7.5 s) at batch 8
    against the serial path, then one real halving: a memory limit under
    which a batch of 30 s clips runs out."""
    from generative_audio_torch.data import read_wav
    clips = [(_noise(SEED + 60 + i, 160000), f"ten{i}") for i in range(8)]
    clips += [(_noise(SEED + 70 + i, 120000), f"sevenhalf{i}") for i in range(5)]
    with tempfile.TemporaryDirectory() as tmp:
        out = {}
        for batch in (8, 1):
            # batch 8: each bucket warmed once at its batch, then served
            _count(counts, lambda: inf.enhance_dir(
                clips, Path(tmp) / str(batch), log=lambda *_: None,
                batch_size=batch), {"lstm_scan_fwd": 8 if batch == 8 else 26},
                f"enhance_dir, batch {batch}")
            out[batch] = {name: read_wav(Path(tmp) / str(batch) / f"{name}.wav")
                          for _, name in clips}
            if batch == 8:
                rtf = inf.last_rtf
        steps = max(float(np.abs(out[8][name][1] - out[1][name][1]).max())
                    for _, name in clips) * 32768
        # 0.8 is the written peak: the same bf16 limit as chunked against
        # unchunked, since another batch sums the projections, norms and
        # convolutions in another order
        log(f"enhance_dir 8 x 10 s + 5 x 7.5 s, batch 8: rtf {rtf:.5f} (phase "
            f"4's batch of 8 x 10 s: {phase4_rtf:.5f}); batched vs serial max "
            f"{steps:.0f} int16 steps ({steps / 32768 / 0.8:.3e} of the peak); "
            f"on {card}")
        for noisy, name in clips:
            sr, wav = out[8][name]
            check(sr == 16000 and wav.shape == noisy.shape
                  and np.isfinite(wav).all(), f"enhance_dir wrote {name}")
        check(steps / 32768 / 0.8 < PATH_REL,
              f"batched enhance_dir vs serial within {PATH_REL} of the peak")
        _halving(dev, inf, Path(tmp))


def _batch_parts(dev, model, card):
    """Where a batch of 8 clips and its first clip alone part: the
    full-band tower's output (convolutions and norms over another batch sum
    in another order) and so the sub-band input differ, while the sub-band
    model (the projections and kernel A) on the same 257 rows, among 2056
    or alone, gives the same bits."""
    from generative_audio_torch.ops import prepare_input_from_waveform
    seen = {}

    def keep(name):
        def hook(module, args, out):
            seen.setdefault(name, []).append((args[0], out))
        return hook

    hooks = [model.get_submodule(name).register_forward_hook(keep(name))
             for name in ("fb_model", "sb_model")]
    wav = torch.from_numpy(_noise(SEED + 60, 8, 160000)).to(dev)
    with torch.inference_mode():
        for batch in (8, 1):
            model(*prepare_input_from_waveform(wav[:batch], 512, 256, 512))
        for hook in hooks:
            hook.remove()
        (fb8, fb1), (sb8, sb1) = seen["fb_model"], seen["sb_model"]
        fb = float((fb8[1][:1] - fb1[1]).abs().max() / fb1[1].abs().max())
        sb_in = float((sb8[0][:257] - sb1[0]).abs().max())
        alone = model.sb_model(sb8[0][:257].contiguous())
        same = torch.equal(alone, sb8[1][:257])
    log(f"batch 8 vs its first clip alone: full-band tower output max|diff|/"
        f"peak {fb:.3e}, sub-band input max|diff| {sb_in:.3e}; the sub-band "
        f"model on the same 257 rows, among 2056 vs alone, bit for bit: "
        f"{same}; on {card}")
    check(same, "the sub-band model's rows do not depend on the batch")


def _halving(dev, inf, tmp):
    """One real halving: the memory limit is what is reserved now plus what
    a batch of two 30 s clips takes, so that a batch of 8 (four times that)
    runs out. Free space inside segments that are reserved may let a batch
    of 4 fit, so the check is that the batch halved and every clip was
    written, not how often."""
    from generative_audio_torch.data import read_wav
    long = [(_noise(SEED + 80 + i, OOM_SECONDS * 16000), f"long{i}")
            for i in range(OOM_BATCH)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    inf.enhance_dir(long[:2], tmp / "batch2", log=lambda *_: None,
                    batch_size=2)
    need2 = torch.cuda.max_memory_allocated(dev) - start
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    limit = reserved + need2
    total = torch.cuda.get_device_properties(dev).total_memory
    logs = []
    torch.cuda.set_per_process_memory_fraction(limit / total, dev)
    try:
        inf.enhance_dir(long, tmp / "long", log=logs.append,
                        batch_size=OOM_BATCH)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    retries = [line for line in logs if "retrying" in line]
    log(f"enhance_dir {OOM_BATCH} x {OOM_SECONDS} s: a batch of 2 takes "
        f"{need2 / 2 ** 30:.2f} GiB; {reserved / 2 ** 30:.2f} GiB reserved "
        f"({torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} allocated), limit "
        f"{limit / 2 ** 30:.2f} GiB: {retries}")
    check(retries and retries[0].startswith(
        f"bucket {OOM_SECONDS * 16000}: batch {OOM_BATCH} ran out of device "
        "memory"), f"the batch of {OOM_BATCH} x {OOM_SECONDS} s clips halved "
        "under the memory limit")
    for noisy, name in long:
        sr, wav = read_wav(tmp / "long" / f"{name}.wav")
        check(wav.shape == noisy.shape and np.isfinite(wav).all(),
              f"enhance_dir wrote {name} after halving")


def _cli(dev, plus, counts, card):
    """generative_audio_torch.cli.inference in process, a JSON config and a
    .pth of the seeded weights, three wavs, on the card and on the CPU."""
    from generative_audio_torch.cli.inference import main as cli_main
    from generative_audio_torch.data import read_wav, write_wav
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "noisy").mkdir()
        for i, seconds in enumerate((0.5, 0.75, 1.0)):
            write_wav(root / "noisy" / f"c{i}.wav",
                      _noise(SEED + 90 + i, int(seconds * 16000)), 16000)
        torch.save({"model": plus.sd}, root / "model.pth")
        (root / "cfg.json").write_text(json.dumps(
            {"inferencer": {"length_bucket": 4000}}))
        for device in (str(dev), "cpu"):
            argv = ["-C", str(root / "cfg.json"), "-M", str(root / "model.pth"),
                    "-I", str(root / "noisy"), "-O", str(root / device),
                    "--device", device]
            _count(counts, lambda: cli_main(argv),
                   {"lstm_scan_fwd": 6} if device != "cpu" else {},
                   f"the CLI on {device}")
        worst = 0.0
        for i in range(3):
            got = read_wav(root / str(dev) / f"c{i}.wav")[1]
            want = read_wav(root / "cpu" / f"c{i}.wav")[1]
            check(got.shape == want.shape and np.isfinite(got).all(),
                  f"the CLI wrote c{i}.wav")
            worst = max(worst, _rel(got, want))
        log(f"cli: 3 wavs, card vs CPU (both bf16) max|err|/peak {worst:.3e} "
            f"on {card}")
        check(worst < PATH_REL, f"the CLI, card vs CPU within {PATH_REL}")


def phase_serving_modes(dev, plus, phase4_rtf):
    """Phase 13. Returns the launches of its kernels."""
    from generative_audio_torch.ops import lstm as L
    card = card_line()
    model = plus.model(torch.bfloat16, dev)
    ref = plus.model(torch.float32, "cpu")
    L.reset_launch_counts()
    counts = L.launch_counts
    _chunks_and_streams(dev, model, ref, counts, card)
    _serve_modes(dev, counts, card)
    _batched_dir(dev, plus.inferencer(model, dev), counts, card, phase4_rtf)
    _batch_parts(dev, model, card)
    _cli(dev, plus, counts, card)
    launched = {k: v for k, v in counts.items() if v}
    log(f"launches on the serving path of phase 13: {launched}")
    check(set(launched) == {"lstm_scan_fwd"},
          f"phase 13 launched kernel A and nothing else (got {launched})")
    _stream_readings(dev, model, card)
    return launched


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from generative_audio_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(dev)}, {torch.cuda.device_count()} device(s)")
    registers = phase_build()
    kernels = phase_kernels(dev, registers)
    kernels.update(phase_train_kernels(dev, registers))
    kernels["lstm_scan_bwd"]["full_band"] = phase_lstm_h512(dev, registers)
    phase_padded_hidden(dev)
    block_kernels, block_launches = phase_block_forwards(dev)
    kernels.update(block_kernels)
    phase_lstm_train_large(dev)
    kernels.update(phase_gru_kernels(dev))
    kernels.update(phase_gru_train_kernels(dev, registers))

    pallas = "generative_audio_tpu/ops/pallas_lstm.py"
    csrc = "generative_audio_torch/csrc"
    table = {       # name: (source, the TPU kernel it replaces)
        "lstm_scan_fwd": (f"{csrc}/lstm_scan.cu", f"{pallas}:142"),
        "lstm_scan_fwd_carry": (f"{csrc}/lstm_scan.cu", f"{pallas}:725"),
        "lstm_scan_fwd_train": (f"{csrc}/lstm_scan.cu", f"{pallas}:205"),
        "lstm_scan_bwd": (f"{csrc}/lstm_scan_bwd.cu", f"{pallas}:300"),
        "gru_scan_fwd": (f"{csrc}/gru_scan.cu", f"{pallas}:907"),
        "gru_scan_fwd_carry": (f"{csrc}/gru_scan.cu", f"{pallas}:1151"),
        "gru_scan_bwd": (f"{csrc}/gru_scan_bwd.cu", f"{pallas}:1019"),
        # the dW_hh line of the same TPU kernel's body
        "gru_scan_bwd_dwhh": (f"{csrc}/gru_scan_bwd.cu", f"{pallas}:1011"),
        # each with an entry point of its own, on no model's path
        "lstm_layer_fwd": (f"{csrc}/lstm_scan_staged.cu", f"{pallas}:542"),
        "lstm_scan_bwd_chains": (f"{csrc}/lstm_scan_bwd_chains.cu",
                                 "scripts/perf_lstm_chains.py:105"),
        "lstm_scan_fwd_unrolled": (f"{csrc}/lstm_scan_staged.cu",
                                   "scripts/perf_lstm_unroll.py:59"),
        # their single-block routes: kernel G where no cluster holds H
        # (its first design), kernel E above H=512
        "lstm_scan_bwd_chains_block": (f"{csrc}/lstm_scan_bwd.cu",
                                       "scripts/perf_lstm_chains.py:105"),
        "lstm_scan_fwd_unrolled_block": (f"{csrc}/lstm_scan_unrolled_block.cu",
                                         "scripts/perf_lstm_unroll.py:59"),
        # the single-block route of rows 1, 5, 2, 6 and 8 where no cluster
        # holds H, on the wrappers' path at such H
        "lstm_scan_fwd_block": (f"{csrc}/lstm_scan_block.cu", f"{pallas}:142"),
        "lstm_scan_fwd_carry_block": (f"{csrc}/lstm_scan_block.cu",
                                      f"{pallas}:725"),
        "lstm_scan_fwd_train_block": (f"{csrc}/lstm_scan_block.cu",
                                      f"{pallas}:205"),
        "gru_scan_fwd_block": (f"{csrc}/gru_scan_block.cu", f"{pallas}:907"),
        "gru_scan_fwd_carry_block": (f"{csrc}/gru_scan_block.cu",
                                     f"{pallas}:1151"),
        # kernel F's single-block route where no cluster holds H
        "lstm_layer_fwd_block": (f"{csrc}/lstm_layer_block.cu",
                                 f"{pallas}:542")}
    plus, v1_gru, v1_lstm = model_paths()
    counts, plus_rtf = drive(dev, plus, ["lstm_scan_fwd", "lstm_scan_fwd_carry",
                                         "lstm_scan_fwd_train", "lstm_scan_bwd"])
    counts.update(drive(dev, v1_gru, [k for k in table if k.startswith("gru_")
                                      and not k.endswith("_block")])[0])
    for name, launched in phase_serving_modes(dev, plus, plus_rtf).items():
        counts[name] += launched
    counts.update(block_launches)
    phase_reference(dev, v1_lstm, v1_lstm.model(torch.bfloat16, dev))

    for phase in (lambda: phase_lstm_chains(
                      dev, kernels["lstm_scan_bwd"]["library_ms"], registers),
                  lambda: phase_lstm_unroll(dev, registers)):
        numbers, launches = phase()
        kernels.update(numbers)
        counts.update(launches)
    (kernels["lstm_layer_fwd"], counts["lstm_layer_fwd"],
     kernels["lstm_layer_fwd_block"]) = phase_lstm_layer(
        dev, plus, kernels["lstm_scan_fwd"]["ms"], registers)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": counts[name], **kernels[name]}
        for name, (source, replaces) in table.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
