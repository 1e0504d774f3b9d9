#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (generative_audio_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card (name, power limit, torch and CUDA versions) and the build of
     every CUDA kernel from generative_audio_torch/csrc, with the registers
     ptxas reports for every instance;
  2. the two inference kernels against their plain PyTorch versions at the
     serving shape (T=628 frames, H=384, 2056 rows = batch 8 x 257 bins, and
     a ragged row count; forward and reverse), the chunked kernel against
     the unchunked one bit for bit, and each kernel's time beside its bound,
     its plain version's time and a cuDNN LSTM's time;
  3. the two training kernels at the training shape (T=195 frames, 2304 rows
     = batch 18 x 128 bins after drop_band, and a ragged row count; forward
     and reverse): the training forward's h against the inference kernel's
     bit for bit, its c sequence and the backward scan's dgates against
     their plain versions, the whole LSTMScan gradient against autograd
     through the float32 recurrence, and the times as in phase 2 (the
     library call is a cuDNN LSTM's forward and backward);
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
     of one training step.
The launch counts are set to 0 just before phases 4-5 drive the serving path
and read just after, and again around the five steps of phase 6. The
second-to-last line of stdout is the `kernels` JSON, the last line the
device JSON. Exits non-zero without a CUDA device.
"""
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

T_FRAMES, HIDDEN, ROWS, RAGGED_ROWS = 628, 384, 8 * 257, 2047
T_CHUNK = 64
# The training shape: 3.072 s clips give 193 frames + 2 look-ahead; batch 18
# x 257 bins, drop_band keeps 128 of them per clip.
TRAIN_T, TRAIN_ROWS, TRAIN_RAGGED_ROWS = 195, 18 * 128, 18 * 128 - 9
TRAIN_BATCH, TRAIN_SAMPLES, TRAIN_STEPS = 18, 49152, 5
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
BWD_MAX_REL, BWD_MEAN_REL = 5e-2, 2e-5
GRAD_MAX_REL, GRAD_MEAN_REL, GRAD_DW_REL = 5e-2, 5e-4, 3e-2
# Training on the card in bf16 vs the float32 model on the CPU, 4 x 1 s:
# relative loss error (measured 2.0e-4), and per parameter tensor (those
# whose gradient norm is above 1e-3 of the largest) the cosine (measured
# 0.9972 at the lowest) and the ratio of the norms (measured 0.985-1.028).
TRAIN_LOSS_REL, TRAIN_GRAD_COS, TRAIN_GRAD_RATIO = 5e-3, 0.95, 0.15
# Whole path: bf16 on the card against float32 on the CPU, and chunked
# against unchunked projections (cuBLAS may round a chunk's bf16 gates
# differently), both as a share of the output's peak.
PATH_REL = 5e-2


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()]


def cuda_ms(fn, iters, warmup=1):
    """Mean milliseconds per call on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(t, rows, h, extra_bytes=0, streams=5, products=1, weights=1):
    """Least time (ms) for one LSTM scan kernel. Bytes: `streams` bf16
    [T, rows, H] arrays each read or written once (the forward: 4 of gates
    in, 1 of h out) and `weights` bf16 copies of W_hh. Operations:
    `products` [rows, H] x [H, 4H] products per step on the bf16 tensor
    cores."""
    bytes_ = (t * rows * streams * h * 2 + weights * 4 * h * h * 2
              + extra_bytes)
    flops = products * 2 * t * rows * h * 4 * h
    by_bytes, by_ops = bytes_ / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase_build():
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


def phase_kernels(dev):
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
    plain_a = cuda_ms(lambda: L.lstm_scan_reference_tm(gates, w_hh), iters=2)
    plain_b = cuda_ms(lambda: [L.lstm_scan_carry_reference_tm(
        gates[s:s + T_CHUNK], w_hh, zeros, zeros)
        for s in range(0, T_FRAMES, T_CHUNK)], iters=2)
    library = library_lstm_ms(gates, w_hh)
    n_chunks = -(-T_FRAMES // T_CHUNK)
    b_a, by_a = bound(T_FRAMES, ROWS, h)
    b_b, by_b = bound(T_FRAMES, ROWS, h, extra_bytes=n_chunks * 4 * ROWS * h * 4)
    log(f"kernel A at T={T_FRAMES} rows={ROWS} H={h}: {ms_a:.3f} ms "
        f"(bound {b_a:.3f} ms by {by_a}; plain {plain_a:.3f} ms; cuDNN LSTM "
        f"{library:.3f} ms) on {card_line()}")
    log(f"kernel B, {n_chunks} chunks of {T_CHUNK}: {ms_b:.3f} ms "
        f"(bound {b_b:.3f} ms by {by_b}; plain {plain_b:.3f} ms) on {card_line()}")
    log(f"kernel B in one chunk of {T_FRAMES}: {ms_b_one:.3f} ms; kernel A at "
        f"257 rows (one 10 s clip): {ms_a_257:.3f} ms (bound "
        f"{bound(T_FRAMES, 257, h)[0]:.3f} ms) on {card_line()}")
    log("  (the cuDNN LSTM is nn.LSTM(4H, H) with W_ih = I and zero bias: the "
        "same recurrence plus one extra [T*rows, 4H] x [4H, 4H] projection)")
    results["lstm_scan_fwd"] = dict(
        max_abs_err=max_a, ms=ms_a, plain_ms=plain_a, bound_ms=b_a,
        bound_by=by_a, library_ms=library)
    results["lstm_scan_fwd_carry"] = dict(
        max_abs_err=max_b, ms=ms_b, plain_ms=plain_b, bound_ms=b_b,
        bound_by=by_b, library_ms=library)
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


def phase_train_kernels(dev):
    """Kernels C (training forward) and D (backward scan) at the training
    shape, and the LSTMScan gradient as a whole."""
    from generative_audio_torch.ops import lstm as L
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

        # LSTMScan as a whole against autograd through the fp32 recurrence
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
        del g_k, w_k, g_x, w_x, err_g, gates, gout

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
    plain_c = cuda_ms(lambda: L.lstm_scan_train_reference_tm(gates, w_hh),
                      iters=2)
    plain_d = cuda_ms(lambda: L.lstm_scan_bwd_reference_tm(
        gates, h_seq, c_seq, gout, w_hh), iters=2)
    lib_fwd, lib_both = library_lstm_train_ms(gates, w_hh, gout)
    # C: gates in, h and c out. D: gates, h, c, gout in, dgates out, both
    # weight layouts, two products per step.
    b_c, by_c = bound(t_len, rows, h, streams=6)
    b_d, by_d = bound(t_len, rows, h, streams=11, products=2, weights=2)
    card = card_line()
    log(f"kernel C at T={t_len} rows={rows} H={h}: {ms_c:.3f} ms (kernel A "
        f"on the same gates {ms_a:.3f} ms; bound {b_c:.3f} ms by {by_c}; plain "
        f"{plain_c:.3f} ms; cuDNN LSTM forward, training mode, {lib_fwd:.3f} ms) "
        f"on {card}")
    log(f"kernel C at {one_wave} rows (one block per SM): {ms_c_wave:.3f} ms "
        f"on {card}")
    log(f"kernel D at T={t_len} rows={rows} H={h}: {ms_d:.3f} ms (bound "
        f"{b_d:.3f} ms by {by_d}; plain {plain_d:.3f} ms; cuDNN LSTM backward "
        f"{lib_both - lib_fwd:.3f} ms = forward + backward {lib_both:.3f} ms "
        f"less the forward) on {card}")
    return {
        "lstm_scan_fwd_train": dict(
            max_abs_err=max_c, ms=ms_c, plain_ms=plain_c, bound_ms=b_c,
            bound_by=by_c, library_ms=lib_fwd),
        "lstm_scan_bwd": dict(
            max_abs_err=max_d, ms=ms_d, plain_ms=plain_d, bound_ms=b_d,
            bound_by=by_d, library_ms=lib_both - lib_fwd)}


def build_models(dev):
    from generative_audio_torch.models import FullSubNetPlus, FullSubNetPlusConfig
    from generative_audio_torch.utils import convert
    cfg = FullSubNetPlusConfig()
    sd = convert.convert_fullsubnet_plus(
        convert.random_fullsubnet_plus_params(cfg, seed=SEED))
    model = FullSubNetPlus(cfg, compute_dtype=torch.bfloat16, device=dev)
    model.load_state_dict(sd)
    return cfg, sd, model


def phase_reference(dev, cfg, sd, model):
    """A 1 s clip: the bf16 model on the card against the float32 model on
    the CPU (the algorithm as the CPU tests hold it against JAX)."""
    from generative_audio_torch.eval import Inferencer
    from generative_audio_torch.models import FullSubNetPlus
    from generative_audio_torch.ops import prepare_input_from_waveform
    ref = FullSubNetPlus(cfg, compute_dtype=torch.float32, device="cpu")
    ref.load_state_dict(sd)
    wav = np.random.default_rng(SEED + 1).standard_normal(16000).astype(
        np.float32) * 0.1
    inputs = prepare_input_from_waveform(torch.from_numpy(wav)[None], 512, 256,
                                         512)
    with torch.inference_mode():
        want = ref(*inputs)
        got = model(*(x.to(dev) for x in inputs)).float().cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"reference: 1 s clip, bf16 cRM on the card vs float32 on the CPU: "
        f"max|err|/peak {rel:.3e} (peak {want.abs().max().item():.3f})")
    check(torch.isfinite(got).all().item() and rel < PATH_REL,
          f"bf16 model vs float32 reference within {PATH_REL}")
    out_gpu = Inferencer(model, device=dev).enhance(wav)
    out_cpu = Inferencer(ref, device="cpu").enhance(wav)
    rel_wav = np.abs(out_gpu - out_cpu).max() / np.abs(out_cpu).max()
    log(f"reference: 1 s clip wav to wav, card vs CPU: max|err|/peak {rel_wav:.3e}")
    check(rel_wav < PATH_REL, f"wav vs float32 reference within {PATH_REL}")


def phase_serving(dev, model, counts):
    from generative_audio_torch.eval import Inferencer
    inf = Inferencer(model, device=dev)
    rng = np.random.default_rng(SEED + 2)
    card = card_line()
    for seconds in (3.0, 7.5, 10.0):
        noisy = (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)
        before = counts["lstm_scan_fwd"]
        t0 = time.perf_counter()
        out = inf.enhance(noisy)
        wall = (time.perf_counter() - t0) * 1e3
        check(out.shape == noisy.shape and np.isfinite(out).all(),
              f"{seconds} s request: shape and finite")
        check(counts["lstm_scan_fwd"] - before == 2,
              "kernel A launched twice per forward")
        log(f"serve {seconds} s clip: rtf {inf.last_rtf:.5f}, {wall:.2f} ms per "
            f"call on {card}")

    clips = [((rng.standard_normal(160000) * 0.1).astype(np.float32), f"clip{i}")
             for i in range(8)]
    before = counts["lstm_scan_fwd"]
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        inf.enhance_dir(clips, out_dir, log=lambda *_: None, batch_size=8)
        wall = (time.perf_counter() - t0) * 1e3
        from generative_audio_torch.data import read_wav
        for noisy, name in clips:
            sr, got = read_wav(Path(out_dir) / f"{name}.wav")
            check(sr == 16000 and got.shape == noisy.shape
                  and np.isfinite(got).all(), f"enhance_dir output {name}")
    check(counts["lstm_scan_fwd"] - before == 2,
          "kernel A launched twice for the batched forward")
    log(f"serve enhance_dir 8 x 10 s, batch 8: rtf {inf.last_rtf:.5f}, "
        f"{wall:.2f} ms on {card}")


def phase_long_clip(dev, cfg, sd, model, counts):
    from generative_audio_torch.eval import Inferencer
    from generative_audio_torch.models import FullSubNetPlus
    limit = LONG_CLIP_GATES_LIMIT
    chunked_model = FullSubNetPlus(cfg, compute_dtype=torch.bfloat16,
                                   device=dev, gates_bytes_limit=limit)
    chunked_model.load_state_dict(sd)
    noisy = (np.random.default_rng(SEED + 3).standard_normal(30 * 16000)
             * 0.1).astype(np.float32)
    whole = Inferencer(model, device=dev).enhance(noisy)
    before = dict(counts)
    inf = Inferencer(chunked_model, device=dev)
    out = inf.enhance(noisy)
    launched_b = counts["lstm_scan_fwd_carry"] - before["lstm_scan_fwd_carry"]
    check(launched_b > 0 and counts["lstm_scan_fwd"] == before["lstm_scan_fwd"],
          "the 30 s request took the chunked path (kernel B only)")
    rel = np.abs(out - whole).max() / np.abs(whole).max()
    log(f"long clip 30 s, gates limit {limit >> 20} MiB: kernel B launched "
        f"{launched_b} times, rtf {inf.last_rtf:.5f}; chunked vs unchunked "
        f"max|err|/peak {rel:.3e}")
    check(out.shape == noisy.shape and np.isfinite(out).all() and rel < PATH_REL,
          f"chunked vs unchunked within {PATH_REL}")


def _noise_batch(seed, batch, samples):
    """(noisy, clean) float32 [batch, samples]: seeded noise as the clean
    signal, plus seeded noise."""
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((batch, samples)) * 0.1).astype(np.float32)
    noisy = clean + (rng.standard_normal((batch, samples)) * 0.03
                     ).astype(np.float32)
    return noisy, clean


def phase_training(dev, sd, counts):
    """Five steps of EnhanceTrainer at full width on one fixed batch. The
    caller has set the launch counts to 0."""
    from generative_audio_torch.train import EnhanceTrainConfig, EnhanceTrainer
    cfg = EnhanceTrainConfig()
    trainer = EnhanceTrainer(cfg, seed=SEED, pretrained_state_dict=sd,
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
    losses, times = [], []
    for step in range(TRAIN_STEPS):
        before = dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_epoch([(noisy, clean)]))   # ends in a fetch
        times.append((time.perf_counter() - t0) * 1e3)
        launched = {k: counts[k] - before[k] for k in counts}
        check(launched == {"lstm_scan_fwd": 0, "lstm_scan_fwd_carry": 0,
                           "lstm_scan_fwd_train": 2, "lstm_scan_bwd": 2},
              f"train step {step + 1} launched 2 training forwards and 2 "
              f"backward scans and nothing else (got {launched})")
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
    log(f"train: batch {TRAIN_BATCH} x {TRAIN_SAMPLES / 16000:.3f} s, bf16, "
        f"losses {' '.join(f'{x:.5f}' for x in losses)}")
    check(np.isfinite(losses).all(), "training losses finite")
    check(losses[-1] < losses[0], "the fifth loss is below the first")
    check(trainer.state.step == TRAIN_STEPS, "five optimizer steps counted")
    steady = statistics.median(times[1:])
    log(f"train: ms per step {' '.join(f'{x:.1f}' for x in times)}; median of "
        f"steps 2-{TRAIN_STEPS} {steady:.2f} ms = "
        f"{TRAIN_BATCH / steady * 1e3:.2f} clips/s; peak memory {peak:.2f} GiB "
        f"on {card_line()}")
    return trainer


def phase_training_reference(dev, sd):
    """A batch of 4 x 1 s: the bf16 loss and gradients on the card against
    the float32 model on the CPU."""
    import torch.nn.functional as F
    from generative_audio_torch.train import (
        EnhanceTrainConfig, enhance_loss_fn, init_enhance_state)
    noisy, clean = (torch.from_numpy(x) for x in
                    _noise_batch(SEED + 7, 4, 16000))
    grads, losses = {}, {}
    for name, device, dtype in (("card", dev, "bfloat16"),
                                ("cpu", "cpu", "float32")):
        cfg = EnhanceTrainConfig(compute_dtype=dtype)
        state = init_enhance_state(cfg, SEED, device)
        state.model.load_state_dict(sd)
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
    log(f"train reference: 4 x 1 s, bf16 on the card vs float32 on the CPU: "
        f"loss {losses['card']:.6f} vs {losses['cpu']:.6f} (rel {rel:.3e}); "
        f"of {len(rows)} parameter tensors {len(carrying)} carry the gradient "
        f"(norm above 1e-3 of the largest): lowest cosine {worst[0]:.4f} "
        f"({worst[3]}), norm ratios {min(r[1] for r in carrying):.3f}-"
        f"{max(r[1] for r in carrying):.3f}")
    for cos, ratio, share, k in rows:
        if k.startswith("sb_model.sequence_model"):
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


def phase_profile(dev, model, trainer):
    """Where the time goes on the card, by kernel: one batch-8 x 10 s model
    forward and one training step. Run after the launch counts are read."""
    from generative_audio_torch.ops import prepare_input_from_waveform
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    wav = torch.randn(8, 160000, generator=gen, device=dev) * 0.1
    inputs = prepare_input_from_waveform(wav, 512, 256, 512)
    with torch.inference_mode():
        _profile(lambda: model(*inputs), "batch 8 x 10 s forward")
    del inputs, wav
    noisy, clean = (torch.from_numpy(x).to(dev) for x in
                    _noise_batch(SEED + 6, TRAIN_BATCH, TRAIN_SAMPLES))
    _profile(lambda: trainer.train_epoch([(noisy, clean)]),
             f"training step, batch {TRAIN_BATCH} x "
             f"{TRAIN_SAMPLES / 16000:.3f} s")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(dev)}, {torch.cuda.device_count()} device(s)")
    phase_build()
    kernels = phase_kernels(dev)
    kernels.update(phase_train_kernels(dev))
    cfg, sd, model = build_models(dev)
    phase_reference(dev, cfg, sd, model)

    serving = ("lstm_scan_fwd", "lstm_scan_fwd_carry")
    training = ("lstm_scan_fwd_train", "lstm_scan_bwd")
    L.reset_launch_counts()
    phase_serving(dev, model, L.launch_counts)
    phase_long_clip(dev, cfg, sd, model, L.launch_counts)
    counts = dict(L.launch_counts)
    log(f"launches on the serving path: {counts}")
    for name in serving:
        check(counts[name] > 0, f"{name} launched on the serving path")

    L.reset_launch_counts()
    trainer = phase_training(dev, sd, L.launch_counts)
    train_counts = dict(L.launch_counts)
    log(f"launches on the training path: {train_counts}")
    for name in training:
        check(train_counts[name] == 2 * TRAIN_STEPS,
              f"{name} launched twice per step on the training path")
        counts[name] = train_counts[name]
    phase_training_reference(dev, sd)
    phase_profile(dev, model, trainer)

    pallas = "generative_audio_tpu/ops/pallas_lstm.py"
    scan_cu = "generative_audio_torch/csrc/lstm_scan.cu"
    table = {       # name: (source, the TPU kernel it replaces)
        "lstm_scan_fwd": (scan_cu, f"{pallas}:142"),
        "lstm_scan_fwd_carry": (scan_cu, f"{pallas}:725"),
        "lstm_scan_fwd_train": (scan_cu, f"{pallas}:205"),
        "lstm_scan_bwd": ("generative_audio_torch/csrc/lstm_scan_bwd.cu",
                          f"{pallas}:300")}
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
