#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (generative_audio_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card (name, power limit, torch and CUDA versions) and the build of
     every CUDA kernel of the serving path from generative_audio_torch/csrc;
  2. each kernel against its plain PyTorch version at the serving shape
     (T=628 frames, H=384, 2056 rows = batch 8 x 257 bins, and a ragged
     row count; forward and reverse), the chunked kernel against the
     unchunked one bit for bit, and each kernel's time beside its bound, its
     plain version's time and a cuDNN LSTM's time;
  3. the serving path at FullSubNet+'s full width (random weights from a
     numpy seed in the JAX param layout, carried across by
     utils/convert.py), bf16: a 1 s clip against the float32 model on the
     CPU, then three single requests (3 s, 7.5 s, 10 s) and one batched
     enhance_dir of 8 x 10 s clips;
  4. a 30 s request with a lowered gates limit, so the sub-band LSTM takes
     the time-chunked path, against the same request unchunked;
  5. a torch.profiler breakdown of one batch-8 x 10 s forward by kernel.
The launch counts are set to 0 just before phases 3-4 drive the path and
read just after. The second-to-last line of stdout is the `kernels` JSON,
the last line the device JSON. Exits non-zero without a CUDA device.
"""
import json
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


def bound(t, rows, h, extra_bytes=0):
    """Least time (ms) for one LSTM scan: bf16 gates in, W_hh in, bf16 h out,
    2*T*rows*H*4H operations on the bf16 tensor cores."""
    bytes_ = t * rows * 4 * h * 2 + 4 * h * h * 2 + t * rows * h * 2 + extra_bytes
    flops = 2 * t * rows * h * 4 * h
    by_bytes, by_ops = bytes_ / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase_build():
    from generative_audio_torch.ops import _cuda
    t0 = time.perf_counter()
    reports = _cuda.build(["lstm_scan"])
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_cuda.NVCC_FLAGS)})")
    for name, report in reports.items():
        for line in report.splitlines():
            if "entry function" in line or "registers" in line:
                log(f"  ptxas {name}: {line.strip()}")
    _cuda.load("lstm_scan")


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


def phase_profile(dev, model):
    """Where the time of one batch-8 x 10 s model forward goes on the card:
    torch.profiler's device time by kernel, against the forward's wall time.
    Run after the launch counts are read."""
    from torch.profiler import ProfilerActivity, profile
    from generative_audio_torch.ops import prepare_input_from_waveform
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    wav = torch.randn(8, 160000, generator=gen, device=dev) * 0.1
    inputs = prepare_input_from_waveform(wav, 512, 256, 512)
    with torch.inference_mode():
        model(*inputs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(*inputs)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    if busy == 0:
        log("profile: torch.profiler recorded no device time")
        return
    log(f"profile: batch 8 x 10 s forward, wall {wall:.2f} ms (profiled), "
        f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%), on {card_line()}")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {key[:90]}")


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
    cfg, sd, model = build_models(dev)
    phase_reference(dev, cfg, sd, model)

    L.reset_launch_counts()
    phase_serving(dev, model, L.launch_counts)
    phase_long_clip(dev, cfg, sd, model, L.launch_counts)
    counts = dict(L.launch_counts)
    log(f"launches on the path: {counts}")
    for name, n in counts.items():
        check(n > 0, f"{name} launched on the path")
    phase_profile(dev, model)

    replaces = {
        "lstm_scan_fwd": "generative_audio_tpu/ops/pallas_lstm.py:142",
        "lstm_scan_fwd_carry": "generative_audio_tpu/ops/pallas_lstm.py:725"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "generative_audio_torch/csrc/lstm_scan.cu",
         "replaces": replaces[name], "launches": counts[name],
         **kernels[name]} for name in ("lstm_scan_fwd", "lstm_scan_fwd_carry")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
