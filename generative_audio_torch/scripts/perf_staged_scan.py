"""The staged LSTM scans (csrc/lstm_scan_staged.cu: kernel E
`lstm_scan_fwd_unrolled`, kernel F `lstm_layer_fwd`; above H = 512 their
streamed clusters, csrc/lstm_staged_stream.cu `lstm_scan_fwd_unrolled_stream`
and `lstm_layer_fwd_stream`) under forced launch plans, on the card.

All run as thread-block clusters whose shape the planners choose
(ops.lstm.plan_unrolled and plan_layer; plan_unrolled_stream and
plan_layer_stream). This script holds every plan that fits against the
kernel it must equal bit for bit (kernel E: kernel A, `lstm_scan_fwd`, or
above H = 512 kernel A's single block; kernel F: its single block,
`lstm_layer_fwd_block`, the first design of kernel F) and times each plan,
one cluster alone and a full batch of them, to fit the planners' step
models. `--stream` does so for the streamed clusters: a spread of plans
(cluster size, rows, resident k-steps, ring depth and kernel E's gate
groups) against the single blocks, then one-cluster plans timed at T = 192
and the least-squares fit of `_UNROLL_STREAM_PARTS` and
`_LAYER_STREAM_PARTS` of ops/lstm.py, and the planner's plans at 18 and
2056 rows beside the single blocks.

    # identity of every plan, at small ragged shapes
    python -m generative_audio_torch.scripts.perf_staged_scan --check
    # the identity, then the sweep at the scripts' and sub-band shapes
    python -m generative_audio_torch.scripts.perf_staged_scan
    # the streamed clusters: identity only, or identity, sweep and fit
    python -m generative_audio_torch.scripts.perf_staged_scan --stream-check
    python -m generative_audio_torch.scripts.perf_staged_scan --stream
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from generative_audio_torch.ops import lstm as L
from generative_audio_torch.utils.device import cuda_ms, resolve_device

__all__ = ["unrolled_plans", "layer_plans", "gates_inputs", "layer_inputs",
           "check", "sweep", "unrolled_stream_plan", "layer_stream_plan",
           "stream_check", "fit_parts", "stream_sweep", "main"]

# kernel E at perf_lstm_unroll's shape, kernel F at FullSubNet+'s sub-band
# layers (one batch of 8 x 10 s)
T, ROWS_E, ROWS_F, H = 628, 2304, 2056, 384
SUB_BAND_F = (34, 384)
MAX_ROWS = 96          # rows per cluster the sweep tries, at most
_SOURCE = "lstm_scan_staged"
_STREAM_SOURCE = "lstm_staged_stream"


def _shapes(hsz, batch):
    """(C, R) of every cluster size that splits hsz and every row count up
    to MAX_ROWS (and the batch's m16 tiles)."""
    for cluster in L.CLUSTER_SIZES:
        if hsz % (8 * cluster) == 0:
            for rows in range(16, min(MAX_ROWS, 16 * -(-batch // 16)) + 1, 16):
                yield cluster, rows


def unrolled_plans(hsz: int, batch: int, k: int, device) -> list:
    """Every plan of kernel E that fits at (H, batch) with k steps a group,
    with the card's occupancy."""
    index = torch.device(device).index
    out = []
    for cluster, rows in _shapes(hsz, batch):
        smem = L.unrolled_smem_bytes(hsz, cluster, rows, k)
        if smem > L.SMEM_LIMIT:
            continue
        n = L._max_clusters(_SOURCE, index, (k, 0), hsz, cluster, rows)
        if n < 1:
            continue
        clusters = -(-batch // rows)
        out.append(L.ScanPlan(cluster, rows, clusters, n, -(-clusters // n),
                              smem))
    return out


def layer_plans(hsz: int, batch: int, device,
                out_dtype: torch.dtype = torch.bfloat16) -> list:
    """Every plan of kernel F that fits at (H, batch), one warp an item,
    with the card's occupancy."""
    index = torch.device(device).index
    out = []
    for cluster, rows in _shapes(hsz, batch):
        smem = L.layer_smem_bytes(hsz, cluster, rows)
        if (smem > L.SMEM_LIMIT
                or rows // 16 * (hsz // cluster // 8) > L._MAX_WARPS):
            continue
        n = L._max_clusters(_SOURCE, index,
                            (1, int(out_dtype == torch.float32)), hsz,
                            cluster, rows)
        if n < 1:
            continue
        clusters = -(-batch // rows)
        out.append(L.ScanPlan(cluster, rows, clusters, n, -(-clusters // n),
                              smem))
    return out


def gates_inputs(t_len: int, b: int, hsz: int, device, seed: int):
    """bf16 gates (unit normal) and a float32 w_hh (uniform in +-H^-0.5)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w_hh = (torch.rand(hsz, 4 * hsz, generator=gen, device=device) * 2 - 1
            ) * hsz ** -0.5
    gates = torch.randn(t_len, b, 4 * hsz, generator=gen,
                        device=device).to(torch.bfloat16)
    return gates, w_hh


def layer_inputs(t_len: int, b: int, f: int, hsz: int, device, seed: int):
    """bf16 x (unit normal) and float32 w_ih, w_hh, bias (uniform in
    +-H^-0.5, as torch's LSTM initialises them)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bound = hsz ** -0.5

    def uniform(*shape):
        return (torch.rand(*shape, generator=gen, device=device) * 2 - 1
                ) * bound

    x = torch.randn(t_len, b, f, generator=gen, device=device)
    return (x.to(torch.bfloat16), uniform(f, 4 * hsz), uniform(hsz, 4 * hsz),
            uniform(4 * hsz))


def check(device, unrolled_shapes=((8, 40, 384), (12, 33, 512), (4, 17, 64),
                                   (8, 1, 384)),
          layer_shapes=((7, 40, 34, 384), (5, 33, 384, 384), (6, 17, 5, 512),
                        (3, 1, 64, 384), (4, 50, 34, 100))) -> int:
    """Every plan of kernel E == kernel A and every plan of kernel F == its
    single block, bit for bit, at each (T, rows, H) and (T, rows, F, H);
    kernel F forward and reverse with fp32 output. Returns the number of
    failures."""
    failures = 0
    with torch.no_grad():
        for i, (t_len, b, hsz) in enumerate(unrolled_shapes):
            gates, w_hh = gates_inputs(t_len, b, hsz, device, seed=200 + i)
            want = L.lstm_scan_tm(gates, w_hh)                    # kernel A
            for k in L.UNROLL_STEPS:
                for plan in unrolled_plans(L.unrolled_hidden(hsz, k), b, k,
                                           device):
                    got = L.lstm_scan_unrolled_planned_tm(gates, w_hh, plan, k)
                    same = torch.equal(got, want)
                    failures += not same
                    print(f"unrolled T={t_len} rows={b} H={hsz} K={k} "
                          f"C={plan.cluster} R={plan.rows}: == lstm_scan_fwd "
                          f"{'bitwise' if same else 'FAILED'}", flush=True)
        for i, (t_len, b, f, hsz) in enumerate(layer_shapes):
            inputs = layer_inputs(t_len, b, f, hsz, device, seed=300 + i)
            hp = L.layer_route(hsz, f + f % 2)[0]
            for reverse in (False, True):
                with L.single_block_forwards():
                    want = L.lstm_layer_tm(*inputs, reverse, torch.float32)
                for plan in layer_plans(hp, b, device, torch.float32):
                    got = L.lstm_layer_planned_tm(*inputs, plan, reverse,
                                                  torch.float32)
                    same = torch.equal(got, want)
                    failures += not same
                    print(f"layer T={t_len} rows={b} F={f} H={hsz} reverse="
                          f"{reverse} C={plan.cluster} R={plan.rows}: == "
                          f"lstm_layer_fwd_block "
                          f"{'bitwise' if same else 'FAILED'}", flush=True)
    return failures


def sweep(device, card: str) -> None:
    """Time every plan: kernel E at T=628 x 2304 rows (K=2, 4), kernel F at
    FullSubNet+'s two sub-band layers (T=628 x 2056 rows, F=34 and 384),
    one cluster alone (rows = R) and the whole batch."""
    with torch.no_grad():
        gates, w_hh = gates_inputs(T, ROWS_E, H, device, seed=7)
        for k in L.UNROLL_STEPS:
            for plan in unrolled_plans(H, ROWS_E, k, device):
                ms = cuda_ms(lambda: L.lstm_scan_unrolled_planned_tm(
                    gates, w_hh, plan, k), iters=3)
                one = gates[:, :plan.rows].contiguous()
                ms_one = cuda_ms(lambda: L.lstm_scan_unrolled_planned_tm(
                    one, w_hh, plan, k), iters=3)
                print(f"unrolled K={k} H={H} T={T} rows={ROWS_E} "
                      f"C={plan.cluster} R={plan.rows} {plan.smem_bytes} B, "
                      f"{plan.clusters} clusters, {plan.active} at once, "
                      f"{plan.waves} wave(s): {ms:.3f} ms, "
                      f"{1e3 * ms / T / plan.waves:.2f} us a step a wave "
                      f"(model {L.unrolled_step_us(H, plan.cluster, plan.rows):.2f}); "
                      f"one cluster alone {1e3 * ms_one / T:.2f} us a step on "
                      f"{card}", flush=True)
        del gates
        for f in SUB_BAND_F:
            inputs = layer_inputs(T, ROWS_F, f, H, device, seed=8)
            for plan in layer_plans(H, ROWS_F, device):
                ms = cuda_ms(lambda: L.lstm_layer_planned_tm(*inputs, plan),
                             iters=3)
                one = (inputs[0][:, :plan.rows].contiguous(), *inputs[1:])
                ms_one = cuda_ms(lambda: L.lstm_layer_planned_tm(*one, plan),
                                 iters=3)
                print(f"layer F={f} H={H} T={T} rows={ROWS_F} "
                      f"C={plan.cluster} R={plan.rows} {plan.smem_bytes} B, "
                      f"{plan.clusters} clusters, {plan.active} at once, "
                      f"{plan.waves} wave(s): {ms:.3f} ms, "
                      f"{1e3 * ms / T / plan.waves:.2f} us a step a wave "
                      f"(model {L.layer_step_us(H, plan.cluster, plan.rows, f):.2f}); "
                      f"one cluster alone "
                      f"{1e3 * ms_one / T:.2f} us a step on {card}",
                      flush=True)
            del inputs


# ---- the streamed clusters (csrc/lstm_staged_stream.cu) -------------------

def _stream_fit(hp, cluster, rows, resident, stages, smem):
    """The resident k-steps (None: the most that fit) of a streamed CTA at
    (H, C, R, stages), or None where the plan does not fit."""
    res = L._stream_resident(hp, cluster, rows, stages, smem, resident)
    if (res is None or stages > hp // 32 - res // 2
            or rows // 16 * (hp // cluster // 8) > L._STREAM_MAX_ITEMS):
        return None
    return res


def unrolled_stream_plan(hsz, batch, k, cluster, rows, resident, stages,
                         groups, device):
    """Kernel E's UnrolledStreamPlan of (C, R, resident k-steps, stages,
    gate groups) for `batch` rows at H = hsz with the card's occupancy,
    resident None for the most that fit; None where it does not fit."""
    hp = L.stream_hidden(hsz, cluster)
    res = _stream_fit(hp, cluster, rows, resident, stages,
                      lambda h, c, r, re, st: L.unrolled_stream_smem_bytes(
                          h, c, r, k, re, st, groups))
    if res is None:
        return None
    active = L._max_clusters(_STREAM_SOURCE, torch.device(device).index,
                             (k, 0, res, stages, groups), hp, cluster, rows)
    if active < 1:
        return None
    clusters = -(-batch // rows)
    return L.UnrolledStreamPlan(
        hp, cluster, rows, res, stages, clusters, active,
        -(-clusters // active),
        L.unrolled_stream_smem_bytes(hp, cluster, rows, k, res, stages,
                                     groups),
        L.unrolled_stream_step_us(hp, cluster, rows, res, stages, k, groups),
        groups)


def layer_stream_plan(hsz, batch, f, cluster, rows, resident, stages, device,
                      out_dtype=torch.bfloat16):
    """Kernel F's StreamPlan of (C, R, resident k-steps, stages) for `batch`
    rows at H = hsz and f features with the card's occupancy; None where it
    does not fit."""
    hp = L.stream_hidden(hsz, cluster)
    res = _stream_fit(hp, cluster, rows, resident, stages,
                      L.layer_stream_smem_bytes)
    if res is None:
        return None
    active = L._max_clusters(_STREAM_SOURCE, torch.device(device).index,
                             (1, int(out_dtype == torch.float32), res,
                              stages, 0), hp, cluster, rows)
    if active < 1:
        return None
    clusters = -(-batch // rows)
    return L.StreamPlan(hp, cluster, rows, res, stages, clusters, active,
                        -(-clusters // active),
                        L.layer_stream_smem_bytes(hp, cluster, rows, res,
                                                  stages),
                        L.layer_stream_step_us(hp, cluster, rows, res, stages,
                                               f))


STREAM_CHECK_E = ((8, 40, 640), (12, 33, 768), (4, 17, 1024), (4, 1, 1536))
STREAM_CHECK_F = ((7, 40, 34, 640), (5, 33, 768, 768), (6, 17, 6, 1024),
                  (3, 1, 1024, 1024))


def stream_check(device) -> int:
    """Every streamed plan of a spread (both cluster sizes where they hold
    H, 16-48 rows, no, two and the most resident k-steps, rings of 1-3
    stages, and kernel E's one and two gate groups) bit for bit against the
    single block: kernel E (K = 2 and 4) against kernel A's single block,
    kernel F (forward and reverse, fp32 out) against lstm_layer_fwd_block.
    Returns the number of failures."""
    failures = tried = 0
    spread = [(c, r, res, st) for c in L.CLUSTER_SIZES for r in (16, 32, 48)
              for res in (0, 2, None) for st in (1, 2, 3)]
    with torch.no_grad():
        for i, (t_len, b, hsz) in enumerate(STREAM_CHECK_E):
            gates, w_hh = gates_inputs(t_len, b, hsz, device, seed=400 + i)
            with L.single_block_forwards():
                want = L.lstm_scan_tm(gates, w_hh)
            for k in L.UNROLL_STEPS:
                for groups in L.UNROLL_STREAM_GROUPS:
                    for c, r, res, st in spread:
                        plan = unrolled_stream_plan(hsz, b, k, c, r, res, st,
                                                    groups, device)
                        if plan is None:
                            continue
                        tried += 1
                        got = L.lstm_scan_unrolled_planned_tm(gates, w_hh,
                                                              plan, k)
                        if not torch.equal(got, want):
                            failures += 1
                            print(f"MISMATCH unrolled T={t_len} rows={b} "
                                  f"H={hsz} K={k} {plan}", flush=True)
            print(f"stream check unrolled T={t_len} rows={b} H={hsz}",
                  flush=True)
        for i, (t_len, b, f, hsz) in enumerate(STREAM_CHECK_F):
            inputs = layer_inputs(t_len, b, f, hsz, device, seed=500 + i)
            for reverse in (False, True):
                with L.single_block_forwards():
                    want = L.lstm_layer_tm(*inputs, reverse, torch.float32)
                for c, r, res, st in spread:
                    plan = layer_stream_plan(hsz, b, f, c, r, res, st, device,
                                             torch.float32)
                    if plan is None:
                        continue
                    tried += 1
                    got = L.lstm_layer_planned_tm(*inputs, plan, reverse,
                                                  torch.float32)
                    if not torch.equal(got, want):
                        failures += 1
                        print(f"MISMATCH layer T={t_len} rows={b} F={f} "
                              f"H={hsz} reverse={reverse} {plan}", flush=True)
            print(f"stream check layer T={t_len} rows={b} F={f} H={hsz}",
                  flush=True)
    torch.cuda.synchronize()
    print(f"stream check: {tried} plans, {failures} mismatches", flush=True)
    return failures


def fit_parts(features, steps):
    """The parts (step, store, kilobyte, latency, extra) of
    stream_cluster_step_us plus one more linear term, for the measured
    steps: features (stores, streamed k-pairs, KB a k-pair, stages, extra
    term's factor). A grid over the kilobyte and latency parts, the others
    by least squares at each; the least sum of squares. Returns (parts, max
    |error|, mean |error|)."""
    f, y = np.array(features, dtype=float), np.array(steps, dtype=float)
    x = np.stack([np.ones(len(y)), f[:, 0], f[:, 4]], axis=1)
    best = None
    for kb in np.arange(0.0, 0.03, 0.0002):
        for latency in np.arange(0.0, 1.5, 0.01):
            stream = f[:, 1] * np.maximum(kb * f[:, 2], latency / f[:, 3])
            coef, *_ = np.linalg.lstsq(x, y - stream, rcond=None)
            err = x @ coef + stream - y
            if best is None or (err ** 2).sum() < best[0]:
                best = ((err ** 2).sum(), coef, kb, latency, err)
    _, coef, kb, latency, err = best
    parts = (float(coef[0]), float(coef[1]), float(kb), float(latency),
             float(coef[2]))
    return parts, float(np.abs(err).max()), float(np.abs(err).mean())


def _features(plan, extra):
    units = plan.hidden // plan.cluster
    return (plan.rows * units // 8 * (plan.cluster - 1),
            plan.hidden // 32 - plan.resident // 2, 4 * units * 64 / 1024,
            plan.stages, extra)


STREAM_T = 192                   # steps of the sweep: whole groups of 4
STREAM_SWEEP_HIDDEN = (640, 768, 1024, 1536, 2048)
STREAM_SWEEP_F = (34, None)      # kernel F's features: 34 and F = H
STREAM_FULL_ROWS = (18, 2056)


def stream_sweep(device, card: str) -> None:
    """One-cluster plans of both streamed kernels timed at T = STREAM_T
    (their microseconds a step against the models' terms, and the fit of
    the parts), then the planner's plans at 18 and 2056 rows beside the
    single blocks."""
    ex, ey, fx, fy = [], [], [], []
    spread = [(None, st) for st in L.STREAM_STAGES] + [(0, 2), (8, 2)]
    with torch.no_grad():
        for hsz in STREAM_SWEEP_HIDDEN:
            for cluster in L.CLUSTER_SIZES:
                for rows in (16, 32, 48):
                    gates, w_hh = gates_inputs(STREAM_T, rows, hsz, device,
                                               seed=hsz + rows)
                    for k in L.UNROLL_STEPS:
                        for groups in L.UNROLL_STREAM_GROUPS:
                            for res, st in spread:
                                plan = unrolled_stream_plan(
                                    hsz, rows, k, cluster, rows, res, st,
                                    groups, device)
                                if plan is None:
                                    continue
                                us = cuda_ms(
                                    lambda: L.lstm_scan_unrolled_planned_tm(
                                        gates, w_hh, plan, k),
                                    iters=3) * 1e3 / STREAM_T
                                ex.append(_features(
                                    plan, (groups == 1) / k))
                                ey.append(us)
                                print(f"unrolled stream H={hsz} K={k} "
                                      f"C={cluster} R={rows} resident="
                                      f"{plan.resident} stages={plan.stages}"
                                      f" groups={groups} smem="
                                      f"{plan.smem_bytes}: {us:.3f} us a "
                                      f"step (model {plan.step_us:.3f})",
                                      flush=True)
                    del gates
                    for f in STREAM_SWEEP_F:
                        f = f or hsz
                        inputs = layer_inputs(STREAM_T, rows, f, hsz, device,
                                              seed=hsz + rows + f)
                        for res, st in spread:
                            plan = layer_stream_plan(hsz, rows, f, cluster,
                                                     rows, res, st, device)
                            if plan is None:
                                continue
                            us = cuda_ms(lambda: L.lstm_layer_planned_tm(
                                *inputs, plan), iters=3) * 1e3 / STREAM_T
                            items = rows // 16 * (plan.hidden // cluster // 8)
                            fx.append(_features(plan, -(-f // 16) * items))
                            fy.append(us)
                            print(f"layer stream H={hsz} F={f} C={cluster} "
                                  f"R={rows} resident={plan.resident} "
                                  f"stages={plan.stages} smem="
                                  f"{plan.smem_bytes}: {us:.3f} us a step "
                                  f"(model {plan.step_us:.3f})", flush=True)
                        del inputs
        for name, x, y in (("unrolled", ex, ey), ("layer", fx, fy)):
            parts, worst, mean = fit_parts(x, y)
            print(f"{name} streamed step fit (step, store, KB, latency, "
                  f"{'group' if name == 'unrolled' else 'x k-step'}): "
                  f"{tuple(round(p, 7) for p in parts)}, off by at most "
                  f"{worst:.3f} us over {len(y)} plans, mean {mean:.3f}; on "
                  f"{card}", flush=True)
        for hsz in (768, 1536):
            for b in STREAM_FULL_ROWS:
                gates, w_hh = gates_inputs(STREAM_T, b, hsz, device, seed=b)
                for k in L.UNROLL_STEPS:
                    plan = L.card_unrolled_stream_plan(device, hsz, b, k)
                    ms = cuda_ms(lambda: L.lstm_scan_unrolled_planned_tm(
                        gates, w_hh, plan, k), iters=3)
                    block = "does not hold H"
                    if L.unrolled_block_smem_bytes(
                            hsz, L.UNROLLED_BLOCK_ROWS[-1], k) <= L.SMEM_LIMIT:
                        with L.single_block_forwards():
                            block = "%.3f ms" % cuda_ms(lambda: L.lstm_scan_tm(
                                gates, w_hh, block_t=k), iters=1)
                    print(f"unrolled H={hsz} K={k} rows={b} T={STREAM_T}: "
                          f"planner's {plan} {ms:.3f} ms "
                          f"({ms * 1e3 / STREAM_T / plan.waves:.3f} us a "
                          f"step a wave); single block {block}", flush=True)
                del gates
                for f in (34, hsz):
                    inputs = layer_inputs(STREAM_T, b, f, hsz, device, seed=f)
                    plan = L.card_layer_stream_plan(device, hsz, b, f)
                    ms = cuda_ms(lambda: L.lstm_layer_planned_tm(
                        *inputs, plan), iters=3)
                    block = "does not hold H"
                    if L.layer_block_smem_bytes(hsz, f) <= L.SMEM_LIMIT:
                        with L.single_block_forwards():
                            block = "%.3f ms" % cuda_ms(
                                lambda: L.lstm_layer_tm(*inputs), iters=1)
                    print(f"layer H={hsz} F={f} rows={b} T={STREAM_T}: "
                          f"planner's {plan} {ms:.3f} ms "
                          f"({ms * 1e3 / STREAM_T / plan.waves:.3f} us a "
                          f"step a wave); single block {block}", flush=True)
                    del inputs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="the identity at small shapes only")
    parser.add_argument("--stream", action="store_true",
                        help="the streamed clusters: identity, sweep, fit")
    parser.add_argument("--stream-check", action="store_true",
                        help="the streamed clusters' identity only")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    if args.stream or args.stream_check:
        from generative_audio_torch.ops import _cuda
        print(f"card: {card}", flush=True)
        for name, log in _cuda.build([_STREAM_SOURCE, "lstm_scan_block",
                                      "lstm_layer_block"]).items():
            for line in log.splitlines():
                if "entry function" in line or "registers" in line \
                        or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}", flush=True)
        if stream_check(device):
            return 1
        if args.stream:
            stream_sweep(device, card.splitlines()[device.index or 0])
        return 0
    failures = check(device)
    if failures:
        print(f"perf_staged_scan: {failures} plan(s) differ from the kernel "
              f"they reorganise", file=sys.stderr)
        return 1
    if not args.check:
        sweep(device, card.splitlines()[device.index or 0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
