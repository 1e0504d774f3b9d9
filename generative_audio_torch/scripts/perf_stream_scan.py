"""The streamed cluster forwards (csrc/lstm_scan.cu `lstm_scan_fwd_stream`,
`lstm_scan_fwd_carry_stream`, `lstm_scan_fwd_train_stream`; csrc/gru_scan.cu
`gru_scan_fwd_stream`, `gru_scan_fwd_carry_stream`) under forced launch
plans, on the card.

The wrappers take the streamed cluster where no resident cluster holds H and
its modelled time beats the single block's (ops.lstm.plan_forward). This
script holds every entry, under a spread of plans (cluster size, rows,
resident k-steps, ring depth), against the single block bit for bit, then
times plans of one cluster alone and the planner's plans at full batches
beside the single block: the sweep that the step models of the streamed
forwards (`_STREAM_PARTS` of ops/lstm.py and ops/gru.py) and of the single
blocks (`_BLOCK_PARTS`) are fitted to. It prints the least-squares fit.

    # identity of the plans, at small ragged shapes
    python -m generative_audio_torch.scripts.perf_stream_scan --check
    # the identity, then the sweep and the fit
    python -m generative_audio_torch.scripts.perf_stream_scan
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys

import numpy as np
import torch

from generative_audio_torch.ops import gru as G
from generative_audio_torch.ops import lstm as L
from generative_audio_torch.utils.device import cuda_ms, resolve_device

__all__ = ["forced", "stream_plan", "inputs", "run", "check", "sweep",
           "main"]

T = 195                       # the full-band training clip's frames
SWEEP_HIDDEN = {"lstm": (640, 768, 1024), "gru": (768, 1024)}
SWEEP_ROWS = (16, 32, 48)     # rows of the one-cluster plans
FULL_ROWS = (18, 2056)        # the full-band batch and a sub-band batch
_MODULES = {"lstm": L, "gru": G}


def stream_plan(kind: str, hsz: int, batch: int, cluster: int, rows: int,
                resident, stages: int, device, instance=None):
    """The StreamPlan of (cluster, rows, resident k-steps, stages) for
    `batch` rows at H = hsz with the card's occupancy, resident None for the
    most that fit; None where it does not fit."""
    M = _MODULES[kind]
    hp = L.stream_hidden(hsz, cluster)
    res = L._stream_resident(hp, cluster, rows, stages, M.stream_smem_bytes,
                             resident)
    if (res is None or stages > hp // 32 - res // 2
            or rows // 16 * (hp // cluster // 8) > L._STREAM_MAX_ITEMS):
        return None
    index = torch.device(device).index
    instance = instance or ((0, 0, 0) if kind == "lstm" else (0, 0))
    source = "lstm_scan" if kind == "lstm" else "gru_scan"
    active = L._max_clusters(source, index, (*instance, res, stages), hp,
                             cluster, rows, f"{source}_stream_max_clusters")
    if active < 1:
        return None
    clusters = -(-batch // rows)
    return L.StreamPlan(hp, cluster, rows, res, stages, clusters, active,
                        -(-clusters // active),
                        M.stream_smem_bytes(hp, cluster, rows, res, stages),
                        M.stream_step_us(hp, cluster, rows, res, stages))


@contextlib.contextmanager
def forced(kind: str, plan):
    """Within the block, the forward wrappers of `kind` take the streamed
    cluster with `plan` (whatever the instance and the row count)."""
    M = _MODULES[kind]
    saved = M.card_stream_plan
    M.card_stream_plan = lambda *args, **kwargs: plan
    try:
        with L.streamed_forwards(plan.resident):
            yield
    finally:
        M.card_stream_plan = saved


def inputs(kind: str, t_len: int, b: int, hsz: int, device, seed: int):
    """bf16 gates (unit normal), float32 w_hh (and b_hh for the GRU; uniform
    in +-H^-0.5) and a float32 state h0 (and c0) for the carry entries."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = 4 if kind == "lstm" else 3

    def uniform(*shape, bound=hsz ** -0.5):
        return (torch.rand(*shape, generator=gen, device=device) * 2 - 1
                ) * bound

    gates = torch.randn(t_len, b, n * hsz, generator=gen,
                        device=device).to(torch.bfloat16)
    weights = ((uniform(hsz, 4 * hsz),) if kind == "lstm"
               else (uniform(hsz, 3 * hsz), uniform(3 * hsz)))
    state = (uniform(b, hsz, bound=1.0),)
    if kind == "lstm":
        state += (torch.randn(b, hsz, generator=gen, device=device),)
    return gates, weights, state


def run(kind: str, entry: str, gates, weights, state, reverse=False,
        out_dtype=torch.bfloat16):
    """The wrapper of `entry` ("fwd", "carry" or, for the LSTM, "train") on
    the operands: its outputs as a tuple."""
    with torch.no_grad():
        if kind == "lstm":
            if entry == "fwd":
                return (L.lstm_scan_tm(gates, *weights, reverse, out_dtype),)
            if entry == "carry":
                return L.lstm_scan_carry_tm(gates, *weights, *state, reverse,
                                            out_dtype)
            return L.lstm_scan_train_tm(gates, *weights, reverse)
        if entry == "fwd":
            return (G.gru_scan_tm(gates, *weights, reverse, out_dtype),)
        return G.gru_scan_carry_tm(gates, *weights, *state, reverse,
                                   out_dtype)


ENTRIES = {"lstm": ("fwd", "carry", "train"), "gru": ("fwd", "carry")}
CHECK_SHAPES = {"lstm": ((6, 40, 256), (5, 33, 640), (4, 17, 768),
                         (3, 1, 1024)),
                "gru": ((6, 40, 256), (5, 33, 768), (3, 1, 1024))}


def check(device) -> int:
    """Every entry == the single block bit for bit under each plan of a
    spread (both cluster sizes where they split H, 16-48 rows, no, two and
    the most resident k-steps, rings of 1-3 stages), forward and reverse,
    bf16 and fp32 out (the carry from a random state), at each (T, rows,
    H). Returns the number of failures."""
    failures = 0
    for kind, shapes in CHECK_SHAPES.items():
        for t_len, b, hsz in shapes:
            gates, weights, state = inputs(kind, t_len, b, hsz, device,
                                           seed=t_len * b + hsz)
            want = {}
            with L.single_block_forwards():
                for entry in ENTRIES[kind]:
                    for reverse in (False, True):
                        for out_dtype in (torch.bfloat16, torch.float32):
                            if entry == "train" and out_dtype != torch.bfloat16:
                                continue
                            want[entry, reverse, out_dtype] = run(
                                kind, entry, gates, weights, state, reverse,
                                out_dtype)
            tried = 0
            for cluster in L.CLUSTER_SIZES:
                for rows in (16, 32, 48):
                    for resident in (0, 2, None):
                        for stages in (1, 2, 3):
                            plan = stream_plan(kind, hsz, b, cluster, rows,
                                               resident, stages, device)
                            if plan is None:
                                continue
                            tried += 1
                            with forced(kind, plan):
                                for key, blk in want.items():
                                    got = run(kind, key[0], gates, weights,
                                              state, *key[1:])
                                    if not all(torch.equal(x, y)
                                               for x, y in zip(got, blk)):
                                        failures += 1
                                        print(f"MISMATCH {kind} {key} "
                                              f"T={t_len} rows={b} H={hsz} "
                                              f"{plan}", flush=True)
            torch.cuda.synchronize()
            print(f"check {kind} T={t_len} rows={b} H={hsz}: {tried} plans "
                  f"x {len(want)} calls against the single block",
                  flush=True)
    print(f"check: {failures} mismatches", flush=True)
    return failures


def _time_plan(kind, plan, gates, weights, state):
    with forced(kind, plan):
        return cuda_ms(lambda: run(kind, "fwd", gates, weights, state),
                       iters=3)


def _block_ms(kind, gates, weights, state):
    with L.single_block_forwards():
        return cuda_ms(lambda: run(kind, "fwd", gates, weights, state),
                       iters=2)


def _features(kind, plan):
    """stream_cluster_step_us's terms of a plan: (stores, streamed k-pairs,
    KB a k-pair, stages)."""
    n = 4 if kind == "lstm" else 3
    units = plan.hidden // plan.cluster
    return (plan.rows * units // 8 * (plan.cluster - 1),
            plan.hidden // 32 - plan.resident // 2, n * units * 64 / 1024,
            plan.stages)


def fit_stream_parts(features, steps):
    """stream_cluster_step_us's parts (step, store, kilobyte, latency) for
    the measured steps: a grid over the kilobyte and latency parts (0.2 ns
    and 10 ns apart), the step and store parts by least squares at each;
    the least sum of squares. Returns (parts, max |error|, mean |error|)."""
    f, y = np.array(features, dtype=float), np.array(steps, dtype=float)
    x = np.stack([np.ones(len(y)), f[:, 0]], axis=1)
    best = None
    for kb in np.arange(0.0, 0.03, 0.0002):
        for latency in np.arange(0.0, 1.5, 0.01):
            stream = f[:, 1] * np.maximum(kb * f[:, 2], latency / f[:, 3])
            coef, *_ = np.linalg.lstsq(x, y - stream, rcond=None)
            err = x @ coef + stream - y
            if best is None or (err ** 2).sum() < best[0]:
                best = ((err ** 2).sum(), (*coef, kb, latency), err)
    _, parts, err = best
    return (tuple(float(p) for p in parts), float(np.abs(err).max()),
            float(np.abs(err).mean()))


def sweep(device, card: str) -> None:
    """Per kind: one-cluster plans timed at T steps (their microseconds a
    step against the model's terms, and the least-squares fit of the
    parts); the single block at 18 and 2056 rows (a step; the fit of its
    parts); and the planner's plan at 18 and 2056 rows beside the single
    block, with the measured time of each."""
    for kind, hiddens in SWEEP_HIDDEN.items():
        M = _MODULES[kind]
        rows_x, steps_y, block_pts = [], [], []
        for hsz in hiddens:
            for cluster in L.CLUSTER_SIZES:
                for rows in SWEEP_ROWS:
                    gates, weights, state = inputs(kind, T, rows, hsz, device,
                                                   seed=hsz + rows)
                    spread = [(None, s) for s in L.STREAM_STAGES]
                    if rows == 16:
                        spread += [(0, 4), (8, 4), (16, 4)]
                    for resident, stages in spread:
                        plan = stream_plan(kind, hsz, rows, cluster, rows,
                                           resident, stages, device)
                        if plan is None or (cluster == 8 and stages not in
                                            (2, 4)):
                            continue
                        us = _time_plan(kind, plan, gates, weights, state
                                        ) * 1e3 / T
                        rows_x.append(_features(kind, plan))
                        steps_y.append(us)
                        print(f"{kind} H={hsz} C={cluster} R={rows} "
                              f"resident={plan.resident} stages={plan.stages}"
                              f" smem={plan.smem_bytes}: {us:.3f} us a step "
                              f"(model {plan.step_us:.3f})", flush=True)
            for b in FULL_ROWS:
                gates, weights, state = inputs(kind, T, b, hsz, device,
                                               seed=hsz + b)
                hb = -(-hsz // 16) * 16
                blocks = min(-(-b // 16), L.sm_blocks(M.block_smem_bytes(hb)))
                block_us = _block_ms(kind, gates, weights, state) * 1e3 / T
                block_pts.append((hb, blocks, block_us))
                plan = M.card_stream_plan(device, hsz, b,
                                          (0, 0, 0) if kind == "lstm"
                                          else (0, 0))
                ms = _time_plan(kind, plan, gates, weights, state)
                print(f"{kind} H={hsz} rows={b} T={T}: planner's streamed "
                      f"plan {plan} {ms:.3f} ms ({ms * 1e3 / T / plan.waves:.3f}"
                      f" us a step a wave, model {plan.step_us:.3f}); single "
                      f"block {block_us * T / 1e3:.3f} ms ({block_us:.3f} us "
                      f"a step, {blocks} blocks a wave, model "
                      f"{M.block_step_us(hb, blocks):.3f})", flush=True)
        parts, worst, mean = fit_stream_parts(rows_x, steps_y)
        print(f"{kind} streamed step fit (step, store, KB, latency): "
              f"{tuple(round(p, 7) for p in parts)}, off by at most "
              f"{worst:.3f} us over {len(steps_y)} plans, mean {mean:.3f}; "
              f"on {card}", flush=True)
        n = 4 if kind == "lstm" else 3
        small = [(h, us) for h, b, us in block_pts if b <= 2]
        xb = np.array([(1.0, -(-h // 64) * (h // 16)) for h, _ in small])
        (b0, b1), *_ = np.linalg.lstsq(xb, np.array([u for _, u in small]),
                                       rcond=None)
        mb = [(us - b0) / (b * n * h * h * 2 / 1e6)
              for h, b, us in block_pts if b > 2]
        print(f"{kind} single-block step fit (step, round, MB): "
              f"({b0:.3f}, {b1:.5f}, {max(mb):.5f}); points {block_pts}",
              flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="only the identity of the plans")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[torch.cuda.current_device()]
    print(f"card: {card}", flush=True)
    from generative_audio_torch.ops import _cuda
    reports = _cuda.build(["lstm_scan", "gru_scan", "lstm_scan_block",
                           "gru_scan_block"])
    name = None
    for line in "\n".join(reports.values()).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "stream_kernel" in line else None
        if name and ("registers" in line or "spill" in line):
            print(f"ptxas {name}: {line.strip()}", flush=True)
    if check(device):
        return 1
    if not args.check:
        sweep(device, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
