"""The wide cluster forwards of kernels A and B (csrc/lstm_scan_wide.cu
`lstm_scan_fwd_wide`, `lstm_scan_fwd_carry_wide`: the step's product on
warpgroup MMA) under forced launch plans, on the card.

Where a resident cluster holds W_hh's slice (H up to 512), the wrappers of
kernels A and B take the wide cluster or the resident one, whichever has the
least modelled waves x step (ops.lstm.plan_forward). This script holds both
entries, under a spread of wide plans (cluster size, rows, resident
k-steps, ring depth), against the resident cluster bit for bit, then times
plans of one cluster alone (the sweep that the wide step model,
`_WIDE_PARTS` of ops/lstm.py, is fitted to; it prints the least-squares
fit), the planner's plans at the sub-band batches beside the resident
cluster, and a clock64 trace of one step of the 8 x 10 s batch's plan
(`lstm_scan_wide_trace`: the products, the ring's waits, the cell, the
cluster barrier and the exchange), after perf_stream_scan.py.

    # identity of the plans, at small ragged shapes
    python -m generative_audio_torch.scripts.perf_wide_scan --check
    # the identity, then the sweep, the fit, the plans and the trace
    python -m generative_audio_torch.scripts.perf_wide_scan
    # the identity, then the plans and the trace
    python -m generative_audio_torch.scripts.perf_wide_scan --trace
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys

import numpy as np
import torch

from generative_audio_torch.ops import lstm as L
from generative_audio_torch.scripts.perf_stream_scan import inputs, run
from generative_audio_torch.utils.device import cuda_ms, resolve_device

__all__ = ["forced", "wide_plan", "check", "sweep", "fit_wide_parts",
           "wide_trace", "plans", "main"]

T = 195                       # the training clip's frames
SWEEP_HIDDEN = (384, 512)
SWEEP_ROWS = L.WIDE_ROWS
FULL = ((628, 257), (628, 2056))   # (T, rows): one 10 s request, 8 x 10 s
ENTRIES = ("fwd", "carry")
CHECK_SHAPES = ((6, 40, 256), (5, 33, 384), (4, 17, 512), (3, 1, 384),
                (5, 150, 384))


def wide_plan(hsz: int, batch: int, cluster: int, rows: int, resident,
              stages: int, device):
    """The WidePlan of (cluster, rows, resident k-steps, stages) for
    `batch` rows at H = hsz with the card's occupancy, resident None for
    the most that fit (all of them with no ring); None where it does not
    fit."""
    hp = L.wide_hidden(hsz, cluster)
    if rows not in L.WIDE_ROWS or hp // cluster // 16 > L._WIDE_MAX_WARPGROUPS:
        return None
    res = L._wide_resident(hp, cluster, rows, stages, resident)
    if res is None or (stages and stages > hp // 32 - res // 2):
        return None
    index = torch.device(device).index
    active = L._max_clusters("lstm_scan_wide", index, (res, stages), hp,
                             cluster, rows)
    if active < 1:
        return None
    clusters = -(-batch // rows)
    return L.WidePlan(hp, cluster, rows, res, stages, clusters, active,
                      -(-clusters // active),
                      L.wide_smem_bytes(hp, cluster, rows, res, stages),
                      L.wide_step_us(hp, cluster, rows, res, stages))


@contextlib.contextmanager
def forced(plan):
    """Within the block, kernels A and B take the wide cluster with `plan`
    (whatever the instance and the row count)."""
    saved = L.card_wide_plan
    L.card_wide_plan = lambda *args, **kwargs: plan
    try:
        with L.wide_forwards():
            yield
    finally:
        L.card_wide_plan = saved


def _spread(hsz, b, device):
    """A spread of wide plans at (hsz, b rows): both cluster sizes, 16 to 96
    rows, no ring and rings of 2-3 stages with none, two and the most
    resident k-steps."""
    for cluster in L.CLUSTER_SIZES:
        for rows in (16, 32, 48, 96):
            for resident, stages in ((None, 0), (0, 2), (2, 2), (None, 2),
                                     (None, 3)):
                plan = wide_plan(hsz, b, cluster, rows, resident, stages,
                                 device)
                if plan is not None:
                    yield plan


def check(device) -> int:
    """Both entries == the resident cluster bit for bit under each plan of
    a spread, forward and reverse, bf16 and fp32 out (the carry from a
    random state), at each (T, rows, H). Returns the number of failures."""
    failures = 0
    for t_len, b, hsz in CHECK_SHAPES:
        gates, weights, state = inputs("lstm", t_len, b, hsz, device,
                                       seed=t_len * b + hsz)
        want = {}
        with L.resident_forwards():
            for entry in ENTRIES:
                for reverse in (False, True):
                    for out_dtype in (torch.bfloat16, torch.float32):
                        want[entry, reverse, out_dtype] = run(
                            "lstm", entry, gates, weights, state, reverse,
                            out_dtype)
        tried = 0
        for plan in _spread(hsz, b, device):
            tried += 1
            with forced(plan):
                for key, res in want.items():
                    got = run("lstm", key[0], gates, weights, state, *key[1:])
                    if not all(torch.equal(x, y) for x, y in zip(got, res)):
                        failures += 1
                        print(f"MISMATCH {key} T={t_len} rows={b} H={hsz} "
                              f"{plan}", flush=True)
        torch.cuda.synchronize()
        print(f"check T={t_len} rows={b} H={hsz}: {tried} plans x "
              f"{len(want)} calls against the resident cluster", flush=True)
    print(f"check: {failures} mismatches", flush=True)
    return failures


def _features(plan):
    """wide_step_us's terms of a plan: (the CTA's wgmma products in
    thousands of m64n8k16 blocks, the cell's 8-row chunks a thread, KB
    sent, streamed k-pairs, KB a k-pair, stages)."""
    h, c, r = plan.hidden, plan.cluster, plan.rows
    units = h // c
    return (units // 16 * (r // 8) * (h // 16) / 1000, r // 8,
            r * units * 2 * (c - 1) / 1024, h // 32 - plan.resident // 2,
            units * 256 / 1024, max(plan.stages, 1))


def fit_wide_parts(features, steps):
    """wide_step_us's parts (step, CTA, cell, exchange KB, kilobyte,
    latency) for the measured steps: a grid over the kilobyte and latency
    parts, the others by least squares at each; the least sum of squares.
    Returns (parts, max |error|, mean |error|)."""
    f, y = np.array(features, dtype=float), np.array(steps, dtype=float)
    x = np.stack([np.ones(len(y)), f[:, 0], f[:, 1], f[:, 2]], axis=1)
    best = None
    for kb in np.arange(0.0, 0.03, 0.0005):
        for latency in np.arange(0.0, 1.5, 0.02):
            stream = f[:, 3] * np.maximum(kb * f[:, 4], latency / f[:, 5])
            coef, *_ = np.linalg.lstsq(x, y - stream, rcond=None)
            err = x @ coef + stream - y
            if best is None or (err ** 2).sum() < best[0]:
                best = ((err ** 2).sum(), (*coef, kb, latency), err)
    _, parts, err = best
    return (tuple(float(p) for p in parts), float(np.abs(err).max()),
            float(np.abs(err).mean()))


def _time(fn, iters=3):
    return cuda_ms(fn, iters=iters)


def sweep(device, card: str) -> None:
    """One-cluster wide plans timed at T steps (their microseconds a step
    against the model's terms), and the fit of the parts."""
    xs, ys = [], []
    for hsz in SWEEP_HIDDEN:
        for rows in SWEEP_ROWS:
            gates, weights, state = inputs("lstm", T, rows, hsz, device,
                                           seed=hsz + rows)
            for cluster in L.CLUSTER_SIZES:
                for resident, stages in ((None, 0), (None, 2), (None, 3),
                                         (None, 4), (None, 6), (0, 2)):
                    plan = wide_plan(hsz, rows, cluster, rows, resident,
                                     stages, device)
                    if plan is None:
                        continue
                    with forced(plan):
                        us = _time(lambda: run("lstm", "fwd", gates,
                                               weights, state)) * 1e3 / T
                    xs.append(_features(plan))
                    ys.append(us)
                    print(f"H={hsz} C={cluster} R={rows} "
                          f"resident={plan.resident} stages={plan.stages} "
                          f"smem={plan.smem_bytes}: {us:.3f} us a step "
                          f"(model {plan.step_us:.3f})", flush=True)
    parts, worst, mean = fit_wide_parts(xs, ys)
    print(f"wide step fit (step, CTA, cell, exchange KB, KB, latency): "
          f"{tuple(round(p, 5) for p in parts)}, off by at most {worst:.3f} "
          f"us over {len(ys)} plans, mean {mean:.3f}; on {card}", flush=True)


def wide_trace(gates, w_hh, plan):
    """One launch of lstm_scan_wide_trace (kernel A, bf16 out) under `plan`:
    the clock64 readings of the first CTA's consumer warp 0, [steps][8]
    int64 (csrc/lstm_scan_wide.cu TRACE_POINTS), and h."""
    from generative_audio_torch.ops import _cuda
    t_len, b, _ = gates.shape
    hp = plan.hidden
    out = torch.empty(t_len, b, hp, dtype=torch.bfloat16, device=gates.device)
    trace = torch.zeros(64, 8, dtype=torch.int64, device=gates.device)
    lib = _cuda.load("lstm_scan_wide")
    err = lib.lstm_scan_wide_trace(
        L._pad_gates(gates, 4, hp).data_ptr(),
        L._wide_weight(w_hh, hp, plan.cluster).data_ptr(), out.data_ptr(), 0,
        t_len, b, hp, 0, *plan.launch_args, trace.data_ptr(),
        _cuda.stream_handle(gates.device))
    _cuda.check("lstm_scan_wide", err, "lstm_scan_wide_trace")
    torch.cuda.synchronize()
    return trace.cpu(), L._unpad_units(out, w_hh.shape[0])


def print_trace(trace, us_per_step: float, t_len: int, card: str) -> None:
    """The phases of a traced step in microseconds (the SM clock scaled by
    the measured step), the mean over steps 1 .. min(T, 64) - 2: the
    products (of which the ring's waits), the CTA's barrier (the other
    warpgroups' products), the gates' wait, the cell, the cluster
    barrier's wait, the exchange (the bf16 output, the peers' slices)."""
    n = min(t_len, trace.shape[0]) - 1
    rows = trace[1:n].double()
    steps = rows[1:, 0] - rows[:-1, 0]
    scale = us_per_step / float(steps.mean())
    names = ("products", "CTA barrier", "gates' wait", "cell",
             "cluster barrier", "exchange")
    spans = {name: float((rows[:, i + 1] - rows[:, i]).mean()) * scale
             for i, name in enumerate(names)}
    spans["ring waits"] = float(rows[:, 7].mean()) * scale
    print("trace (us, mean over steps 1-%d): " % (n - 1) + ", ".join(
        f"{name} {x:.2f}" for name, x in spans.items())
        + f"; step {us_per_step:.2f}; {card}", flush=True)


def plans(device, card: str) -> None:
    """At the sub-band batches the planner's wide plan and the resident
    cluster's, each timed in turns (wide, resident, resident, wide), with
    the route plan_forward takes there; at 2056 rows the trace of a step."""
    for t_len, b in FULL:
        gates, weights, state = inputs("lstm", t_len, b, 384, device, seed=b)
        plan = L.card_wide_plan(device, 384, b)
        resident = L.card_scan_plan(device, 384, b)
        route = L._forward_route(384, b, device)[1] or "resident"

        def wide():
            with forced(plan):
                return run("lstm", "fwd", gates, weights, state)

        def res():
            with L.resident_forwards():
                return run("lstm", "fwd", gates, weights, state)

        rounds = [_time(wide), _time(res), _time(res), _time(wide)]
        wide_ms, res_ms = min(rounds[0], rounds[3]), min(rounds[1:3])
        print(f"H=384 rows={b} T={t_len}: wide {plan} {wide_ms:.3f} ms "
              f"({wide_ms * 1e3 / t_len / plan.waves:.3f} us a step a wave, "
              f"model {plan.step_us:.3f}); resident {resident} {res_ms:.3f} "
              f"ms ({res_ms * 1e3 / t_len / resident.waves:.3f} us a step a "
              f"wave, model {L.scan_step_us(384, resident.cluster, resident.rows):.3f}); "
              f"rounds {' '.join(f'{r:.3f}' for r in rounds)}; route {route}; "
              f"on {card}", flush=True)
        if b == 2056:
            trace, h = wide_trace(gates, weights[0], plan)
            with L.resident_forwards():
                want = run("lstm", "fwd", gates, weights, state)[0]
            if not torch.equal(h, want):
                raise RuntimeError("the traced kernel differs from the "
                                   "resident cluster")
            print_trace(trace, wide_ms * 1e3 / t_len / plan.waves, t_len,
                        card)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="only the identity of the plans")
    parser.add_argument("--trace", action="store_true",
                        help="the identity, the plans and the trace, no "
                             "sweep")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[torch.cuda.current_device()]
    print(f"card: {card}", flush=True)
    from generative_audio_torch.ops import _cuda
    reports = _cuda.build(["lstm_scan", "lstm_scan_wide"])
    name = None
    for line in "\n".join(reports.values()).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "wide_kernel" in line else None
        if "C75" in line or name and ("registers" in line
                                      or "spill" in line):
            print(f"ptxas {name}: {line.strip()}", flush=True)
    if check(device):
        return 1
    if not args.check:
        if not args.trace:
            sweep(device, card)
        plans(device, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
