"""The wide cluster forwards of kernels A and B (csrc/lstm_scan_wide.cu
`lstm_scan_fwd_wide`, `lstm_scan_fwd_carry_wide`: the step's product on
warpgroup MMA) and, with `--kind gru`, of the GRU forward and carry
(csrc/gru_scan_wide.cu `gru_scan_fwd_wide`, `gru_scan_fwd_carry_wide`: the
same design with a fourth gate row of zeros a unit) under forced launch
plans, on the card.

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
cluster barrier and the exchange), after perf_stream_scan.py. For the GRU
(the GRU's wide step model, `_GRU_WIDE_PARTS` of ops/gru.py, is its own
fit) the plans are timed at every row count of FullSubNet v1-GRU's paths,
sub-band (H=384) and full band (H=512), with the route's pick beside the
measured times; the trace runs `gru_scan_wide_trace`.

    # identity of the plans, at small ragged shapes
    python -m generative_audio_torch.scripts.perf_wide_scan --check
    # the identity, then the sweep, the fit, the plans and the trace
    python -m generative_audio_torch.scripts.perf_wide_scan
    # the identity, then the plans and the trace
    python -m generative_audio_torch.scripts.perf_wide_scan --trace
    # the same for the GRU's wide cluster
    python -m generative_audio_torch.scripts.perf_wide_scan --kind gru
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
# (T, rows, H) of the GRU's plans: FullSubNet v1-GRU's sub-band GRU (H=384)
# over one 10 s request, the 8 x 10 s batch, the training batch (2304 rows
# after drop_band), a rank's half of it on the band axis and the NPPC-sized
# 1024 rows; its full-band GRU (H=512) over one clip, 8 and 18.
GRU_FULL = ((628, 257, 384), (628, 2056, 384), (195, 2304, 384),
            (195, 1152, 384), (195, 1024, 384), (628, 1, 512),
            (628, 8, 512), (195, 18, 512))
# Per kind: the module's gate count, wide source, step model and card plan.
KINDS = {"lstm": (4, "lstm_scan_wide", L.wide_step_us, "card_wide_plan", L),
         "gru": (3, "gru_scan_wide", G.gru_wide_step_us,
                 "card_gru_wide_plan", G)}


def wide_plan(hsz: int, batch: int, cluster: int, rows: int, resident,
              stages: int, device, kind: str = "lstm"):
    """The WidePlan of (cluster, rows, resident k-steps, stages) for
    `batch` rows at H = hsz with the card's occupancy, resident None for
    the most that fit (all of them with no ring); None where it does not
    fit."""
    gates, source, step_us, _, _ = KINDS[kind]
    hp = L.wide_hidden(hsz, cluster)
    if rows not in L.WIDE_ROWS or hp // cluster // 16 > L._WIDE_MAX_WARPGROUPS:
        return None
    res = L._wide_resident(hp, cluster, rows, stages, resident, gates)
    if res is None or (stages and stages > hp // 32 - res // 2):
        return None
    index = torch.device(device).index
    active = L._max_clusters(source, index, (res, stages), hp, cluster, rows)
    if active < 1:
        return None
    clusters = -(-batch // rows)
    return L.WidePlan(hp, cluster, rows, res, stages, clusters, active,
                      -(-clusters // active),
                      L.wide_smem_bytes(hp, cluster, rows, res, stages,
                                        gates),
                      step_us(hp, cluster, rows, res, stages), gates)


@contextlib.contextmanager
def forced(plan):
    """Within the block, the wide entries of the plan's cell (kernels A and
    B, or the GRU's forward and carry) take the wide cluster with `plan`
    (whatever the instance and the row count)."""
    _, _, _, name, module = KINDS["lstm" if plan.gates == 4 else "gru"]
    saved = getattr(module, name)
    setattr(module, name, lambda *args, **kwargs: plan)
    try:
        with L.wide_forwards():
            yield
    finally:
        setattr(module, name, saved)


def _spread(hsz, b, device, kind="lstm"):
    """A spread of wide plans at (hsz, b rows): both cluster sizes, 16 to 96
    rows, no ring and rings of 2-3 stages with none, two and the most
    resident k-steps."""
    for cluster in L.CLUSTER_SIZES:
        for rows in (16, 32, 48, 96):
            for resident, stages in ((None, 0), (0, 2), (2, 2), (None, 2),
                                     (None, 3)):
                plan = wide_plan(hsz, b, cluster, rows, resident, stages,
                                 device, kind)
                if plan is not None:
                    yield plan


def check(device, kind: str = "lstm") -> int:
    """Both entries == the resident cluster bit for bit under each plan of
    a spread, forward and reverse, bf16 and fp32 out (the carry from a
    random state), at each (T, rows, H). Returns the number of failures."""
    failures = 0
    for t_len, b, hsz in CHECK_SHAPES:
        gates, weights, state = inputs(kind, t_len, b, hsz, device,
                                       seed=t_len * b + hsz)
        want = {}
        with L.resident_forwards():
            for entry in ENTRIES:
                for reverse in (False, True):
                    for out_dtype in (torch.bfloat16, torch.float32):
                        want[entry, reverse, out_dtype] = run(
                            kind, entry, gates, weights, state, reverse,
                            out_dtype)
        tried = 0
        for plan in _spread(hsz, b, device, kind):
            tried += 1
            with forced(plan):
                for key, res in want.items():
                    got = run(kind, key[0], gates, weights, state, *key[1:])
                    if not all(torch.equal(x, y) for x, y in zip(got, res)):
                        failures += 1
                        print(f"MISMATCH {key} T={t_len} rows={b} H={hsz} "
                              f"{plan}", flush=True)
        torch.cuda.synchronize()
        print(f"check {kind} T={t_len} rows={b} H={hsz}: {tried} plans x "
              f"{len(want)} calls against the resident cluster", flush=True)
    print(f"check {kind}: {failures} mismatches", flush=True)
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


def sweep(device, card: str, kind: str = "lstm") -> tuple:
    """One-cluster wide plans timed at T steps (their microseconds a step
    against the model's terms), and the fit of the parts; returns the
    fit (parts, max error, mean error)."""
    xs, ys = [], []
    for hsz in SWEEP_HIDDEN:
        for rows in SWEEP_ROWS:
            gates, weights, state = inputs(kind, T, rows, hsz, device,
                                           seed=hsz + rows)
            for cluster in L.CLUSTER_SIZES:
                for resident, stages in ((None, 0), (None, 2), (None, 3),
                                         (None, 4), (None, 6), (0, 2)):
                    plan = wide_plan(hsz, rows, cluster, rows, resident,
                                     stages, device, kind)
                    if plan is None:
                        continue
                    with forced(plan):
                        us = _time(lambda: run(kind, "fwd", gates,
                                               weights, state)) * 1e3 / T
                    xs.append(_features(plan))
                    ys.append(us)
                    print(f"H={hsz} C={cluster} R={rows} "
                          f"resident={plan.resident} stages={plan.stages} "
                          f"smem={plan.smem_bytes}: {us:.3f} us a step "
                          f"(model {plan.step_us:.3f})", flush=True)
    parts, worst, mean = fit_wide_parts(xs, ys)
    print(f"{kind} wide step fit (step, CTA, cell, exchange KB, KB, "
          f"latency): {tuple(round(p, 5) for p in parts)}, off by at most "
          f"{worst:.3f} us over {len(ys)} plans, mean {mean:.3f}; on {card}",
          flush=True)
    return parts, worst, mean


def wide_trace(gates, weights, plan):
    """One launch of the traced entry (lstm_scan_wide_trace, kernel A; or
    gru_scan_wide_trace, the GRU forward; bf16 out) under `plan`: the
    clock64 readings of the first CTA's consumer warp 0, [steps][8] int64
    (csrc/scan_fwd_wide.cuh TRACE_POINTS), and h."""
    from generative_audio_torch.ops import _cuda
    t_len, b, _ = gates.shape
    hp, w_hh = plan.hidden, weights[0]
    source = "lstm_scan_wide" if plan.gates == 4 else "gru_scan_wide"
    out = torch.empty(t_len, b, hp, dtype=torch.bfloat16, device=gates.device)
    trace = torch.zeros(64, 8, dtype=torch.int64, device=gates.device)
    operands = [L._pad_gates(gates, plan.gates, hp),
                L._wide_weight(w_hh, hp, plan.cluster)]
    if plan.gates == 3:                                 # b_hh
        operands.append(G._kernel_bias(weights[1], hp))
    lib = _cuda.load(source)
    err = getattr(lib, f"{source}_trace")(
        *(x.data_ptr() for x in operands), out.data_ptr(), 0, t_len, b, hp,
        0, *plan.launch_args, trace.data_ptr(),
        _cuda.stream_handle(gates.device))
    _cuda.check(source, err, f"{source}_trace")
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


def plans(device, card: str, kind: str = "lstm") -> list:
    """At the sub-band batches (for the GRU at every row count of v1's
    paths, GRU_FULL) the planner's wide plan and the resident cluster's,
    each timed in turns (wide, resident, resident, wide), with the route
    plan_forward takes there, and whether it took the faster; at 2056 rows
    the trace of a step. Returns the rows' readings."""
    _, _, _, name, M = KINDS[kind]
    shapes = (((t, b, 384) for t, b in FULL) if kind == "lstm"
              else GRU_FULL)
    out = []
    for t_len, b, hsz in shapes:
        gates, weights, state = inputs(kind, t_len, b, hsz, device, seed=b)
        plan = getattr(M, name)(device, hsz, b)
        resident = M.card_scan_plan(device, hsz, b)
        route = M._forward_route(hsz, b, device)[1] or "resident"

        def wide():
            with forced(plan):
                return run(kind, "fwd", gates, weights, state)

        def res():
            with L.resident_forwards():
                return run(kind, "fwd", gates, weights, state)

        rounds = [_time(wide), _time(res), _time(res), _time(wide)]
        wide_ms, res_ms = min(rounds[0], rounds[3]), min(rounds[1:3])
        res_model = M.scan_step_us(hsz, resident.cluster, resident.rows)
        faster = "_wide" if wide_ms < res_ms else "resident"
        print(f"{kind} H={hsz} rows={b} T={t_len}: wide {plan} {wide_ms:.3f} "
              f"ms ({wide_ms * 1e3 / t_len / plan.waves:.3f} us a step a "
              f"wave, model {plan.step_us:.3f}); resident {resident} "
              f"{res_ms:.3f} ms ({res_ms * 1e3 / t_len / resident.waves:.3f} "
              f"us a step a wave, model {res_model:.3f}); rounds "
              f"{' '.join(f'{r:.3f}' for r in rounds)}; route {route}, "
              f"faster {faster}{'' if route == faster else ' (MISPICK)'}; "
              f"on {card}", flush=True)
        out.append(dict(t=t_len, rows=b, hidden=hsz, wide_ms=wide_ms,
                        resident_ms=res_ms, route=route, faster=faster))
        if b == 2056:
            trace, h = wide_trace(gates, weights, plan)
            with L.resident_forwards():
                want = run(kind, "fwd", gates, weights, state)[0]
            if not torch.equal(h, want):
                raise RuntimeError("the traced kernel differs from the "
                                   "resident cluster")
            print_trace(trace, wide_ms * 1e3 / t_len / plan.waves, t_len,
                        card)
        del gates, weights, state
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="only the identity of the plans")
    parser.add_argument("--trace", action="store_true",
                        help="the identity, the plans and the trace, no "
                             "sweep")
    parser.add_argument("--kind", choices=tuple(KINDS), default="lstm",
                        help="kernels A and B (lstm) or the GRU forwards")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[torch.cuda.current_device()]
    print(f"card: {card}", flush=True)
    from generative_audio_torch.ops import _cuda
    reports = _cuda.build(["lstm_scan", "lstm_scan_wide"] if args.kind ==
                          "lstm" else ["gru_scan", "gru_scan_wide"])
    name = None
    for line in "\n".join(reports.values()).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "wide_kernel" in line else None
        if "C75" in line or name and ("registers" in line
                                      or "spill" in line):
            print(f"ptxas {name}: {line.strip()}", flush=True)
    if check(device, args.kind):
        return 1
    if not args.check:
        if not args.trace:
            sweep(device, card, args.kind)
        plans(device, card, args.kind)
    return 0


if __name__ == "__main__":
    sys.exit(main())
