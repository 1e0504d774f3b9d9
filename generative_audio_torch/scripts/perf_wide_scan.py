"""The wide cluster forwards of kernels A and B (csrc/lstm_scan_wide.cu
`lstm_scan_fwd_wide`, `lstm_scan_fwd_carry_wide`) under forced launch
plans, on the card.

Where a resident cluster holds W_hh's slice (H up to 512), the wrappers of
kernels A and B take the wide cluster or the resident one, whichever has the
least modelled waves x step (ops.lstm.plan_forward). This script holds both
entries, under a spread of wide plans (cluster size, rows, tiles an item,
resident k-steps, ring depth), against the resident cluster bit for bit,
then times plans of one cluster alone (the sweep that the wide step model,
`_WIDE_PARTS` of ops/lstm.py, is fitted to; it prints the least-squares fit)
and the planner's plans at the sub-band batches beside the resident
cluster, after perf_stream_scan.py.

    # identity of the plans, at small ragged shapes
    python -m generative_audio_torch.scripts.perf_wide_scan --check
    # the identity, then the sweep and the fit
    python -m generative_audio_torch.scripts.perf_wide_scan
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
           "main"]

T = 195                       # the training clip's frames
SWEEP_HIDDEN = (384, 512)
SWEEP_ROWS = (16, 32, 48, 64, 80, 96, 112, 128, 144)
FULL = ((628, 257), (628, 2056))   # (T, rows): one 10 s request, 8 x 10 s
ENTRIES = ("fwd", "carry")
CHECK_SHAPES = ((6, 40, 256), (5, 33, 384), (4, 17, 512), (3, 1, 384),
                (5, 150, 384))


def wide_plan(hsz: int, batch: int, cluster: int, rows: int, tiles: int,
              groups: int, resident, stages: int, device, instance=(0, 0)):
    """The WidePlan of (cluster, rows, tiles, groups, resident k-steps,
    stages) for
    `batch` rows at H = hsz with the card's occupancy, resident None for
    the most that fit (all of them with no ring); None where it does not
    fit."""
    hp = L.stream_hidden(hsz, cluster)
    units = hp // cluster
    if (rows % (16 * tiles) or units % (8 * groups) or units > L._WIDE_BOX
            or L.wide_items(hp, cluster, rows, tiles, groups)
            > L._WIDE_MAX_ITEMS):
        return None
    res = L._wide_resident(hp, cluster, rows, stages, resident)
    if res is None or (stages and stages > hp // 32 - res // 2):
        return None
    index = torch.device(device).index
    active = L._max_clusters("lstm_scan_wide", index,
                             (*instance, tiles, groups, res, stages), hp,
                             cluster, rows)
    if active < 1:
        return None
    clusters = -(-batch // rows)
    return L.WidePlan(hp, cluster, rows, tiles, groups, res, stages,
                      clusters, active, -(-clusters // active),
                      L.wide_smem_bytes(hp, cluster, rows, res, stages),
                      L.wide_step_us(hp, cluster, rows, tiles, groups, res,
                                     stages))


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
    rows, every item, no ring and rings of 1-3 stages with none, two and
    the most resident k-steps."""
    for cluster in L.CLUSTER_SIZES:
        for rows in (16, 32, 48, 96):
            for tiles, groups in L.WIDE_ITEMS:
                for resident, stages in ((None, 0), (0, 1), (2, 2),
                                         (None, 1), (None, 3)):
                    plan = wide_plan(hsz, b, cluster, rows, tiles, groups,
                                     resident, stages, device)
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
    """wide_step_us's terms of a plan: (the CTA's and the busiest warp's
    products in thousands, KB sent, streamed k-pairs, KB a k-pair,
    stages)."""
    h, c, r = plan.hidden, plan.cluster, plan.rows
    units = h // c
    groups, ksteps = units // 8, h // 16
    return (r // 16 * groups * 4 * ksteps / 1000,
            plan.tiles * plan.groups * 4 * ksteps / 1000,
            r * L.wide_slice_stride(units) * 2 * (c - 1) / 1024,
            h // 32 - plan.resident // 2, units * 256 / 1024,
            max(plan.stages, 1))


def fit_wide_parts(features, steps):
    """wide_step_us's parts (step, CTA, warp, exchange KB, kilobyte,
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
    against the model's terms, and the fit of the parts); then at the
    sub-band batches the planner's wide plan and the resident cluster's,
    each timed, with the route plan_forward takes there."""
    xs, ys = [], []
    for hsz in SWEEP_HIDDEN:
        for rows in SWEEP_ROWS:
            gates, weights, state = inputs("lstm", T, rows, hsz, device,
                                           seed=hsz + rows)
            for cluster in L.CLUSTER_SIZES:
                for tiles, groups in L.WIDE_ITEMS:
                    for resident, stages in ((None, 0), (None, 1), (None, 2),
                                             (None, 3), (None, 4), (0, 2)):
                        plan = wide_plan(hsz, rows, cluster, rows, tiles,
                                         groups, resident, stages, device)
                        if plan is None:
                            continue
                        with forced(plan):
                            us = _time(lambda: run("lstm", "fwd", gates,
                                                   weights, state)) * 1e3 / T
                        xs.append(_features(plan))
                        ys.append(us)
                        print(f"H={hsz} C={cluster} R={rows} item={tiles}x"
                              f"{groups} "
                              f"resident={plan.resident} stages="
                              f"{plan.stages} smem={plan.smem_bytes}: "
                              f"{us:.3f} us a step (model "
                              f"{plan.step_us:.3f})", flush=True)
    parts, worst, mean = fit_wide_parts(xs, ys)
    print(f"wide step fit (step, CTA, warp, exchange KB, KB, latency): "
          f"{tuple(round(p, 5) for p in parts)}, off by at most {worst:.3f} "
          f"us over {len(ys)} plans, mean {mean:.3f}; on {card}", flush=True)
    for t_len, b in FULL:
        gates, weights, state = inputs("lstm", t_len, b, 384, device, seed=b)
        plan = L.card_wide_plan(device, 384, b)
        resident = L.card_scan_plan(device, 384, b)
        route = L._forward_route(384, b, device)[1] or "resident"
        with forced(plan):
            wide_ms = _time(lambda: run("lstm", "fwd", gates, weights, state))
        with L.resident_forwards():
            res_ms = _time(lambda: run("lstm", "fwd", gates, weights, state))
        print(f"H=384 rows={b} T={t_len}: wide {plan} {wide_ms:.3f} ms "
              f"({wide_ms * 1e3 / t_len / plan.waves:.3f} us a step a wave, "
              f"model {plan.step_us:.3f}); resident {resident} {res_ms:.3f} "
              f"ms ({res_ms * 1e3 / t_len / resident.waves:.3f} us a step a "
              f"wave, model {L.scan_step_us(384, resident.cluster, resident.rows):.3f}); "
              f"route {route}; on {card}", flush=True)


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
    reports = _cuda.build(["lstm_scan", "lstm_scan_wide"])
    name = None
    for line in "\n".join(reports.values()).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "wide_kernel" in line else None
        if name and ("registers" in line or "spill" in line):
            print(f"ptxas {name}: {line.strip()}", flush=True)
    if check(device):
        return 1
    if not args.check:
        sweep(device, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
