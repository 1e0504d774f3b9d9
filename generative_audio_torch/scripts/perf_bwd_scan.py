"""The LSTM and GRU backward scans (csrc/lstm_scan_bwd.cu `lstm_scan_bwd`,
csrc/gru_scan_bwd.cu `gru_scan_bwd`, their streamed clusters,
csrc/scan_bwd_stream.cu `lstm_scan_bwd_stream`, `gru_scan_bwd_stream`, and
kernel D's wide cluster, csrc/lstm_scan_bwd_wide.cu `lstm_scan_bwd_wide`,
and the GRU backward's, csrc/gru_scan_bwd_wide.cu `gru_scan_bwd_wide`)
under forced launch plans, on the card.

Each backward runs as the single-block design, as a thread-block cluster
with its weight slices resident or, where no resident cluster holds H, as a
streamed cluster (ops.lstm.plan_bwd_scan, ops.gru.plan_bwd_scan). This
script holds every plan that fits against the single-block design bit for
bit (LSTM dgates; GRU dgx, dhn and every db_hh partial) and times each
plan, one cluster alone and a full batch of them, to fit the planners' step
models; with --stream it does so for a spread of streamed plans (cluster
size, rows, resident slots, ring depth, whole tile or slices) and prints the
least-squares fit of the streamed step model's parts; with --wide the same
for a spread of the wide plans of kernel D (cluster size, item, rows, both
rings' depths, resident k-steps) and of the GRU backward (cluster size,
rows, ring depth), then the planner's wide plan at the training shape
beside the resident cluster in turns, with a clock64 trace of each one's
steps, and the GRU's dW_hh
contraction (csrc/gru_scan_bwd.cu `gru_scan_bwd_dwhh`): plan_dwhh's plan
against the first design's and torch.mm, and a sweep of slice counts.

    # identity of every plan with the single block, at small shapes
    python -m generative_audio_torch.scripts.perf_bwd_scan --check
    # the identity, then the sweep at the training shapes
    python -m generative_audio_torch.scripts.perf_bwd_scan
    # the streamed plans' identity at small shapes (--stream-check), then
    # their sweep and fit (--stream)
    python -m generative_audio_torch.scripts.perf_bwd_scan --stream-check
    python -m generative_audio_torch.scripts.perf_bwd_scan --stream
    # the wide plans of kernel D and the GRU: their identity at small
    # ragged shapes (--wide-check), then their sweeps, fits, traces and
    # the GRU's contraction (--wide); --kind lstm or gru for one
    python -m generative_audio_torch.scripts.perf_bwd_scan --wide-check
    python -m generative_audio_torch.scripts.perf_bwd_scan --wide --kind gru
    # the GRU's dW_hh contraction alone (--wide --kind gru runs it too)
    python -m generative_audio_torch.scripts.perf_bwd_scan --dwhh
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from generative_audio_torch.ops import gru as G
from generative_audio_torch.ops import lstm as L
from generative_audio_torch.utils.device import cuda_ms, resolve_device

__all__ = ["plans", "lstm_inputs", "gru_inputs", "run", "check", "sweep",
           "stream_plan", "stream_plans", "check_stream", "fit_stream_parts",
           "sweep_stream", "wide_plan", "wide_plans", "check_wide",
           "fit_wide_parts", "wide_trace", "sweep_wide", "sweep_gru_wide",
           "gru_wide_plan", "gru_wide_trace", "gru_trace_spans",
           "fit_gru_wide_parts",
           "dwhh_inputs", "device_us", "dwhh_rounds", "dwhh_times",
           "main"]

# the sub-band and full-band training shapes
T, ROWS, H, FB_ROWS, FB_H = 195, 2304, 384, 18, 512
MAX_ROWS = 64          # rows per cluster the sweep tries, at most


def plans(kind: str, hsz: int, batch: int, device) -> list:
    """The single-block plan and every cluster plan (C, R <= MAX_ROWS,
    resident or not) that fits at (H, batch) on the card, each with the
    card's occupancy and the planner's modelled step."""
    M = L if kind == "lstm" else G
    source = f"{kind}_scan_bwd"
    index = torch.device(device).index
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    tiles = -(-batch // 16)
    block = (L.bwd_smem_bytes(hsz) if kind == "lstm"
             else G.bwd_block_smem_bytes(hsz))
    active = L.sm_blocks(block, sms)
    step = M.plan_bwd_scan(hsz, 1, lambda c, r, res: 0, sms).step_us
    out = [L.BwdPlan(1, 16, False, tiles, active, -(-tiles // active), block,
                     step)]
    for cluster in L.CLUSTER_SIZES:
        if hsz % (8 * cluster):
            continue
        for resident in (True, False):
            for rows in range(16, min(MAX_ROWS, 16 * tiles) + 1, 16):
                smem = M.bwd_smem_bytes_cluster(hsz, cluster, rows, resident)
                if (smem > L.SMEM_LIMIT or
                        2 * rows // 16 * (hsz // cluster // 8) > L.BWD_WARPS):
                    continue
                n = L._max_clusters(source, index, (int(resident),), hsz,
                                    cluster, rows)
                if n < 1:
                    continue
                clusters = -(-batch // rows)
                out.append(L.BwdPlan(cluster, rows, resident, clusters, n,
                                     -(-clusters // n), smem,
                                     M.bwd_step_us(hsz, cluster, rows,
                                                   resident)))
    return out


def lstm_inputs(t_len: int, b: int, hsz: int, device, seed: int):
    """bf16 gates and gout (unit normal), h_seq and c_seq from the training
    forward, and a float32 w_hh (uniform in +-H^-0.5)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w_hh = (torch.rand(hsz, 4 * hsz, generator=gen, device=device) * 2 - 1
            ) * hsz ** -0.5
    gates = torch.randn(t_len, b, 4 * hsz, generator=gen,
                        device=device).to(torch.bfloat16)
    gout = torch.randn(t_len, b, hsz, generator=gen,
                       device=device).to(torch.bfloat16)
    h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh)
    return gates, h_seq, c_seq, gout, w_hh


def gru_inputs(t_len: int, b: int, hsz: int, device, seed: int):
    """bf16 gates and gout, h_seq from the forward, float32 w_hh and b_hh."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bound = hsz ** -0.5
    w_hh = (torch.rand(hsz, 3 * hsz, generator=gen, device=device) * 2 - 1
            ) * bound
    b_hh = (torch.rand(3 * hsz, generator=gen, device=device) * 2 - 1) * bound
    gates = torch.randn(t_len, b, 3 * hsz, generator=gen,
                        device=device).to(torch.bfloat16)
    gout = torch.randn(t_len, b, hsz, generator=gen,
                       device=device).to(torch.bfloat16)
    with torch.no_grad():
        h_seq = G.gru_scan_tm(gates, w_hh, b_hh)
    return gates, h_seq, gout, w_hh, b_hh


def run(kind: str, inputs, plan, reverse: bool = False):
    """The backward under `plan`: LSTM dgates, or the GRU's (dgx, dhn,
    db_hh partials)."""
    if kind == "lstm":
        g, h_seq, c_seq, gout, w_hh = inputs
        return (L.lstm_scan_bwd_planned_tm(g, h_seq, c_seq, gout, w_hh, plan,
                                           reverse),)
    g, h_seq, gout, w_hh, b_hh = inputs
    return G.gru_scan_bwd_streams_planned_tm(g, h_seq, gout, w_hh, b_hh, plan,
                                             reverse)


def check(device, shapes=((7, 40, 384), (5, 33, 512), (1, 17, 384),
                          (6, 1, 512))) -> int:
    """Every plan of both kernels == the single block, bit for bit, forward
    and reverse, at each (T, rows, H). Returns the number of failures."""
    failures = 0
    for kind, make in (("lstm", lstm_inputs), ("gru", gru_inputs)):
        for i, (t_len, b, hsz) in enumerate(shapes):
            inputs = make(t_len, b, hsz, device, seed=100 + i)
            all_plans = plans(kind, hsz, b, device)
            for reverse in (False, True):
                want = run(kind, inputs, all_plans[0], reverse)
                for plan in all_plans[1:]:
                    got = run(kind, inputs, plan, reverse)
                    same = all(torch.equal(x, y) for x, y in zip(got, want))
                    failures += not same
                    print(f"{kind} T={t_len} rows={b} H={hsz} reverse="
                          f"{reverse} C={plan.cluster} R={plan.rows} resident="
                          f"{plan.resident}: == single block "
                          f"{'bitwise' if same else 'FAILED'}", flush=True)
    return failures


def sweep(device, card: str) -> None:
    """Time every plan at the sub-band and full-band training shapes: one
    cluster alone (rows = R) and the whole batch."""
    for kind, make in (("lstm", lstm_inputs), ("gru", gru_inputs)):
        for b, hsz in ((ROWS, H), (FB_ROWS, FB_H)):
            inputs = make(T, b, hsz, device, seed=7)
            for plan in plans(kind, hsz, b, device):
                ms = cuda_ms(lambda: run(kind, inputs, plan), iters=3)
                one = [x[:, :plan.rows].contiguous() for x in inputs[:-1]
                       if x.dim() == 3]
                rest = list(inputs[len(one):])
                one_plan = plans(kind, hsz, plan.rows, device)
                one_plan = next(p for p in one_plan if
                                (p.cluster, p.rows, p.resident) ==
                                (plan.cluster, plan.rows, plan.resident))
                ms_one = cuda_ms(lambda: run(kind, one + rest, one_plan),
                                 iters=3)
                print(f"{kind} H={hsz} T={T} rows={b} C={plan.cluster} "
                      f"R={plan.rows} resident={plan.resident} "
                      f"{plan.smem_bytes} B, {plan.clusters} clusters, "
                      f"{plan.active} at once, {plan.waves} wave(s): "
                      f"{ms:.3f} ms, {1e3 * ms / T / plan.waves:.2f} us a "
                      f"step a wave (model {plan.step_us:.2f}); one cluster "
                      f"alone {1e3 * ms_one / T:.2f} us a step on {card}",
                      flush=True)
            del inputs


# ---- the streamed clusters --------------------------------------------------

_MODULES = {"lstm": L, "gru": G}
_INPUTS = {"lstm": lstm_inputs, "gru": gru_inputs}
# (T, rows, H) of the identity: the single block holds H (LSTM up to 1024,
# GRU up to 1072) and, at 384 and 512, the resident cluster too
STREAM_CHECK = {"lstm": ((5, 40, 384), (4, 17, 512), (4, 33, 640),
                         (3, 18, 1024)),
                "gru": ((5, 40, 384), (4, 17, 512), (4, 33, 640),
                        (3, 18, 1072))}
SWEEP_STREAM_HIDDEN = (768, 1024, 1536, 2304)


def stream_plan(kind: str, hsz: int, batch: int, cluster: int, rows: int,
                resident, stages: int, tile: bool, device):
    """The BwdStreamPlan of (cluster, rows, resident slots, stages, tile)
    for `batch` rows of a layer of hsz units with the card's occupancy,
    resident None for the most that fit; None where it does not fit."""
    M = _MODULES[kind]
    n = 4 if kind == "lstm" else 3
    hp = L.stream_hidden(hsz, cluster)
    if not L.bwd_warp_items(rows // 16, hp // cluster // 8):
        return None
    res = L._bwd_stream_resident(hp, cluster, rows, stages, tile, n, resident)
    if res is None or stages > hp // 32 - res:
        return None
    index = torch.device(device).index
    active = L._card_stream_bwd_clusters(f"{kind}_scan_bwd", index)(
        hp, cluster, rows, res, stages, tile)
    if active < 1:
        return None
    clusters = -(-batch // rows)
    return L.BwdStreamPlan(hp, cluster, rows, res, stages, tile, clusters,
                           active, -(-clusters // active),
                           M.bwd_stream_smem_bytes(hp, cluster, rows, res,
                                                   stages, tile),
                           M.bwd_stream_step_us(hp, cluster, rows, res,
                                                stages, tile))


def stream_plans(kind: str, hsz: int, batch: int, device) -> list:
    """A spread of streamed plans at (H, batch): both cluster sizes, 16-48
    rows, the whole tile and the slices, rings of 1-3 stages with no, one
    and the most resident slots, each that fits."""
    out = []
    for cluster in L.CLUSTER_SIZES:
        for rows in (16, 32, 48):
            if rows > 16 * -(-batch // 16) + 16:
                break
            for tile in (True, False):
                for stages in (1, 2, 3):
                    for resident in (0, 1, None):
                        plan = stream_plan(kind, hsz, batch, cluster, rows,
                                           resident, stages, tile, device)
                        if plan is not None and plan not in out:
                            out.append(plan)
    return out


def check_stream(device, card: str = "") -> int:
    """Every streamed plan of the spread == the single block and (at H =
    384 and 512) the resident clusters bit for bit, forward and reverse, at
    each shape of STREAM_CHECK. Returns the number of failures."""
    failures = 0
    for kind, shapes in STREAM_CHECK.items():
        for i, (t_len, b, hsz) in enumerate(shapes):
            inputs = _INPUTS[kind](t_len, b, hsz, device, seed=200 + i)
            refs = [p for p in plans(kind, hsz, b, device)
                    if p.cluster == 1 or hsz <= 512]
            tried = 0
            for reverse in (False, True):
                wants = [run(kind, inputs, p, reverse) for p in refs]
                for w in wants[1:]:
                    if not all(torch.equal(x, y) for x, y in zip(w, wants[0])):
                        failures += 1
                        print(f"MISMATCH {kind} references", flush=True)
                for plan in stream_plans(kind, hsz, b, device):
                    got = run(kind, inputs, plan, reverse)
                    torch.cuda.synchronize()
                    tried += 1
                    if not all(torch.equal(x, y)
                               for x, y in zip(got, wants[0])):
                        failures += 1
                        print(f"MISMATCH {kind} T={t_len} rows={b} H={hsz} "
                              f"reverse={reverse} {plan}", flush=True)
            print(f"stream check {kind} T={t_len} rows={b} H={hsz}: {tried} "
                  f"streamed runs against {len(refs)} reference plan(s) "
                  f"{card}", flush=True)
    print(f"stream check: {failures} mismatches", flush=True)
    return failures


def _stream_features(kind, plan):
    """The terms of bwd_stream_cluster_step_us beyond the resident
    cluster's step: (remote k-steps, streamed slots, KB of both rings'
    slots, stages)."""
    n = 4 if kind == "lstm" else 3
    units = plan.hidden // plan.cluster
    return (0 if plan.tile else n * plan.hidden // 16,
            plan.hidden // 32 - plan.resident, 2 * n * units * 64 / 1024,
            plan.stages)


def fit_stream_parts(features, extra):
    """bwd_stream_cluster_step_us's stream parts (step, kilobyte, latency,
    remote) for the measured steps less the resident cluster's modelled
    step (`extra`), by least squares: the terms are linear in each part.
    Returns (parts, max |error|, mean |error|)."""
    f, y = np.array(features, dtype=float), np.array(extra, dtype=float)
    x = np.stack([np.ones(len(y)), f[:, 1] * f[:, 2], f[:, 1] / f[:, 3],
                  f[:, 0]], axis=1)
    coef, *_ = np.linalg.lstsq(x, y, rcond=None)
    err = x @ coef - y
    return (tuple(float(p) for p in coef), float(np.abs(err).max()),
            float(np.abs(err).mean()))


def sweep_stream(device, card: str) -> None:
    """Per kind: one-cluster streamed plans timed at T steps (their
    microseconds a step beside the model, and the least-squares fit of the
    stream parts), then the planner's plan at 18 rows beside the single
    block where it holds H."""
    for kind in ("lstm", "gru"):
        M = _MODULES[kind]
        n = 4 if kind == "lstm" else 3
        feats, extra = [], []
        for hsz in SWEEP_STREAM_HIDDEN:
            for rows in (16, 32):
                inputs = _INPUTS[kind](T, rows, hsz, device, seed=hsz + rows)
                for cluster in L.CLUSTER_SIZES:
                    for tile in (True, False):
                        for stages, resident in ((1, None), (2, None),
                                                 (4, None), (8, None),
                                                 (2, 0), (4, 0)):
                            plan = stream_plan(kind, hsz, rows, cluster, rows,
                                               resident, stages, tile, device)
                            if plan is None:
                                continue
                            us = cuda_ms(lambda: run(kind, inputs, plan),
                                         iters=3) * 1e3 / T
                            base = L.bwd_cluster_step_us(
                                plan.hidden, cluster, rows, True, n,
                                M._BWD_PARTS if tile else
                                (M._BWD_PARTS[0], 0.0, *M._BWD_PARTS[2:]))
                            feats.append(_stream_features(kind, plan))
                            extra.append(us - base)
                            print(f"{kind} H={hsz} C={cluster} R={rows} "
                                  f"tile={tile} resident={plan.resident} "
                                  f"stages={plan.stages} "
                                  f"smem={plan.smem_bytes}: {us:.3f} us a "
                                  f"step (model {plan.step_us:.3f})",
                                  flush=True)
                del inputs
        parts, worst, mean = fit_stream_parts(feats, extra)
        print(f"{kind} streamed backward step fit (step, KB, latency, "
              f"remote): {tuple(round(p, 5) for p in parts)}, off by at most "
              f"{worst:.3f} us over {len(extra)} plans, mean {mean:.3f}; on "
              f"{card}", flush=True)


# ---- the wide clusters: kernel D's and the GRU backward's ------------------

# (T, rows, H) of the identity: ragged row counts, T = 1, and H = 128 and
# 512, where only 1 x 2 items fit; the GRU's also at 200 rows, where its
# clusters of 128 and 192 rows (two and three warpgroups) are ragged
WIDE_CHECK = ((7, 40, 384), (6, 17, 384), (1, 17, 384), (5, 33, 512),
              (6, 100, 128))
GRU_WIDE_CHECK = WIDE_CHECK + ((4, 200, 384), (1, 200, 128))
# (H, rows) of the GRU's one-cluster sweep: each row count of its wide
# cluster at v1's sub-band width (clusters of 8, and of 16 at H padded to
# 512) and at the full band's
GRU_SWEEP = ((384, 64), (384, 128), (384, 192), (512, 64), (512, 128),
             (512, 192))


def wide_plan(hsz: int, batch: int, cluster: int, rows: int, tiles: int,
              groups: int, resident, stages: int, pieces: int, device):
    """Kernel D's BwdWidePlan of (cluster, rows, item, resident k-steps,
    stages, pieces) for `batch` rows of a layer of hsz units with the
    card's occupancy, resident None for the most that fit; None where it
    does not fit."""
    hp = L.stream_hidden(hsz, cluster)
    units = hp // cluster
    if (units // 8 % groups or units > L._BWD_WIDE_BOX or rows % (16 * tiles)
            or L.bwd_wide_items(hp, cluster, rows, tiles, groups)
            > L._BWD_WIDE_MAX_ITEMS[tiles, groups]):
        return None
    res = L._bwd_wide_resident(hp, cluster, rows, stages, pieces, resident)
    if res is None or (stages and stages > hp // 32 - res // 2):
        return None
    active = L._card_wide_bwd_clusters(torch.device(device).index)(
        hp, cluster, rows, tiles, groups, res, stages, pieces)
    if active < 1:
        return None
    clusters = -(-batch // rows)
    return L.BwdWidePlan(hp, cluster, rows, tiles, groups, res, stages, pieces,
                         clusters, active, -(-clusters // active),
                         L.bwd_wide_smem_bytes(hp, cluster, rows, res, stages,
                                               pieces),
                         L.bwd_wide_step_us(hp, cluster, rows, tiles, groups,
                                            res, stages, pieces))


def gru_wide_plan(hsz: int, batch: int, cluster: int, rows: int,
                  stages: int, device):
    """The GRU's GruBwdWidePlan of (cluster, rows, stages) for `batch` rows
    of a layer of hsz units with the card's occupancy; None where it does
    not fit."""
    hp = G.bwd_wide_hidden(hsz, cluster)
    smem = G.bwd_wide_smem_bytes(hp, cluster, rows, stages)
    if hp // cluster not in G.BWD_WIDE_UNITS or smem > L.SMEM_LIMIT:
        return None
    index = torch.device(device).index
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    active = min(L._max_clusters("gru_scan_bwd_wide", index, (stages,), hp,
                                 cluster, rows), sms // cluster)
    if active < 1:
        return None
    clusters = -(-batch // rows)
    return G.GruBwdWidePlan(hp, cluster, rows, stages, clusters, active,
                            -(-clusters // active), smem,
                            G.bwd_wide_step_us(hp, cluster, rows, stages))


def wide_plans(hsz: int, batch: int, device, rows_list=None,
               kind: str = "lstm") -> list:
    """A spread of `kind`'s wide plans at (H, batch): both cluster sizes,
    every item, rows from one item's tile up to the item's limit (or
    `rows_list`), rings of 1-4 pieces and recompute rings of none (all
    resident), 1 and 3 stages with no and the most resident k-steps, each
    that fits; for the GRU both cluster sizes, its row counts up to the
    first that holds the batch (or `rows_list`) and every ring depth of
    BWD_WIDE_STAGES that fits."""
    out = []
    if kind == "gru":
        for cluster in L.CLUSTER_SIZES:
            for rows in rows_list or [r for r in G.BWD_WIDE_ROWS
                                      if r - 64 < batch]:
                for stages in G.BWD_WIDE_STAGES:
                    plan = gru_wide_plan(hsz, batch, cluster, rows, stages,
                                         device)
                    if plan is not None:
                        out.append(plan)
        return out
    for cluster in L.CLUSTER_SIZES:
        for tiles, groups in L.BWD_WIDE_ITEMS:
            for rows in rows_list or range(16 * tiles, 16 * -(-batch // 16)
                                           + 16 * tiles, 16 * tiles):
                for pieces in (1, 2, 4):
                    for stages, resident in ((0, None), (1, None), (3, 0),
                                             (3, None)):
                        plan = wide_plan(hsz, batch, cluster, rows, tiles,
                                         groups, resident, stages, pieces,
                                         device)
                        if plan is not None and plan not in out:
                            out.append(plan)
    return out


def check_wide(device, card: str = "", kinds=("lstm", "gru")) -> int:
    """Every wide plan of the spread == the single block and the resident
    clusters bit for bit (LSTM dgates; GRU dgx, dhn and every db_hh
    partial), forward and reverse, at each shape of WIDE_CHECK, for each
    kind. Returns the number of failures."""
    failures = 0
    for kind in kinds:
        for i, (t_len, b, hsz) in enumerate(
                GRU_WIDE_CHECK if kind == "gru" else WIDE_CHECK):
            inputs = _INPUTS[kind](t_len, b, hsz, device, seed=300 + i)
            refs = plans(kind, hsz, b, device)
            tried = 0
            for reverse in (False, True):
                wants = [run(kind, inputs, p, reverse) for p in refs]
                for w in wants[1:]:
                    if not all(torch.equal(x, y) for x, y in zip(w, wants[0])):
                        failures += 1
                        print(f"MISMATCH {kind} references", flush=True)
                for plan in wide_plans(hsz, b, device, kind=kind):
                    got = run(kind, inputs, plan, reverse)
                    torch.cuda.synchronize()
                    tried += 1
                    if not all(torch.equal(x, y)
                               for x, y in zip(got, wants[0])):
                        failures += 1
                        print(f"MISMATCH {kind} T={t_len} rows={b} H={hsz} "
                              f"reverse={reverse} {plan}", flush=True)
            print(f"wide check {kind} T={t_len} rows={b} H={hsz}: {tried} "
                  f"wide runs against {len(refs)} reference plan(s) {card}",
                  flush=True)
    print(f"wide check: {failures} mismatches", flush=True)
    return failures


def _wide_features(plan):
    """The terms of kernel D's bwd_wide_cluster_step_us: (1, CTA products,
    warp products, streamed slots over their rings' depths)."""
    hp, c, r = plan.hidden, plan.cluster, plan.rows
    units, ksteps = hp // c, hp // 16
    streamed = hp // 32 - plan.resident // 2
    return (1.0, r // 16 * (units // 8) * 8 * ksteps / 1000,
            plan.tiles * plan.groups * 8 * ksteps / 1000,
            (streamed / plan.stages if streamed else 0.0)
            + 4 * hp // 64 / plan.pieces)


def fit_gru_wide_parts(plans, steps):
    """The GRU's bwd_wide_step_us parts for the measured steps of `plans`:
    for each knee of whole stages a slot serves, the least-squares fit of
    the other three (the model is linear in them there), keeping the knee
    of the least worst error. Returns (parts, max |error|, mean |error|)."""
    best = None
    for knee in range(0, 17):
        feats = [tuple(G.bwd_wide_step_us(
            p.hidden, p.cluster, p.rows, p.stages,
            (float(i == 0), float(i == 1), float(i == 2), float(knee)))
            for i in range(3)) for p in plans]
        coef, worst, mean = fit_wide_parts(feats, steps)
        if best is None or worst < best[1]:
            best = ((*coef, float(knee)), worst, mean)
    return best


def fit_wide_parts(features, steps):
    """A wide backward's step parts for the measured steps by least squares
    (the model is linear in its parts). Returns (parts, max |error|, mean
    |error|)."""
    x, y = np.array(features, dtype=float), np.array(steps, dtype=float)
    coef, *_ = np.linalg.lstsq(x, y, rcond=None)
    err = x @ coef - y
    return (tuple(float(p) for p in coef), float(np.abs(err).max()),
            float(np.abs(err).mean()))


def wide_trace(inputs, plan, reverse: bool = False):
    """One launch of lstm_scan_bwd_wide_trace under `plan` (its operands
    packed as lstm_scan_bwd_planned_tm packs them): the clock64 readings of
    the first CTA's consumer warp 0 and exchange producer, [steps][8]
    int64 (csrc/lstm_scan_bwd_wide.cu TRACE_POINTS), and the dgates."""
    from generative_audio_torch.ops import _cuda
    g, h_seq, c_seq, gout, w_hh = inputs
    t_len, b, _ = g.shape
    hp = plan.hidden
    ops = (L._pad_gates(g, 4, hp), L._pad_units(h_seq, hp),
           L._pad_units(c_seq, hp), L._pad_units(gout, hp),
           L._stream_weight(w_hh, hp, plan.cluster),
           L._stream_dh_weight(w_hh, hp, plan.cluster))
    dgates = torch.empty(t_len, b, 4 * hp, dtype=torch.bfloat16,
                         device=g.device)
    trace = torch.zeros(64, 8, dtype=torch.int64, device=g.device)
    lib = _cuda.load("lstm_scan_bwd_wide")
    err = lib.lstm_scan_bwd_wide_trace(
        *[x.data_ptr() for x in ops], dgates.data_ptr(), t_len, b, hp,
        int(reverse), *plan.launch_args, trace.data_ptr(),
        _cuda.stream_handle(g.device))
    _cuda.check("lstm_scan_bwd_wide", err, "lstm_scan_bwd_wide_trace")
    torch.cuda.synchronize()
    return trace.cpu(), dgates


def _print_trace(trace, us_per_step: float, t_len: int, card: str) -> None:
    """The phases of a traced step in microseconds (the SM clock scaled by
    the measured step): operands' wait, cell + arrive, recompute, the
    first dgates piece's wait, the rest of the second product, the
    barrier's wait; the mean over steps 1 .. min(T, 64) - 2."""
    n = min(t_len, trace.shape[0]) - 1
    rows = trace[1:n].double()
    steps = rows[1:, 0] - rows[:-1, 0]
    scale = us_per_step / float(steps.mean())
    names = ("operands' wait", "cell + arrive", "recompute",
             "first piece's wait", "second product", "barrier wait")
    spans = [rows[:, i + 1] - rows[:, i] for i in range(6)]
    exchange = rows[:, 7] - rows[:, 2]
    print("trace (us, mean over steps 1-%d): " % (n - 1) + ", ".join(
        f"{name} {float(x.mean()) * scale:.2f}" for name, x in
        zip(names, spans)) + f"; step {us_per_step:.2f}; the exchange "
        f"producer's barrier done {float(exchange.mean()) * scale:.2f} after "
        f"the cell; {card}", flush=True)


def sweep_wide(device, card: str) -> None:
    """Kernel D's one-cluster wide plans timed at T steps (their
    microseconds a step beside the model, and the least-squares fit of
    _BWD_WIDE_PARTS); then the planner's wide plan (the card's occupancy)
    at the training shape and at 2295 and 1024 rows, each in turns against
    the resident cluster (wide, resident, resident, wide), and the trace of
    the training shape's plan."""
    feats, steps = [], []
    for hsz in (H, FB_H):
        for rows in (16, 32, 48, 64, 80, 96):
            inputs = lstm_inputs(T, rows, hsz, device, seed=hsz + rows)
            for plan in wide_plans(hsz, rows, device, (rows,)):
                if plan.pieces == 1 and plan.stages == 1:
                    continue
                us = cuda_ms(lambda: run("lstm", inputs, plan),
                             iters=3) * 1e3 / T
                feats.append(_wide_features(plan))
                steps.append(us)
                print(f"wide H={hsz} C={plan.cluster} R={rows} item "
                      f"{plan.tiles}x{plan.groups} resident={plan.resident}"
                      f" stages={plan.stages} pieces={plan.pieces} "
                      f"smem={plan.smem_bytes}: {us:.3f} us a step (model "
                      f"{plan.step_us:.3f})", flush=True)
            del inputs
    parts, worst, mean = fit_wide_parts(feats, steps)
    print(f"wide backward step fit (step, CTA, warp, latency): "
          f"{tuple(round(p, 5) for p in parts)}, off by at most {worst:.3f} "
          f"us over {len(steps)} plans, mean {mean:.3f}; on {card}",
          flush=True)
    for b in (ROWS, ROWS - 9, 1024):
        inputs = lstm_inputs(T, b, H, device, seed=b)
        plan = L.card_bwd_wide_plan(device, H, b)
        with L.resident_backwards():
            res = L.card_bwd_scan_plan(device, H, b)
        rounds = [cuda_ms(lambda: run("lstm", inputs, p), iters=3)
                  for p in (plan, res, res, plan)]
        ms, ms_res = min(rounds[0], rounds[3]), min(rounds[1:3])
        print(f"wide plan at T={T} rows={b} H={H}: {plan}; {ms:.3f} ms, "
              f"{1e3 * ms / T / plan.waves:.2f} us a step a wave (model "
              f"{plan.step_us:.2f}); resident {res.cluster} x {res.rows}, "
              f"{res.waves} waves: {ms_res:.3f} ms; rounds "
              f"{' '.join(f'{r:.3f}' for r in rounds)}; on {card}",
              flush=True)
        if b == ROWS:
            trace, _ = wide_trace(inputs, plan)
            _print_trace(trace, 1e3 * ms / T / plan.waves, T, card)
            # the gate recompute hoisted out of the chain would be one
            # product of every step's h_prev with W_hh, z written in fp32:
            # a cuBLAS call of that shape (not kernel D's k order) as the
            # floor of such a pass
            h_prev = inputs[1].reshape(-1, H)
            w = inputs[4].to(torch.bfloat16)
            mm = cuda_ms(lambda: torch.mm(h_prev, w, out_dtype=torch.float32),
                         iters=3)
            print(f"a hoisted recompute's product as one torch.mm "
                  f"[{h_prev.shape[0]}, {H}] x [{H}, {4 * H}], fp32 out: "
                  f"{mm:.3f} ms, z {h_prev.shape[0] * 4 * H * 4 / 1e9:.2f} GB "
                  f"written and read back; on {card}", flush=True)
        del inputs


def gru_wide_trace(inputs, plan, reverse: bool = False):
    """One launch of gru_scan_bwd_wide_trace under `plan` (its operands
    packed as gru_scan_bwd_streams_planned_tm packs them): the clock64
    readings of the first CTA's consumer warp 0, [steps][8] int64
    (csrc/gru_scan_bwd_wide.cu BWD_TRACE_POINTS), and dgx."""
    from generative_audio_torch.ops import _cuda
    g, h_seq, gout, w_hh, b_hh = inputs
    t_len, b, _ = g.shape
    hp = plan.hidden
    ops = (L._pad_gates(g, 3, hp), L._pad_units(h_seq, hp),
           L._pad_units(gout, hp), *G._wide_bwd_weights(w_hh, hp, plan.cluster),
           G._kernel_bias(b_hh, hp))
    dgx = torch.empty(t_len, b, 3 * hp, dtype=torch.bfloat16, device=g.device)
    dhn = torch.empty(t_len, b, hp, dtype=torch.bfloat16, device=g.device)
    dbhh = torch.empty(-(-b // 16), 3 * hp, device=g.device)
    trace = torch.zeros(64, 8, dtype=torch.int64, device=g.device)
    lib = _cuda.load("gru_scan_bwd_wide")
    err = lib.gru_scan_bwd_wide_trace(
        *[x.data_ptr() for x in ops], dgx.data_ptr(), dhn.data_ptr(),
        dbhh.data_ptr(), dbhh.shape[0], t_len, b, hp, int(reverse),
        *plan.launch_args, trace.data_ptr(), _cuda.stream_handle(g.device))
    _cuda.check("gru_scan_bwd_wide", err, "gru_scan_bwd_wide_trace")
    torch.cuda.synchronize()
    return trace.cpu(), dgx


def gru_trace_spans(trace, us_per_step: float, t_len: int) -> dict:
    """The phases of the GRU wide backward's traced step in microseconds
    (the SM clock scaled by the measured step), the mean over steps 1 ..
    min(T, 64) - 2: the cell operands' wait, the cell and the barrier's
    arrive, the recompute's issue (its boxes waited for), the first dgh
    piece's wait, the rest of the second product, the barrier's wait, and
    the clocks the step waited for ring slots."""
    n = min(t_len, trace.shape[0]) - 1
    rows = trace[1:n].double()
    steps = rows[1:, 0] - rows[:-1, 0]
    scale = us_per_step / float(steps.mean())
    names = ("operands' wait", "cell + arrive", "recompute issue",
             "first piece's wait", "second product", "barrier wait")
    out = {name: float((rows[:, i + 1] - rows[:, i]).mean()) * scale
           for i, name in enumerate(names)}
    out["ring waits"] = float(rows[:, 7].mean()) * scale
    return out


def sweep_gru_wide(device, card: str) -> None:
    """The GRU backward's wide cluster: one-cluster plans of GRU_SWEEP (every
    ring that fits, both cluster sizes) timed at T steps beside the model,
    the least-squares fit of its parts (ops/gru.py _BWD_WIDE_PARTS), then
    the planner's plan at the training shape, 2295, 1152 and 1024 rows in
    turns against the resident cluster (wide, resident, resident, wide),
    and the clock64 trace of the training shape's plan."""
    swept, steps = [], []
    for hsz, rows in GRU_SWEEP:
        inputs = gru_inputs(T, rows, hsz, device, seed=hsz + rows)
        for plan in wide_plans(hsz, rows, device, (rows,), "gru"):
            us = cuda_ms(lambda: run("gru", inputs, plan), iters=3) * 1e3 / T
            swept.append(plan)
            steps.append(us)
            print(f"gru wide H={plan.hidden} C={plan.cluster} R={rows} "
                  f"stages={plan.stages} smem={plan.smem_bytes}: {us:.3f} us "
                  f"a step (model {plan.step_us:.3f})", flush=True)
        del inputs
    parts, worst, mean = fit_gru_wide_parts(swept, steps)
    print(f"gru wide backward step fit (step, CTA, latency, knee): "
          f"{tuple(round(p, 5) for p in parts)}, off by at most {worst:.3f} "
          f"us over {len(steps)} plans, mean {mean:.3f}; on {card}",
          flush=True)
    for b in (ROWS, ROWS - 9, ROWS // 2, 1024):
        inputs = gru_inputs(T, b, H, device, seed=b)
        plan = G.card_bwd_wide_plan(device, H, b)
        with L.resident_backwards():
            res = G.card_bwd_scan_plan(device, H, b)
        rounds = [cuda_ms(lambda: run("gru", inputs, p), iters=3)
                  for p in (plan, res, res, plan)]
        ms, ms_res = min(rounds[0], rounds[3]), min(rounds[1:3])
        print(f"gru wide plan at T={T} rows={b} H={H}: {plan}; {ms:.3f} ms, "
              f"{1e3 * ms / T / plan.waves:.2f} us a step a wave (model "
              f"{plan.step_us:.2f}); resident {res.cluster} x {res.rows}, "
              f"{res.waves} waves: {ms_res:.3f} ms; rounds "
              f"{' '.join(f'{r:.3f}' for r in rounds)}; route "
              f"{G.card_bwd_scan_plan(device, H, b).design}; on {card}",
              flush=True)
        if b == ROWS:
            trace, dgx = gru_wide_trace(inputs, plan)
            want = run("gru", inputs, plan)[0]
            spans = gru_trace_spans(trace, 1e3 * ms / T / plan.waves, T)
            print("gru wide trace (us, mean over steps 1-62): " + ", ".join(
                f"{k} {v:.2f}" for k, v in spans.items()) + f"; step "
                f"{1e3 * ms / T / plan.waves:.2f}; the traced launch's dgx "
                f"== the untraced one's: {torch.equal(dgx, want)}; {card}",
                flush=True)
        del inputs


# (H, N) of the contraction: the sub-band training layer's shifted rows
# (194 x 2304) and the full band's (194 x 18)
DWHH_SHAPES = ((H, (T - 1) * ROWS), (FB_H, (T - 1) * FB_ROWS))


def dwhh_inputs(n: int, hsz: int, device, seed: int):
    """bf16 h_prev [n, H], dgx [n, 3H], dhn [n, H] (unit normal)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(n, k * hsz, generator=gen, device=device).to(
        torch.bfloat16) for k in (1, 3, 1))


def device_us(fn, n: int = 20) -> float:
    """Microseconds of device time a call of fn (every kernel it launches,
    by torch.profiler), over n calls after one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / n


def dwhh_rounds(device, hsz: int, n: int, seed: int) -> dict:
    """The contraction over n rows at H = hsz (dwhh_inputs of `seed`):
    plan_dwhh's plan for the card's SMs (`new`), the first design's
    (`first`, plan_dwhh_first) and one fp32-output torch.mm of the same
    product (`mm`) in turns (new, first, mm, mm, first, new) by CUDA events
    (`times` in `order`, `best` of each), and by the profiler's device
    time (`device_us`); the new plan twice (`repeats`: bit for bit);
    |new - x| / |x| for x the first design's, torch.mm's and the plain
    version's results (`rel`), and the plain version's time
    (`plain_ms`)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    h_prev, dgx, dhn = dwhh_inputs(n, hsz, device, seed)
    dg = torch.cat([dgx[:, :2 * hsz], dhn], dim=-1)
    new, first = G.plan_dwhh(n, hsz, sms), G.plan_dwhh_first(n, hsz)
    calls = {"new": lambda: G.gru_dwhh(h_prev, dgx, dhn, new),
             "first": lambda: G.gru_dwhh(h_prev, dgx, dhn, first),
             "mm": lambda: torch.mm(h_prev.t(), dg, out_dtype=torch.float32)}
    order = ("new", "first", "mm", "mm", "first", "new")
    times = [cuda_ms(calls[k], iters=10) for k in order]
    best = {k: min(t for o, t in zip(order, times) if o == k) for k in calls}
    a, b = calls["new"](), calls["new"]()
    others = {"first": calls["first"](), "mm": calls["mm"](),
              "plain": G.gru_dwhh_reference(h_prev, dgx, dhn)}
    plain_ms = cuda_ms(lambda: G.gru_dwhh_reference(h_prev, dgx, dhn),
                       iters=2)
    torch.cuda.synchronize()
    rel = {k: ((a - x).norm() / x.norm()).item() for k, x in others.items()}
    return dict(new=new, first=first, order=order, times=times, best=best,
                device_us={k: device_us(f) for k, f in calls.items()},
                repeats=torch.equal(a, b), rel=rel, plain_ms=plain_ms)


def dwhh_times(device, card: str) -> None:
    """The dW_hh contraction at DWHH_SHAPES: dwhh_rounds (the two designs
    and torch.mm in turns, events and device time, two runs bit for bit,
    the differences), then every slice count up to two waves (the narrow
    tiles one slice fewer) timed beside dwhh_us, and the fit of its
    stage's parts (ops/gru.py _DW_STAGE_US from the run of fewest CTAs,
    _DW_SHARED_US and _DW_FREE_CTAS a line through the excess of a stage
    over the runs of one wave at H = 384 and at least a third of the
    SMs)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    runs = []             # (N, working CTAs, microseconds a stage)
    for hsz, n in DWHH_SHAPES:
        r = dwhh_rounds(device, hsz, n, seed=n)
        rounds = " ".join(f"{o} {t:.4f}" for o, t in zip(r["order"],
                                                         r["times"]))
        print(f"dW_hh H={hsz} N={n}: new {r['new']} {r['best']['new']:.4f} "
              f"ms; first design {r['first']} {r['best']['first']:.4f} ms; "
              f"torch.mm fp32 out {r['best']['mm']:.4f} ms; device time "
              f"(profiler) new {r['device_us']['new']:.2f} us, first "
              f"{r['device_us']['first']:.2f}, torch.mm "
              f"{r['device_us']['mm']:.2f}; rounds {rounds}; two runs bit "
              f"for bit: {r['repeats']}; |new - x| / |x|: "
              f"first {r['rel']['first']:.3e}, torch.mm {r['rel']['mm']:.3e}"
              f", plain {r['rel']['plain']:.3e}; on {card}", flush=True)
        h_prev, dgx, dhn = dwhh_inputs(n, hsz, device, seed=n)
        full, narrow, share = G._dwhh_tiles(hsz)
        for slices in range(1, 2 * sms // (full + narrow) + 1):
            plan = G.DwhhPlan(full + narrow, slices, G._dwhh_rows(n, slices),
                              narrow, max(1, slices - 1) if narrow else 0,
                              G._dwhh_rows(n, max(1, slices - 1)), 1)
            if plan.rows_per_slice * (slices - 1) >= n:
                continue
            ms = cuda_ms(lambda: G.gru_dwhh(h_prev, dgx, dhn, plan), iters=5)
            us = G.dwhh_us(n, hsz, slices, plan.narrow_slices, sms)
            working = full * slices + narrow * plan.narrow_slices
            run = max(plan.rows_per_slice // 64 if full else 0,
                      plan.narrow_rows // 64 * share if narrow else 0)
            if working <= sms:
                runs.append((n, working, 1e3 * ms / run))
            print(f"dW_hh H={hsz} N={n} slices {slices} (narrow "
                  f"{plan.narrow_slices}), {working} CTAs on {sms} SMs: "
                  f"{ms:.4f} ms (model {us / 1e3:.4f}); on {card}",
                  flush=True)
        del h_prev, dgx, dhn
    sub = DWHH_SHAPES[0][1]
    fewest = min(w for n, w, _ in runs if n == sub)
    base = next(st for n, w, st in runs if n == sub and w == fewest)
    pts = [(w, st - base) for n, w, st in runs if n == sub and w >= sms / 3]
    x = np.array([(w, 1.0) for w, _ in pts], dtype=float)
    y = np.array([e for _, e in pts], dtype=float)
    (slope, icept), *_ = np.linalg.lstsq(x, y, rcond=None)
    err = x @ np.array([slope, icept]) - y
    print(f"dW_hh stage fit (stage us, us a CTA above the knee, knee): "
          f"({base:.4f}, {float(slope):.6f}, {float(-icept / slope):.1f}), "
          f"off by at most {float(np.abs(err).max()):.4f} us a stage over "
          f"{len(y)} runs; on {card}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="the identity at small shapes only")
    parser.add_argument("--stream-check", action="store_true",
                        help="the streamed plans' identity only")
    parser.add_argument("--stream", action="store_true",
                        help="the streamed plans' identity, sweep and fit")
    parser.add_argument("--wide-check", action="store_true",
                        help="the wide plans' identity only")
    parser.add_argument("--wide", action="store_true",
                        help="the wide plans' identity, sweep and fit (and "
                             "kernel D's trace, the GRU's contraction)")
    parser.add_argument("--dwhh", action="store_true",
                        help="the GRU's dW_hh contraction alone: its designs "
                             "against torch.mm and every slice count")
    parser.add_argument("--kind", choices=("lstm", "gru", "both"),
                        default="both",
                        help="the wide backward(s) --wide and --wide-check "
                             "take: kernel D's, the GRU's or both")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    if args.dwhh:
        dwhh_times(device, card.splitlines()[device.index or 0])
        return 0
    if args.wide_check or args.wide:
        kinds = ("lstm", "gru") if args.kind == "both" else (args.kind,)
        failures = check_wide(device, card, kinds)
        if failures:
            print(f"perf_bwd_scan: {failures} wide plan(s) differ",
                  file=sys.stderr)
            return 1
        if args.wide:
            card = card.splitlines()[device.index or 0]
            if "lstm" in kinds:
                sweep_wide(device, card)
            if "gru" in kinds:
                sweep_gru_wide(device, card)
                dwhh_times(device, card)
        return 0
    if args.stream_check or args.stream:
        failures = check_stream(device, card)
        if failures:
            print(f"perf_bwd_scan: {failures} streamed plan(s) differ",
                  file=sys.stderr)
            return 1
        if args.stream:
            sweep_stream(device, card.splitlines()[device.index or 0])
        return 0
    failures = check(device)
    if failures:
        print(f"perf_bwd_scan: {failures} plan(s) differ from the single "
              f"block", file=sys.stderr)
        return 1
    if not args.check:
        sweep(device, card.splitlines()[device.index or 0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
