"""The LSTM and GRU backward scans (csrc/lstm_scan_bwd.cu `lstm_scan_bwd`,
csrc/gru_scan_bwd.cu `gru_scan_bwd`) under forced launch plans, on the card.

Each backward runs as the single-block design or as a thread-block cluster
(ops.lstm.plan_bwd_scan, ops.gru.plan_bwd_scan). This script holds every
cluster plan that fits against the single-block design bit for bit (LSTM
dgates; GRU dgx, dhn and every db_hh partial) and times each plan, one
cluster alone and a full batch of them, to fit the planners' step models.

    # identity of every plan with the single block, at small shapes
    python -m generative_audio_torch.scripts.perf_bwd_scan --check
    # the identity, then the sweep at the training shapes
    python -m generative_audio_torch.scripts.perf_bwd_scan
"""
from __future__ import annotations

import argparse
import sys

import torch

from generative_audio_torch.ops import gru as G
from generative_audio_torch.ops import lstm as L
from generative_audio_torch.utils.device import cuda_ms, resolve_device

__all__ = ["plans", "lstm_inputs", "gru_inputs", "run", "check", "sweep",
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="the identity at small shapes only")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
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
