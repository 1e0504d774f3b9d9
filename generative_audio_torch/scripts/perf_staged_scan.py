"""The staged LSTM scans (csrc/lstm_scan_staged.cu: kernel E
`lstm_scan_fwd_unrolled`, kernel F `lstm_layer_fwd`) under forced launch
plans, on the card.

Both run as thread-block clusters whose shape the planners choose
(ops.lstm.plan_unrolled and plan_layer). This script holds every plan that
fits against the kernel it must equal bit for bit (kernel E: kernel A,
`lstm_scan_fwd`; kernel F: its single block, `lstm_layer_fwd_block`, the
first design of kernel F) and times each plan, one cluster alone and a full
batch of them, to fit the planners' step models.

    # identity of every plan, at small ragged shapes
    python -m generative_audio_torch.scripts.perf_staged_scan --check
    # the identity, then the sweep at the scripts' and sub-band shapes
    python -m generative_audio_torch.scripts.perf_staged_scan
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from generative_audio_torch.ops import lstm as L
from generative_audio_torch.utils.device import cuda_ms, resolve_device

__all__ = ["unrolled_plans", "layer_plans", "gates_inputs", "layer_inputs",
           "check", "sweep", "main"]

# kernel E at perf_lstm_unroll's shape, kernel F at FullSubNet+'s sub-band
# layers (one batch of 8 x 10 s)
T, ROWS_E, ROWS_F, H = 628, 2304, 2056, 384
SUB_BAND_F = (34, 384)
MAX_ROWS = 96          # rows per cluster the sweep tries, at most
_SOURCE = "lstm_scan_staged"


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="the identity at small shapes only")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
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
