"""Chains LSTM backward scan: kernel G (csrc/lstm_scan_bwd_chains.cu
`lstm_scan_bwd_chains`, and its single block csrc/lstm_scan_bwd.cu
`lstm_scan_bwd_chains_block`), the port of scripts/perf_lstm_chains.py.

The backward scan (kernel D) whose compute warps each carry N = 2 or 4
independent accumulator chains and run each phase for all of them before
the next: the gate derivatives, then the sends, then the dh products, the
chains' mma.sync interleaved k-step by k-step. Rows are independent and
each chain keeps kernel D's operations, so the output is bit-identical to
kernel D's.

    # A/B against kernel D on the card (T=194, 2560 rows and T=195, 2304
    # rows; H=384; 2 and 4 chains)
    python -m generative_audio_torch.scripts.perf_lstm_chains
    # every plan of kernel G == kernel D bit for bit, at small ragged shapes
    python -m generative_audio_torch.scripts.perf_lstm_chains --check
    # the identity, then every plan timed alone and at a full batch (the
    # sweep that ops.lstm's _CHAINS_PARTS are fitted to)
    python -m generative_audio_torch.scripts.perf_lstm_chains --sweep
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from generative_audio_torch.ops import lstm as L
from generative_audio_torch.utils.device import cuda_ms, resolve_device

__all__ = ["chains_bwd", "chains_bwd_reference", "make_inputs", "plans",
           "check", "sweep", "ab", "bench", "main"]

# the script's training shape of the sub-band backward
T, B, H = 194, 2560, 384
REPS, ROUNDS = 10, 3
# the shapes --check holds every plan at: (T, rows, H), ragged row counts
CHECK_SHAPES = ((6, 37, 384), (5, 40, 512), (3, 70, 384), (2, 1, 384),
                (4, 20, 16), (4, 19, 100), (3, 21, 200), (3, 33, 256))


def chains_bwd_reference(gates: torch.Tensor, h_seq: torch.Tensor,
                         c_seq: torch.Tensor, gout: torch.Tensor,
                         w_hh: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel G: the backward scan of a forward that was not
    reversed, bf16 gates [T, B, 4H], h_seq, c_seq, gout [T, B, H], w_hh
    [H, 4H] -> dgates [T, B, 4H] bf16. Chains only reorder work between rows
    and units, so this is kernel D's plain version."""
    return L.lstm_scan_bwd_reference_tm(gates, h_seq, c_seq, gout, w_hh,
                                        reverse=False)


def chains_bwd(gates: torch.Tensor, h_seq: torch.Tensor, c_seq: torch.Tensor,
               gout: torch.Tensor, w_hh: torch.Tensor,
               n_chains: int = 2) -> torch.Tensor:
    """Kernel G on CUDA tensors (n_chains = 2 or 4 chains a warp, the plan
    ops.lstm.card_chains_scan_plan picks), its plain version on CPU
    tensors: ops.lstm.lstm_scan_bwd_tm with reverse=False and n_chains."""
    return L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh,
                              n_chains=n_chains)


def make_inputs(t_len: int, b: int, hsz: int, device, seed: int = 0):
    """The script's inputs, made on `device` from a seed: bf16 gates and gout
    (unit normal), bf16 h_seq and c_seq (0.1) and a float32 w_hh (0.05)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    bf16 = torch.bfloat16
    return (normal((t_len, b, 4 * hsz), 1.0).to(bf16),
            normal((t_len, b, hsz), 0.1).to(bf16),
            normal((t_len, b, hsz), 0.1).to(bf16),
            normal((t_len, b, hsz), 1.0).to(bf16),
            normal((hsz, 4 * hsz), 0.05))


def plans(hsz: int, batch: int, n_chains: int, device) -> list:
    """Every plan of kernel G at (H padded to 16, batch) on the card
    (ops.lstm.chains_scan_plans with the card's occupancy and SMs): each
    cluster in which a warp carries all n_chains chains and whose CTA fits,
    and the single block where it holds the chains."""
    hp = -(-hsz // 16) * 16
    index = torch.device(device).index or 0
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return L.chains_scan_plans(
        hp, batch, n_chains,
        lambda c, r, resident, arrangement: L._max_clusters(
            "lstm_scan_bwd_chains", index,
            (n_chains, arrangement, int(resident)), hp, c, r), sms)[0]


def describe(plan) -> str:
    if plan.design == "block":
        return (f"single block {plan.rows} rows, {plan.clusters} blocks, "
                f"{plan.active} at once, {plan.waves} wave(s), "
                f"{plan.smem_bytes} B")
    return (f"C={plan.cluster} R={plan.rows} resident={plan.resident} "
            f"chains of {'row tiles' if plan.arrangement == 0 else 'units'}, "
            f"{plan.smem_bytes} B, {plan.clusters} clusters, {plan.active} at "
            f"once, {plan.waves} wave(s)")


def check(device, shapes=CHECK_SHAPES) -> int:
    """Every plan of kernel G, 2 and 4 chains, == kernel D (its own plan)
    bit for bit at each (T, rows, H). Returns the number of failures."""
    failures = 0
    for i, (t_len, b, hsz) in enumerate(shapes):
        inputs = make_inputs(t_len, b, hsz, device, seed=100 + i)
        want = L.lstm_scan_bwd_tm(*inputs)
        for n in L.CHAIN_COUNTS:
            for plan in plans(hsz, b, n, device):
                got = L.lstm_scan_bwd_planned_tm(*inputs, plan)
                same = torch.equal(got, want)
                failures += not same
                print(f"chains={n} T={t_len} rows={b} H={hsz} "
                      f"{describe(plan)}: == lstm_scan_bwd "
                      f"{'bitwise' if same else 'FAILED'}", flush=True)
    return failures


def sweep(device, card: str) -> list:
    """Time every plan of kernel G (2 and 4 chains) and kernel D's own plan
    at the training shapes (T=195: 2304 rows at H=384, 18 rows at H=512):
    the whole batch, and one cluster alone (rows = R). Prints one line a
    plan and returns the records (for fitting the step model)."""
    records = []
    t_len = 195
    for b, hsz in ((2304, 384), (18, 512)):
        inputs = make_inputs(t_len, b, hsz, device, seed=7)
        with L.resident_backwards():   # the cluster kernel G is built on
            d_ms = cuda_ms(lambda: L.lstm_scan_bwd_tm(*inputs), iters=3)
            d_plan = L.card_bwd_scan_plan(device, hsz, b)
            d_one = [x[:, :d_plan.rows].contiguous() for x in inputs[:4]]
            d_one_ms = cuda_ms(lambda: L.lstm_scan_bwd_tm(*d_one, inputs[4]),
                               iters=3)
        print(f"kernel D H={hsz} T={t_len} rows={b} C={d_plan.cluster} "
              f"R={d_plan.rows}: {d_ms:.3f} ms, "
              f"{1e3 * d_ms / t_len / d_plan.waves:.2f} us a step a wave; one "
              f"cluster alone {1e3 * d_one_ms / t_len:.2f} us a step on {card}",
              flush=True)
        for n in L.CHAIN_COUNTS:
            for plan in plans(hsz, b, n, device):
                ms = cuda_ms(lambda: L.lstm_scan_bwd_planned_tm(*inputs, plan),
                             iters=3)
                one = [x[:, :plan.rows].contiguous() for x in inputs[:4]]
                one_plan = next(p for p in plans(hsz, plan.rows, n, device)
                                if (p.cluster, p.rows, p.resident,
                                    p.arrangement) ==
                                (plan.cluster, plan.rows, plan.resident,
                                 plan.arrangement))
                ms_one = cuda_ms(lambda: L.lstm_scan_bwd_planned_tm(
                    *one, inputs[4], one_plan), iters=3)
                rec = dict(H=hsz, rows=b, chains=n, cluster=plan.cluster,
                           R=plan.rows, resident=plan.resident,
                           arrangement=plan.arrangement, waves=plan.waves,
                           ms=ms, us_step_wave=1e3 * ms / t_len / plan.waves,
                           one_cluster_us=1e3 * ms_one / t_len,
                           model_us=plan.step_us, kernel_d_ms=d_ms)
                records.append(rec)
                print(f"chains={n} H={hsz} T={t_len} rows={b} "
                      f"{describe(plan)}: {ms:.3f} ms (kernel D {d_ms:.3f}), "
                      f"{rec['us_step_wave']:.2f} us a step a wave (model "
                      f"{plan.step_us:.2f}); one cluster alone "
                      f"{rec['one_cluster_us']:.2f} us a step on {card}",
                      flush=True)
        del inputs
    print("SWEEP " + json.dumps(records), flush=True)
    return records


def ab(inputs, rounds: int = ROUNDS, reps: int = REPS) -> dict:
    """Kernel D against kernel G with 2 and 4 chains on the same inputs:
    `rounds` rounds in alternating order, in each the best of `reps` single
    calls of each arm by CUDA events. -> {"lstm_scan_bwd": [ms per round],
    "chains2": [...], "chains4": [...]}."""
    arms = {"lstm_scan_bwd": lambda: L.lstm_scan_bwd_tm(*inputs)}
    for n in L.CHAIN_COUNTS:
        arms[f"chains{n}"] = lambda n=n: chains_bwd(*inputs, n_chains=n)
    names = list(arms)
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            fn = arms[name]
            fn()
            times[name].append(min(cuda_ms(fn, iters=1, warmup=0)
                                   for _ in range(reps)))
    return times


def bench(device) -> dict:
    """The script's A/B on the card at its shape and at the training shape,
    each after a full-tensor identity check. Returns each arm's best time
    in ms by shape."""
    out = {}
    for t_len, b in ((T, B), (195, 2304)):
        inputs = make_inputs(t_len, b, H, device)
        want = L.lstm_scan_bwd_tm(*inputs)
        for n in L.CHAIN_COUNTS:
            got = chains_bwd(*inputs, n_chains=n)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"chains={n}: output differs from "
                                 f"lstm_scan_bwd")
            print(f"chains={n} == lstm_scan_bwd over all {want.numel()} "
                  f"outputs (T={t_len}, rows={b}, H={H}); "
                  f"{describe(L.card_chains_scan_plan(device, H, b, n))}",
                  flush=True)
        times = ab(inputs)
        base = min(times["lstm_scan_bwd"])
        for name, rounds in times.items():
            print(f"T={t_len} rows={b} {name}: best {min(rounds):.3f} ms "
                  f"({100 * (min(rounds) - base) / base:+.1f}% vs "
                  f"lstm_scan_bwd), rounds "
                  f"{' '.join(f'{x:.3f}' for x in rounds)} on "
                  f"{torch.cuda.get_device_name(device)}", flush=True)
        out[(t_len, b)] = {name: min(r) for name, r in times.items()}
        del inputs, want
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="only every plan's identity at small ragged shapes")
    ap.add_argument("--sweep", action="store_true",
                    help="the identity, then every plan timed")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    if args.check or args.sweep:
        failures = check(device)
        if failures:
            print(f"perf_lstm_chains: {failures} plan(s) differ from kernel D",
                  file=sys.stderr)
            return 1
        print("CHECK OK", flush=True)
        if args.sweep:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], check=True, capture_output=True,
                text=True).stdout.strip().splitlines()[device.index or 0]
            sweep(device, card)
    else:
        bench(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
