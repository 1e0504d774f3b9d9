"""Chains-within-block LSTM backward scan: kernel G (csrc/lstm_scan_bwd.cu
`lstm_scan_bwd_chains`), the port of scripts/perf_lstm_chains.py.

The backward scan (kernel D) with each block split into independent
16-row chains whose phases run together: all gate-recompute products, then
all gate derivatives, then all dh products. Each B fragment of W_hh that a
warp reads from L2 feeds every chain's product. Rows are independent, so
the output is bit-identical to kernel D's.

    # A/B against kernel D on the card (T=194, 2560 rows, H=384)
    python -m generative_audio_torch.scripts.perf_lstm_chains
    # the identity alone on the card, at a small ragged shape
    python -m generative_audio_torch.scripts.perf_lstm_chains --check
"""
from __future__ import annotations

import argparse
import sys

import torch

from generative_audio_torch.ops import lstm as L
from generative_audio_torch.utils.device import cuda_ms, resolve_device

__all__ = ["chains_bwd", "chains_bwd_reference", "make_inputs", "check",
           "ab", "bench", "main"]

# the script's training shape of the sub-band backward
T, B, H = 194, 2560, 384
REPS, ROUNDS = 10, 3


def chains_bwd_reference(gates: torch.Tensor, h_seq: torch.Tensor,
                         c_seq: torch.Tensor, gout: torch.Tensor,
                         w_hh: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel G: the backward scan of a forward that was not
    reversed, bf16 gates [T, B, 4H], h_seq, c_seq, gout [T, B, H], w_hh
    [H, 4H] -> dgates [T, B, 4H] bf16. Chains only reorder work between rows,
    so this is kernel D's plain version."""
    return L.lstm_scan_bwd_reference_tm(gates, h_seq, c_seq, gout, w_hh,
                                        reverse=False)


def chains_bwd(gates: torch.Tensor, h_seq: torch.Tensor, c_seq: torch.Tensor,
               gout: torch.Tensor, w_hh: torch.Tensor,
               n_chains: int = 2) -> torch.Tensor:
    """Kernel G on CUDA tensors (n_chains 2 or 4 chains of 16 rows per
    block), its plain version on CPU tensors: ops.lstm.lstm_scan_bwd_tm with
    reverse=False and n_chains."""
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


def check(device, t_len: int = 6, b: int = 37, hsz: int = 16) -> None:
    """Kernel G == kernel D bit for bit at a small ragged shape."""
    inputs = make_inputs(t_len, b, hsz, device, seed=1)
    want = L.lstm_scan_bwd_tm(*inputs)
    for n in L.CHAIN_COUNTS:
        same = torch.equal(chains_bwd(*inputs, n_chains=n), want)
        print(f"chains={n} T={t_len} rows={b} H={hsz}: bit-identical to "
              f"lstm_scan_bwd = {same}", flush=True)
        if not same:
            raise SystemExit(f"chains={n}: output differs from lstm_scan_bwd")
    print("CHECK OK", flush=True)


def ab(inputs, rounds: int = ROUNDS, reps: int = REPS) -> dict:
    """Kernel D against kernel G with 2 chains (4 do not fit at H=384) on the
    same inputs: `rounds` alternating rounds, in each the best of `reps`
    single calls of each arm by CUDA events. -> {"lstm_scan_bwd": [ms per
    round], "chains2": [ms per round]}."""
    arms = {"lstm_scan_bwd": lambda: L.lstm_scan_bwd_tm(*inputs),
            "chains2": lambda: chains_bwd(*inputs, n_chains=2)}
    times = {name: [] for name in arms}
    for _ in range(rounds):
        for name, fn in arms.items():
            fn()
            times[name].append(min(cuda_ms(fn, iters=1, warmup=0)
                                   for _ in range(reps)))
    return times


def bench(device) -> dict:
    """The script's A/B on the card at its shape, after a full-tensor
    identity check. Returns each arm's best time in ms."""
    inputs = make_inputs(T, B, H, device)
    want = L.lstm_scan_bwd_tm(*inputs)
    got = chains_bwd(*inputs, n_chains=2)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit("chains=2: output differs from lstm_scan_bwd")
    print(f"chains=2 == lstm_scan_bwd over all {want.numel()} outputs "
          f"(T={T}, rows={B}, H={H})", flush=True)
    times = ab(inputs)
    base = min(times["lstm_scan_bwd"])
    for name, rounds in times.items():
        print(f"{name}: best {min(rounds):.3f} ms ({100 * (min(rounds) - base) / base:+.1f}% "
              f"vs lstm_scan_bwd), rounds {' '.join(f'{x:.3f}' for x in rounds)} "
              f"on {torch.cuda.get_device_name(device)}", flush=True)
    return {name: min(rounds) for name, rounds in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="only the identity at a small ragged shape")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    if args.check:
        check(device)
    else:
        bench(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
