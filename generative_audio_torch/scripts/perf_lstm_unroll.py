"""K-step unrolled LSTM forward scan: kernel E (csrc/lstm_scan_staged.cu
`lstm_scan_fwd_unrolled`), the port of scripts/perf_lstm_unroll.py.

The inference scan (kernel A's thread-block cluster, bf16 out, forward)
whose x-side gates arrive K steps at a time: one thread of each CTA copies
the group's gate tiles of its columns by TMA into a ring of two groups, and
every thread waits for them once a group, so those loads leave the serial
chain. The products and the cell are kernel A's, so the output is
bit-identical. The wrapper pads H to the cluster's units; above H=512, where
no cluster holds the ring, it takes kernel E's streamed cluster
(csrc/lstm_staged_stream.cu `lstm_scan_fwd_unrolled_stream`: the W_hh^T
slice partly resident, partly streamed from L2, the gates by TMA in a ring
of one or two groups; H up to 2304 at K=2 and 2048 at K=4), bit-identical
to lstm_scan_fwd_stream, or, within single_block_forwards(), its single
block (csrc/lstm_scan_unrolled_block.cu `lstm_scan_fwd_unrolled_block`:
16, 8 or 4 rows a block), bit-identical to lstm_scan_fwd_block.

    # kernel A against K = 2 and 4 on the card (T=628, 2304 rows, H=384)
    python -m generative_audio_torch.scripts.perf_lstm_unroll
"""
from __future__ import annotations

import argparse
import sys

import torch

from generative_audio_torch.ops import lstm as L
from generative_audio_torch.utils.device import cuda_ms, resolve_device

__all__ = ["lstm_unrolled", "lstm_unrolled_reference", "ab", "main"]

# the script's sub-band layer shape
T, B, H = 628, 2304, 384
REPS, ROUNDS = 8, 3


def lstm_unrolled_reference(gates: torch.Tensor, w_hh: torch.Tensor
                            ) -> torch.Tensor:
    """Plain version of kernel E: bf16 gates [T, B, 4H], w_hh [H, 4H] -> h
    [T, B, H] bf16. Unrolling changes no arithmetic, so this is kernel A's
    plain version rounded to bf16."""
    return L.lstm_scan_reference_tm(gates, w_hh).to(torch.bfloat16)


def lstm_unrolled(gates: torch.Tensor, w_hh: torch.Tensor,
                  block_t: int = 2) -> torch.Tensor:
    """Kernel E on CUDA tensors (block_t = K steps per staged gate tile,
    2 or 4), its plain version on CPU tensors: gates [T, B, 4H], w_hh
    [H, 4H] -> h [T, B, H] bf16, forward; ops.lstm.lstm_scan_tm with
    block_t. T must be a multiple of block_t, as the script asserts."""
    return L.lstm_scan_tm(gates, w_hh, block_t=block_t)


def ab(gates: torch.Tensor, w_hh: torch.Tensor, rounds: int = ROUNDS,
       reps: int = REPS) -> dict:
    """Kernel A (K=1) against kernel E at each K on the same inputs:
    `rounds` rounds in alternating order, in each the best of `reps` single
    calls of each arm by CUDA events. -> {K: [ms per round]}."""
    ks = (1, *L.UNROLL_STEPS)
    times = {k: [] for k in ks}
    with torch.no_grad():
        for r in range(rounds):
            for k in (ks if r % 2 == 0 else ks[::-1]):
                fn = (lambda k=k: L.lstm_scan_tm(gates, w_hh, block_t=k))
                fn()
                times[k].append(min(cuda_ms(fn, iters=1, warmup=0)
                                    for _ in range(reps)))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    device = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    gates = (torch.randn(T, B, 4 * H, generator=gen, device=device) * 0.1
             ).to(torch.bfloat16)
    w_hh = torch.randn(H, 4 * H, generator=gen, device=device) * 0.05
    with torch.no_grad():
        ref = L.lstm_scan_tm(gates, w_hh)
        for k in L.UNROLL_STEPS:
            got = lstm_unrolled(gates, w_hh, block_t=k)
            err = (got.float() - ref.float()).abs().max().item()
            print(f"unroll K={k} vs lstm_scan_fwd: max|diff| = {err:.3e}",
                  flush=True)
            if err != 0.0:
                raise SystemExit(f"K={k}: output differs from lstm_scan_fwd")
    times = ab(gates, w_hh)
    base = min(times[1])
    for k, rounds in times.items():
        name = "lstm_scan_fwd (K=1)" if k == 1 else f"lstm_scan_fwd_unrolled K={k}"
        print(f"{name}: best {min(rounds):.3f} ms ({100 * (min(rounds) - base) / base:+.1f}% "
              f"vs K=1), rounds {' '.join(f'{x:.3f}' for x in rounds)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
