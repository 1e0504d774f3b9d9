"""Start an N-process torch.distributed job on this machine: the reference's
mp.spawn launcher (tools/train.py:85-120), the counterpart of
generative_audio_tpu/cli/launch.py:35-107.

    python -m generative_audio_torch.cli.launch --nprocs 2 --backend gloo \
        -- python -m generative_audio_torch.cli.train -C cfg.yaml --device cpu

Each of the N copies of the command gets the GAT_* environment that
parallel.distributed.initialize() reads: rank 0's rendezvous address, the
world size, its rank, the backend, and how many ranks share a card.
OMP_NUM_THREADS is 1 in the children unless the caller set it. An NCCL job
takes one card per rank; `--ranks-per-device K` lets K ranks share a card,
in a gloo job only (the counterpart of the JAX launcher's
--devices-per-process, which gives each process K virtual devices).

Fail-fast: on the first rank that exits non-zero the others are terminated
by handle, and the launcher returns that rank's code, shell-style (128 + N
for a rank killed by signal N).
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

__all__ = ["main"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Spawn an N-process torch.distributed job on this host")
    parser.add_argument("--nprocs", type=int, required=True)
    parser.add_argument("--port", type=int, default=None,
                        help="rendezvous port (default: pick a free one)")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                        help="default: nccl where CUDA is available, else "
                             "gloo")
    parser.add_argument("--ranks-per-device", type=int, default=1,
                        help="ranks that share one card (gloo only)")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="command to run in each process (after --)")
    args = parser.parse_args(argv)

    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        parser.error("no command given (append it after --)")
    if args.ranks_per_device < 1:
        parser.error("--ranks-per-device must be at least 1")
    if args.ranks_per_device > 1 and args.backend != "gloo":
        parser.error("ranks share a card only in a gloo job: NCCL takes one "
                     "card per rank (--backend gloo)")

    coordinator = f"127.0.0.1:{args.port or _free_port()}"
    # Spawn and wait inside one try/finally: if a spawn fails midway, the
    # ranks already started would otherwise wait for a world that never
    # assembles.
    procs = []
    first_bad = 0
    try:
        for rank in range(args.nprocs):
            env = dict(os.environ)
            env["GAT_COORDINATOR"] = coordinator
            env["GAT_NUM_PROCESSES"] = str(args.nprocs)
            env["GAT_PROCESS_ID"] = str(rank)
            env["GAT_RANKS_PER_DEVICE"] = str(args.ranks_per_device)
            if args.backend:
                env["GAT_BACKEND"] = args.backend
            env.setdefault("OMP_NUM_THREADS", "1")
            procs.append(subprocess.Popen(command, env=env))

        # on the first non-zero exit, terminate the rest by handle (never by
        # process name), so that one failed rank does not leave the others
        # waiting in a collective
        pending = list(procs)
        while pending:
            for p in list(pending):
                if p.poll() is not None:
                    pending.remove(p)
                    if p.returncode != 0 and first_bad == 0:
                        first_bad = p.returncode
                        for q in pending:
                            q.terminate()
            if pending:
                time.sleep(0.1)
        rc = first_bad if first_bad >= 0 else 128 - first_bad
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
    return rc


if __name__ == "__main__":
    sys.exit(main())
