"""Training auxiliaries: seeding, RNG capsules, timers, status lines,
loop loaders, profiling.

The port's own copy of generative_audio_tpu/utils/auxil.py (reference:
nppc/auxil.py: run_and_profile :22, set_random_seed :40,
EncapsulatedRandomState :48, Timer :77, StatusMassages :114, LoopLoader
:124; the step-loop analogue lives in data.loader.LoopIterator).
set_random_seed seeds torch as well (its CPU and CUDA generators);
EncapsulatedRandomState guards the host generators (python random and
numpy) that drive dataset sampling; run_and_profile runs a callable under
torch.profiler (CPU and, where a card is in use, CUDA activity) with its
wall time, where the JAX module takes a jax.profiler trace.
"""
from __future__ import annotations

import random
import sys
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

__all__ = [
    "set_random_seed", "EncapsulatedRandomState", "Timer", "StatusMessages",
    "LoopLoader", "run_and_profile",
]


def set_random_seed(seed: int) -> None:
    """Seed the python, numpy and torch global generators (torch's on every
    CUDA device too). Ref auxil.py:40-45."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class EncapsulatedRandomState:
    """Scoped host-RNG state: seeds inside the block, restores the previous
    python/numpy state on exit (ref auxil.py:48-75)."""

    def __init__(self, random_seed: Optional[int] = None):
        self.random_seed = random_seed
        self._py_state = None
        self._np_state = None

    def __enter__(self):
        self._py_state = random.getstate()
        self._np_state = np.random.get_state()
        if self.random_seed is not None:
            random.seed(self.random_seed)
            np.random.seed(self.random_seed)
        return self

    def __exit__(self, *exc):
        random.setstate(self._py_state)
        np.random.set_state(self._np_state)
        return False


class Timer:
    """Interval timer: fires every `interval` seconds; bool() tests expiry
    (ref auxil.py:77-111). interval=None never fires; interval=0 always."""

    def __init__(self, interval: Optional[float], reset: bool = True):
        self.interval = interval
        self._start = time.time() if reset else -1e12

    def reset(self):
        self._start = time.time()

    def elapsed(self) -> float:
        return time.time() - self._start

    def __bool__(self) -> bool:
        if self.interval is None:
            return False
        return self.elapsed() >= self.interval


class StatusMessages:
    """Named status lines printed on update (ref auxil.py:114-122's tqdm
    status bars, stream-friendly for non-tty logs)."""

    def __init__(self, fields: Iterable[str], file=None):
        self._fields = {f: "" for f in fields}
        self._file = file or sys.stderr

    def set(self, field: str, msg: str):
        self._fields[field] = msg
        line = " | ".join(f"{k}: {v}" for k, v in self._fields.items() if v)
        print(f"\r{line}", end="", file=self._file, flush=True)

    def close(self):
        print(file=self._file)


class LoopLoader:
    """Iterate a dataloader for exactly n_steps or n_epochs
    (ref auxil.py:124-149). Alias of data.loader.LoopIterator semantics but
    importable from utils like the reference's auxil."""

    def __init__(self, dataloader, n_steps: Optional[int] = None,
                 n_epochs: Optional[int] = None):
        if (n_steps is None) == (n_epochs is None):
            raise ValueError("exactly one of n_steps/n_epochs required")
        self.dataloader = dataloader
        self.n_steps = n_steps
        self.n_epochs = n_epochs

    def __len__(self):
        if self.n_steps is not None:
            return self.n_steps
        return self.n_epochs * len(self.dataloader)

    def __iter__(self):
        if self.n_epochs is not None:
            for _ in range(self.n_epochs):
                yield from self.dataloader
            return
        remaining = self.n_steps
        while remaining > 0:
            for batch in self.dataloader:
                if remaining <= 0:
                    return
                yield batch
                remaining -= 1


def run_and_profile(fn: Callable, *args, trace_dir: Optional[str] = None,
                    log=print, **kwargs):
    """Run fn with wall-clock timing, under torch.profiler when `trace_dir`
    is given (a Chrome trace, trace.json, is written there). The time ends
    after the card has finished fn's work. Returns fn's result. Ref
    auxil.py:22-38 (line_profiler)."""
    def synchronize():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    if trace_dir is not None:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            result = fn(*args, **kwargs)
            synchronize()
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))
    else:
        result = fn(*args, **kwargs)
        synchronize()
    log(f"run_and_profile: {fn.__name__} took "
        f"{time.perf_counter() - t0:.3f}s"
        + (f" (trace -> {trace_dir})" if trace_dir else ""))
    return result
