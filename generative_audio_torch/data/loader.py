"""Host-side batch loader feeding the training step.

The port's own copy of generative_audio_tpu/data/loader.py:22-149
(BatchLoader, LoopIterator; they replace the reference's torch DataLoader +
DistributedSampler): thread-pool decode workers (audio decode is numpy and
scipy, and the native decoder releases the GIL), `prefetch` batches in
flight, and per-host sharding (each host loads only its contiguous
1/num_hosts slice of every batch, DistributedSampler's semantics). Batches
are numpy; the train step moves them to the device.

One addition: each iteration calls the dataset's `set_epoch(epoch)` where it
has one, so that a dataset drawing item i of epoch e from its own generator
(data/audio_dataset.item_rng) mixes a new clip each epoch. With such a
dataset the batches depend on the seed alone, not on num_workers.
"""
from __future__ import annotations

import queue
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np

__all__ = ["BatchLoader", "LoopIterator"]


def _default_collate(samples):
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([s[i] for s in samples])
                     for i in range(len(first)))
    return np.stack(samples)


class BatchLoader:
    """Iterates (shuffled) batches of a map-style dataset.

    Args:
        dataset: object with __len__ / __getitem__ (and optionally
            set_epoch).
        global_batch_size: total batch across all hosts; this host yields
            global_batch_size // num_hosts samples per batch.
    """

    def __init__(self, dataset, global_batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 collate_fn: Optional[Callable] = None,
                 num_workers: int = 8, host_id: int = 0, num_hosts: int = 1,
                 prefetch: int = 2):
        if global_batch_size % num_hosts:
            raise ValueError(f"global_batch_size {global_batch_size} is not a "
                             f"multiple of num_hosts {num_hosts}")
        if num_hosts > 1 and not drop_last:
            # A ragged final batch cannot be evenly sharded across hosts
            # (len(batch) // num_hosts would silently drop rows, or yield
            # an empty local slice that crashes collate). Multi-host runs
            # therefore always drop the partial tail, announced.
            warnings.warn("BatchLoader: multi-host sharding requires equal "
                          "per-host batches; forcing drop_last=True (the "
                          "final partial batch, if any, is skipped)")
            drop_last = True
        self.dataset = dataset
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // num_hosts
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.collate_fn = collate_fn or _default_collate
        self.num_workers = num_workers
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch_size
        return (n + self.global_batch_size - 1) // self.global_batch_size

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(
                self.seed + self.epoch).permutation(n)
        usable = (n // self.global_batch_size) * self.global_batch_size \
            if self.drop_last else n
        for start in range(0, usable, self.global_batch_size):
            batch = order[start:start + self.global_batch_size]
            # this host's CONTIGUOUS slice of the global batch: the hosts'
            # rows concatenated in rank order give the global batch's rows
            # in the loader's order
            per = len(batch) // self.num_hosts
            yield batch[self.host_id * per:(self.host_id + 1) * per]

    def __iter__(self) -> Iterator:
        self.epoch += 1
        set_epoch = getattr(self.dataset, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(self.epoch)
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = queue.Queue()
            batches = self._batch_indices()

            def submit_next():
                try:
                    idxs = next(batches)
                except StopIteration:
                    return False
                pending.put(pool.map(self.dataset.__getitem__, idxs))
                return True

            live = 0
            for _ in range(self.prefetch + 1):
                if submit_next():
                    live += 1
            while live:
                futures = pending.get()
                samples = list(futures)
                if submit_next():
                    live += 1
                live -= 1
                yield self.collate_fn(samples)


class LoopIterator:
    """Step-based looping over a loader (n_steps OR n_epochs), mirroring
    nppc/auxil.py:124-148 (LoopLoader)."""

    def __init__(self, loader, n_steps: Optional[int] = None,
                 n_epochs: Optional[int] = None):
        if (n_steps is None) == (n_epochs is None):
            raise ValueError("specify exactly one of n_steps / n_epochs")
        self.loader = loader
        if n_steps is None:
            n_steps = n_epochs * len(loader)
        self.n_steps = n_steps

    def __len__(self) -> int:
        return self.n_steps

    def __iter__(self):
        steps = 0
        while steps < self.n_steps:
            empty = True
            for batch in self.loader:
                empty = False
                if steps >= self.n_steps:
                    return
                yield batch
                steps += 1
            if empty:
                # e.g. BatchLoader(drop_last) over a dataset smaller than
                # one batch: without this the while-loop spins forever
                raise RuntimeError(
                    "LoopIterator: underlying loader yielded no batches "
                    "(dataset smaller than one batch with drop_last?)")
