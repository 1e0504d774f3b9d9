"""The multi-process runtime on torch.distributed: the counterpart of
generative_audio_tpu/parallel/distributed.py:47-195, under the same public
names.

The reference trains with single-host DDP (mp.spawn one process per GPU,
init_process_group, DistributedSampler): so does the port. Each process is
one rank; `initialize()` joins the job; each rank loads its contiguous rows
of every global batch (data/loader.BatchLoader's host_id / num_hosts,
DistributedSampler's contract); the trainers wrap their trained module in
DistributedDataParallel (parallel/mesh.data_parallel), whose backward
averages the gradient over the ranks; checkpoints and reports are written by
rank 0 alone (train/checkpoint.py).

`cli/launch.py` starts N ranks on one machine and hands each this
environment, which `initialize()` reads:

    GAT_COORDINATOR       host:port of rank 0's rendezvous store
    GAT_NUM_PROCESSES     the world size
    GAT_PROCESS_ID        this process's rank (and its local rank)
    GAT_BACKEND           "nccl" or "gloo" (the launcher's --backend)
    GAT_RANKS_PER_DEVICE  ranks that share one card (gloo only)
    GAT_TIMEOUT           seconds a collective may wait (default 600)

Under torchrun, `initialize(auto=True)` (cli/train.py --distributed) reads
torchrun's env:// variables instead. Which card a rank uses is explicit: an
NCCL job takes cuda:{LOCAL_RANK}, one card per rank, and raises where there
are fewer cards than ranks; ranks share a card only in a gloo job started
with GAT_RANKS_PER_DEVICE above 1. Nothing is remapped and the backend never
changes silently.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize", "is_initialized", "process_index", "process_count",
    "is_coordinator", "local_slice", "global_batch_from_local",
    "per_process_batch_size", "DistributedBatches", "replicate_global",
    "replicate_from_coordinator", "local_device", "barrier", "shutdown",
    "draw_rows", "all_reduce_sum", "TORCHRUN_VARS",
]

_ENV_COORD = "GAT_COORDINATOR"
_ENV_NPROC = "GAT_NUM_PROCESSES"
_ENV_PID = "GAT_PROCESS_ID"
_ENV_BACKEND = "GAT_BACKEND"
_ENV_PER_DEVICE = "GAT_RANKS_PER_DEVICE"
_ENV_TIMEOUT = "GAT_TIMEOUT"
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "LOCAL_RANK")
BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class _Job:
    backend: str
    local_rank: int
    ranks_per_device: int


_job: Optional[_Job] = None


def _backend(backend: Optional[str]) -> str:
    """The job's backend: the argument, else the launcher's GAT_BACKEND,
    else nccl where CUDA is available and gloo where not. An argument that
    differs from GAT_BACKEND raises."""
    env = os.environ.get(_ENV_BACKEND) or None
    if backend and env and backend != env:
        raise ValueError(f"backend {backend!r} differs from the launcher's "
                         f"{_ENV_BACKEND}={env!r}")
    backend = backend or env or ("nccl" if torch.cuda.is_available()
                                 else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return backend


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               auto: bool = False, backend: Optional[str] = None) -> bool:
    """Join this process to the job (torch.distributed.init_process_group).

    The arguments default to the GAT_* contract of cli/launch.py. With no
    contract and auto=True (cli/train.py --distributed) the job comes from
    torchrun's MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK,
    and a RuntimeError names the ones missing. With neither, this is a
    single-process run and nothing happens (the entry points call this
    unconditionally, as the reference calls init_process_group).
    GAT_TIMEOUT (seconds, 600 by default) bounds every collective, so that
    a lost peer fails the run instead of hanging it.

    Returns True when this process is part of a torch.distributed job, a
    world of one included."""
    global _job
    if _job is not None:
        return True
    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and _ENV_NPROC in os.environ:
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and _ENV_PID in os.environ:
        process_id = int(os.environ[_ENV_PID])

    if coordinator_address is None and (num_processes is None
                                        or num_processes <= 1):
        if not auto:
            return False                        # single-process run
        missing = [v for v in TORCHRUN_VARS if v not in os.environ]
        if missing:
            raise RuntimeError(
                "--distributed takes the job from torchrun's environment, "
                f"which lacks {', '.join(missing)} (of "
                f"{', '.join(TORCHRUN_VARS)}); start it under torchrun, or "
                "with python -m generative_audio_torch.cli.launch without "
                "--distributed")
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        local_rank = int(os.environ["LOCAL_RANK"])
    else:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError(
                f"a launched job needs {_ENV_COORD}, {_ENV_NPROC} and "
                f"{_ENV_PID} (or the arguments) all three")
        init_method = f"tcp://{coordinator_address}"
        world, rank, local_rank = num_processes, process_id, process_id
    backend = _backend(backend)
    per_device = int(os.environ.get(_ENV_PER_DEVICE, "1"))
    if per_device < 1:
        raise ValueError(f"{_ENV_PER_DEVICE} must be at least 1")
    if backend == "nccl":
        if per_device != 1:
            raise ValueError("NCCL takes one card per rank: ranks share a "
                             "card only in a gloo job")
        _check_card(local_rank, backend)
        torch.cuda.set_device(local_rank)
    timeout = datetime.timedelta(
        seconds=float(os.environ.get(_ENV_TIMEOUT, "600")))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout)
    _job = _Job(backend, local_rank, per_device)
    return True


def _check_card(index: int, backend: str) -> None:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if index >= count:
        raise RuntimeError(
            f"this rank needs cuda:{index}, but the machine has {count} "
            f"card(s): a {backend} job takes one card per rank unless its "
            f"ranks share cards in a gloo job ({_ENV_PER_DEVICE})")


def local_device(kind="cuda") -> torch.device:
    """This rank's device of `kind` ("cuda" or "cpu"): the CPU, or card
    LOCAL_RANK // GAT_RANKS_PER_DEVICE, which becomes the current device.
    Outside a job it is utils.device.resolve_device(kind)."""
    from generative_audio_torch.utils.device import resolve_device
    dev = torch.device(kind)
    if _job is None or dev.type == "cpu":
        return resolve_device(dev)
    index = _job.local_rank // _job.ranks_per_device
    _check_card(index, _job.backend)
    torch.cuda.set_device(index)
    return resolve_device(torch.device("cuda", index))


def is_initialized() -> bool:
    return _job is not None


def process_index() -> int:
    return dist.get_rank() if _job is not None else 0


def process_count() -> int:
    return dist.get_world_size() if _job is not None else 1


def is_coordinator() -> bool:
    """The rank-0 check that gates checkpoint writes, reports and logging,
    as the reference's `rank == 0` guards (base_trainer.py:160,
    tools/train.py:58)."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank (nothing to wait for in a world of one)."""
    if process_count() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the job (destroy_process_group); a no-op outside one."""
    global _job
    if _job is not None:
        dist.destroy_process_group()
        _job = None


def per_process_batch_size(global_batch_size: int) -> int:
    """This process's share of the global batch (equal contiguous shards:
    global_batch_size must divide)."""
    n = process_count()
    assert global_batch_size % n == 0, (
        f"global batch {global_batch_size} not divisible by {n} processes")
    return global_batch_size // n


def local_slice(global_batch_size: int) -> Tuple[int, int]:
    """[start, stop) of this process's rows in the global batch: the
    indices to hand the host-side dataset (DistributedSampler's
    contract)."""
    per = per_process_batch_size(global_batch_size)
    start = process_index() * per
    return start, start + per


def draw_rows(draw: Callable[[Tuple[int, ...]], torch.Tensor],
              shape: Sequence[int],
              global_rows: Optional[Tuple[int, int]]) -> torch.Tensor:
    """A random draw for a batch of `shape` that does not depend on the
    process count: draw(shape) itself without global_rows; with
    global_rows = (first row, global batch size) draw(...) at the global
    batch's shape, sliced to this batch's rows. Every rank's generator is
    in the same state, so each rank holds the rows of one global draw."""
    shape = tuple(shape)
    if global_rows is None:
        return draw(shape)
    first, total = global_rows
    return draw((total,) + shape[1:])[first:first + shape[0]]


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group's ranks, forward and backward: every rank's
    input reaches every rank's sum, so each input's gradient is the sum of
    the ranks' upstream gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), ctx.group), None


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """In place; a gloo group sums a card's tensor through the host."""
    if not x.is_cuda or dist.get_backend(group) == "nccl":
        dist.all_reduce(x, group=group)
        return x
    buf = x.cpu()
    dist.all_reduce(buf, group=group)
    return x.copy_(buf)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks of `group`, with its gradient (a new
    tensor; x itself as it is for group None or a group of one rank). A
    small torch.autograd.Function: torch.distributed.nn's all_reduce is
    deprecated, and SyncBatchNorm refuses tensors on the CPU."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def _is_rows(x) -> bool:
    """A numeric array or tensor with a batch axis (the leaves that are
    split over the ranks); anything else stays local to the process."""
    if isinstance(x, torch.Tensor):
        return x.ndim > 0
    if isinstance(x, np.ndarray):
        return x.ndim > 0 and (np.issubdtype(x.dtype, np.number)
                               or x.dtype == np.bool_)
    return False


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _mesh_device(mesh) -> torch.device:
    return local_device(mesh.device_type if mesh is not None else "cpu")


def global_batch_from_local(mesh, local_batch):
    """This process's rows of the global batch (a tree of tuples, lists and
    dicts over numpy arrays or tensors) as tensors on the rank's device.
    They stay this rank's rows: DDP, not an array, spans the ranks, and
    parallel/mesh.place_rows takes a tensor as rows already placed.
    Non-numeric leaves and scalars (collate_inpainting's metadata: paths,
    transcriptions, mask indices) stay local to the process, as in the JAX
    package."""
    dev = _mesh_device(mesh)

    def put(x):
        if not _is_rows(x):
            return x
        return torch.as_tensor(x).to(dev, non_blocking=True)

    return _map(put, local_batch)


def replicate_global(mesh, tree):
    """A tree already equal on every process (a seeded init) as tensors on
    the rank's device; nothing is exchanged."""
    dev = _mesh_device(mesh)
    return _map(lambda x: torch.as_tensor(x).to(dev)
                if isinstance(x, (torch.Tensor, np.ndarray)) else x, tree)


@dataclasses.dataclass(frozen=True)
class _Slot:
    """A tensor leaf in the broadcast skeleton."""
    index: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    on_cuda: bool


def _group(mesh):
    return mesh.get_group("data") if mesh is not None else dist.group.WORLD


def replicate_from_coordinator(mesh, tree):
    """`tree` with rank 0's values on every rank: rank 0's structure,
    Python values and tensors (a model's and an optimizer's state_dict, the
    step, best_score, best_val), for state that only rank 0 is sure to hold,
    such as a resume whose checkpoint directory may not be shared. A tensor
    on a card lands on this rank's card, one on the CPU on the CPU. Outside
    a job the tree is returned as it is."""
    if process_count() == 1:
        return tree
    group = _group(mesh)
    src = dist.get_global_rank(group, 0)
    tensors = []

    def strip(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
            return _Slot(len(tensors) - 1, tuple(x.shape), x.dtype, x.is_cuda)
        return x

    skeleton = [_map(strip, tree) if dist.get_rank() == src else None]
    dist.broadcast_object_list(skeleton, src=src, group=group)
    comm = (torch.device("cuda", torch.cuda.current_device())
            if _job.backend == "nccl" else torch.device("cpu"))
    card = (torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else None)

    def fill(x):
        if not isinstance(x, _Slot):
            return x
        if dist.get_rank() == src:
            buf = tensors[x.index].detach().to(comm).contiguous()
        else:
            buf = torch.empty(x.shape, dtype=x.dtype, device=comm)
        dist.broadcast(buf, src=src, group=group)
        return buf.to(card if x.on_cuda else "cpu")

    return _map(fill, skeleton[0])


class DistributedBatches:
    """A per-process BatchLoader (host_id / num_hosts sharded) whose batches
    come out as this rank's rows on its device (global_batch_from_local):
    the trainers consume it unchanged (`for noisy, clean in loader`)."""

    def __init__(self, loader, mesh):
        self.loader = loader
        self.mesh = mesh

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            yield global_batch_from_local(self.mesh, batch)
