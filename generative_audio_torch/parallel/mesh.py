"""The mesh and the batch's placement over the ranks: the counterpart of
generative_audio_tpu/parallel/mesh.py:29-126, under the same public names.

The JAX package runs one jitted program over a ("data", "band") mesh of
devices; XLA inserts the gradient's all-reduce. The port runs one process
per rank and DistributedDataParallel: `make_mesh()` is a
torch.distributed DeviceMesh of shape (data, band) over the ranks, whose
"data" group carries DDP's all-reduce and the UNets' global BatchNorm
statistics; each rank holds its contiguous rows of every global batch
(`place_batch`); parameters are replicated (`replicate_state`, and DDP's
own broadcast at construction).

The band axis is not ported: `make_mesh(band > 1)` and `subband_sharding`
raise (ROADMAP.md, queue A item 10). No entry point of the JAX package sets
it: its training CLI calls make_mesh() with band=1, so its sub-band rows
spread over the data axis alone, which is what DDP's split of the batch
does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from generative_audio_torch.parallel import distributed as D

__all__ = ["make_mesh", "data_sharding", "replicated", "shard_batch",
           "subband_sharding", "place_batch", "replicate_state",
           "place_rows", "data_parallel", "mean_over_ranks",
           "from_coordinator", "resume_from_coordinator"]

_BAND = ("the band axis (make_mesh(band > 1), subband_sharding) is not "
         "ported: ROADMAP.md, queue A item 10")


def make_mesh(data: Optional[int] = None, band: int = 1,
              device_type: Optional[str] = None):
    """A ("data", "band") DeviceMesh over the job's ranks, all of them on
    the data axis by default. device_type: "cuda" or "cpu" (default: "cuda"
    in an NCCL job, "cpu" in a gloo one). Needs
    parallel.distributed.initialize() first."""
    if band != 1:
        raise NotImplementedError(_BAND)
    if not D.is_initialized():
        raise RuntimeError("make_mesh spans the ranks of a torch.distributed "
                           "job: call parallel.distributed.initialize() "
                           "first (a single process trains with mesh=None)")
    n = D.process_count()
    if data is None:
        data = n
    assert data * band == n, f"mesh {data}x{band} != {n} ranks"
    if device_type is None:
        device_type = "cuda" if D._job.backend == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (data, band),
                            mesh_dim_names=("data", "band"))


def data_sharding(mesh, ndim: int = 1):
    """The placements of a batch: axis 0 split over "data", whole over
    "band" (ndim is taken for the JAX signature: only axis 0 is split)."""
    from torch.distributed.tensor import Replicate, Shard
    return (Shard(0), Replicate())


def replicated(mesh):
    from torch.distributed.tensor import Replicate
    return (Replicate(), Replicate())


def subband_sharding(mesh):
    raise NotImplementedError(_BAND)


def _rows_of(batch) -> Optional[object]:
    """The first leaf with a batch axis."""
    if isinstance(batch, dict):
        batch = list(batch.values())
    if isinstance(batch, (list, tuple)):
        for x in batch:
            leaf = _rows_of(x)
            if leaf is not None:
                return leaf
        return None
    return batch if D._is_rows(batch) else None


def place_rows(batch, mesh) -> Tuple[object, Optional[Tuple[int, int]]]:
    """(this rank's rows of `batch`, their global_rows): global_rows is
    (first row, global batch size), the argument of ops.subband.drop_band,
    the UNets' dropout and the image distortions, None without a mesh.

    A batch of numpy arrays is the global batch, the same on every rank
    (a deterministic loader order): each rank takes its contiguous rows,
    or, where axis 0 does not divide over the ranks (a ragged tail), the
    whole batch, so every rank computes the same rows and the result does
    not change. Tensors are rows already placed (DistributedBatches): they
    pass through, as the first rows of rank r in a global batch of
    process_count() times as many. Non-numeric leaves stay as they are."""
    if mesh is None:
        return batch, None
    first = _rows_of(batch)
    if first is None:
        return batch, None
    n, rank = mesh.size(0), mesh.get_local_rank("data")
    b = first.shape[0]
    if isinstance(first, torch.Tensor):
        return batch, (rank * b, n * b)
    if b % n:
        return batch, (0, b)
    per = b // n
    rows = slice(rank * per, (rank + 1) * per)
    return D._map(lambda x: x[rows] if D._is_rows(x) else x, batch), \
        (rank * per, b)


def place_batch(batch, mesh):
    """This rank's rows of a batch (place_rows without the global rows);
    the batch as it is without a mesh."""
    return place_rows(batch, mesh)[0]


def shard_batch(batch, mesh):
    """This rank's contiguous rows of a global batch on its device."""
    dev = D._mesh_device(mesh)
    return D._map(lambda x: torch.as_tensor(x).to(dev)
                  if D._is_rows(x) else x, place_batch(batch, mesh))


def replicate_state(module: nn.Module, mesh) -> nn.Module:
    """Rank 0's parameters and buffers in `module` on every rank (in
    place); nothing without a mesh or in a world of one."""
    if mesh is None or mesh.size() == 1:
        return module
    group = mesh.get_group("data")
    src = torch.distributed.get_global_rank(group, 0)
    with torch.no_grad():
        for t in module.state_dict().values():
            if D._job.backend == "nccl" or not t.is_cuda:
                torch.distributed.broadcast(t, src=src, group=group)
            else:
                buf = t.cpu()
                torch.distributed.broadcast(buf, src=src, group=group)
                t.copy_(buf)
    return module


def data_parallel(module: nn.Module, mesh) -> nn.Module:
    """The module a trainer's step calls: `module` itself without a mesh,
    else its DistributedDataParallel over the mesh's data group, whose
    backward averages the gradient over the ranks, with every BatchNorm of
    the inpainting UNets (nn.unet.batch_norm) on the global batch's
    statistics. DDP takes rank 0's parameters and buffers at
    construction. Only a trained module goes in: a frozen one has no
    gradient to average, and DDP refuses a module without one."""
    if mesh is None:
        return module
    from torch.nn.parallel import DistributedDataParallel
    from generative_audio_torch.nn.unet import sync_batch_norm
    group = mesh.get_group("data")
    sync_batch_norm(module, group)
    dev = next(module.parameters()).device
    return DistributedDataParallel(
        module, device_ids=[dev.index] if dev.type == "cuda" else None,
        process_group=group)


def mean_over_ranks(values: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of `values` (e.g. a step's losses, each the mean over one
    rank's equal share of the batch) over the ranks: the global batch's
    value. `values` as it is without a mesh."""
    if mesh is None or mesh.size() == 1:
        return values
    group = mesh.get_group("data")
    buf = values.detach().double()
    if D._job.backend != "nccl":
        buf = buf.cpu()
    torch.distributed.all_reduce(buf, group=group)
    return (buf / mesh.size()).to(values.device, values.dtype)


def from_coordinator(value, mesh):
    """Rank 0's `value` (any picklable) on every rank: the scores that
    decide a best checkpoint, so that every rank takes the same decision
    and none waits at a barrier that another skipped."""
    if mesh is None or mesh.size() == 1:
        return value
    group = mesh.get_group("data")
    box = [value]
    torch.distributed.broadcast_object_list(
        box, src=torch.distributed.get_global_rank(group, 0), group=group)
    return box[0]



def resume_from_coordinator(trainer, mesh, restored: bool, *names) -> bool:
    """After a trainer's restore_latest on every rank: rank 0's TrainState
    (model, optimizer state, step, EMA), its trainer attributes `names`
    (best_score, best_val) and its `restored` on every rank, the recipe of
    the JAX CLI's _dist_state (generative_audio_tpu/cli/train.py:76-111),
    so that a rank that found another checkpoint, or none, resumes from
    rank 0's. Returns rank 0's `restored`; nothing changes without a mesh."""
    if mesh is None or mesh.size() == 1:
        return restored
    tree = D.replicate_from_coordinator(mesh, {
        "state": trainer.state.state_dict(), "restored": restored,
        **{n: getattr(trainer, n) for n in names}})
    trainer.state.load_state_dict(tree["state"])
    for n in names:
        setattr(trainer, n, tree[n])
    return tree["restored"]
