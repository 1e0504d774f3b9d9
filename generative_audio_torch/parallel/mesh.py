"""The mesh and the batch's placement over the ranks: the counterpart of
generative_audio_tpu/parallel/mesh.py:29-126, under the same public names.

The JAX package runs one jitted program over a ("data", "band") mesh of
devices; XLA inserts the gradient's all-reduce. The port runs one process
per rank and DistributedDataParallel: `make_mesh()` is a
torch.distributed DeviceMesh of shape (data, band) over the ranks, rank r
at (r // band, r % band); the "data" group carries the UNets' global
BatchNorm statistics; the ranks of one "band" group hold the same rows of
every global batch (`place_batch`: each data group its contiguous rows);
parameters are replicated (`replicate_state`, and DDP's own broadcast at
construction).

The band axis splits the sub-band model's rows: `subband_sharding(mesh)`
is the counterpart of the JAX NamedSharding P(("data", "band"), None,
None), which the JAX models put on the fused [B*F', C, T] sub-band batch.
Where JAX constrains that batch and lets GSPMD split it, the port's models
call its `split` just before the sub-band model (this rank's contiguous
block of the rows, in band-rank order) and its `gather` just after (every
block on every rank), so that the rest of the step is the data group's
whole batch on every band rank. The gradient is then DDP's mean over all
the ranks, after which `sum_over_band` makes the sub-band model's (each
rank's from its own rows) their sum over the band.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from generative_audio_torch.parallel import distributed as D

__all__ = ["make_mesh", "data_sharding", "replicated", "shard_batch",
           "subband_sharding", "SubbandSharding", "place_batch",
           "replicate_state",
           "place_rows", "data_parallel", "mean_over_ranks",
           "from_coordinator", "resume_from_coordinator"]


def _mesh_shape(ranks: int, data: Optional[int],
                band: int) -> Tuple[int, int]:
    """(data, band) of a mesh over `ranks` ranks, checked as the JAX
    make_mesh checks it: data defaults to ranks // band."""
    if data is None:
        assert ranks % band == 0, f"{ranks} ranks not divisible by band={band}"
        data = ranks // band
    assert data * band == ranks, f"mesh {data}x{band} != {ranks} ranks"
    return data, band


def make_mesh(data: Optional[int] = None, band: int = 1,
              device_type: Optional[str] = None):
    """A ("data", "band") DeviceMesh over the job's ranks, all of them on
    the data axis by default; band > 1 splits the ranks between batch and
    sub-band parallelism (subband_sharding). device_type: "cuda" or "cpu"
    (default: "cuda" in an NCCL job, "cpu" in a gloo one). Needs
    parallel.distributed.initialize() first."""
    if not D.is_initialized():
        raise RuntimeError("make_mesh spans the ranks of a torch.distributed "
                           "job: call parallel.distributed.initialize() "
                           "first (a single process trains with mesh=None)")
    shape = _mesh_shape(D.process_count(), data, band)
    if device_type is None:
        device_type = "cuda" if D._job.backend == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=("data", "band"))


def data_sharding(mesh, ndim: int = 1):
    """The placements of a batch: axis 0 split over "data", whole over
    "band" (ndim is taken for the JAX signature: only axis 0 is split)."""
    from torch.distributed.tensor import Replicate, Shard
    return (Shard(0), Replicate())


def replicated(mesh):
    from torch.distributed.tensor import Replicate
    return (Replicate(), Replicate())


@dataclasses.dataclass(frozen=True)
class SubbandSharding:
    """The sub-band rows' split over a mesh's "band" axis: `group` is this
    rank's band group (None for a band of one), `index` its place there,
    `size` the band's ranks. With size 1 every method is the identity."""
    group: object
    index: int
    size: int

    def split(self, rows: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of the fused sub-band batch [N, ...]
        (distributed.row_blocks: uneven where N does not divide)."""
        return rows if self.size == 1 else D.split_rows(rows, self.group)

    def gather(self, rows: torch.Tensor, total: int) -> torch.Tensor:
        """The `total` rows of the band, from this rank's block `rows`."""
        return (rows if self.size == 1
                else D.gather_rows(rows, self.group, total))

    def sum_over_band(self, params) -> None:
        """After DDP's mean over every rank of the mesh: the gradients of
        `params`, each rank's from its own block of the sub-band rows,
        become their sum over the band (times size, which undoes the mean's
        division by the band's ranks)."""
        if self.size == 1:
            return
        for p in params:
            if p.grad is not None:
                p.grad.mul_(self.size)


def subband_sharding(mesh) -> SubbandSharding:
    """The split of the fused [B*F', C, T] sub-band batch over the mesh's
    "band" axis, which the models apply around their sub-band model; over
    "data" the batch is split already. The identity at band=1."""
    if mesh is None:
        raise RuntimeError("subband_sharding spans the ranks of a mesh: "
                           "call parallel.distributed.initialize() and "
                           "make_mesh() first")
    size = mesh.size(1)
    return SubbandSharding(mesh.get_group("band") if size > 1 else None,
                           mesh.get_local_rank("band"), size)


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
    (a deterministic loader order): each rank takes its data group's
    contiguous rows, or, where axis 0 does not divide over the data axis (a
    ragged tail), the whole batch, so every rank computes the same rows and
    the result does not change. Tensors are rows already placed
    (DistributedBatches): they pass through, as the first rows of data
    group d in a global batch of mesh.size(0) times as many. Non-numeric
    leaves stay as they are."""
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
    with torch.no_grad():
        for t in module.state_dict().values():
            if D._job.backend == "nccl" or not t.is_cuda:
                torch.distributed.broadcast(t, src=0)
            else:
                buf = t.cpu()
                torch.distributed.broadcast(buf, src=0)
                t.copy_(buf)
    return module


def data_parallel(module: nn.Module, mesh) -> nn.Module:
    """The module a trainer's step calls: `module` itself without a mesh,
    else its DistributedDataParallel over all the mesh's ranks, whose
    backward averages the gradient over them, with every BatchNorm of
    the inpainting UNets (nn.unet.batch_norm) on the global batch's
    statistics (over the data group). The band ranks of a data group hold
    the same rows, so the mean over every rank is the mean over the data
    groups; a gradient from a band rank's own sub-band rows needs
    SubbandSharding.sum_over_band after it. DDP takes rank 0's parameters
    and buffers at construction. Only a trained module goes in: a frozen
    one has no gradient to average, and DDP refuses a module without
    one."""
    if mesh is None:
        return module
    from torch.nn.parallel import DistributedDataParallel
    from generative_audio_torch.nn.unet import sync_batch_norm
    sync_batch_norm(module, mesh.get_group("data"))
    dev = next(module.parameters()).device
    return DistributedDataParallel(
        module, device_ids=[dev.index] if dev.type == "cuda" else None)


def mean_over_ranks(values: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of `values` (e.g. a step's losses, each the mean over one
    data group's equal share of the batch) over the data axis: the global
    batch's value. `values` as it is without a mesh."""
    if mesh is None or mesh.size(0) == 1:
        return values
    group = mesh.get_group("data")
    buf = values.detach().double()
    if D._job.backend != "nccl":
        buf = buf.cpu()
    torch.distributed.all_reduce(buf, group=group)
    return (buf / mesh.size(0)).to(values.device, values.dtype)


def from_coordinator(value, mesh):
    """Rank 0's `value` (any picklable) on every rank: the scores that
    decide a best checkpoint, so that every rank takes the same decision
    and none waits at a barrier that another skipped."""
    if mesh is None or mesh.size() == 1:
        return value
    box = [value]
    torch.distributed.broadcast_object_list(box, src=0)
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
