"""The port's multi-GPU runtime in one process: parallel/distributed.py and
parallel/mesh.py without a process group or in a gloo world of one, and
the ops whose result would otherwise depend on the number of ranks, each
held, for every rank's rows of a global batch, against the global batch's
result at those rows (a fake mesh stands in for the ranks).

2-process jobs are in tests/test_torch_distributed.py.
"""
import socket
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from generative_audio_torch.cli import launch
from generative_audio_torch.nn.unet import dropout
from generative_audio_torch.ops.subband import drop_band
from generative_audio_torch.parallel import distributed as D
from generative_audio_torch.parallel import mesh as M

torch.set_num_threads(2)
sys.path.insert(0, str(Path(__file__).parent))


class FakeMesh:
    """A data axis of `n` ranks seen from rank `rank` (no process group)."""
    device_type = "cpu"

    def __init__(self, n, rank):
        self.n, self.rank = n, rank

    def size(self, dim=None):
        return self.n

    def get_local_rank(self, name):
        assert name == "data"
        return self.rank


@pytest.fixture
def world_of_one(monkeypatch):
    """A gloo job of one rank through the launcher's GAT_* contract; left
    after the test."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in (("GAT_COORDINATOR", f"127.0.0.1:{port}"),
                 ("GAT_NUM_PROCESSES", "1"), ("GAT_PROCESS_ID", "0"),
                 ("GAT_BACKEND", "gloo"), ("GAT_TIMEOUT", "60")):
        monkeypatch.setenv(k, v)
    yield
    D.shutdown()


def test_single_process_helpers(monkeypatch):
    """No environment, no group: a single-process run (the JAX package's
    tests/test_distributed.py:57-62 and tests/test_parallel.py:143-148)."""
    for k in ("GAT_COORDINATOR", "GAT_NUM_PROCESSES", "GAT_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert D.initialize() is False
    assert not D.is_initialized()
    assert D.is_coordinator() is True
    assert (D.process_index(), D.process_count()) == (0, 1)
    assert D.per_process_batch_size(8) == 8
    assert D.local_slice(8) == (0, 8)
    assert D.local_device("cpu") == torch.device("cpu")
    D.barrier()                                  # nothing to wait for
    tree = {"a": torch.ones(2), "b": 3.0}
    assert D.replicate_from_coordinator(None, tree) is tree


def test_distributed_needs_torchrun_variables(monkeypatch):
    """auto=True (--distributed) without torchrun's env:// variables
    raises a RuntimeError naming the missing ones."""
    for k in D.TORCHRUN_VARS + ("GAT_COORDINATOR", "GAT_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(RuntimeError,
                       match="MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK"):
        D.initialize(auto=True)
    assert not D.is_initialized()


def test_backend_and_card_rules(monkeypatch):
    """An argument that contradicts the launcher's backend raises; NCCL
    takes one card per rank (this machine has none) and never shares one;
    the launcher refuses shared cards outside gloo. Nothing is remapped."""
    monkeypatch.setenv("GAT_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("GAT_NUM_PROCESSES", "2")
    monkeypatch.setenv("GAT_PROCESS_ID", "1")
    monkeypatch.setenv("GAT_BACKEND", "gloo")
    with pytest.raises(ValueError, match="differs from the launcher"):
        D.initialize(backend="nccl")
    monkeypatch.setenv("GAT_BACKEND", "nccl")
    with pytest.raises(RuntimeError, match="needs cuda:1"):
        D.initialize()
    monkeypatch.setenv("GAT_RANKS_PER_DEVICE", "2")
    with pytest.raises(ValueError, match="only in a gloo job"):
        D.initialize()
    assert not D.is_initialized()
    with pytest.raises(SystemExit):
        launch.main(["--nprocs", "2", "--ranks-per-device", "2",
                     "--backend", "nccl", "--", "true"])


def test_band_axis_raises(world_of_one):
    """make_mesh's (data, band) shape and its AssertionError cases, as the
    JAX make_mesh's (tests/test_parallel.py:36-44); make_mesh and
    subband_sharding need a job; subband_sharding at band=1 is the
    identity. Meshes with band > 1 over real ranks are in
    tests/test_torch_band_axis.py."""
    assert M._mesh_shape(8, None, 1) == (8, 1)
    assert M._mesh_shape(8, None, 2) == (4, 2)
    assert M._mesh_shape(4, 2, 2) == (2, 2)
    assert M._mesh_shape(4, 1, 4) == (1, 4)
    for ranks, data, band in ((8, 3, 3), (8, None, 3), (4, 1, 2)):
        with pytest.raises(AssertionError):
            M._mesh_shape(ranks, data, band)
    with pytest.raises(RuntimeError, match="initialize"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="make_mesh"):
        M.subband_sharding(None)
    assert D.initialize()
    with pytest.raises(AssertionError):
        M.make_mesh(band=2)
    with pytest.raises(AssertionError):
        M.make_mesh(data=3, band=3)
    mesh = M.make_mesh()
    assert mesh.mesh_dim_names == ("data", "band")
    assert tuple(mesh.shape) == (1, 1)
    sharding = M.subband_sharding(mesh)
    assert (sharding.group, sharding.index, sharding.size) == (None, 0, 1)
    rows = torch.randn(5, 3, 4, requires_grad=True)
    assert sharding.split(rows) is rows
    assert sharding.gather(rows, 5) is rows
    rows.grad = torch.ones_like(rows)
    sharding.sum_over_band([rows])
    assert torch.equal(rows.grad, torch.ones_like(rows))
    assert [type(p).__name__ for p in M.data_sharding(mesh)] == [
        "Shard", "Replicate"]
    assert [type(p).__name__ for p in M.replicated(mesh)] == [
        "Replicate", "Replicate"]


@pytest.mark.parametrize("rows,size,blocks", [
    (16, 2, (8, 8)), (27, 4, (7, 7, 7, 6)), (2304, 2, (1152, 1152)),
    (45, 4, (12, 11, 11, 11)), (3, 3, (1, 1, 1))])
def test_row_blocks(rows, size, blocks):
    """The sub-band rows' blocks: contiguous, in band-rank order, the first
    rows % size one row longer."""
    assert D.row_blocks(rows, size) == blocks
    assert sum(blocks) == rows


def test_row_blocks_need_a_row_a_rank():
    with pytest.raises(ValueError, match="cannot be split"):
        D.row_blocks(3, 4)


def test_split_and_gather_rows_world_of_one(world_of_one):
    """split_rows and gather_rows through a group of one rank: the rows
    come back whole, and the gradient reaches every row."""
    assert D.initialize()
    group = torch.distributed.group.WORLD
    x = torch.randn(7, 3, 5, requires_grad=True)
    part = D.split_rows(x, group)
    assert torch.equal(part, x)
    y = D.gather_rows(part * 2, group, 7)
    assert torch.equal(y, 2 * x)
    y.sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 2.0))
    with pytest.raises(ValueError, match="holds 6 rows"):
        D.gather_rows(x[:6], group, 7)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_place_rows(n):
    """Each rank's contiguous rows of a numpy batch and their global_rows;
    a batch whose axis 0 does not divide goes to every rank whole (the
    ragged-tail rule, generative_audio_tpu/parallel/mesh.py:97-104);
    tensors are rows already placed; metadata stays."""
    batch = (np.arange(12 * 3, dtype=np.float32).reshape(12, 3),
             np.arange(12), {"paths": ["a", "b"], "n": np.asarray(5)})
    rows = []
    for r in range(n):
        got, global_rows = M.place_rows(batch, FakeMesh(n, r))
        per = 12 // n
        assert global_rows == (r * per, 12)
        np.testing.assert_array_equal(got[1], np.arange(r * per,
                                                        (r + 1) * per))
        assert got[2]["paths"] == ["a", "b"] and got[2]["n"] == 5
        rows.append(got[0])
        assert M.place_batch(batch, FakeMesh(n, r))[1].shape == (per,)
    np.testing.assert_array_equal(np.concatenate(rows), batch[0])
    ragged = np.zeros((5, 2), np.float32)
    got, global_rows = M.place_rows(ragged, FakeMesh(2, 1))
    assert got is ragged and global_rows == (0, 5)
    local = torch.zeros(3, 2)
    assert M.place_rows((local,), FakeMesh(n, 1)) == ((local,), (3, 3 * n))
    assert M.place_rows(batch, None) == (batch, None)


@pytest.mark.parametrize("batch,groups,n", [
    (18, 2, 2), (4, 2, 2), (12, 3, 4), (8, 2, 4), (9, 3, 3), (6, 2, 3)])
def test_drop_band_rows_equal_the_global_batch(batch, groups, n):
    """drop_band of each rank's rows with global_rows == the JAX drop_band
    of the global batch at that rank's rows, in the same order, exactly in
    float32 (batch 18 over 2 ranks: rank 1's first row, global row 9, is in
    group 1; batch 4 over 2 ranks with 2 groups passes the global check)."""
    import jax.numpy as jnp
    from generative_audio_tpu.ops.subband import drop_band as jax_drop_band
    x = np.random.default_rng(batch).standard_normal(
        (batch, 2, 9, 5)).astype(np.float32)
    want = np.asarray(jax_drop_band(jnp.asarray(x), groups))
    source = np.concatenate([np.arange(g, batch, groups)
                             for g in range(groups)])
    per = batch // n
    for r in range(n):
        mine = np.arange(r * per, (r + 1) * per)
        got = drop_band(torch.from_numpy(x[mine]), groups, (r * per, batch))
        np.testing.assert_array_equal(got.numpy(),
                                      want[np.isin(source, mine)])
    if per <= groups:
        with pytest.raises(ValueError, match="larger than"):
            drop_band(torch.from_numpy(x[:per]), groups)


def test_dropout_and_distortions_do_not_depend_on_the_ranks():
    """The UNets' dropout masks (one generator, and a generator a stacked
    MC pass) and the image distortions' noise: each rank's rows, drawn with
    global_rows, == the global batch's draw at those rows, bit for bit."""
    from generative_audio_torch.models.image_restoration import (
        Denoising, SuperResolution)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 3, 6, 10)).astype(np.float32))

    def gens(k=1):
        return [torch.Generator().manual_seed(7 + i) for i in range(k)]

    whole = dropout(x, 0.3, gens()[0])
    passes = dropout(torch.cat([x, x]), 0.3, gens(2))
    noisy = Denoising(0.5).distort(x, gens()[0])
    coarse = SuperResolution(2, noise_std=0.1).distort(x, gens()[0])
    for r in range(2):
        rows = slice(4 * r, 4 * r + 4)
        part = x[rows]
        assert torch.equal(dropout(part, 0.3, gens()[0], (4 * r, 8)),
                           whole[rows])
        got = dropout(torch.cat([part, part]), 0.3, gens(2), (4 * r, 8))
        assert torch.equal(got[:4], passes[:8][rows])
        assert torch.equal(got[4:], passes[8:][rows])
        assert torch.equal(Denoising(0.5).distort(part, gens()[0],
                                                  (4 * r, 8)), noisy[rows])
        assert torch.equal(SuperResolution(2, noise_std=0.1).distort(
            part, gens()[0], (4 * r, 8)), coarse[rows])


def test_world_of_one_trains_bit_for_bit(world_of_one):
    """A DDP trainer in a gloo world of one (the NCCL world-of-one path of
    chip_smoke.py's phase 20 on the CPU): two steps and the losses bit for
    bit the plain trainer's; replicate_from_coordinator and
    replicate_state keep every value."""
    from generative_audio_torch.train import EnhanceTrainer
    import torch_distributed_worker as W
    assert D.initialize() and D.process_count() == 1
    mesh = M.make_mesh()
    trainers = []
    for m in (None, mesh):
        t = EnhanceTrainer(W.enhance_config(), device="cpu", mesh=m)
        W.numpy_state(t.state.model, 10)
        trainers.append(t)
    assert type(trainers[1].net).__name__ == "DistributedDataParallel"
    for b in W.enhance_batches():
        assert trainers[0].train_epoch([b]) == trainers[1].train_epoch([b])
    for a, b in zip(trainers[0].state.model.state_dict().values(),
                    trainers[1].state.model.state_dict().values()):
        assert torch.equal(a, b)
    tree = {"sd": trainers[1].state.state_dict(), "best": 1.5}
    assert D.replicate_from_coordinator(mesh, tree) is tree
    assert M.replicate_state(trainers[1].state.model, mesh) is \
        trainers[1].state.model


def test_masked_mse_loss_world_of_one(world_of_one):
    """masked_mse_loss with a group of one rank is the plain loss, bit for
    bit (2 ranks: tests/test_torch_distributed.py's restoration line)."""
    from generative_audio_torch.losses import masked_mse_loss
    assert D.initialize()
    group = M.make_mesh().get_group("data")
    rng = np.random.default_rng(3)
    pred, target = (torch.from_numpy(rng.standard_normal((2, 1, 4, 6))
                                     .astype(np.float32)) for _ in range(2))
    mask = torch.ones(2, 1, 4, 6)
    mask[..., 2:4] = 0
    assert torch.equal(masked_mse_loss(pred, target, mask, group),
                       masked_mse_loss(pred, target, mask))
