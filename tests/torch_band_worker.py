"""The ranks' side of tests/test_torch_band_axis.py: run under
generative_audio_torch.cli.launch (4 ranks, gloo, on the CPU). Every rank
writes its results to OUT/rank{r}.pt.

    python tests/torch_band_worker.py OUT

In one job, on meshes made in this order:
  * (2, 2): FullSubNet+ at tests/test_parallel.py:_cfg(groups=2)'s shape,
    one EnhanceTrainer epoch of one global batch with accum_steps=2, the
    sub-band rows split over the band (rank 0 writes the checkpoint);
  * (1, 4): FullSubNet v1, GRU and LSTM, one step on a batch whose B*F'
    rows do not divide by 4; MultiDirectionFullSubNetPlus's forward on
    rows that do not either;
  * (4, 1) and (2, 2) again: what mean_over_ranks, from_coordinator,
    local_slice and cli.train's loader give each rank.
The test calls the same functions with mesh=None for the single process.
"""
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_distributed_worker import numpy_state  # noqa: E402

# tests/test_parallel.py:_cfg(groups=2) and its batch fixture
PLUS = dict(num_freqs=16, sb_num_neighbors=2, fb_model_hidden_size=16,
            sb_model_hidden_size=8, num_groups_in_drop_band=2)
PLUS_STFT = dict(n_fft=30, hop_length=16, win_length=30)
PLUS_ACCUM = 2
# F = 18 and two drop_band groups: 9 bins a row, 3 rows -> 27 sub-band rows
# over 4 ranks, blocks of 7, 7, 7, 6
V1 = dict(num_freqs=18, sb_num_neighbors=2, fb_model_hidden_size=16,
          sb_model_hidden_size=8, num_groups_in_drop_band=2)
V1_STFT = dict(n_fft=34, hop_length=16, win_length=34)
V1_BATCH = 3
# 5 rows x 9 bins = 45 sub-band rows over 4 ranks, blocks of 12, 11, 11, 11
HEAD = dict(num_freqs=18, sb_num_neighbors=2, fb_model_hidden_size=16,
            sb_model_hidden_size=8, num_groups_in_drop_band=2,
            n_directions=2)
HEAD_SHAPE = (5, 1, 18, 20)
LOADER_BATCH = 8


def plus_config():
    from generative_audio_torch.models import FullSubNetPlusConfig
    from generative_audio_torch.train import EnhanceTrainConfig
    return EnhanceTrainConfig(model=FullSubNetPlusConfig(**PLUS),
                              compute_dtype="float32", **PLUS_STFT)


def plus_batch():
    rng = np.random.default_rng(0)
    clean = rng.standard_normal((8, 512)).astype(np.float32)
    noisy = clean + 0.3 * rng.standard_normal((8, 512)).astype(np.float32)
    return noisy, clean


def v1_config(kind):
    from generative_audio_torch.models import FullSubNetConfig
    from generative_audio_torch.train import EnhanceTrainConfig
    return EnhanceTrainConfig(
        model_type="fullsubnet",
        model_v1=FullSubNetConfig(sequence_model=kind, **V1),
        compute_dtype="float32", **V1_STFT)


def v1_batch():
    rng = np.random.default_rng(1)
    clean = rng.standard_normal((V1_BATCH, 512)).astype(np.float32)
    noisy = clean + 0.3 * rng.standard_normal((V1_BATCH, 512)).astype(
        np.float32)
    return noisy, clean


def train_one(config, batch, mesh, accum=1, checkpoint_dir=None, seed=10):
    """One EnhanceTrainer epoch of one global batch on numpy-made
    parameters: {"loss", "grads" (what apply_gradients found), "state",
    "rows" (the rows of each sub-band model call)}."""
    from generative_audio_torch.parallel import replicate_state
    from generative_audio_torch.train import EnhanceTrainer
    from generative_audio_torch.train.enhance import make_enhance_train_step
    trainer = EnhanceTrainer(config, device="cpu", mesh=mesh,
                             checkpoint_dir=checkpoint_dir)
    numpy_state(trainer.state.model, seed)
    if mesh is not None:       # DDP took the parameters at construction
        replicate_state(trainer.state.model, mesh)
    trainer._step_fn = make_enhance_train_step(
        config, accum, net=trainer.net,
        subband_sharding=trainer.subband_sharding)
    grads, rows = {}, []
    trainer.state.model.sb_model.register_forward_pre_hook(
        lambda module, args: rows.append(args[0].shape[0]))
    apply = trainer.state.apply_gradients

    def spy():
        grads.update({k: p.grad.detach().clone() for k, p in
                      trainer.state.model.named_parameters()})
        apply()
    trainer.state.apply_gradients = spy
    if checkpoint_dir is None:
        trainer.train_epoch([batch])
    else:
        trainer.train([batch], epochs=1, log=lambda *a: None)
    return {"loss": trainer.loss_history[-1], "grads": grads, "rows": rows,
            "state": {k: v.detach().clone() for k, v in
                      trainer.state.model.state_dict().items()}}


def head_forward(sharding):
    """MultiDirectionFullSubNetPlus's output on six seeded streams, and
    the rows of its sub-band model call."""
    from generative_audio_torch.models import (
        MultiDirectionConfig, MultiDirectionFullSubNetPlus)
    model = numpy_state(MultiDirectionFullSubNetPlus(
        MultiDirectionConfig(**HEAD), compute_dtype=torch.float32,
        device="cpu", subband_sharding=sharding), 12)
    rows = []
    model.sb_model.register_forward_pre_hook(
        lambda module, args: rows.append(args[0].shape[0]))
    rng = np.random.default_rng(3)
    streams = [torch.from_numpy(rng.uniform(0.1, 1.0, HEAD_SHAPE)
                                .astype(np.float32)) for _ in range(6)]
    with torch.no_grad():
        return model(*streams), rows


class _Items:
    """Item i is [i, i]: a loader's rows name their dataset indices."""

    def __len__(self):
        return 2 * LOADER_BATCH

    def __getitem__(self, i):
        return np.full(2, i, np.float32)


def helpers(mesh, rank):
    """What the mesh's helpers give this rank."""
    from generative_audio_torch.cli.train import _loader
    from generative_audio_torch.parallel import distributed as D
    from generative_audio_torch.parallel.mesh import (
        from_coordinator, mean_over_ranks)
    loader = _loader(_Items(), {"global_batch_size": LOADER_BATCH,
                                "shuffle": False, "num_workers": 1}, None,
                     mesh)
    return {"mean": mean_over_ranks(torch.tensor([float(rank)]),
                                    mesh).item(),
            "coordinator": from_coordinator(rank, mesh),
            "local_slice": D.local_slice(LOADER_BATCH, mesh),
            "loader_rows": next(iter(loader))[:, 0].tolist()}


def main(out):
    from generative_audio_torch.parallel import (
        distributed as D, make_mesh, subband_sharding)
    out = Path(out)
    assert D.initialize(), "run under generative_audio_torch.cli.launch"
    rank = D.process_index()
    result = {"rank": rank}
    mesh = make_mesh(data=2, band=2, device_type="cpu")
    result["plus_sharding"] = tuple(
        getattr(subband_sharding(mesh), k) for k in ("index", "size"))
    result["plus"] = train_one(plus_config(), plus_batch(), mesh,
                               accum=PLUS_ACCUM,
                               checkpoint_dir=out / "ckpt")
    result["helpers_2x2"] = helpers(mesh, rank)
    mesh = make_mesh(band=4, device_type="cpu")
    for kind in ("GRU", "LSTM"):
        result[kind] = train_one(v1_config(kind), v1_batch(), mesh)
    result["head"] = head_forward(subband_sharding(mesh))
    result["helpers_4x1"] = helpers(make_mesh(device_type="cpu"), rank)
    torch.save(result, out / f"rank{rank}.pt")
    D.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
