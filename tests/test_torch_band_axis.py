"""The band axis on the CPU: parallel.make_mesh(data, band) and
subband_sharding in a 4-rank gloo job started through
generative_audio_torch.cli.launch (tests/torch_band_worker.py is the
ranks' side), against one process and against the JAX package's
band-sharded step.

  * mesh (2, 2): FullSubNet+ at tests/test_parallel.py:_cfg(groups=2)'s
    shape with accum_steps=2, the sub-band rows of each data group split
    over its 2 band ranks, against the JAX step under make_mesh(data=2,
    band=2) + subband_sharding on 4 of conftest's 8 CPU devices (loss 1e-5,
    parameters 1e-3 after Adam: tests/test_parallel.py:97-108's limits)
    and against the port's single process (loss 1e-6, the gradient 1e-5 of
    its peak before Adam);
  * mesh (1, 4): FullSubNet v1 (GRU and LSTM) on 27 sub-band rows, uneven
    blocks of 7, 7, 7, 6, and MultiDirectionFullSubNetPlus's forward on 45,
    against one process;
  * every rank's parameters bit for bit equal; the band job's checkpoint
    in one process; at band=1 the helpers shard as before.

One launch serves the file: it runs in the background while the tests
compute their references. It has its own timeout (240 s) and the process
group a shorter one (GAT_TIMEOUT 60 s).
"""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).parent))
import torch_band_worker as W  # noqa: E402

RANKS = 4
SPAWN_TIMEOUT = 240
WORKER = str(Path(__file__).parent / "torch_band_worker.py")


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The 4-rank launch, in a session of its own so that a launch past its
    timeout is killed whole; yields a function that waits for it and
    returns each rank's results."""
    out = tmp_path_factory.mktemp("torch_band")
    env = dict(os.environ, GAT_TIMEOUT="60", PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    log = out / "launch.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "generative_audio_torch.cli.launch",
             "--nprocs", str(RANKS), "--backend", "gloo", "--",
             sys.executable, WORKER, str(out)],
            cwd=str(REPO), env=env, stdout=f, stderr=subprocess.STDOUT,
            start_new_session=True)
    t0 = time.time()
    ranks = []

    def wait():
        if not ranks:
            try:
                proc.wait(timeout=max(1.0, SPAWN_TIMEOUT
                                      - (time.time() - t0)))
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            assert proc.returncode == 0, log.read_text()[-3000:]
            ranks.extend(torch.load(out / f"rank{r}.pt", weights_only=True)
                         for r in range(RANKS))
        return ranks
    wait.checkpoint = out / "ckpt"
    yield wait
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


@pytest.fixture(scope="module")
def one_process():
    """The single process's runs, computed while the ranks run."""
    return {"plus": W.train_one(W.plus_config(), W.plus_batch(), None,
                                accum=W.PLUS_ACCUM),
            **{kind: W.train_one(W.v1_config(kind), W.v1_batch(), None)
               for kind in ("GRU", "LSTM")},
            "head": W.head_forward(None)[0]}


def _grad_rel(got, want):
    peak = max(v.abs().max().item() for v in want.values())
    return max((got[k] - v).abs().max().item() for k, v in want.items()) / peak


def test_band_step_matches_jax(job, monkeypatch):
    """The (2, 2) step == the JAX step under make_mesh(data=2, band=2) and
    subband_sharding on the same numpy-made parameters and batch. The JAX
    LSTM's backward takes its lax.scan route (USE_PALLAS_BACKWARD), whose
    step compiles in three quarters of the time."""
    import jax
    from generative_audio_tpu.models import FullSubNetPlusConfig
    from generative_audio_tpu.ops import pallas_lstm
    from generative_audio_tpu.parallel import (
        data_sharding, make_mesh, replicated, subband_sharding)
    from generative_audio_tpu.train import enhance as JE
    from generative_audio_tpu.train.state import (
        create_train_state, make_optimizer)
    from generative_audio_torch.models import FullSubNetPlus
    from generative_audio_torch.utils.convert import (
        convert_fullsubnet_plus, to_jax_fullsubnet_plus)
    monkeypatch.setattr(pallas_lstm, "USE_PALLAS_BACKWARD", False)
    model = W.numpy_state(FullSubNetPlus(
        W.plus_config().model, compute_dtype=torch.float32, device="cpu"), 10)
    jcfg = JE.EnhanceTrainConfig(model=FullSubNetPlusConfig(**W.PLUS),
                                 compute_dtype="float32", **W.PLUS_STFT)
    state = create_train_state(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                               to_jax_fullsubnet_plus(model.state_dict())),
        make_optimizer(jcfg.learning_rate, jcfg.betas,
                       clip_norm=jcfg.clip_grad_norm))
    mesh = make_mesh(data=2, band=2, devices=jax.devices()[:4])
    step = JE.make_enhance_train_step(
        jcfg, subband_sharding=subband_sharding(mesh), donate=False,
        accum_steps=W.PLUS_ACCUM)
    noisy, clean = W.plus_batch()
    state, loss = step(jax.device_put(state, replicated(mesh)),
                       jax.device_put(noisy, data_sharding(mesh, 2)),
                       jax.device_put(clean, data_sharding(mesh, 2)))
    want = convert_fullsubnet_plus(jax.tree_util.tree_map(
        np.asarray, state.params))
    got = job()[0]["plus"]
    assert np.isclose(got["loss"], float(loss), atol=1e-5)
    diff = max((got["state"][k].double() - torch.as_tensor(v).double())
               .abs().max().item() for k, v in want.items())
    assert diff < 1e-3, diff


def test_band_step_matches_one_process(job, one_process):
    """The (2, 2) step == one process on the global batch: the loss within
    1e-6, the gradient apply_gradients finds within 1e-5 of its peak, each
    band rank's sub-band model over its block of the 16 rows of each
    microbatch of its data group."""
    want = one_process["plus"]
    for r in job():
        got = r["plus"]
        assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
        assert _grad_rel(got["grads"], want["grads"]) < 1e-5
        assert r["plus_sharding"] == (r["rank"] % 2, 2)
        assert got["rows"] == [8] * W.PLUS_ACCUM
    assert want["rows"] == [32] * W.PLUS_ACCUM


@pytest.mark.parametrize("kind", ["GRU", "LSTM"])
def test_uneven_blocks_match_one_process(job, one_process, kind):
    """FullSubNet v1 over a (1, 4) mesh: 27 sub-band rows in blocks of 7,
    7, 7, 6 (the full-band model's 3 rows whole on every rank); the loss,
    the gradient and the parameters after Adam against one process."""
    want = one_process[kind]
    for r in job():
        got = r[kind]
        assert got["rows"] == [(7, 7, 7, 6)[r["rank"]]]
        assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
        assert _grad_rel(got["grads"], want["grads"]) < 1e-5
        for k, v in want["state"].items():
            assert (got["state"][k] - v).abs().max().item() < 1e-5, k
    assert want["rows"] == [27]


def test_multi_direction_forward_matches_one_process(job, one_process):
    """MultiDirectionFullSubNetPlus (constructed with the sharding) over a
    (1, 4) mesh: 45 sub-band rows in blocks of 12, 11, 11, 11, the output
    equal to one process's on every rank."""
    want = one_process["head"]
    for r in job():
        out, rows = r["head"]
        assert rows == [(12, 11, 11, 11)[r["rank"]]]
        assert out.shape == want.shape
        torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("run", ["plus", "GRU", "LSTM"])
def test_ranks_bitwise_equal(job, run):
    """After the step every rank holds the same parameters, bit for bit."""
    ranks = job()
    for r in ranks[1:]:
        for k, v in ranks[0][run]["state"].items():
            assert torch.equal(r[run]["state"][k], v), (r["rank"], k)


def test_band_checkpoint_loads_in_one_process(job):
    """The (2, 2) job's checkpoint (written by rank 0; no parameter or
    buffer of the split in the state dict) resumes a single-process
    trainer at rank 0's state."""
    from generative_audio_torch.train import EnhanceTrainer
    want = job()[0]["plus"]["state"]
    trainer = EnhanceTrainer(W.plus_config(), checkpoint_dir=job.checkpoint,
                             device="cpu")
    assert trainer.restore_latest()
    assert trainer.state.step == 1
    sd = trainer.state.model.state_dict()
    assert sorted(sd) == sorted(want)
    assert all(torch.equal(v, want[k]) for k, v in sd.items())


def test_helpers_read_the_data_axis(job):
    """At band=1 (a (4, 1) mesh) the helpers shard by rank as before: the
    mean over 4 ranks, rank 0's value, 2 rows a rank. On (2, 2) the two
    band ranks of a data group load the same 4 rows, the mean is over the
    data axis and the coordinator is global rank 0."""
    for r in job():
        rank = r["rank"]
        d, b = divmod(rank, 2)
        assert r["helpers_4x1"] == {
            "mean": 1.5, "coordinator": 0,
            "local_slice": (2 * rank, 2 * rank + 2),
            "loader_rows": [2.0 * rank, 2.0 * rank + 1]}
        assert r["helpers_2x2"] == {
            "mean": float(b + 1), "coordinator": 0,
            "local_slice": (4 * d, 4 * d + 4),
            "loader_rows": [4.0 * d + i for i in range(4)]}
