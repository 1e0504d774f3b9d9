"""Multi-GPU training of the port on the CPU: 2-process gloo jobs started
through generative_audio_torch.cli.launch (tests/torch_distributed_worker.py
is the ranks' side) against one process.

  * every trainer line, two steps over 2 ranks, against the port's single
    process on the same numpy-made parameters and global batch: losses
    within rtol 1e-5, parameters within the JAX bound of 2e-3
    (tests/test_parallel.py:160-169), BatchNorm running statistics within
    5e-4 (tests/test_distributed.py:251-258), the ranks bit for bit equal;
    the enhance line's 2-rank losses also against the JAX EnhanceTrainer
    on one process (float32, rtol 1e-5);
  * the enhance and restoration CLIs under the launcher (the configs of
    tests/test_distributed.py:121-139 and :151-176): files written by rank 0
    alone, the resume at the saved step with every rank equal to rank 0,
    the restoration line against one process (with a validation: block, so
    the ranks share best_val), and a 2-rank checkpoint loaded into a
    single-process trainer;
  * the launcher's fail-fast rule.

One launch serves the file: it runs in the background while the tests
compute their single-process and JAX references. Each spawn has its own
timeout (240 s) and the process group a shorter one (GAT_TIMEOUT 60 s), so
that a hang fails one test, not the suite.
"""
import json
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
import torch_distributed_worker as W  # noqa: E402

SPAWN_TIMEOUT = 240
WORKER = str(Path(__file__).parent / "torch_distributed_worker.py")


def _launch_cmd(command):
    env = dict(os.environ, GAT_TIMEOUT="60",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    return ([sys.executable, "-m", "generative_audio_torch.cli.launch",
             "--nprocs", "2", "--backend", "gloo", "--"] + command,
            env)


def _launch(command, timeout=SPAWN_TIMEOUT):
    argv, env = _launch_cmd(command)
    return subprocess.run(argv, cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=timeout)


class Job:
    """A 2-rank launch in the background, in a session of its own: the
    tests compute their single-process references meanwhile, and a launch
    past its timeout is killed whole, ranks included."""

    def __init__(self, command, log):
        argv, env = _launch_cmd(command)
        self.log = log
        with open(log, "w") as f:
            self.proc = subprocess.Popen(argv, cwd=str(REPO), env=env,
                                         stdout=f, stderr=subprocess.STDOUT,
                                         start_new_session=True)
        self.t0 = time.time()

    def wait(self):
        if self.proc.returncode is None:
            try:
                self.proc.wait(timeout=max(
                    1.0, SPAWN_TIMEOUT - (time.time() - self.t0)))
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)
                self.proc.wait()
        assert self.proc.returncode == 0, Path(self.log).read_text()[-3000:]

    def kill(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()


def _restoration_cfg(clean_dir, ckpt_dir):
    """tests/test_distributed.py's inpainting config (nfft 255 / hop 128 on
    0.508 s crops: 128 x 64 spectrograms; 8 clips / global batch 4) with a
    validation: block over the same clips."""
    data = {"clean_path": str(clean_dir), "file_glob": "*.wav",
            "sub_sample_length_seconds": 0.508,
            "missing_length_seconds": 0.064, "seed": 11,
            "is_random_sub_sample": False,
            "stft_configuration": {"nfft": 255, "hop_length": 128,
                                   "win_length": 255}}
    return {"line": "restoration", "checkpoint_dir": str(ckpt_dir),
            "train": {"model": {"in_channels": 1, "out_channels": 1,
                                "dropout": 0.2},
                      "num_freqs": 128, "num_frames": 64,
                      "log_interval": 1, "save_interval": 1000},
            "data": data, "validation": {**data, "seed": 12},
            "dataloader": {"global_batch_size": 4, "num_workers": 1,
                           "shuffle": False}}


def _enhance_cfg(clean_dir, noise_dir, ckpt_dir):
    """tests/test_distributed.py:121-139 (global batch 4, 8 clips)."""
    return {"line": "enhance", "checkpoint_dir": str(ckpt_dir),
            "train": {"model": W.ENHANCE_MODEL, "compute_dtype": "float32",
                      **W.STFT},
            "data": {"clean_path": str(clean_dir),
                     "noisy_path": str(noise_dir),
                     "sub_sample_length_seconds": 0.256},
            "dataloader": {"global_batch_size": 4, "num_workers": 1,
                           "shuffle": False}}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """One 2-rank launch for the file: every trainer line for two steps,
    then cli.train's enhance line for an epoch and -R for another, and the
    restoration line likewise."""
    from generative_audio_torch.data import write_synthetic_corpus
    root = tmp_path_factory.mktemp("torch_dist")
    clean, noise = write_synthetic_corpus(root / "corpus", n_clean=8,
                                          n_noise=2, seconds=1.0)
    paths = {"root": root, "clean": clean, "enhance": root / "ck_enhance",
             "restoration": root / "ck_restoration", "out": root / "out"}
    paths["out"].mkdir()
    args = []
    for name, cfg in (
            ("enhance", _enhance_cfg(clean, noise, paths["enhance"])),
            ("restoration", _restoration_cfg(clean, paths["restoration"]))):
        path = root / f"{name}.json"
        path.write_text(json.dumps(cfg))
        run = ["-C", str(path), "--epochs", "1", "--device", "cpu"]
        args += run + ["--"] + run + ["-R", "--"]
    launched = Job([sys.executable, WORKER, str(paths["out"]),
                    "lines", *W.LINES, "::", "cli", *args[:-1]],
                   root / "launch.log")
    paths["job"] = launched
    yield paths
    launched.kill()


def _ranks(job):
    """Each rank's results of the lines (waits for the launch)."""
    if "ranks" not in job:
        job["job"].wait()
        job["ranks"] = [torch.load(job["out"] / f"rank{r}.pt",
                                   weights_only=True) for r in (0, 1)]
    return job["ranks"]


@pytest.fixture(scope="module")
def cli(job):
    """The CLI runs: each rank's record of them and of its writes."""
    job["job"].wait()
    for r in (0, 1):
        job[f"runs{r}"] = json.loads(
            (job["out"] / f"runs_rank{r}.json").read_text())
        job[f"writes{r}"] = json.loads(
            (job["out"] / f"writes_rank{r}.json").read_text())
    return job


def _is_bn_stat(name):
    return "running_" in name or "num_batches_tracked" in name


def test_two_rank_enhance_matches_jax(job, monkeypatch):
    """The enhance line's 2-rank losses against the JAX EnhanceTrainer's
    train step on one process (tests/distributed_worker.py's tiny config,
    float32), on the same parameters and global batches. The JAX LSTM's
    backward takes its lax.scan route (the package's USE_PALLAS_BACKWARD
    switch), whose step compiles in three quarters of the time."""
    import jax
    from generative_audio_tpu.models import FullSubNetPlusConfig
    from generative_audio_tpu.ops import pallas_lstm
    from generative_audio_tpu.train import enhance as JE
    from generative_audio_tpu.train.state import (
        create_train_state, make_optimizer)
    from generative_audio_torch.models import FullSubNetPlus
    from generative_audio_torch.utils.convert import to_jax_fullsubnet_plus
    monkeypatch.setattr(pallas_lstm, "USE_PALLAS_BACKWARD", False)
    model = W.numpy_state(FullSubNetPlus(
        W.enhance_config().model, compute_dtype=torch.float32, device="cpu"),
        10)
    jcfg = JE.EnhanceTrainConfig(
        model=FullSubNetPlusConfig(**W.ENHANCE_MODEL),
        compute_dtype="float32", **W.STFT)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        to_jax_fullsubnet_plus(model.state_dict()))
    state = create_train_state(params, make_optimizer(
        jcfg.learning_rate, jcfg.betas, clip_norm=jcfg.clip_grad_norm))
    step = JE.make_enhance_train_step(jcfg, donate=False)
    losses = []
    for noisy, clean in W.enhance_batches():
        state, loss = step(state, noisy, clean)
        losses.append(float(loss))
    np.testing.assert_allclose(_ranks(job)[0]["enhance"]["losses"], losses,
                               rtol=1e-5)


@pytest.mark.parametrize("line", list(W.LINES))
def test_two_ranks_match_one_process(job, line):
    """Two steps over 2 ranks == two steps of one process on the global
    batch (drop_band by global row, the dropout and MC masks and the
    distortions drawn for the global batch, global BatchNorm and
    normalisation statistics, the masked MSE over the global gap count,
    DDP's mean of the gradient, accum_steps=2 under no_sync)."""
    want = W.run_line(line, None)
    got, other = (r[line] for r in _ranks(job))
    for k, v in got["state"].items():
        assert torch.equal(v, other["state"][k]), f"ranks differ at {k}"
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k, v in want["state"].items():
        diff = (got["state"][k].double() - v.double()).abs().max().item()
        bound = 5e-4 if _is_bn_stat(k) else 2e-3
        assert diff < bound, (k, diff)
    if line in ("restoration", "nppc_inpainting"):
        assert any("running_var" in k for k in want["state"])


# -------------------------------------------------------------------- CLI --
def _state(cli, rank, run):
    return torch.load(cli["out"] / f"state_rank{rank}_{run}.pt",
                      weights_only=True)


@pytest.mark.parametrize("line,first", [("enhance", 0), ("restoration", 2)])
def test_cli_resume_on_every_rank(cli, line, first):
    """latest_step.json reads 2 after the first epoch and 4 after -R; after
    each run every rank's parameters and buffers are rank 0's, bit for
    bit."""
    for r in (0, 1):
        runs = cli[f"runs{r}"]
        assert [runs[first]["latest_step"], runs[first + 1]["latest_step"]] \
            == [2, 4]
        assert [runs[first]["step"], runs[first + 1]["step"]] == [2, 4]
    for run in (first, first + 1):
        a, b = _state(cli, 0, run), _state(cli, 1, run)
        assert all(torch.equal(v, b[k]) for k, v in a.items())
    if line == "restoration":     # best/ was decided alike on both ranks
        assert cli["runs0"][first + 1]["best_val"] == \
            cli["runs1"][first + 1]["best_val"] < float("inf")
        assert (cli["restoration"] / "best.pt").exists()


def test_cli_files_from_rank_zero_only(cli):
    """Rank 1 opened no file for writing in either checkpoint directory;
    rank 0 wrote the checkpoints, the sidecars and the reports."""
    dirs = [str(cli["enhance"]), str(cli["restoration"])]
    assert not [p for p in cli["writes1"]
                if any(p.startswith(d) for d in dirs)]
    names = {Path(p).name for p in cli["writes0"]}
    assert {".latest.pt.tmp", ".latest_step.json.tmp", ".config.json.tmp",
            ".best.pt.tmp", ".best_score.json.tmp", "report.html"} <= names
    for d in ("enhance", "restoration"):
        assert (cli[d] / "latest.pt").exists()
        assert (cli[d] / "step_00000004.pt").exists()


def test_cli_restoration_two_ranks_match_one_process(job, tmp_path):
    """The restoration CLI over 2 ranks against the same CLI in one
    process: the parameters within 2e-3, the BatchNorm statistics within
    5e-4 (tests/test_distributed.py:251-258)."""
    from generative_audio_torch.cli import train as train_cli
    cfg = _restoration_cfg(job["clean"], tmp_path / "ck")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    one = train_cli.main(["-C", str(path), "--epochs", "1", "--device",
                          "cpu"])
    assert one.state.step == 2
    job["job"].wait()
    two = _state(job, 0, 2)
    for k, v in one.state.model.state_dict().items():
        diff = (two[k].double() - v.double()).abs().max().item()
        assert diff < (5e-4 if _is_bn_stat(k) else 2e-3), (k, diff)


@pytest.mark.parametrize("line", ["enhance", "restoration"])
def test_two_rank_checkpoint_loads_in_one_process(cli, line):
    """A checkpoint written by 2 ranks (reference state-dict keys, no DDP
    prefix) resumes a single-process trainer at rank 0's state."""
    from generative_audio_torch import train as T
    from generative_audio_torch.utils.config import build_dataclass
    raw = json.loads((cli["root"] / f"{line}.json").read_text())
    if line == "enhance":
        trainer = T.EnhanceTrainer(
            build_dataclass(T.EnhanceTrainConfig, raw["train"]),
            checkpoint_dir=cli[line], device="cpu")
    else:
        trainer = T.RestorationTrainer(
            build_dataclass(T.RestorationTrainConfig, raw["train"]),
            checkpoint_dir=cli[line], device="cpu")
    assert trainer.restore_latest()
    assert trainer.state.step == 4
    want = _state(cli, 0, 1 if line == "enhance" else 3)
    sd = trainer.state.model.state_dict()
    assert not [k for k in sd if k.startswith("module.")]
    assert all(torch.equal(v, want[k]) for k, v in sd.items())


def test_launcher_fails_fast_on_rank_failure():
    """A failed rank terminates the others at once and its exit code is the
    launcher's (tests/test_distributed.py:71-90)."""
    t0 = time.time()
    proc = _launch([sys.executable, "-c",
                    "import os, sys, time\n"
                    "if os.environ['GAT_PROCESS_ID'] == '1':\n"
                    "    sys.exit(3)\n"
                    "time.sleep(120)\n"], timeout=60)
    assert proc.returncode == 3, proc.stderr[-500:]
    assert time.time() - t0 < 30
