"""The port's inpainting trainers, dataset and CLI lines against the JAX
package on the CPU: one RestorationTrainer step (loss, gradients, the
parameters after Adam, BatchNorm's running statistics), one
NPPCInpaintingTrainer base step at the shipped dropouts and one
mc_pca_aligned step on injected MC samples, both trainers' resume,
AudioInpaintingDataset items and collate_inpainting for a seed, and the
training CLI's restoration and nppc_inpainting lines on a corpus on disk,
with the JAX CLI's two quirks pinned.

Both UNets at the shipped widths over a 32 x 64 spectrogram, batch 2,
float32; the JAX trainers start from numpy-made variables (their
jit_init replaced), so that no JAX init runs. Tolerances: losses and
objectives within 1e-5 relative; each gradient tensor whose norm is above
1e-3 of the largest within cosine 0.9999 and a norm ratio of 1 +/- 1e-3
(the others are rounding noise: conv biases before a training-mode
BatchNorm have a zero gradient); every gradient element within 1e-3 of
the largest (measured 4.6e-4: the BatchNorm backward's sums over 2 x 32 x
64 values cancel); the parameters after Adam as tests/test_torch_training.py
holds them: within twice the learning rate everywhere (Adam divides by
|g|, so an element whose gradient is rounding noise moves by the learning
rate either way), within 2% of it where the gradient is above 2e-3 of the
largest element (twice the noise bound, so no sign there can flip), and
with a first-order effect on the loss below 1e-3 of the step's; running statistics within 1e-5 of their peak; dataset STFTs
within 1e-5 of their peak (two FFT libraries), every other array and the
metadata equal.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from generative_audio_tpu import train as JT
from generative_audio_tpu.data import inpainting_dataset as jax_ds
from generative_audio_tpu.eval import mc_dropout as jax_mc
from generative_audio_tpu.models import nppc_model as jax_nppc
from generative_audio_tpu.models.pc_wrapper import (
    AudioInpaintingPCWrapperConfig as JaxPCConfig)
from generative_audio_torch import train as T
from generative_audio_torch.cli import train as train_cli
from generative_audio_torch.data import inpainting_dataset as ds
from generative_audio_torch.data.audio_dataset import item_rng
from generative_audio_torch.eval import mc_dropout
from generative_audio_torch.models import (
    AudioInpaintingPCWrapperConfig, InpaintingNPPCConfig, UNetModelConfig)
from generative_audio_torch.train.restoration import device_batch
from generative_audio_torch.utils import convert
from generative_audio_torch.utils.config import build_dataclass

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
F_, T_, B = 32, 64, 2
LR = 1e-4


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((B, 2, F_, T_)).astype(np.float32)
    mask = np.ones((B, T_), np.float32)
    mask[:, 20:30] = 0
    return clean * mask[:, None, None, :], mask, clean


def _perturbed(variables, seed):
    """BatchNorm parameters and running statistics drawn around their init
    (in place)."""
    rng = np.random.default_rng(seed)

    def walk(p, s):
        for k in p:
            if k.startswith("bn"):
                n = p[k]["scale"].shape
                p[k]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                p[k]["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
                s[k]["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])

    walk(variables["params"], variables["batch_stats"])
    return variables


def _compare_grads(got, want):
    """got, want: {path: array} of the same leaves."""
    norms = {k: np.linalg.norm(v) for k, v in want.items()}
    top = max(norms.values())
    compared = 0
    for k, w in want.items():
        g = got[k]
        if norms[k] > 1e-3 * top:
            cos = np.sum(g * w) / (np.linalg.norm(g) * norms[k])
            assert cos >= 0.9999, (k, cos)
            assert abs(np.linalg.norm(g) / norms[k] - 1) < 1e-3, k
            compared += 1
        else:
            assert np.linalg.norm(g) < 1e-3 * top, k
    assert compared >= len(want) // 2


def _leaves(tree):
    return {tuple(getattr(p, "key", p) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


# ------------------------------------------------------ restoration step --
@pytest.fixture(scope="module")
def restoration_pair():
    """(JAX trainer, port trainer) from the same numpy-made variables, the
    UNet at dropout 0, so that both steps are deterministic."""
    unet_vars = _perturbed(convert.random_unet_params(1, 1, 30), 31)
    variables = {"params": {"net": unet_vars["params"]},
                 "batch_stats": {"net": unet_vars["batch_stats"]}}
    cfg = dict(model=UNetModelConfig(1, 1, 0.0), num_freqs=F_,
               num_frames=T_, learning_rate=LR)
    mp = pytest.MonkeyPatch()
    mp.setattr("generative_audio_tpu.train.restoration.jit_init",
               lambda fn: (lambda key: variables))
    jt = JT.RestorationTrainer(JT.RestorationTrainConfig(
        **{**cfg, "model": jax_nppc.UNetModelConfig(1, 1, 0.0)}))
    mp.undo()
    pt = T.RestorationTrainer(T.RestorationTrainConfig(**cfg), device="cpu")
    pt.state.model.load_state_dict(
        convert.convert_inpainting_restoration(variables))
    return jt, pt


def test_restoration_step_matches_jax(restoration_pair):
    jt, pt = restoration_pair
    batch = _batch(1)
    jbatch = tuple(jnp.asarray(x) for x in batch)

    @jax.jit
    def jax_step(state, rng, batch):
        (loss, stats), grads = jax.value_and_grad(
            jt._loss, has_aux=True)(state.params, state.batch_stats, rng,
                                    batch, True)
        return loss, grads, state.apply_gradients(grads,
                                                  new_batch_stats=stats)

    loss, grads, new_state = jax_step(jt.state, jax.random.PRNGKey(0), jbatch)
    model = pt.state.model
    got_loss = pt.loss(device_batch(batch, "cpu"), train=True)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-5)
    port_grads = convert.to_jax_unet(
        {k: p.grad for k, p in model.named_parameters()}, "net.")["params"]
    _compare_grads(_leaves(port_grads), _leaves(grads["net"]))
    first = {k: np.abs(g) for k, g in _leaves(grads["net"]).items()}
    got_first = _leaves(port_grads)
    peak = max(g.max() for g in first.values())
    noise = max(np.abs(got_first[k] - _leaves(grads["net"])[k]).max()
                for k in first) / peak
    assert noise < 1e-3, noise
    start = _leaves(convert.to_jax_unet(model.state_dict(), "net.")["params"])
    pt.state.apply_gradients()
    after = _leaves(convert.to_jax_unet(model.state_dict(), "net.")["params"])
    effect = moved = 0.0
    for k, w in _leaves(new_state.params["net"]).items():
        diff = np.abs(after[k] - w)
        assert diff.max() <= 2 * LR + 1e-6, k           # Adam's own bound
        clear = first[k] > 2e-3 * peak
        assert diff[clear].max(initial=0) <= 0.02 * LR, k
        effect += float((first[k] * diff).sum())
        moved += float((first[k] * np.abs(w - start[k])).sum())
    assert effect <= 1e-3 * moved, (effect, moved)
    stats = _leaves(convert.to_jax_unet(model.state_dict(), "net.")
                    ["batch_stats"])
    for k, w in _leaves(new_state.batch_stats["net"]).items():
        np.testing.assert_allclose(stats[k], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert pt.state.step == 1


def test_restoration_trainer_resume_keeps_best(tmp_path):
    """Validation at each log point keeps the val-minimum best/, a resume
    restores the step, the EMA and best_val, and best/ holds the EMA
    parameters (AdamW with weight decay)."""
    cfg = T.RestorationTrainConfig(
        model=UNetModelConfig(1, 1, 0.2), log_interval=2, save_interval=100,
        ema_decay=0.9, optimizer="adamw", weight_decay=1e-4)
    trainer = T.RestorationTrainer(cfg, checkpoint_dir=tmp_path / "r",
                                   device="cpu")
    batch = _batch(2)
    losses = trainer.train([batch] * 3, n_steps=6, val_loader=[batch],
                           log=lambda *a: None)
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert trainer.best_val == min(v for _, v in trainer.val_loss_history)
    assert trainer.ckpt.best_score() == pytest.approx(trainer.best_val)
    best = trainer.ckpt.restore("best")["params"]
    key = "net.up4.conv.conv.3.weight"
    assert not torch.equal(best[key],
                           trainer.state.model.state_dict()[key])
    assert list(tmp_path.joinpath("r").glob("metrics_final_*.json"))

    fresh = T.RestorationTrainer(cfg, checkpoint_dir=tmp_path / "r",
                                 device="cpu")
    assert fresh.best_val == float("inf") and fresh.restore_latest()
    assert fresh.state.step == 6
    assert fresh.best_val == pytest.approx(trainer.best_val)
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(v, fresh.state.model.state_dict()[k]), k
    for k, v in trainer.state.ema_params.items():
        assert torch.equal(v, fresh.state.ema_params[k]), k
    # a resumed run whose validation is worse leaves best/ alone
    fresh.best_val = -1.0
    fresh.train([batch], n_steps=2, val_loader=[batch], log=lambda *a: None)
    assert fresh.state.step == 8
    assert fresh.ckpt.best_score() == pytest.approx(trainer.best_val)


# ------------------------------------------------------------ NPPC steps --
def _nppc_configs(variant):
    kw = dict(num_freqs=F_, num_frames=T_, learning_rate=LR,
              second_moment_loss_grace=4, objective_variant=variant,
              n_mc_samples=6, mc_chunk_size=4)
    jcfg = JT.NPPCInpaintingTrainConfig(
        model=jax_nppc.InpaintingNPPCConfig(
            restoration=jax_nppc.UNetModelConfig(1, 1, 0.2),
            pc_wrapper=JaxPCConfig(2, 3, 0.0, 3)), **kw)
    pcfg = T.NPPCInpaintingTrainConfig(
        model=InpaintingNPPCConfig(
            restoration=UNetModelConfig(1, 1, 0.2),
            pc_wrapper=AudioInpaintingPCWrapperConfig(2, 3, 0.0, 3)), **kw)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def nppc_variables():
    v = convert.random_inpainting_nppc_params(_nppc_configs("base_step")[1].model,
                                              seed=40)
    for name in ("pretrained_restoration_model", "pc_wrapper"):
        _perturbed({"params": v["params"][name]["net"],
                    "batch_stats": v["batch_stats"][name]["net"]}, 41)
    return v


def _nppc_pair(variables, variant):
    jcfg, pcfg = _nppc_configs(variant)
    mp = pytest.MonkeyPatch()
    mp.setattr("generative_audio_tpu.train.nppc.jit_init",
               lambda fn: (lambda key: variables))
    jt = JT.NPPCInpaintingTrainer(jcfg)
    mp.undo()
    pt = T.NPPCInpaintingTrainer(pcfg, device="cpu")
    pt.state.model.load_state_dict(convert.convert_inpainting_nppc(variables))
    return jt, pt


def _nppc_step(jt, pt, batch, step):
    """The JAX objective, reconst_err, head gradients and PC UNet stats;
    the port's step on the same batch; compared."""
    @jax.jit
    def jax_fn(params, stats, batch):
        return jax.value_and_grad(jt._objective, has_aux=True)(
            params, stats, jax.random.PRNGKey(0), batch, jnp.int32(step),
            True)

    (obj, (reconst, new_stats, _)), grads = jax_fn(
        jt.state.params, jt.state.batch_stats,
        tuple(jnp.asarray(x) for x in batch))
    model = pt.state.model
    frozen = {k: v.clone() for k, v in
              model.pretrained_restoration_model.state_dict().items()}
    got_obj, got_rec, _ = pt.objective(device_batch(batch, "cpu"), step,
                                       train=True)
    got_obj.backward()
    np.testing.assert_allclose(got_obj.item(), float(obj), rtol=1e-5)
    np.testing.assert_allclose(got_rec.detach().numpy(), reconst, rtol=1e-5)
    head = convert.to_jax_unet({k: p.grad for k, p in
                                model.named_parameters()}, "pc_wrapper.net.")
    _compare_grads(_leaves(head["params"]),
                   _leaves(grads["pc_wrapper"]["net"]))
    assert all(p.grad is None
               for p in model.pretrained_restoration_model.parameters())
    stats = convert.to_jax_unet(model.state_dict(), "pc_wrapper.net.")
    for k, w in _leaves(new_stats["pc_wrapper"]["net"]).items():
        np.testing.assert_allclose(_leaves(stats["batch_stats"])[k], w,
                                   rtol=0, atol=1e-5 * np.abs(w).max())
    for k, v in model.pretrained_restoration_model.state_dict().items():
        assert torch.equal(v, frozen[k]), k


def test_nppc_base_step_matches_jax(nppc_variables):
    """The shipped dropouts: the frozen UNet at 0.2 but in eval (no
    dropout, its running statistics), the PC UNet at 0.0 in training."""
    jt, pt = _nppc_pair(nppc_variables, "base_step")
    _nppc_step(jt, pt, _batch(3), step=3)


def test_nppc_mc_pca_aligned_step_matches_jax(nppc_variables, monkeypatch):
    """mc_pca_aligned on the same six MC samples on both sides (each
    side's mc_dropout_inference replaced): the objective squares its
    projections, so the PCA's signs do not matter."""
    samples = np.random.default_rng(42).standard_normal(
        (6, B, 1, F_, T_)).astype(np.float32)
    monkeypatch.setattr(jax_mc, "mc_dropout_inference",
                        lambda *a, **k: jnp.asarray(samples))
    monkeypatch.setattr(mc_dropout, "mc_dropout_inference",
                        lambda *a, **k: torch.from_numpy(samples))
    jt, pt = _nppc_pair(nppc_variables, "mc_pca_aligned")
    _nppc_step(jt, pt, _batch(4), step=5)


def test_nppc_mc_step_draws_its_own_passes(nppc_variables):
    """The real MC path on the CPU: the six passes of a step are distinct,
    a step's objective is finite, evaluation draws the same passes each
    time, the frozen UNet is untouched and the head moves."""
    _, pt = _nppc_pair(nppc_variables, "mc_pca_aligned")
    batch = device_batch(_batch(5), "cpu")
    with torch.no_grad():
        a = pt.objective(batch, 0, train=False)[0]
        b = pt.objective(batch, 0, train=False)[0]
    assert torch.equal(a, b)
    head = pt.state.model.pc_wrapper.net.outc.conv.weight.clone()
    obj, rec = pt.train_step(_batch(5))
    assert np.isfinite(obj.item()) and 0 <= rec.item() <= 1
    assert not torch.equal(head, pt.state.model.pc_wrapper.net.outc.conv.weight)


def test_nppc_trainer_resume(tmp_path, nppc_variables):
    _, pcfg = _nppc_configs("base_step")
    pcfg = T.NPPCInpaintingTrainConfig(**{**pcfg.__dict__, "log_interval": 2})
    trainer = T.NPPCInpaintingTrainer(
        pcfg, restoration_variables=convert.convert_inpainting_restoration(
            {k: v["pretrained_restoration_model"]
             for k, v in nppc_variables.items()}),
        checkpoint_dir=tmp_path / "n", device="cpu")
    batch = _batch(6)
    trainer.train([batch] * 2, n_steps=4, val_loader=[batch],
                  log=lambda *a: None)
    fresh = T.NPPCInpaintingTrainer(pcfg, checkpoint_dir=tmp_path / "n",
                                    device="cpu")
    assert fresh.restore_latest() and fresh.state.step == 4
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(v, fresh.state.model.state_dict()[k]), k
    fresh.train([batch], n_steps=1, log=lambda *a: None)
    assert fresh.state.step == 5
    metrics = json.loads(sorted(tmp_path.joinpath("n").glob(
        "metrics_final_*.json"))[-1].read_text())
    assert metrics["total_steps"] == 5 and np.isfinite(metrics["final_loss"])


def test_from_artifact(tmp_path):
    """from_artifact finds latest.pt one level down in the artifact."""
    from generative_audio_torch.utils.tracking import ArtifactRegistry
    rest = T.RestorationTrainer(T.RestorationTrainConfig(),
                                checkpoint_dir=tmp_path / "ckpt",
                                device="cpu")
    rest._save(0)
    ref = ArtifactRegistry(tmp_path / "reg").log_artifact(
        "restoration-model", tmp_path / "ckpt")
    trainer = T.NPPCInpaintingTrainer.from_artifact(
        T.NPPCInpaintingTrainConfig(), tmp_path / "reg", ref, device="cpu")
    for k, v in rest.state.model.state_dict().items():
        assert torch.equal(
            v, trainer.state.model.pretrained_restoration_model
            .state_dict()[k]), k


# --------------------------------------------------------------- dataset --
def _speechlike(rng, seconds, sr=16000):
    """Tone bursts with silences between them, so that a VAD finds
    segments."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    env = (np.sin(2 * np.pi * 1.5 * t) > 0.1).astype(np.float64)
    tone = np.sin(2 * np.pi * rng.uniform(120, 250) * t)
    return (0.3 * env * tone + 0.003 * rng.standard_normal(n)
            ).astype(np.float32)


def _corpus(root, n_files=6, seconds=(0.5, 1.2)):
    """A LibriSpeech layout: speaker/chapter/{speaker}-{chapter}-{i}.wav and
    {speaker}-{chapter}.trans.txt."""
    rng = np.random.default_rng(7)
    for spk in ("19", "26"):
        chapter = root / spk / "198"
        chapter.mkdir(parents=True)
        lines = []
        for i in range(n_files // 2):
            stem = f"{spk}-198-{i:04d}"
            wav = _speechlike(rng, rng.uniform(*seconds))
            wavfile.write(chapter / f"{stem}.wav", 16000,
                          (wav * 32767).astype(np.int16))
            lines.append(f"{stem} WORDS OF {spk} NUMBER {i}")
        (chapter / f"{spk}-198.trans.txt").write_text("\n".join(lines) + "\n")
    return root


DATA = dict(sample_rate=16000, missing_length_seconds=0.016,
            sub_sample_length_seconds=0.128, file_glob="*.wav",
            stft_configuration={"nfft": 63, "hop_length": 32,
                                "win_length": 63})


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("librispeech"))


def _items_equal(got, want):
    for name in ("stft_masked", "stft_clean"):
        w = getattr(want, name)
        np.testing.assert_allclose(getattr(got, name), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    for name in ("mask_frames", "masked_audio"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    for name in ("clean_audio_path", "subsample_start_idx", "mask_start_idx",
                 "mask_end_idx", "mask_start_frame_idx", "mask_end_frame_idx",
                 "transcription", "sample_rate"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("extra", [
    {"seed": 3},
    {"seed": 5, "missing_start_seconds": 0.04, "target_dB_FS_floating_value":
     5.0},
    {"seed": 8, "use_vad": True, "vad_type": "entropy"},
    {"seed": 9, "use_vad": True, "vad_type": "energy"}])
def test_dataset_items_match_jax(corpus, extra):
    cfg = {**DATA, "clean_path": str(corpus), **extra}
    got = ds.AudioInpaintingDataset(build_dataclass(
        ds.AudioInpaintingConfig, cfg))
    want = jax_ds.AudioInpaintingDataset(build_dataclass(
        jax_ds.AudioInpaintingConfig, cfg))
    assert len(got) == len(want) == 6
    assert got.transcriptions == want.transcriptions
    assert got.transcriptions["26-198-0001"] == "WORDS OF 26 NUMBER 1"
    for i in range(len(got)):
        _items_equal(got[i], want[i])
    batch = ds.collate_inpainting([got[i] for i in range(3)])
    jbatch = jax_ds.collate_inpainting([want[i] for i in range(3)])
    assert batch[4] == jbatch[4]
    for g, w in zip(batch[:4], jbatch[:4]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_unseeded_dataset_draws_per_item(corpus):
    """Without config.seed, item i of epoch e draws from
    default_rng([seed, e, i]): with the JAX dataset's shared generator set
    to it, the items are the JAX items; another epoch gives another draw."""
    cfg = {**DATA, "clean_path": str(corpus)}
    got = ds.AudioInpaintingDataset(build_dataclass(
        ds.AudioInpaintingConfig, cfg), seed=11)
    want = jax_ds.AudioInpaintingDataset(build_dataclass(
        jax_ds.AudioInpaintingConfig, cfg))
    for i in range(len(got)):
        want._rng = item_rng(11, 0, i)
        _items_equal(got[i], want[i])
    first = got[0].subsample_start_idx, got[0].mask_start_idx
    got.set_epoch(1)
    assert (got[0].subsample_start_idx, got[0].mask_start_idx) != first
    assert ds.time_to_spec_mask(np.ones(100), 5, 100, 31, 16).all()


# ------------------------------------------------------------------- CLI --
def _cli_config(tmp_path, corpus, line, **extra):
    cfg = {"line": line, "checkpoint_dir": str(tmp_path / line),
           "data": {**DATA, "clean_path": str(corpus)},
           "dataloader": {"global_batch_size": 2, "num_workers": 2,
                          "seed": 0},
           **extra}
    path = tmp_path / f"{line}.json"
    path.write_text(json.dumps(cfg))
    return path


def test_cli_restoration_then_nppc_inpainting(tmp_path, corpus):
    """The restoration line, 2 epochs of 2 steps with a validation block,
    then -R for one more; the nppc_inpainting line over its best/ (not its
    latest/), then -R."""
    train = {"model": {"in_channels": 1, "out_channels": 1, "dropout": 0.2},
             "num_freqs": 32, "num_frames": 65, "log_interval": 1,
             "save_interval": 100}
    val = {**DATA, "clean_path": str(corpus), "seed": 4}
    rest_cfg = _cli_config(tmp_path, corpus, "restoration", train=train,
                           validation=val)
    args = ["-C", str(rest_cfg), "--device", "cpu", "--steps", "2"]
    first = train_cli.main(args + ["--epochs", "2"])
    assert first.state.step == 4 and len(first.val_loss_history) == 4
    second = train_cli.main(args + ["-R", "--epochs", "1"])
    assert second.state.step == 6
    assert second.best_val <= first.best_val
    ckpt = second.ckpt
    best = ckpt.restore("best")["params"]
    latest = ckpt.restore("latest")["params"]
    key = "net.inc.conv.0.weight"
    assert not torch.equal(best[key], latest[key])

    nppc_train = {"model": {"restoration": train["model"],
                            "pc_wrapper": {"in_channels": 2,
                                           "out_channels": 3, "n_dirs": 3}},
                  "num_freqs": 32, "num_frames": 65,
                  "second_moment_loss_grace": 4, "log_interval": 1}
    nppc_cfg = _cli_config(tmp_path, corpus, "nppc_inpainting",
                           train=nppc_train,
                           pretrained_restoration_checkpoint=str(
                               tmp_path / "restoration"))
    args = ["-C", str(nppc_cfg), "--device", "cpu", "--steps", "2"]
    nppc = train_cli.main(args)
    frozen = nppc.state.model.pretrained_restoration_model.state_dict()
    for k, v in best.items():
        assert torch.equal(frozen[k], v), k
    assert nppc.state.step == 2 and np.isfinite(nppc.loss_history).all()
    resumed = train_cli.main(args + ["-R"])
    assert resumed.state.step == 4


def test_cli_nppc_inpainting_quirks(tmp_path, corpus, monkeypatch):
    """The JAX CLI restores the restoration checkpoint's latest/ and, where
    the named directory holds nothing, trains over a random UNet without a
    word (both seen through fakes of its checkpoint manager and trainers).
    The port takes best/ (then latest/) and raises for an empty
    directory."""
    import generative_audio_tpu.train as jax_train
    from generative_audio_tpu.cli import train as jax_cli
    requested, built = [], {}

    class FakeManager:
        def __init__(self, directory, *a, **k):
            self.directory = Path(directory)

        def restore(self, name, tree=None, partial=False):
            requested.append(name)
            return None

    class FakeProbe:
        def __init__(self, *a, **k):
            self.state = type("S", (), {"params": {}, "batch_stats": {},
                                        "opt_state": {}})()

    class Stop(Exception):
        pass

    def fake_nppc(cfg, restoration_variables=None, **k):
        built["restoration_variables"] = restoration_variables
        raise Stop

    monkeypatch.setattr(jax_train, "CheckpointManager", FakeManager)
    monkeypatch.setattr(jax_train, "RestorationTrainer", FakeProbe)
    monkeypatch.setattr(jax_train, "NPPCInpaintingTrainer", fake_nppc)
    empty = tmp_path / "empty"
    empty.mkdir()
    cfg = _cli_config(tmp_path, corpus, "nppc_inpainting",
                      pretrained_restoration_checkpoint=str(empty))
    with pytest.raises(Stop):
        jax_cli.main(["-C", str(cfg)])
    assert requested == ["latest"]
    assert built["restoration_variables"] is None
    with pytest.raises(FileNotFoundError, match="holds no best.pt"):
        train_cli.main(["-C", str(cfg), "--device", "cpu"])

    rest = T.RestorationTrainer(T.RestorationTrainConfig(),
                                checkpoint_dir=tmp_path / "only_latest",
                                device="cpu")
    rest._save(3)
    sd, name = train_cli.restoration_checkpoint(tmp_path / "only_latest")
    assert name == "latest"
    rest.ckpt.save_best({"params": rest.selected_state_dict()}, 0.5, 3)
    assert train_cli.restoration_checkpoint(tmp_path / "only_latest")[1] == \
        "best"


@pytest.mark.parametrize("name", ["inpainting_restoration", "inpainting_nppc"])
def test_shipped_configs_build(name):
    """Both shipped configs build the port's dataclasses as the JAX
    package's (the batch of 128 and 5 directions at 128 x 256)."""
    raw = yaml.safe_load((REPO / "configs" / f"{name}.yaml").read_text())
    data = build_dataclass(ds.AudioInpaintingConfig, raw["data"])
    jdata = build_dataclass(jax_ds.AudioInpaintingConfig, raw["data"])
    assert data.sub_sample_length == jdata.sub_sample_length == 32704
    assert data.stft_configuration.nfft == 255
    cls, jcls = ((T.RestorationTrainConfig, JT.RestorationTrainConfig)
                 if raw["line"] == "restoration" else
                 (T.NPPCInpaintingTrainConfig, JT.NPPCInpaintingTrainConfig))
    cfg, jcfg = (build_dataclass(c, raw["train"]) for c in (cls, jcls))
    assert (cfg.num_freqs, cfg.num_frames) == (128, 256)
    assert raw["dataloader"]["global_batch_size"] == 128
    if raw["line"] == "nppc_inpainting":
        assert cfg.model.pc_wrapper.n_dirs == jcfg.model.pc_wrapper.n_dirs == 5
        assert cfg.model.restoration.dropout == 0.2
