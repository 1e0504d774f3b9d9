"""The port's denoising-NPPC line against the JAX package on the CPU: the
MultiDirectionFullSubNetPlus head, DenoisingNPPCModel, the params' round
trip, NPPCDenoisingTrainer's steps and checkpoints, DenoisingNPPCValidator,
and the training CLI's nppc_denoising line.

Small configuration: 32 bins from a 62-point STFT (hop 32), TCN towers at
width 16, sub-band LSTM H=8 with 2 neighbours, 3 directions, the head's
drop_band with G=2 and the enhancer's with G=1, batch 4. Weights come from
the JAX `init` through generative_audio_torch.utils.convert. Both sides are
float32 with sums in another order: outputs agree to 1e-4 of their peak,
objectives to 1e-4 relative over three steps. Parameters after the steps
are compared as tests/test_torch_training.py compares them: where the first
gradient is above 1e-4 of its global peak (Adam divides by |g|, so an
element with a near-zero gradient may move by the learning rate either
way).
"""
import json
import struct
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from generative_audio_tpu.eval.nppc_denoising_validator import (
    DenoisingNPPCValidator as JaxValidator,
    DenoisingNPPCValidatorConfig as JaxValidatorConfig)
from generative_audio_tpu.models import (
    FullSubNetPlusConfig as JaxPlusConfig,
    MultiDirectionConfig as JaxMDConfig,
    MultiDirectionFullSubNetPlus as JaxMD)
from generative_audio_tpu.models.nppc_model import (
    DenoisingNPPCConfig as JaxNPPCConfig, DenoisingNPPCModel as JaxNPPCModel,
    StftConfig as JaxStftConfig)
from generative_audio_tpu.ops.mask import compress_cIRM as jax_compress
from generative_audio_tpu.train.nppc import (
    NPPCDenoisingTrainConfig as JaxTrainConfig,
    NPPCDenoisingTrainer as JaxTrainer)
from generative_audio_tpu.utils import torch_convert
from generative_audio_torch.cli import train as train_cli
from generative_audio_torch.data import write_synthetic_corpus
from generative_audio_torch.eval import (
    DenoisingNPPCValidator, DenoisingNPPCValidatorConfig)
from generative_audio_torch.eval.nppc_denoising_validator import figure_size
from generative_audio_torch.models import (
    DenoisingNPPCConfig, DenoisingNPPCModel, FullSubNetPlusConfig,
    MultiDirectionConfig, MultiDirectionFullSubNetPlus, StftConfig)
from generative_audio_torch.ops.mask import compress_cIRM
from generative_audio_torch.train import (
    NPPCDenoisingTrainConfig, NPPCDenoisingTrainer)
from generative_audio_torch.utils import convert

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
SMALL = dict(num_freqs=32, sb_num_neighbors=2, fb_model_hidden_size=16,
             sb_model_hidden_size=8)
N_DIRS, LR = 3, 1e-4
STFT = dict(nfft=62, hop_length=32, win_length=62)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _peak_close(got, want, share=1e-4):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=share * np.abs(want).max())


def _model_configs():
    jax_cfg = JaxNPPCConfig(
        restoration=JaxPlusConfig(num_groups_in_drop_band=1, **SMALL),
        pc_wrapper=JaxMDConfig(n_directions=N_DIRS, num_groups_in_drop_band=2,
                               **SMALL),
        stft=JaxStftConfig(**STFT))
    port_cfg = DenoisingNPPCConfig(
        restoration=FullSubNetPlusConfig(num_groups_in_drop_band=1, **SMALL),
        pc_wrapper=MultiDirectionConfig(n_directions=N_DIRS,
                                        num_groups_in_drop_band=2, **SMALL),
        stft=StftConfig(**STFT))
    return jax_cfg, port_cfg


def _batch(seed=0, batch=4, samples=2048):
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((batch, samples)) * 0.3).astype(np.float32)
    noisy = clean + (rng.standard_normal((batch, samples)) * 0.1
                     ).astype(np.float32)
    return noisy, clean


@pytest.fixture(scope="module")
def jax_trainer():
    """The JAX trainer at the small configuration: its initial params are
    the weights every test below carries across."""
    jax_cfg, _ = _model_configs()
    return JaxTrainer(JaxTrainConfig(model=jax_cfg, learning_rate=LR,
                                     second_moment_loss_lambda=0.1,
                                     second_moment_loss_grace=2),
                      example_length=2048)


def _params(trainer):
    return jax.tree_util.tree_map(np.asarray, trainer.state.params)


def _port_model(params, port_cfg):
    model = DenoisingNPPCModel(port_cfg, compute_dtype=torch.float32,
                               device="cpu")
    model.load_state_dict(convert.convert_denoising_nppc(params))
    return model


@pytest.mark.parametrize("batch", [1, 4])
def test_multidirection_matches_jax(jax_trainer, batch):
    """B = 1 (no drop_band) and B = 4 with G = 2 (group-major rows)."""
    jax_cfg, port_cfg = _model_configs()
    head = _params(jax_trainer)["audio_pc_wrapper"]["net"]
    streams = [np.abs(_rand((batch, 1, 32, 20), seed=i)) if i % 3 == 0
               else _rand((batch, 1, 32, 20), seed=i) for i in range(6)]
    want = np.asarray(jax.jit(JaxMD(jax_cfg.pc_wrapper).apply)(
        {"params": head}, *streams))
    model = MultiDirectionFullSubNetPlus(port_cfg.pc_wrapper,
                                         compute_dtype=torch.float32,
                                         device="cpu")
    model.load_state_dict(convert.convert_multidirection(head))
    with torch.no_grad():
        got = model(*(torch.from_numpy(s) for s in streams)).numpy()
    assert got.shape == (batch, 2 * N_DIRS, 32 if batch == 1 else 16, 20)
    _peak_close(got, want)


def test_denoising_model_matches_jax(jax_trainer):
    jax_cfg, port_cfg = _model_configs()
    params = _params(jax_trainer)
    noisy, _ = _batch(seed=1)
    want_w, want_crm = jax.jit(lambda p, x: JaxNPPCModel(jax_cfg).apply(
        {"params": p}, x, method=JaxNPPCModel.forward_with_pred_crm))(
        params, noisy)
    model = _port_model(params, port_cfg)
    with torch.no_grad():
        got_w, got_crm = model.forward_with_pred_crm(torch.from_numpy(noisy))
        got_pred = model.get_pred_crm(torch.from_numpy(noisy))
    assert got_w.shape == (4, N_DIRS, 2, 16, 65)
    _peak_close(got_w.numpy(), want_w)
    _peak_close(got_crm.numpy(), want_crm)
    assert torch.equal(got_pred, got_crm)
    assert all(not p.requires_grad for p in
               model.pretrained_restoration_model.parameters())


def test_params_round_trip_and_random_layout(jax_trainer):
    """JAX params -> the port's state_dict -> the JAX package's converter ->
    the same arrays; the numpy-made params have the JAX tree and shapes."""
    _, port_cfg = _model_configs()
    params = _params(jax_trainer)
    model = _port_model(params, port_cfg)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = {
        "pretrained_restoration_model": torch_convert.convert_fullsubnet_plus(
            {k[len("pretrained_restoration_model."):]: v
             for k, v in sd.items()
             if k.startswith("pretrained_restoration_model.")}),
        "audio_pc_wrapper": {"net": torch_convert.convert_multidirection(
            {k[len("audio_pc_wrapper.net."):]: v for k, v in sd.items()
             if k.startswith("audio_pc_wrapper.net.")})}}
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(flat) == set(flat_back)
    for path, value in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), value,
                                      err_msg=str(path))
    made = convert.random_denoising_nppc_params(port_cfg, seed=0)
    assert (jax.tree_util.tree_structure(made)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(made),
                    jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == np.float32


def _port_trainer(params, checkpoint_dir=None, **over):
    _, port_cfg = _model_configs()
    cfg = NPPCDenoisingTrainConfig(model=port_cfg, learning_rate=LR,
                                   second_moment_loss_lambda=0.1,
                                   second_moment_loss_grace=2, **over)
    trainer = NPPCDenoisingTrainer(
        cfg, restoration_params=params["pretrained_restoration_model"],
        checkpoint_dir=checkpoint_dir, device="cpu",
        compute_dtype=torch.float32)
    head = convert.convert_multidirection(params["audio_pc_wrapper"]["net"])
    trainer.state.model.audio_pc_wrapper.net.load_state_dict(head)
    return trainer


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_trainer_three_steps_match_jax(jax_trainer):
    """Three steps on one batch from the JAX trainer's initial params (grace
    2, so the lambda ramp moves across them), one train() call each."""
    params = _params(jax_trainer)
    noisy, clean = _batch(seed=2)
    trainer = _port_trainer(params)
    enhancer = trainer.state.model.pretrained_restoration_model
    frozen = {k: v.clone() for k, v in enhancer.state_dict().items()}
    objective, _, _ = trainer.objective(torch.from_numpy(noisy),
                                        torch.from_numpy(clean), 0)
    objective.backward()
    first_grad = {k: np.abs(v) for k, v in _leaves(
        convert.to_jax_fullsubnet_plus(
            {k: p.grad for k, p in
             trainer.state.model.audio_pc_wrapper.net.named_parameters()})
    ).items()}
    trainer.state.optimizer.zero_grad(set_to_none=True)
    peak = max(g.max() for g in first_grad.values())
    start = _leaves(params["audio_pc_wrapper"]["net"])

    for step in range(1, 4):
        jax_trainer.train([(noisy, clean)], n_steps=1, log=lambda *_: None)
        trainer.train([(noisy, clean)], n_steps=1, log=lambda *_: None)
        assert trainer.state.step == int(jax_trainer.state.step) == step
        want = _leaves(jax_trainer.state.params["audio_pc_wrapper"]["net"])
        got = _leaves(convert.to_jax_fullsubnet_plus(
            trainer.state.model.audio_pc_wrapper.net.state_dict()))
        assert set(got) == set(want)
        effect = moved = 0.0
        for key, w in want.items():
            diff = np.abs(got[key] - w)
            assert diff.max() <= 2 * LR * step + 1e-6, key   # Adam's own bound
            clear = first_grad[key] > 1e-4 * peak
            if step == 1 and clear.any():
                assert diff[clear].max() <= 0.02 * LR, key
            effect += float((first_grad[key] * diff).sum())
            moved += float((first_grad[key] * np.abs(w - start[key])).sum())
        assert effect <= 1e-3 * moved, (step, effect, moved)
    np.testing.assert_allclose(trainer.loss_history,
                               jax_trainer.loss_history, rtol=1e-4)
    np.testing.assert_allclose(trainer.reconst_err_history,
                               jax_trainer.reconst_err_history, rtol=1e-4)
    for k, v in enhancer.state_dict().items():
        assert torch.equal(v, frozen[k]), k
    assert all(p.grad is None for p in enhancer.parameters())


def test_trainer_checkpoint_and_resume(jax_trainer, tmp_path):
    params = _params(jax_trainer)
    noisy, clean = _batch(seed=3)
    trainer = _port_trainer(params, tmp_path / "ckpt", save_interval=1,
                            log_interval=1)
    logs = []
    trainer.train([(noisy, clean)], n_steps=2, log=logs.append)
    ckpt = tmp_path / "ckpt"
    assert len(logs) == 2 and logs[-1].startswith("step 2: objective=")
    assert json.loads((ckpt / "latest_step.json").read_text()) == {"step": 2}
    assert (ckpt / "step_00000002.pt").exists()
    (metrics,) = ckpt.glob("metrics_final_*.json")
    record = json.loads(metrics.read_text())
    assert record["total_steps"] == 2
    assert record["final_objective"] == trainer.loss_history[-1]
    assert record["final_reconst_err"] == trainer.reconst_err_history[-1]
    assert json.loads((ckpt / "config.json").read_text())[
        "model"]["pc_wrapper"]["n_directions"] == N_DIRS

    twin = _port_trainer(_params(jax_trainer), ckpt)
    assert twin.restore_latest() and twin.state.step == 2
    for a, b in zip(trainer.state.model.state_dict().values(),
                    twin.state.model.state_dict().values()):
        assert torch.equal(a, b)
    obj_a, _ = trainer.train_step(noisy, clean)
    obj_b, _ = twin.train_step(noisy, clean)
    assert obj_a.item() == obj_b.item()
    assert not _port_trainer(params, tmp_path / "empty").restore_latest()


def test_validator_matches_jax(tmp_path):
    """The stub callables of tests/test_nppc_validation.py: random directions
    and the identity mask."""
    w_mat = np.asarray(0.1 * jax.random.normal(jax.random.PRNGKey(0),
                                               (1, 2, 2, 257, 63)))
    ones = np.ones((1, 257, 63), np.float32)
    identity = np.stack([ones, np.zeros_like(ones)], axis=1)
    noisy = _rand(16000 - 128, seed=4, scale=0.1)
    clean = _rand(16000 - 128, seed=5, scale=0.1)
    jax_val = JaxValidator(lambda v, wav: jnp.asarray(w_mat),
                           lambda v, wav: jax_compress(jnp.asarray(identity)),
                           {}, JaxValidatorConfig(save_dir=str(tmp_path / "j")))
    want = jax_val.validate_sample(noisy, clean_waveform=clean, sample_idx=0,
                                   make_plot=False)
    seen = []

    def model_fn(wav):
        seen.append((tuple(wav.shape), torch.is_inference_mode_enabled()))
        return torch.tensor(w_mat)

    val = DenoisingNPPCValidator(
        model_fn, lambda wav: compress_cIRM(torch.from_numpy(identity)),
        DenoisingNPPCValidatorConfig(save_dir=str(tmp_path / "t")),
        device="cpu")
    got = val.validate_sample(noisy, clean_waveform=clean, sample_idx=0)
    assert seen == [((1, 16000 - 128), True)]
    assert got["n_dirs"] == want["n_dirs"] == 2
    assert ([(v["pc"], v["alpha"]) for v in got["variations"]]
            == [(v["pc"], v["alpha"]) for v in want["variations"]])
    np.testing.assert_allclose([v["rms"] for v in got["variations"]],
                               [v["rms"] for v in want["variations"]],
                               rtol=1e-5)
    out = Path(got["save_dir"])
    names = {p.name for p in out.iterdir()}
    assert {p.name for p in Path(want["save_dir"]).iterdir()} <= names
    assert {"enhanced.wav", "noisy.wav", "clean.wav",
            "pc_spectrograms_variations.png"} <= names
    assert len([n for n in names if n.startswith("pc") and
                n.endswith(".wav")]) == 2 * 6
    png = (out / "pc_spectrograms_variations.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and png[12:16] == b"IHDR"
    width, height = struct.unpack(">II", png[16:24])
    assert (width, height) == figure_size(2, 6, 257, 63)
    assert png[24:26] == bytes([8, 2])                   # 8-bit RGB
    idat = png.index(b"IDAT")
    (length,) = struct.unpack(">I", png[idat - 4:idat])
    pixels = zlib.decompress(png[idat + 4:idat + 4 + length])
    assert len(pixels) == height * (1 + 3 * width)


def _cli_config(tmp_path, corpus, **train):
    model = {"restoration": SMALL,
             "pc_wrapper": {**SMALL, "num_groups_in_drop_band": 2},
             "stft": STFT}
    cfg = {"line": "nppc_denoising", "checkpoint_dir": str(tmp_path / "ckpt"),
           "train": {"model": model, "learning_rate": LR,
                     "second_moment_loss_lambda": 0.1,
                     "second_moment_loss_grace": 200, **train},
           "data": {"clean_path": str(corpus[0]), "noisy_path": str(corpus[1]),
                    "sub_sample_length_seconds": 0.25},
           "dataloader": {"global_batch_size": 4, "num_workers": 2}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return path


def test_train_cli_nppc_denoising(tmp_path):
    corpus = write_synthetic_corpus(tmp_path / "corpus", n_clean=4,
                                    n_noise=2, seconds=1.0)
    path = _cli_config(tmp_path, corpus, n_dirs=2)
    argv = ["-C", str(path), "--steps", "1", "--device", "cpu"]
    trainer = train_cli.main(argv + ["--epochs", "2"])
    assert trainer.state.model.config.pc_wrapper.n_directions == 2
    assert trainer.state.step == 2 and len(trainer.loss_history) == 2
    assert np.isfinite(trainer.loss_history).all()
    ckpt = tmp_path / "ckpt"
    assert len(list(ckpt.glob("metrics_final_*.json"))) == 1
    resumed = train_cli.main(argv + ["-R"])
    assert resumed.state.step == 3 and len(resumed.loss_history) == 1
    assert json.loads((ckpt / "latest_step.json").read_text()) == {"step": 3}


def test_train_cli_nppc_denoising_refuses_validation(tmp_path):
    """The line has no in-loop validation: a `validation:` block raises
    instead of being dropped."""
    path = _cli_config(tmp_path, (tmp_path / "clean", tmp_path / "noise"))
    cfg = json.loads(path.read_text())
    cfg["validation"] = {"val_dir": str(tmp_path / "val")}
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="no validation"):
        train_cli.main(["-C", str(path), "--device", "cpu"])


def test_shipped_config_builds_five_directions():
    """configs/denoising_nppc.yaml puts n_dirs under train:, which the JAX
    CLI's build_dataclass refuses; the port maps it to the head's
    n_directions, and refuses a conflicting n_directions."""
    from generative_audio_tpu.utils.config import build_dataclass
    train = yaml.safe_load((REPO / "configs" / "denoising_nppc.yaml")
                           .read_text())["train"]
    cfg = train_cli.nppc_denoising_config(train)
    assert cfg.model.pc_wrapper.n_directions == 5
    assert (cfg.learning_rate, cfg.second_moment_loss_lambda,
            cfg.second_moment_loss_grace) == (1e-4, 0.1, 200)
    with pytest.raises(ValueError, match="Unknown config keys"):
        build_dataclass(JaxTrainConfig, train)
    with pytest.raises(ValueError, match="n_directions"):
        train_cli.nppc_denoising_config(
            {**train, "model": {"pc_wrapper": {"n_directions": 4}}})
    with pytest.raises(ValueError, match="Unknown config keys"):
        train_cli.nppc_denoising_config({**train, "n_dir": 5})
