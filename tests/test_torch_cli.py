"""The port's inference CLI against the JAX CLI on the CPU, and the host
pieces it stands on (config files, audio loading, the inference dataset).

One reference-format `.pth` (FullSubNet+ at SMALL width: numpy-made params
in the JAX layout, carried to the reference's state-dict keys by
generative_audio_torch.utils.convert) goes to both CLIs on the same wav
directory and yaml config. Both build the model in bf16, as the JAX CLI
does, and round to bf16 at different places (the port adds the bias inside
its bf16 projection, the JAX package adds an fp32 bias and then rounds), so
the written wavs, each normalised to a peak of 0.8, are held within 1e-2
absolute (1.25% of that peak; the largest difference measured here was
1.9e-3).
"""
import json
import sys

import numpy as np
import pytest
import torch
import yaml

from generative_audio_tpu.cli.inference import main as jax_main
from generative_audio_tpu.data import audio_io as jax_audio_io
from generative_audio_tpu.models import (
    FullSubNetPlusConfig as JaxFullSubNetPlusConfig)
from generative_audio_torch.cli.inference import main, load_model_state
from generative_audio_torch.data import (
    InferenceDataset, load_audio, resample, to_mono, write_wav)
from generative_audio_torch.data.audio_io import read_wav
from generative_audio_torch.eval import InferencerConfig
from generative_audio_torch.models import FullSubNetPlus, FullSubNetPlusConfig
from generative_audio_torch.train import CheckpointManager
from generative_audio_torch.utils import convert
from generative_audio_torch.utils.config import (
    build_dataclass, dump_config, load_config_file, merge_config)

torch.set_num_threads(2)
SMALL = dict(num_freqs=33, sb_num_neighbors=3, sb_model_hidden_size=16)
CONFIG = {"model": SMALL,
          "inferencer": {"n_fft": 64, "hop_length": 32, "win_length": 64,
                         "length_bucket": 1600}}
BF16_WAV_ATOL = 1e-2
NAMES = ("a", "b", "c")


def _state_dict(seed):
    return convert.convert_fullsubnet_plus(convert.random_fullsubnet_plus_params(
        JaxFullSubNetPlusConfig(**SMALL), seed=seed))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A wav dir of three clips, the yaml config and a .pth under `model`."""
    root = tmp_path_factory.mktemp("cli")
    noisy = root / "noisy"
    noisy.mkdir()
    rng = np.random.default_rng(0)
    for name, n in zip(NAMES, (3000, 3100, 2000)):    # one bucket
        write_wav(noisy / f"{name}.wav",
                  rng.standard_normal(n).astype(np.float32) * 0.1, 16000)
    cfg = root / "inf.yaml"
    cfg.write_text(yaml.safe_dump(CONFIG))
    pth = root / "best_model.pth"
    torch.save({"model": _state_dict(seed=0), "epoch": 3}, pth)
    return root, noisy, cfg, pth


def _wavs(directory):
    out = {}
    for name in NAMES:
        sr, wav = read_wav(directory / f"{name}.wav")
        assert sr == 16000
        out[name] = wav
    return out


def _port(inputs, model_path, out, *extra):
    _, noisy, cfg, _ = inputs
    main(["-C", str(cfg), "-M", str(model_path), "-I", str(noisy),
          "-O", str(out), "--device", "cpu", *extra])
    return _wavs(out)


def test_cli_matches_jax(inputs, tmp_path):
    _, noisy, cfg, pth = inputs
    jax_main(["-C", str(cfg), "-M", str(pth), "-I", str(noisy),
              "-O", str(tmp_path / "jax")])
    want = _wavs(tmp_path / "jax")
    got = _port(inputs, pth, tmp_path / "torch")
    for name in NAMES:
        assert got[name].shape == want[name].shape
        assert np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], want[name], atol=BF16_WAV_ATOL)


def test_cli_restores_checkpoint_manager_dir(inputs, tmp_path):
    """A CheckpointManager directory: `best` wins over `latest`, and a
    directory with `latest` only restores it; the wavs equal the .pth run."""
    want = _port(inputs, inputs[3], tmp_path / "pth")
    ckpt = CheckpointManager(tmp_path / "ckpt")
    ckpt.save_latest({"params": _state_dict(seed=1), "step": 7}, 7)
    ckpt.save_best({"params": _state_dict(seed=0), "step": 5}, 1.0, 5)
    got = _port(inputs, tmp_path / "ckpt", tmp_path / "best")
    for name in NAMES:
        np.testing.assert_array_equal(got[name], want[name])
    latest_only = CheckpointManager(tmp_path / "latest_only")
    latest_only.save_latest({"params": _state_dict(seed=0), "step": 7}, 7)
    got = _port(inputs, tmp_path / "latest_only", tmp_path / "latest")
    for name in NAMES:
        np.testing.assert_array_equal(got[name], want[name])


def test_load_model_state_refusals(inputs, tmp_path):
    model = FullSubNetPlus(FullSubNetPlusConfig(**SMALL), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_model_state(tmp_path / "missing", model)
    CheckpointManager(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        load_model_state(tmp_path / "empty", model)
    sd = _state_dict(seed=0)
    sd.pop("sb_model.fc_output_layer.bias")
    torch.save({"state_dict": sd}, tmp_path / "partial.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_model_state(tmp_path / "partial.pt", model)


def test_cli_needs_cuda_unless_asked_for_cpu(inputs, tmp_path, monkeypatch):
    _, noisy, cfg, pth = inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-C", str(cfg), "-M", str(pth), "-I", str(noisy),
              "-O", str(tmp_path)])


@pytest.mark.parametrize("suffix", [".yaml", ".toml", ".json"])
def test_load_config_file(tmp_path, suffix):
    data = {"model": {"num_freqs": 33, "kersize": [3, 5, 10]},
            "inferencer": {"n_fft": 64, "inference_type": "mag"}}
    path = tmp_path / f"cfg{suffix}"
    if suffix == ".yaml":
        path.write_text(yaml.safe_dump(data))
    elif suffix == ".json":
        path.write_text(json.dumps(data))
    else:
        path.write_text('[model]\nnum_freqs = 33\nkersize = [3, 5, 10]\n'
                        '[inferencer]\nn_fft = 64\ninference_type = "mag"\n')
    assert load_config_file(path) == data


def test_config_helpers(tmp_path):
    """build_dataclass refuses unknown keys and keeps defaults; merge_config
    merges nested dicts; an unknown suffix raises."""
    with pytest.raises(ValueError, match="Unknown config keys"):
        build_dataclass(InferencerConfig, {"n_fft": 64, "hop": 32})
    cfg = build_dataclass(InferencerConfig, {"n_fft": 64})
    assert cfg.n_fft == 64 and cfg.hop_length == 256
    assert build_dataclass(InferencerConfig, None) == InferencerConfig()
    model = build_dataclass(FullSubNetPlusConfig, {"kersize": [3, 5]})
    assert list(model.kersize) == [3, 5]
    assert dump_config(cfg)["n_fft"] == 64
    assert merge_config({"a": {"b": 1, "c": 2}, "d": 3},
                        {"a": {"b": 5}, "e": 6}) == {
        "a": {"b": 5, "c": 2}, "d": 3, "e": 6}
    (tmp_path / "cfg.ini").write_text("")
    with pytest.raises(ValueError, match="Unsupported"):
        load_config_file(tmp_path / "cfg.ini")


def test_audio_loading_matches_jax(tmp_path, monkeypatch):
    """to_mono and resample equal the JAX package's; load_audio reads a
    stereo 8 kHz wav as mono 16 kHz; InferenceDataset lists a dir sorted;
    FLAC without soundfile goes to the native decoder, which refuses an
    empty file."""
    rng = np.random.default_rng(1)
    stereo = rng.standard_normal((4000, 2)).astype(np.float32) * 0.1
    for data in (stereo, stereo.T):
        np.testing.assert_array_equal(to_mono(data),
                                      jax_audio_io.to_mono(data))
    mono = to_mono(stereo)
    np.testing.assert_array_equal(resample(mono, 8000, 16000),
                                  jax_audio_io.resample(mono, 8000, 16000))
    write_wav(tmp_path / "z.wav", stereo, 8000)
    write_wav(tmp_path / "y.wav", mono, 16000)
    loaded = load_audio(tmp_path / "z.wav", sr=16000)
    assert loaded.dtype == np.float32 and loaded.shape == (8000,)
    np.testing.assert_allclose(
        loaded, resample(to_mono(read_wav(tmp_path / "z.wav")[1]), 8000,
                         16000))
    ds = InferenceDataset(tmp_path)
    assert len(ds) == 2 and ds[0][1] == "y" and ds[1][1] == "z"
    monkeypatch.setitem(sys.modules, "soundfile", None)
    (tmp_path / "x.flac").write_bytes(b"")
    with pytest.raises(ValueError, match="gat_decode_flac failed"):
        load_audio(tmp_path / "x.flac")
    with pytest.raises(ValueError, match="Unsupported"):
        load_audio(tmp_path / "x.mp3")
