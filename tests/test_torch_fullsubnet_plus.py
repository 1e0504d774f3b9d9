"""The port's FullSubNet+ serving path against the JAX package on the CPU.

Weights come from the JAX model's `init` at a small configuration
(num_freqs=33, sb_num_neighbors=3, sb_model_hidden_size=16, as in
tests/test_fullsubnet_parity.py) and are carried across with
generative_audio_torch.utils.convert; inputs come from numpy with a fixed
seed. Both sides run in float32, so the tolerances are float32 ones that
allow for a different order of sums: 5e-5 absolute plus 1e-3 relative on
the cRM, and 1e-4 of the peak on the enhanced waveform. The wav files the
two Inferencers write may differ by one int16 step.
"""
import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from generative_audio_tpu.eval.inferencer import (
    Inferencer as JaxInferencer, InferencerConfig as JaxInferencerConfig)
from generative_audio_tpu.models import (
    FullSubNetPlus as JaxFullSubNetPlus,
    FullSubNetPlusConfig as JaxFullSubNetPlusConfig)
from generative_audio_tpu.utils import torch_convert
from generative_audio_torch.data.audio_io import read_wav
from generative_audio_torch.eval import Inferencer, InferencerConfig
from generative_audio_torch.models import FullSubNetPlus, FullSubNetPlusConfig
from generative_audio_torch.utils import convert

torch.set_num_threads(2)
SMALL = dict(num_freqs=33, sb_num_neighbors=3, sb_model_hidden_size=16)
REPO = Path(__file__).resolve().parent.parent


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _models(groups=1):
    jcfg = JaxFullSubNetPlusConfig(num_groups_in_drop_band=groups, **SMALL)
    jm = JaxFullSubNetPlus(jcfg)
    dummy = np.zeros((1, 1, 33, 8), np.float32)
    params = jm.init(jax.random.PRNGKey(0), dummy, dummy, dummy)["params"]
    tm = FullSubNetPlus(FullSubNetPlusConfig(num_groups_in_drop_band=groups,
                                             **SMALL),
                        compute_dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.convert_fullsubnet_plus(params))
    return jm, params, tm.eval()


@pytest.mark.parametrize("batch,groups", [(1, 1), (3, 1), (4, 2)])
def test_fullsubnet_plus_matches_jax(batch, groups):
    """Includes the look-ahead pad/crop and the B > 1 drop_band gate."""
    jm, params, tm = _models(groups)
    mag = np.abs(_rand((batch, 1, 33, 18), seed=1))
    real = _rand((batch, 1, 33, 18), seed=2)
    imag = _rand((batch, 1, 33, 18), seed=3)
    want = np.asarray(jm.apply({"params": params}, mag, real, imag))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (mag, real, imag))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-3)


def test_state_dict_round_trip():
    """JAX params -> the port's state_dict (the reference checkpoint's keys)
    -> torch_convert.convert_fullsubnet_plus -> the same arrays."""
    _, params, tm = _models()
    sd = convert.convert_fullsubnet_plus(params)
    assert set(sd) == set(tm.state_dict())
    assert "sb_model.sequence_model.weight_ih_l0" in sd
    assert "fb_model.sequence_model.3.depthwise_conv.weight" in sd
    back = torch_convert.convert_fullsubnet_plus(
        {k: v.numpy() for k, v in tm.state_dict().items()})
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_params = dict(jax.tree_util.tree_leaves_with_path(params))
    assert set(flat_back) == set(flat_params)
    for path, value in flat_params.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]),
                                      np.asarray(value), err_msg=str(path))


def test_random_params_have_the_jax_layout():
    """The numpy-made params that chip_smoke.py serves with have the JAX
    model's tree and shapes at the full-width default configuration."""
    cfg = JaxFullSubNetPlusConfig()
    dummy = jax.ShapeDtypeStruct((1, 1, cfg.num_freqs, 8), np.float32)
    shapes = jax.eval_shape(JaxFullSubNetPlus(cfg).init, jax.random.PRNGKey(0),
                            dummy, dummy, dummy)["params"]
    made = convert.random_fullsubnet_plus_params(cfg, seed=0)
    assert (jax.tree_util.tree_structure(made)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(
                lambda s: 0, shapes)))
    for a, s in zip(jax.tree_util.tree_leaves(made),
                    jax.tree_util.tree_leaves(shapes)):
        assert a.shape == s.shape and a.dtype == np.float32


def _inferencers():
    jm, params, tm = _models()
    kw = dict(n_fft=64, hop_length=32, win_length=64, length_bucket=1600)
    jinf = JaxInferencer(lambda v, *inputs: jm.apply(v, *inputs),
                         {"params": params}, JaxInferencerConfig(**kw))
    return jinf, Inferencer(tm, InferencerConfig(**kw), device="cpu")


def test_inferencer_enhance_matches_jax():
    jinf, tinf = _inferencers()
    noisy = _rand((3000,), seed=4, scale=0.1)
    want = jinf.enhance(noisy)
    got = tinf.enhance(noisy)
    assert got.shape == noisy.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    assert tinf.last_rtf is not None and tinf.last_rtf > 0


class _Clips:
    def __init__(self, lengths):
        self.items = [(_rand((n,), seed=10 + i, scale=0.1), f"clip{i}")
                      for i, n in enumerate(lengths)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("batch_size", [1, 2])
def test_enhance_dir_matches_jax(tmp_path, batch_size):
    """Per clip (batch_size=1) and batched by length bucket: three clips, two
    of which share a 3200-sample bucket."""
    jinf, tinf = _inferencers()
    clips = _Clips([3000, 2000, 1500])
    jinf.enhance_dir(clips, tmp_path / "jax", log=lambda *_: None,
                     batch_size=batch_size)
    tinf.enhance_dir(clips, tmp_path / "torch", log=lambda *_: None,
                     batch_size=batch_size)
    for noisy, name in clips.items:
        _, want = read_wav(tmp_path / "jax" / f"{name}.wav")
        sr, got = read_wav(tmp_path / "torch" / f"{name}.wav")
        assert sr == 16000 and got.shape == noisy.shape
        np.testing.assert_allclose(got, want, atol=1.5 / 32768)


def test_entry_points_refuse_missing_cuda(monkeypatch):
    """Without a CUDA device the entry points raise unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = FullSubNetPlusConfig(**SMALL)
    with pytest.raises(RuntimeError):
        FullSubNetPlus(cfg)
    model = FullSubNetPlus(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        Inferencer(model)
    with pytest.raises(NotImplementedError):
        Inferencer(model, InferencerConfig(inference_type="magnitude"),
                   device="cpu").enhance(np.zeros(100, np.float32))


FORBIDDEN = ("jax", "flax", "optax", "orbax", "generative_audio_tpu")


def _port_sources():
    package = REPO / "generative_audio_torch"
    return sorted(p for p in package.rglob("*.py")
                  if "_build" not in p.relative_to(package).parts) + [
        REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.name}:{node.lineno} imports {name}")
