"""The port's FullSubNet (v1) path against the JAX package on the CPU: the GRU
layer, SequenceModel("GRU"), the model with GRU and LSTM bodies, the
Inferencer mode `full_band_crm_mask` wav to wav, and the parameter carriers.

Weights come from the JAX modules' `init` at a small configuration
(num_freqs=33, sb_num_neighbors=3, hidden sizes 16) and are carried across
with generative_audio_torch.utils.convert; inputs come from numpy with a
fixed seed. Both sides run in float32, so the tolerances are float32 ones
that allow for a different order of sums: 5e-5 absolute plus 1e-3 relative
on layer outputs and on the cRM (what tests/test_torch_fullsubnet_plus.py
uses), and 1e-4 of the peak on the enhanced waveform. The wav files the two
Inferencers write may differ by one int16 step. The bf16 model against the
float32 one, both the port's: 5e-2 of the cRM's peak (bf16 keeps 8 bits, and
two stacked recurrences carry the rounding along).
"""
import jax
import numpy as np
import pytest
import torch

from generative_audio_tpu.eval.inferencer import (
    Inferencer as JaxInferencer, InferencerConfig as JaxInferencerConfig)
from generative_audio_tpu.models.fullsubnet import (
    FullSubNet as JaxFullSubNet, FullSubNetConfig as JaxFullSubNetConfig)
from generative_audio_tpu.nn.recurrent import (
    GRULayer as JaxGRULayer, SequenceModel as JaxSequenceModel)
from generative_audio_tpu.utils import torch_convert
from generative_audio_torch.data.audio_io import read_wav
from generative_audio_torch.eval import Inferencer, InferencerConfig
from generative_audio_torch.models import FullSubNet, FullSubNetConfig
from generative_audio_torch.nn.recurrent import GRULayer, SequenceModel
from generative_audio_torch.utils import convert

torch.set_num_threads(2)
SMALL = dict(num_freqs=33, sb_num_neighbors=3, fb_model_hidden_size=16,
             sb_model_hidden_size=16)
F32 = dict(atol=5e-5, rtol=1e-3)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_gru_layer_matches_jax(bidirectional):
    x = _rand((3, 10, 6), seed=16)                          # [B, T, F]
    jl = JaxGRULayer(hidden_size=8, bidirectional=bidirectional,
                     use_pallas=False)
    params = jl.init(jax.random.PRNGKey(2), x)["params"]
    want = np.asarray(jl.apply({"params": params}, x))

    def weights(suffix):
        return tuple(torch.from_numpy(np.asarray(params[k + suffix]).T.copy())
                     for k in ("w_ih", "w_hh", "b_ih", "b_hh"))

    layer = GRULayer(8, bidirectional, compute_dtype=torch.float32)
    got = layer(torch.from_numpy(x), weights(""),
                weights("_reverse") if bidirectional else None)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32)
    # the time-major call is the same layer
    got_tm = layer(torch.from_numpy(x).transpose(0, 1), weights(""),
                   weights("_reverse") if bidirectional else None,
                   time_major=True)
    assert torch.equal(got_tm.transpose(0, 1), got)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_gru_sequence_model_matches_jax(bidirectional):
    kw = dict(input_size=6, output_size=5, hidden_size=8, num_layers=2,
              bidirectional=bidirectional, sequence_model="GRU",
              output_activate_function="ReLU")
    x = _rand((3, 6, 11), seed=17)                          # [B, F, T]
    jm = JaxSequenceModel(**kw)
    params = jm.init(jax.random.PRNGKey(3), x)["params"]
    want = np.asarray(jm.apply({"params": params}, x))
    tm = SequenceModel(**kw, compute_dtype=torch.float32, device="cpu")
    sd = convert.convert_sequence_model(params, "", "GRU",
                                        bidirectional=bidirectional)
    assert set(sd) == set(tm.state_dict())
    assert tuple(sd["sequence_model.weight_hh_l1"].shape) == (24, 8)
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 5, 11)
    np.testing.assert_allclose(got, want, **F32)


def test_gru_is_the_default_and_unknown_bodies_raise():
    """SequenceModel's default body is the GRU, as in the JAX package; torch
    initialises its parameters in +/- 1/sqrt(H)."""
    model = SequenceModel(4, 2, 16, device="cpu")
    assert model.kind == "GRU"
    bound = 16 ** -0.5
    for name, p in model.sequence_model.named_parameters():
        assert p.abs().max().item() <= bound, name
    assert model.sequence_model.weight_ih_l0.shape == (48, 4)
    with pytest.raises(NotImplementedError):
        SequenceModel(4, 2, 16, sequence_model="RNN", device="cpu")


def _models(kind, groups=2):
    jcfg = JaxFullSubNetConfig(sequence_model=kind,
                               num_groups_in_drop_band=groups, **SMALL)
    jm = JaxFullSubNet(jcfg)
    dummy = np.zeros((1, 1, 33, 8), np.float32)
    params = jm.init(jax.random.PRNGKey(0), dummy)["params"]
    tm = FullSubNet(FullSubNetConfig(sequence_model=kind,
                                     num_groups_in_drop_band=groups, **SMALL),
                    compute_dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.convert_fullsubnet(params, kind))
    return jm, params, tm.eval()


@pytest.mark.parametrize("kind", ["GRU", "LSTM"])
@pytest.mark.parametrize("batch", [1, 4])
def test_fullsubnet_matches_jax(kind, batch):
    """Includes the look-ahead pad/crop, both norms and, at batch 4, the
    drop_band gate with its two transposes (16 of 33 bins are kept)."""
    jm, params, tm = _models(kind)
    mag = np.abs(_rand((batch, 1, 33, 18), seed=1))
    want = np.asarray(jm.apply({"params": params}, mag))
    with torch.no_grad():
        got = tm(torch.from_numpy(mag)).numpy()
    assert got.shape == want.shape == (batch, 2, 33 if batch == 1 else 16, 18)
    np.testing.assert_allclose(got, want, **F32)
    if batch > 1:       # num_groups=1 overrides the config for one call
        with torch.no_grad():
            assert tm(torch.from_numpy(mag), num_groups=1).shape[2] == 33


@pytest.mark.parametrize("kind", ["GRU", "LSTM"])
def test_state_dict_round_trip(kind):
    """JAX params -> the port's state_dict (the reference checkpoint's keys)
    -> back, by the port's to_jax_fullsubnet and by the JAX package's
    torch_convert.convert_fullsubnet: the same arrays both ways."""
    _, params, tm = _models(kind)
    sd = convert.convert_fullsubnet(params, kind)
    assert set(sd) == set(tm.state_dict())
    assert "fb_model.sequence_model.weight_ih_l0" in sd
    assert "sb_model.sequence_model.bias_hh_l1" in sd
    flat_params = dict(jax.tree_util.tree_leaves_with_path(params))
    for back in (convert.to_jax_fullsubnet(tm.state_dict()),
                 torch_convert.convert_fullsubnet(
                     {k: v.numpy() for k, v in tm.state_dict().items()},
                     kind)):
        flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
        assert set(flat_back) == set(flat_params)
        for path, value in flat_params.items():
            np.testing.assert_array_equal(np.asarray(flat_back[path]),
                                          np.asarray(value), err_msg=str(path))


@pytest.mark.parametrize("kind", ["GRU", "LSTM"])
def test_random_params_have_the_jax_layout(kind):
    """The numpy-made params that chip_smoke.py runs with have the JAX
    model's tree and shapes at the full-width default configuration."""
    cfg = JaxFullSubNetConfig(sequence_model=kind)
    dummy = jax.ShapeDtypeStruct((1, 1, cfg.num_freqs, 8), np.float32)
    shapes = jax.eval_shape(JaxFullSubNet(cfg).init, jax.random.PRNGKey(0),
                            dummy)["params"]
    made = convert.random_fullsubnet_params(cfg, seed=0)
    assert (jax.tree_util.tree_structure(made)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(
                lambda s: 0, shapes)))
    for a, s in zip(jax.tree_util.tree_leaves(made),
                    jax.tree_util.tree_leaves(shapes)):
        assert a.shape == s.shape and a.dtype == np.float32


@pytest.mark.parametrize("kind", ["GRU", "LSTM"])
def test_bf16_model_agrees_with_float32(kind):
    """compute_dtype bf16 on the CPU runs the plain versions of the scan
    kernels over bf16 hoisted gates, full-band and sub-band."""
    _, _, tm = _models(kind)
    tm16 = FullSubNet(tm.config, compute_dtype=torch.bfloat16, device="cpu")
    tm16.load_state_dict(tm.state_dict())
    mag = torch.from_numpy(np.abs(_rand((3, 1, 33, 18), seed=5)))
    with torch.no_grad():
        want, got = tm(mag), tm16.eval()(mag)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert 0 < rel < 5e-2, rel


def _inferencers(kind="GRU"):
    jm, params, tm = _models(kind, groups=1)
    kw = dict(n_fft=64, hop_length=32, win_length=64, length_bucket=1600,
              inference_type="full_band_crm_mask")
    # the JAX batched enhance_dir hands every model (mag, real, imag)
    jinf = JaxInferencer(lambda v, mag, *_: jm.apply(v, mag),
                         {"params": params}, JaxInferencerConfig(**kw))
    return jinf, Inferencer(tm, InferencerConfig(**kw), device="cpu")


def test_inferencer_full_band_crm_mask_matches_jax():
    jinf, tinf = _inferencers()
    noisy = _rand((3000,), seed=4, scale=0.1)
    want = jinf.enhance(noisy)
    got = tinf.enhance(noisy)
    assert got.shape == noisy.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    assert tinf.last_rtf is not None and tinf.last_rtf > 0
    np.testing.assert_array_equal(tinf.full_band_crm_mask(noisy), got)


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


def test_refusals(monkeypatch, tmp_path):
    """No CUDA device: the model raises unless asked for the CPU. A body that
    is neither GRU nor LSTM, an input that is not the magnitude, a batch
    served through a model that drops bands and an unknown mode all
    raise."""
    with pytest.raises(ValueError):
        FullSubNet(FullSubNetConfig(sequence_model="TCN", **SMALL),
                   device="cpu")
    with pytest.raises(ValueError):
        _models("GRU")[2](torch.zeros(1, 2, 33, 8))
    _, _, dropping = _models("GRU", groups=2)
    tinf = Inferencer(dropping, InferencerConfig(
        n_fft=64, hop_length=32, win_length=64, length_bucket=1600,
        inference_type="full_band_crm_mask"), device="cpu")
    with pytest.raises(ValueError, match="num_groups_in_drop_band=1"):
        tinf.enhance_dir(_Clips([1500, 1500, 1500]), tmp_path,
                         log=lambda *_: None, batch_size=3)
    with pytest.raises(NotImplementedError, match="Unknown inference type"):
        Inferencer(dropping, InferencerConfig(inference_type="scaled_masks"),
                   device="cpu").enhance(np.zeros(100, np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        FullSubNet(FullSubNetConfig(**SMALL))
    with pytest.raises(RuntimeError):
        Inferencer(dropping)
