"""generative_audio_torch's MOSNet, its keras-h5 transplant, feature
extraction, windowed score and the MOSNET metric's second branch against
generative_audio_tpu's, on the CPU.

No MOSNet weights ship with the repository, so the keras file is one the
test writes in speechmetrics' layout (as tests/test_mosnet.py does) and the
nets run on numpy-made weights. Float32 on both sides: the net's outputs
agree to 1e-4 relative (3x3 convolutions and a 2-direction keras LSTM,
sums in another order), the features exactly (the same numpy code).
"""
import numpy as np
import pytest
import torch

from generative_audio_tpu.eval import metrics as JM
from generative_audio_tpu.eval import mosnet as jmos
from generative_audio_torch.eval import metrics as TM
from generative_audio_torch.eval import mosnet as tmos
from generative_audio_torch.utils import convert

torch.set_num_threads(2)
REL = 1e-4
TINY = dict(num_freqs=7, conv_channels=(2, 3), lstm_units=4, dense_units=5)
# the features are 257 bins wide, so a scored net takes 257 bins
NARROW = dict(num_freqs=257, conv_channels=(2, 3), lstm_units=4,
              dense_units=5)


def _write_keras_h5(path, cfg, rng):
    """speechmetrics' mosnet.h5 layout: model_weights/<layer>/ groups with
    layer_names / weight_names attrs, HWIO conv kernels, a bidirectional
    LSTM's (kernel, recurrent, bias) per direction, two dense layers."""
    import h5py

    layers = []
    in_ch = 1
    for ch in cfg.conv_channels:
        for _ in range(3):
            name = f"conv2d_{len(layers)}"
            layers.append((name, [
                (f"{name}/kernel:0", rng.standard_normal((3, 3, in_ch, ch)) * .3),
                (f"{name}/bias:0", rng.standard_normal(ch) * .1)]))
            in_ch = ch
    d, h = cfg.reduced_freqs * cfg.conv_channels[-1], cfg.lstm_units
    layers.append(("bidirectional", [
        (f"bidirectional/{direction}_lstm/lstm_cell/{kind}:0", array)
        for direction in ("forward", "backward")
        for kind, array in (
            ("kernel", rng.standard_normal((d, 4 * h)) * .3),
            ("recurrent_kernel", rng.standard_normal((h, 4 * h)) * .3),
            ("bias", rng.standard_normal(4 * h) * .1))]))
    for name, n_in, n_out in (("dense", 2 * h, cfg.dense_units),
                              ("dense_1", cfg.dense_units, 1)):
        layers.append((name, [
            (f"{name}/kernel:0", rng.standard_normal((n_in, n_out)) * .3),
            (f"{name}/bias:0", rng.standard_normal(n_out) * .1)]))
    with h5py.File(path, "w") as f:
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = [n.encode() for n, _ in layers]
        for name, weights in layers:
            g = mw.create_group(name)
            g.attrs["weight_names"] = [w.encode() for w, _ in weights]
            for wname, array in weights:
                g.create_dataset(wname, data=np.asarray(array, np.float32))


def _weights(tmp_path, cfg_kw, seed):
    """(JAX variables, the port's state_dict) from one written keras file."""
    path = tmp_path / f"mosnet_{seed}.h5"
    _write_keras_h5(path, tmos.MOSNetConfig(**cfg_kw),
                    np.random.default_rng(seed))
    return (jmos.load_keras_h5(path, jmos.MOSNetConfig(**cfg_kw)),
            tmos.load_keras_h5(path, tmos.MOSNetConfig(**cfg_kw)), path)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def test_load_keras_h5_matches_jax_and_the_converter(tmp_path):
    variables, sd, _ = _weights(tmp_path, TINY, seed=1)
    want = convert.convert_mosnet(variables["params"])
    assert set(sd) == set(want) == set(
        tmos.MOSNet(tmos.MOSNetConfig(**TINY), device="cpu").state_dict())
    for key in sd:
        assert torch.equal(sd[key], want[key]), key
    with pytest.raises(ValueError, match="unrecognized keras layout"):
        tmos.load_keras_h5(tmp_path / "mosnet_1.h5",
                           tmos.MOSNetConfig(num_freqs=7, conv_channels=(2,),
                                             lstm_units=4))


def test_tiny_mosnet_matches_jax_apply(tmp_path):
    """Odd frequency widths (7 -> 3 -> 1 bins) take TF's SAME padding with
    the extra bin at the high end."""
    variables, sd, _ = _weights(tmp_path, TINY, seed=2)
    mag = np.abs(np.random.default_rng(3).standard_normal((2, 11, 7))
                 ).astype(np.float32)
    want_utt, want_frames = jmos.MOSNet(jmos.MOSNetConfig(**TINY)).apply(
        variables, mag)
    model = tmos.MOSNet(tmos.MOSNetConfig(**TINY), device="cpu")
    model.load_state_dict(sd)
    with torch.no_grad():
        utt, frames = model(torch.from_numpy(mag))
    assert utt.shape == (2,) and frames.shape == (2, 11)
    assert _rel(frames.numpy(), want_frames) < REL
    assert _rel(utt.numpy(), want_utt) < REL


def test_features_match_jax():
    wav = np.random.default_rng(4).standard_normal(16000 + 123).astype(
        np.float32) * 0.1
    np.testing.assert_array_equal(tmos.mosnet_features(wav),
                                  jmos.mosnet_features(wav))
    assert tmos.mosnet_features(wav).shape == (1 + (16000 + 123) // 256, 257)


def test_mosnet_score_windows_match_jax(tmp_path):
    """2.5 s at 1 s windows: three windows, the last one half long; the
    score is their mean; a 22.05 kHz input is resampled first."""
    variables, sd, _ = _weights(tmp_path, NARROW, seed=5)
    cfg_t, cfg_j = tmos.MOSNetConfig(**NARROW), jmos.MOSNetConfig(**NARROW)
    wav = np.random.default_rng(6).standard_normal(40000).astype(
        np.float32) * 0.1
    got = tmos.mosnet_score(wav, sd, config=cfg_t, window_seconds=1.0,
                            device="cpu")
    want = jmos.mosnet_score(wav, variables, config=cfg_j, window_seconds=1.0)
    assert abs(got - want) < REL * abs(want)
    per = [tmos.mosnet_score(wav[i:i + 16000], sd, config=cfg_t,
                             window_seconds=1.0, device="cpu")
           for i in range(0, 40000, 16000)]
    assert abs(got - np.mean(per)) < 1e-6 * abs(got)
    resampled = tmos.mosnet_score(wav[:22050], sd, sr=22050, config=cfg_t,
                                  device="cpu")
    assert abs(resampled - jmos.mosnet_score(wav[:22050], variables,
                                             sr=22050, config=cfg_j)
               ) < REL * abs(resampled)


def test_mosnet_score_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, sd, _ = _weights(tmp_path, NARROW, seed=7)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmos.mosnet_score(np.zeros(16000, np.float32), sd,
                          config=tmos.MOSNetConfig(**NARROW))


def test_mosnet_metric_second_branch(monkeypatch, tmp_path):
    """With $GAT_MOSNET_WEIGHTS the metric loads the keras file and scores
    (here on the CPU, the card being absent) as the JAX metric does; with
    neither the wheel nor the variable it is unavailable, worded as the JAX
    one."""
    try:
        import speechmetrics  # noqa: F401
        pytest.skip("speechmetrics present: MOSNET dispatches to the wheel")
    except ImportError:
        pass
    monkeypatch.delenv("GAT_MOSNET_WEIGHTS", raising=False)
    with pytest.raises(TM.MetricUnavailable) as got:
        TM.MOSNET(np.zeros(16000), np.zeros(16000))
    with pytest.raises(JM.MetricUnavailable) as want:
        JM.MOSNET(np.zeros(16000), np.zeros(16000))
    assert str(got.value) == str(want.value)

    path = tmp_path / "mosnet.h5"
    _write_keras_h5(path, tmos.MOSNetConfig(), np.random.default_rng(8))
    monkeypatch.setenv("GAT_MOSNET_WEIGHTS", str(path))
    monkeypatch.setattr(tmos, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(TM, "_mos_variables", None, raising=False)
    monkeypatch.setattr(JM, "_mos_variables", None, raising=False)
    wav = np.random.default_rng(9).standard_normal(16000).astype(
        np.float32) * 0.1
    got_score = TM.MOSNET(wav, wav)
    assert np.isfinite(got_score)
    assert abs(got_score - JM.MOSNET(wav, wav)) < REL * abs(got_score)
    assert "MOSNET" in TM.REGISTERED_METRICS
