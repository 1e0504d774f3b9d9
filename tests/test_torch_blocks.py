"""generative_audio_torch.nn against generative_audio_tpu.nn on the CPU.

Weights come from the JAX module's `init` and are carried across with
generative_audio_torch.utils.convert; inputs come from numpy with a fixed
seed. In float32 the two sides compute the same algorithm and differ only in
the order of sums (convolutions, matmuls, norms), so the tolerance is 2e-5
absolute plus 1e-4 relative. The bf16 cases (the serving dtype) are held to
3e-2 of the output's scale: the two frameworks round to bf16 at different
places, and the LSTM kernel's plain version rounds the gates to bf16 where
the JAX CPU path keeps them in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.nn import attention as ja
from generative_audio_tpu.nn import recurrent as jr
from generative_audio_torch.nn import attention as ta
from generative_audio_torch.nn import recurrent as tr
from generative_audio_torch.utils import convert

torch.set_num_threads(2)
ATOL, RTOL = 2e-5, 1e-4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def test_tsse_matches_jax():
    x = _rand((2, 12, 20), seed=0)
    jm = ja.ChannelTimeSenseSELayer(num_channels=12)
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    want = np.asarray(jm.apply({"params": params}, x))
    tm = ta.make_channel_attention("TSSE", 12, device="cpu")
    tm.load_state_dict(convert.convert_tsse(params, ""))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_unported_attention_raises():
    """SE, CBAM and ECA build (test_torch_norms_attention.py holds them
    against JAX); an unknown kind and a TSSE whose groups do not divide its
    channels still raise."""
    for kind in ("SE", "CBAM", "ECA"):
        assert isinstance(ta.make_channel_attention(kind, 8, device="cpu"),
                          torch.nn.Module)
    with pytest.raises(NotImplementedError):
        ta.make_channel_attention("bogus", 8)
    with pytest.raises(ValueError):
        ta.make_channel_attention("TSSE", 129, subband_num=2, device="cpu")


def _sequence_models(kind, input_size, output_size, hidden, act, cdt_j,
                     cdt_t, x, seed, bidirectional=False):
    jm = jr.SequenceModel(input_size=input_size, output_size=output_size,
                          hidden_size=hidden, sequence_model=kind,
                          bidirectional=bidirectional,
                          output_activate_function=act, compute_dtype=cdt_j)
    params = jm.init(jax.random.PRNGKey(seed), x)["params"]
    want = np.asarray(jm.apply({"params": params}, x))
    tm = tr.SequenceModel(input_size, output_size, hidden, sequence_model=kind,
                          bidirectional=bidirectional,
                          output_activate_function=act, compute_dtype=cdt_t,
                          device="cpu")
    tm.load_state_dict(convert.convert_sequence_model(
        params, "", kind, bidirectional=bidirectional))
    return tm, want


@pytest.mark.parametrize("kind,hidden,act,bidirectional", [
    ("TCN", 24, "ReLU", False), ("TCN-subband", 16, "ReLU", False),
    ("LSTM", 16, None, False), ("LSTM", 16, "Tanh", False),
    ("LSTM", 16, None, True)])
def test_sequence_model_matches_jax_float32(kind, hidden, act, bidirectional):
    """TCN: TCNStack of 8 TCNBlocks (GlobalLayerNorm, PReLU, dilated
    depthwise convs) + head; LSTM: 2 layers (one- or two-way) + head."""
    x = np.abs(_rand((3, 10, 17), seed=1))
    tm, want = _sequence_models(kind, 10, 7, hidden, act, jnp.float32,
                                torch.float32, x, seed=2,
                                bidirectional=bidirectional)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind,act", [("LSTM", None), ("TCN", "ReLU")])
def test_sequence_model_bf16(kind, act):
    """The serving dtype; relative 3e-2 of the output's scale."""
    x = _rand((6, 8, 15), seed=3)
    tm, want = _sequence_models(kind, 8, 2, 16, act, jnp.bfloat16,
                                torch.bfloat16, x, seed=4)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want,
                               atol=3e-2 * max(np.abs(want).max(), 1.0))


def test_lstm_layer_switches_to_chunked_path(monkeypatch):
    """Above gates_bytes_limit the layer runs the time-chunked projection,
    with outputs equal to the unchunked layer's within bf16 rounding."""
    x = _rand((4, 8, 70), seed=5)
    tm, _ = _sequence_models("LSTM", 8, 2, 16, None, jnp.bfloat16,
                             torch.bfloat16, x, seed=6)
    calls = []
    real = tr.lstm_layer_tm_chunked

    def spy(*args, **kwargs):
        calls.append(args[5])               # t_chunk
        return real(*args, **kwargs)

    monkeypatch.setattr(tr, "lstm_layer_tm_chunked", spy)
    with torch.no_grad():
        base = tm(torch.from_numpy(x))
        assert calls == []
        for layer in tm.sequence_model.layers:
            layer.gates_bytes_limit = 1024
        chunked = tm(torch.from_numpy(x))
    assert calls == [64, 64]                # both layers, 64-frame chunks
    np.testing.assert_allclose(chunked.numpy(), base.numpy(), atol=3e-2)
