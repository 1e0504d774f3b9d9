"""generative_audio_torch's ComplexSequenceModel, the TCN block's causal and
no-skip options and the causal 2-D conv blocks against generative_audio_tpu,
on the CPU.

Parameters are made with numpy (utils.convert.random_complex_sequence_params
and the TCN blocks') or come from the JAX modules' `init` (the conv blocks),
carried across by utils/convert.py.
Float32 on both sides: outputs 2e-5 absolute plus 1e-4 relative; gradients
and recurrences (the port's float32 loop against lax.scan) 1e-4 of the
largest value; BatchNorm statistics 1e-5 relative.
"""
import jax
import numpy as np
import pytest
import torch

from generative_audio_tpu.nn import recurrent as jr
from generative_audio_tpu.nn import tcn as jt
from generative_audio_torch.nn import recurrent as tr
from generative_audio_torch.nn import tcn as tt
from generative_audio_torch.utils import convert

torch.set_num_threads(2)
ATOL, RTOL = 2e-5, 1e-4
REL = 1e-4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("kind,bidirectional", [
    ("LSTM", False), ("LSTM", True), ("GRU", False), ("GRU", True)])
def test_complex_sequence_model_matches_jax(kind, bidirectional):
    """Output and the gradients of every parameter and of the input."""
    n_in, h, n_out, b, t = 5, 8, 3, 2, 9
    params = convert.random_complex_sequence_params(
        kind, n_in, h, n_out, bidirectional=bidirectional, seed=1)
    x = _rand((b, 2 * n_in, t), seed=2)
    w = _rand((b, 2 * n_out, t), seed=3)
    jm = jr.ComplexSequenceModel(n_in, n_out, h, bidirectional=bidirectional,
                                 sequence_model=kind)

    @jax.jit
    def forward_and_vjp(p, v):
        out, vjp = jax.vjp(lambda p, v: jm.apply({"params": p}, v), p, v)
        return out, vjp(w)

    want, (want_dp, want_dx) = forward_and_vjp(params, x)
    tm = tr.ComplexSequenceModel(n_in, n_out, h, bidirectional=bidirectional,
                                 sequence_model=kind, device="cpu")
    tm.load_state_dict(convert.convert_complex_sequence_model(
        params, bidirectional=bidirectional))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tm(xt)
    (got * torch.from_numpy(w)).sum().backward()

    assert got.shape == (b, 2 * n_out, t)
    assert _rel(got.detach().numpy(), want) < REL
    assert _rel(xt.grad.numpy(), want_dx) < REL
    want_grads = convert.convert_complex_sequence_model(
        want_dp, bidirectional=bidirectional)
    for name, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), want_grads[name].numpy()) < REL, name


def test_complex_sequence_model_runs_both_streams_as_one_batch(monkeypatch):
    """Each layer of each tower runs one scan over the 2B rows of the real
    and the imag stream together; the head has the reference's names."""
    calls = []
    real_scan = tr.LSTMLayer._scan_float32

    def recording(self, x_tm, *args):
        calls.append(x_tm.shape[1])
        return real_scan(self, x_tm, *args)

    monkeypatch.setattr(tr.LSTMLayer, "_scan_float32", recording)
    tm = tr.ComplexSequenceModel(4, 2, 8, sequence_model="LSTM", device="cpu")
    tm(torch.zeros(3, 8, 5))
    assert calls == [6, 6, 6, 6]
    names = set(tm.state_dict())
    assert {"real_sequence_model.weight_ih_l1", "imag_sequence_model.bias_hh_l0",
            "real_fc_output_layer.weight", "imag_fc_output_layer.bias"} <= names
    with pytest.raises(NotImplementedError):
        tr.ComplexSequenceModel(4, 2, 8, sequence_model="TCN", device="cpu")


@pytest.mark.parametrize("causal,skip", [(True, True), (False, False)])
def test_tcn_stack_options_match_jax(causal, skip):
    """Eight blocks (dilations 1, 2, 5, 9 twice) with the causal left pad or
    without the skip connection, and the final ReLU."""
    c, hid, b, t = 6, 10, 2, 23
    x = _rand((b, t, c), seed=4)
    rng = np.random.default_rng(5)

    def u(*shape):
        return rng.uniform(-0.4, 0.4, shape).astype(np.float32)

    params = [{"conv1x1": {"kernel": u(c, hid), "bias": u(hid)},
               "prelu1": u(1), "norm1": {"scale": 1 + u(hid), "bias": u(hid)},
               "depthwise_conv": {"kernel": u(3, 1, hid), "bias": u(hid)},
               "prelu2": u(1), "norm2": {"scale": 1 + u(hid), "bias": u(hid)},
               "sconv": {"kernel": u(hid, c), "bias": u(c)}}
              for _ in tt.TCNStack.DILATIONS]
    blocks = [jt.TCNBlock(in_channels=c, hidden_channels=hid, out_channels=c,
                          dilation=d, causal=causal, use_skip_connection=skip)
              for d in tt.TCNStack.DILATIONS]

    @jax.jit
    def jax_stack(ps, y):
        for block, p in zip(blocks, ps):
            y = block.apply({"params": p}, y)
        return jax.nn.relu(y)

    want = np.asarray(jax_stack(params, x))
    stack = torch.nn.Sequential(*(
        tt.TCNBlock(c, hid, c, dilation=d, causal=causal,
                    use_skip_connection=skip, device="cpu")
        for d in tt.TCNStack.DILATIONS))
    stack.load_state_dict({k: v for i, p in enumerate(params) for k, v in
                           convert.convert_tcn_block(p, f"{i}.").items()})
    with torch.no_grad():
        got = torch.relu(stack(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert stack[1].padding == ((4, 0) if causal else (2, 2))   # dilation 2


def _with_random_stats(variables, seed):
    rng = np.random.default_rng(seed)
    stats = {"norm": {
        "mean": rng.standard_normal(variables["batch_stats"]["norm"]["mean"]
                                    .shape).astype(np.float32) * 0.1,
        "var": rng.uniform(0.5, 1.5, variables["batch_stats"]["norm"]["var"]
                           .shape).astype(np.float32)}}
    return {"params": variables["params"], "batch_stats": stats}


def _conv_block_case(jm, tm, sd_of, x_nchw, seed):
    """A train step (output, the updated running statistics) and then an
    eval step, the JAX block on [B, F, T, C], the port's on [B, C, F, T]."""
    x_nhwc = np.ascontiguousarray(x_nchw.transpose(0, 2, 3, 1))
    variables = _with_random_stats(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                                    x_nhwc), seed)
    tm.load_state_dict(sd_of(variables))
    want, updated = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x_nhwc)
    with torch.no_grad():
        got = tm(torch.from_numpy(x_nchw), train=True)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=ATOL, rtol=RTOL)
    for buf, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(tm.norm, buf).numpy(),
            np.asarray(updated["batch_stats"]["norm"][key]), rtol=1e-5,
            atol=1e-7)
    trained = {"params": variables["params"], **updated}
    want_eval = jax.jit(lambda v, x: jm.apply(v, x, train=False))(trained,
                                                                  x_nhwc)
    with torch.no_grad():
        got_eval = tm(torch.from_numpy(x_nchw), train=False)
    np.testing.assert_allclose(got_eval.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want_eval), atol=ATOL, rtol=RTOL)
    return variables


def test_causal_conv_block_matches_jax():
    x = _rand((2, 3, 9, 7), seed=6)             # [B, C, F, T]
    jm = jt.CausalConvBlock(out_channels=4, activation="elu")
    tm = tt.CausalConvBlock(3, 4, activation="elu", device="cpu")
    _conv_block_case(jm, tm, convert.convert_causal_conv_block, x, seed=7)
    assert tm(torch.from_numpy(x)).shape == (2, 4, 4, 7)


@pytest.mark.parametrize("is_last,output_padding", [(False, (1, 0)),
                                                    (True, (0, 0))])
def test_causal_trans_conv_block_matches_jax(is_last, output_padding):
    x = _rand((2, 4, 5, 6), seed=8)
    jm = jt.CausalTransConvBlock(out_channels=3, is_last=is_last,
                                 output_padding=output_padding)
    tm = tt.CausalTransConvBlock(4, 3, is_last=is_last,
                                 output_padding=output_padding, device="cpu")
    _conv_block_case(jm, tm, convert.convert_causal_trans_conv_block, x,
                     seed=9)
    assert tm(torch.from_numpy(x)).shape == (2, 3, 11 + output_padding[0], 6)


def test_trans_conv_kernel_must_be_flipped():
    """flax's ConvTranspose does not flip its kernel and torch's
    conv_transpose2d does: without the converter's flip the block is
    wrong."""
    x = _rand((1, 2, 4, 5), seed=10)
    jm = jt.CausalTransConvBlock(out_channels=2)
    tm = tt.CausalTransConvBlock(2, 2, device="cpu")
    variables = _conv_block_case(jm, tm,
                                 convert.convert_causal_trans_conv_block, x,
                                 seed=11)
    unflipped = convert.convert_causal_trans_conv_block(variables)
    unflipped["conv.weight"] = torch.from_numpy(np.ascontiguousarray(
        np.asarray(variables["params"]["conv"]["kernel"]).transpose(2, 3, 0, 1)))
    tm.load_state_dict(unflipped)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=False).numpy().transpose(0, 2, 3, 1)
    assert _rel(got, want) > 1e-2
