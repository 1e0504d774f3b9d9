"""generative_audio_torch's seven norms and channel-attention family against
generative_audio_tpu's, on the CPU.

Inputs come from numpy with a fixed seed, attention weights from the JAX
modules' `init`, carried across by utils/convert.py. Tolerances (float32
throughout): outputs 2e-5 absolute plus 1e-4 relative, the order of sums
being the only difference; the forgetting family's matmul form against
JAX's lax.scan (and against the port's own step-by-step loop) 1e-5 of the
output's peak, since the matmul sums up to T products where the scan
rounds once a step; gradients 1e-4 of the largest gradient.
"""
import jax
import numpy as np
import pytest
import torch

from generative_audio_tpu.nn import attention as ja
from generative_audio_tpu.ops import norms as jn
from generative_audio_torch.nn import attention as ta
from generative_audio_torch.ops import norms as tn
from generative_audio_torch.utils import convert

torch.set_num_threads(2)
ATOL, RTOL = 2e-5, 1e-4
SCAN_REL, GRAD_REL = 1e-5, 1e-4
# training length small enough that T crosses the warm-up (t < L, c_t =
# min((t - 1) / (t + 1), alpha)) and the steady state (c_t = alpha)
L_SHORT = 5

FOUR_D = ("offline_laplace_norm", "cumulative_laplace_norm",
          "offline_gaussian_norm", "cumulative_layer_norm")
THREE_D = ("forgetting_norm", "sband_forgetting_norm", "hybrid_norm")


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _positive(shape, seed):
    return np.abs(_rand(shape, seed)) + 0.1


def _jax_norm(name, four_d):
    fn = jn.get_norm(name) if four_d else getattr(jn, name)
    if name in THREE_D:
        return lambda x: fn(x, L_SHORT)
    return fn


def _torch_norm(name, four_d):
    fn = tn.get_norm(name) if four_d else getattr(tn, name)
    if name in THREE_D:
        return lambda x: fn(x, L_SHORT)
    return fn


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name,shape", [
    *((n, (2, 2, 7, 12)) for n in FOUR_D),
    *((n, (2, 2, 7, 12)) for n in THREE_D),     # through get_norm's _as_3d
    *((n, (3, 9, 12)) for n in THREE_D),
    ("hybrid_norm", (2, 9, 3)),                 # T < L: warm-up over T
])
def test_norm_forward_and_gradient_match_jax(name, shape):
    four_d = len(shape) == 4
    x = _positive(shape, seed=len(name))
    w = _rand(shape, seed=1)
    jfn, tfn = _jax_norm(name, four_d), _torch_norm(name, four_d)

    @jax.jit
    def forward_and_vjp(v):
        out, vjp = jax.vjp(jfn, v)
        return out, vjp(w)[0]

    want, want_grad = (np.asarray(a) for a in forward_and_vjp(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(xt)
    (got * torch.from_numpy(w)).sum().backward()

    tol = SCAN_REL if name in THREE_D else None
    if tol is None:
        np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                                   rtol=RTOL)
    else:
        assert _rel(got.detach().numpy(), want) < tol
    assert _rel(xt.grad.numpy(), want_grad) < GRAD_REL


@pytest.mark.parametrize("t_len,length", [(12, L_SHORT), (40, 1),
                                          (2100, 1500), (2100, 192)])
def test_forgetting_products_match_their_loops(t_len, length):
    """Each matmul form against the step-by-step recurrence, also where T
    crosses a block of the product (1024 frames) inside and after the
    warm-up."""
    x = torch.from_numpy(_positive((2, 6, t_len), seed=t_len + length))
    for fast, slow in ((tn.forgetting_norm, tn.forgetting_norm_reference),
                       (tn.sband_forgetting_norm,
                        tn.sband_forgetting_norm_reference),
                       (tn.hybrid_norm, tn.hybrid_norm_reference)):
        assert _rel(fast(x, length).numpy(), slow(x, length).numpy()) < SCAN_REL


def test_forgetting_norm_quirks():
    """mu_0 = 2 * mean(frame_0) (alp = -1 at t = 0); the sband norm follows
    bin f // 2 - 1 after the warm-up; the weights' rows are the recurrence's
    coefficients."""
    x = torch.from_numpy(_positive((1, 6, 8), seed=3))
    out = tn.forgetting_norm(x, 4)
    np.testing.assert_allclose(out[0, :, 0].numpy(),
                               (x[0, :, 0] / (2 * x[0, :, 0].mean() + 1e-10)
                                ).numpy(), rtol=1e-6)
    y = x.clone()
    y[:, 6 // 2 - 1, 4:] *= 3.0          # the middle bin after the warm-up
    mu_x = x[0, 0] / tn.sband_forgetting_norm(x, 4)[0, 0]
    mu_y = y[0, 0] / tn.sband_forgetting_norm(y, 4)[0, 0]
    assert torch.allclose(mu_x[:4], mu_y[:4]) and (mu_y[4:] > mu_x[4:]).all()
    w, carry = tn.forgetting_weights(0, 3, 10)
    np.testing.assert_allclose(w, [[2, 0, 0], [0, 1, 0], [0, 1 / 3, 2 / 3]],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(carry, [-1, 0, 0], atol=1e-7)


def test_get_norm_takes_seven_names_and_refuses_others():
    assert set(tn._NORMS) == set(jn._NORMS) and len(tn._NORMS) == 7
    with pytest.raises(NotImplementedError, match="Unknown norm type"):
        tn.get_norm("bogus")
    with pytest.raises(ValueError, match=r"\[B, F, T\]"):
        tn.forgetting_norm(torch.ones(1, 2, 3, 4))


# ---------------------------------------------------------------- attention
def _init_and_apply(module, *inputs):
    """The module's params from its `init` and its output on `inputs`, in
    one jitted call (one compile)."""
    @jax.jit
    def run(*v):
        params = module.init(jax.random.PRNGKey(0), *v)["params"]
        return params, module.apply({"params": params}, *v)
    return run(*inputs)


def _check_attention(jm, tm, sd, x, multi=False):
    params_in = (x,) * (3 if multi else 1)
    params, want = _init_and_apply(jm, *params_in)
    tm.load_state_dict(sd(params))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(v) for v in params_in))
    pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("kind", ["SE", "CBAM", "ECA", "TSSE"])
def test_channel_attention_matches_jax(kind):
    x = _rand((2, 12, 20), seed=4)
    jm = ja.make_channel_attention(kind, 12)
    tm = ta.make_channel_attention(kind, 12, device="cpu")
    _check_attention(jm, tm, lambda p: convert.convert_attention(p, "", kind),
                     x)


def test_grouped_tsse_matches_jax():
    """subband_num = 5 over 20 channels: 4 groups of 5 channels each."""
    x = _rand((2, 20, 30), seed=5)
    jm = ja.make_channel_attention("TSSE", 20, subband_num=5)
    tm = ta.make_channel_attention("TSSE", 20, subband_num=5, device="cpu")
    assert tm.smallConv1d[0].groups == 4
    _check_attention(jm, tm, lambda p: convert.convert_tsse(p, ""), x)


def test_tsse_variants_match_jax():
    x = _rand((2, 6, 24), seed=6)         # the deep branches need T >= 19
    cases = [
        (ja.ChannelTimeSenseSEWeightLayer(6),
         ta.ChannelTimeSenseSEWeightLayer(6, device="cpu"),
         lambda p: convert.convert_tsse(p, "")),
        (ja.ChannelDeepTimeSenseSELayer(6),
         ta.ChannelDeepTimeSenseSELayer(6, device="cpu"),
         lambda p: convert.convert_deep_tsse(p, "")),
        (ja.ChannelTimeSenseAttentionSELayer(6),
         ta.ChannelTimeSenseAttentionSELayer(6, device="cpu"),
         lambda p: convert.convert_attention_tsse(p, ""))]
    for jm, tm, sd in cases:
        _check_attention(jm, tm, sd, x)
    names = set(ta.ChannelDeepTimeSenseSELayer(6, device="cpu").state_dict())
    assert {"smallConv1d.0.weight", "smallConv1d.2.weight"} <= names
    names = set(ta.ChannelTimeSenseAttentionSELayer(6, device="cpu"
                                                    ).state_dict())
    assert {"largeConv1d.conv1d.weight", "largeConv1d.attention.q_linear.weight",
            "largeConv1d.attention.out.bias"} <= names


def test_self_attention_and_conv_attention_block_match_jax():
    x = _rand((2, 9, 7), seed=7)           # [B, T, F]
    _check_attention(ja.SelfAttentionLayer(amp_dim=7, att_dim=5),
                     ta.SelfAttentionLayer(7, 5, device="cpu"),
                     lambda p: convert.convert_self_attention(p, ""), x,
                     multi=True)
    y = _rand((2, 6, 12), seed=8)          # [B, C, T]
    jm = ja.ConvAttentionBlock(6, 3)
    params, want = _init_and_apply(jm, y)
    tm = ta.ConvAttentionBlock(6, 3, device="cpu")
    tm.load_state_dict({
        **convert._conv1d(params["conv1d"], "conv1d"),
        **convert.convert_self_attention(params["attention"], "attention.")})
    with torch.no_grad():
        got = tm(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def test_tsse_refuses_groups_that_do_not_divide_the_channels():
    """F = 257 with subband_num = 2 folds to 129 channels in 129 // 2 = 64
    groups, which do not divide 129 (the JAX model fails there too)."""
    with pytest.raises(ValueError, match=r"129 // 2 = 64.*129"):
        ta.make_channel_attention("TSSE", 129, subband_num=2, device="cpu")
    ta.make_channel_attention("SE", 129, subband_num=2, device="cpu")


def test_unknown_attention_raises():
    with pytest.raises(NotImplementedError, match="bogus"):
        ta.make_channel_attention("bogus", 8)
    with pytest.raises(NotImplementedError, match="bogus"):
        convert.convert_attention({}, "", "bogus")
