"""FullSubNet+ variants of the port against the JAX package on the CPU: the
TSSE over the sub-band fold (subband_num 3, where 3 divides F = 33, so the
reference pads 3 bins, not 0: 12 channels of 3 T frames in 4 groups), and
SE with subband_num 2 and a cumulative norm. The other attention kinds and
norms are held module by module in test_torch_norms_attention.py.

Narrow models (33 or 32 bins, TCN hidden 512 as the reference fixes it,
sub-band hidden 16), numpy-made params (utils.convert
.random_fullsubnet_plus_params) in the JAX layout, float32 on both sides.
Tolerances as in test_torch_fullsubnet_plus.py and test_torch_training.py:
the cRM 5e-5 absolute plus 1e-3 relative; the loss 1e-5 relative; a
gradient leaf 1e-3 of its own peak plus 1e-4 of the largest peak.

One variant takes a training step (loss and gradients through the whole
loss, a batch with drop_band on): the TSSE fold, whose grouped convolution
over the folded stream is the one gradient no module test holds. The two SE
variants are held forward: SE's, the norms' and the fold's gradients are
held module by module. The SE variant with the cumulative Laplace norm
would not train within these tolerances in any case: that norm divides the
real and the imaginary stream by running means near zero, its input
gradient there peaks near 1.5e4, and float32 (either framework) leaves
1.5e-5 of that peak against float64.
"""
import jax
import numpy as np
import pytest
import torch

from generative_audio_tpu import train as JT
from generative_audio_tpu.models import (
    FullSubNetPlus as JaxFullSubNetPlus,
    FullSubNetPlusConfig as JaxFullSubNetPlusConfig)
from generative_audio_torch import train as TT
from generative_audio_torch.models import (
    FullSubNetPlus, FullSubNetPlusConfig, MultiDirectionConfig,
    MultiDirectionFullSubNetPlus)
from generative_audio_torch.models.fullsubnet_plus import attend
from generative_audio_torch.nn.attention import make_channel_attention
from generative_audio_torch.utils import convert

torch.set_num_threads(2)

VARIANTS = {    # name: (model config, n_fft)
    "tsse_fold": (dict(num_freqs=33, channel_attention_model="TSSE",
                       subband_num=3), 64),
    "se_fold_cumulative": (dict(num_freqs=32, channel_attention_model="SE",
                                subband_num=2,
                                norm_type="cumulative_layer_norm"), 62),
    "se_fold_cumulative_laplace": (dict(
        num_freqs=32, channel_attention_model="SE", subband_num=2,
        norm_type="cumulative_laplace_norm"), 62),
}
TRAINED = ("tsse_fold",)
NARROW = dict(sb_num_neighbors=2, sb_model_hidden_size=16,
              num_groups_in_drop_band=2)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _variant(name):
    model, n_fft = VARIANTS[name]
    jcfg = JaxFullSubNetPlusConfig(**model, **NARROW)
    tcfg = FullSubNetPlusConfig(**model, **NARROW)
    params = convert.random_fullsubnet_plus_params(tcfg, seed=1)
    return jcfg, tcfg, params, n_fft


@pytest.mark.parametrize("name", ["se_fold_cumulative",
                                  "se_fold_cumulative_laplace"])
def test_variant_forward_matches_jax(name):
    """One clip, look-ahead included, for each variant the training test
    below leaves out."""
    jcfg, tcfg, params, _ = _variant(name)
    f = tcfg.num_freqs
    mag = np.abs(_rand((1, 1, f, 14), seed=2))
    real, imag = _rand((1, 1, f, 14), seed=3), _rand((1, 1, f, 14), seed=4)
    apply = jax.jit(JaxFullSubNetPlus(jcfg).apply)
    tm = FullSubNetPlus(tcfg, compute_dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.convert_fullsubnet_plus(
        params, attention=tcfg.channel_attention_model))
    want = np.asarray(apply({"params": params}, mag, real, imag))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (mag, real, imag))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("name", TRAINED)
def test_variant_training_loss_and_gradients_match_jax(name):
    jcfg_model, tcfg_model, params, n_fft = _variant(name)
    kw = dict(n_fft=n_fft, hop_length=32, win_length=n_fft,
              compute_dtype="float32")
    jcfg = JT.EnhanceTrainConfig(model=jcfg_model, **kw)
    tcfg = TT.EnhanceTrainConfig(model=tcfg_model, **kw)
    rng = np.random.default_rng(5)
    clean = rng.standard_normal((4, 2048)).astype(np.float32)
    noisy = clean + 0.3 * rng.standard_normal((4, 2048)).astype(np.float32)
    want, want_grads = jax.jit(jax.value_and_grad(JT.enhance_loss_fn),
                               static_argnums=3)(params, noisy, clean, jcfg)

    state = TT.init_enhance_state(tcfg, seed=0, device="cpu")
    state.model.load_state_dict(convert.convert_fullsubnet_plus(
        params, attention=tcfg_model.channel_attention_model))
    got = TT.enhance_loss_fn(state.model, torch.from_numpy(noisy),
                             torch.from_numpy(clean), tcfg)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    got_grads = _leaves(convert.to_jax_fullsubnet_plus(grads))
    want_grads = _leaves(want_grads)
    assert set(got_grads) == set(want_grads)
    peak = max(np.abs(w).max() for w in want_grads.values())
    for key, w in want_grads.items():
        np.testing.assert_allclose(
            got_grads[key], w, rtol=0,
            atol=1e-3 * np.abs(w).max() + 1e-4 * peak, err_msg=key)


def test_fold_pads_with_the_reversed_bins_before_the_last():
    """attend folds [B, 1, F, T] to [B, (F + pad) / s, T * s]: channel c
    holds bins c * s .. c * s + s - 1 one after another in time; the pad
    repeats bins F - 1 - pad .. F - 2 in reverse."""
    seen = []

    class Spy(torch.nn.Module):
        def forward(self, x):
            seen.append(x)
            return x

    y = torch.arange(5 * 2, dtype=torch.float32).reshape(1, 1, 5, 2)
    out = attend(y, Spy(), 2)                  # pad = 2 - 5 % 2 = 1: bin 3
    assert seen[0].shape == (1, 3, 4)
    assert seen[0][0, 2].tolist() == [8, 9, 6, 7]      # bin 4, then bin 3
    assert torch.equal(out, y[:, 0])
    seen.clear()
    attend(y[:, :, :4], Spy(), 2)              # 2 divides 4: pad is 2, not 0
    assert seen[0].shape == (1, 3, 4)
    assert seen[0][0, 2].tolist() == [4, 5, 2, 3]      # bins 2 and 1


def test_model_builds_every_attention_kind_and_refuses_bad_groups():
    for kind in ("SE", "TSSE", "CBAM", "ECA"):
        cfg = FullSubNetPlusConfig(num_freqs=33, channel_attention_model=kind,
                                   **NARROW)
        model = FullSubNetPlus(cfg, compute_dtype=torch.float32, device="cpu")
        model.load_state_dict(convert.convert_fullsubnet_plus(
            convert.random_fullsubnet_plus_params(cfg), attention=kind))
    with pytest.raises(ValueError, match=r"129 // 2 = 64"):
        FullSubNetPlus(FullSubNetPlusConfig(subband_num=2), device="cpu")
    assert isinstance(make_channel_attention("ECA", 9), torch.nn.Module)


def test_multidirection_takes_the_fold():
    """The NPPC head folds as FullSubNetPlus does; the JAX head has no fold
    (its attention gets F channels where it was built for F // s + 1), so
    this holds the head's attention input to attend's."""
    cfg = MultiDirectionConfig(num_freqs=33, subband_num=3, n_directions=2,
                               channel_attention_model="SE", **NARROW)
    head = MultiDirectionFullSubNetPlus(cfg, compute_dtype=torch.float32,
                                        device="cpu")
    seen = []
    head.channel_attention.register_forward_hook(
        lambda m, args, out: seen.append(args[0].shape))
    streams = [torch.from_numpy(np.abs(_rand((3, 1, 33, 10), seed=s)))
               for s in range(6)]
    with torch.no_grad():
        out = head(*streams)
    assert seen == [(3, 12, 36), (3, 12, 36)]
    assert out.shape[:2] == (3, 4) and out.shape[3] == 10
    assert torch.isfinite(out).all()
