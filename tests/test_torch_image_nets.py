"""The port's image nets against the JAX package on the CPU: ImageUNet (with
and without the upscale), ResUNet (with attention, and with the upscale),
ResCNN (with the upscale), pixel_shuffle and AttentionBlock alone.

Narrow widths as tests/test_image_nppc.py:50-118 has them: channels_list
(8, 16) or (8, 8, 16), 4 groups, 6 x 6 to 16 x 16 images, batch 1-2,
float32. Params are made with numpy in the JAX layout
(convert.random_image_net_params) and carried across by
convert.convert_image_net. Tolerances: outputs within 1e-5 of the JAX
output's peak; the port's state_dict through
generative_audio_tpu/utils/torch_convert.convert_* gives back the JAX
params exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.nn import image_nets as jax_nets
from generative_audio_tpu.utils import torch_convert
from generative_audio_torch.nn import image_nets
from generative_audio_torch.utils import convert

torch.set_num_threads(2)

NETS = {
    "unet": ("ImageUNet", dict(
        in_channels=2, out_channels=3, channels_list=(8, 16),
        bottleneck_channels=16, downsample_list=(False, True), n_blocks=1,
        n_blocks_bottleneck=2, min_channels_decoder=8, n_groups=4),
        (2, 2, 12, 12), torch_convert.convert_image_unet),
    "unet_upscale": ("ImageUNet", dict(
        in_channels=1, out_channels=1, channels_list=(8, 16),
        bottleneck_channels=16, downsample_list=(False, True), n_blocks=2,
        n_blocks_bottleneck=1, min_channels_decoder=8, upscale_factor=2,
        n_groups=4), (1, 1, 8, 8), torch_convert.convert_image_unet),
    "res_unet_attn": ("ResUNet", dict(
        in_channels=2, out_channels=4, channels_list=(8, 8, 16),
        bottleneck_channels=16, downsample_list=(False, True, True),
        attn_list=(False, False, True), n_blocks=1, min_channels_decoder=1,
        n_groups=4, attn_heads=2), (2, 2, 16, 16),
        torch_convert.convert_res_unet),
    "res_unet_upscale": ("ResUNet", dict(
        in_channels=2, out_channels=4, channels_list=(8, 16, 16),
        bottleneck_channels=16, downsample_list=(False, True, True),
        attn_list=(False, True, True), n_blocks=2, min_channels_decoder=1,
        n_groups=4, attn_heads=2, upscale_factor=2), (2, 2, 8, 8),
        torch_convert.convert_res_unet),
    "res_cnn_upscale": ("ResCNN", dict(
        in_channels=3, out_channels=3, hidden_channels=8, n_blocks=2,
        upscale_factor=2), (1, 3, 6, 6), torch_convert.convert_res_cnn),
}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _peak_close(got, want, share=1e-5):
    want = np.asarray(want)
    assert np.shape(got) == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=share * np.abs(want).max())


def _pair(name, seed=1):
    kind, kw, shape, _ = NETS[name]
    net = getattr(image_nets, kind)(**kw)
    params = convert.random_image_net_params(net, seed=seed)
    net.load_state_dict(convert.convert_image_net(params, net), strict=True)
    return net, getattr(jax_nets, kind)(**kw), params, shape


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_matches_jax(name):
    net, jnet, params, shape = _pair(name)
    x = _rand(shape, seed=2)
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    _peak_close(got, want)


@pytest.mark.parametrize("name", sorted(NETS))
def test_state_dict_converts_back_exactly(name):
    """The port's state_dict keys are the reference's: the JAX package's
    own torch_convert reads them back into the same params, bit for bit."""
    net, jnet, params, _ = _pair(name)
    tc = NETS[name][3]
    back = tc({k: v.numpy() for k, v in net.state_dict().items()}, jnet)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # and to_jax_image_net is convert_image_net's inverse
    again = convert.to_jax_image_net(net.state_dict(), net)
    for a, b in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(params)):
        assert np.array_equal(a, b)


def test_res_block_shortcut_only_where_channels_change():
    assert image_nets.ResBlock(8, 8, 4).block.shortcut is None
    assert isinstance(image_nets.ResBlock(8, 16, 4).block.shortcut,
                      torch.nn.Conv2d)


def test_res_cnn_trailing_block_doubles():
    """The reference's empty trailing ShortcutBlock returns 2x."""
    block = image_nets.ShortcutBlock(torch.nn.Sequential())
    x = torch.from_numpy(_rand((1, 2, 3, 3), 5))
    assert torch.equal(block(x), x + x)


@pytest.mark.parametrize("shape,factor", [((2, 8, 3, 5), 2),
                                          ((1, 18, 2, 2), 3)])
def test_pixel_shuffle_matches_jax(shape, factor):
    x = _rand(shape, seed=4)
    want = np.asarray(jax_nets.pixel_shuffle(
        jnp.asarray(x.transpose(0, 2, 3, 1)), factor)).transpose(0, 3, 1, 2)
    got = image_nets.pixel_shuffle(torch.from_numpy(x), factor).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("heads,emb", [(1, None), (2, None), (2, 12)])
def test_attention_block_matches_jax(heads, emb):
    """QKV over the flattened pixels, logits scaled by heads ** -0.5,
    conv_in without a bias; Dense (JAX) against Conv1d 1x1 (port)."""
    c = 8
    block = image_nets.AttentionBlock(c, heads, emb)
    e = emb or c
    rng = np.random.default_rng(6)
    params = {"conv_in": {"kernel": rng.uniform(-.3, .3, (c, 3 * e))},
              "conv_out": {"kernel": rng.uniform(-.3, .3, (e, c)),
                           "bias": rng.uniform(-.3, .3, (c,))}}
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)
    block.load_state_dict({
        "conv_in.weight": torch.from_numpy(params["conv_in"]["kernel"].T[
            :, :, None].copy()),
        "conv_out.weight": torch.from_numpy(params["conv_out"]["kernel"].T[
            :, :, None].copy()),
        "conv_out.bias": torch.from_numpy(params["conv_out"]["bias"])})
    x = _rand((2, c, 5, 6), seed=7)
    jblock = jax_nets.AttentionBlock(heads=heads, embedding_channels=emb)
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(
        x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    _peak_close(got, want)
    # the residual is the input itself: the attention's part is not zero
    assert np.abs(got - x).max() > 1e-2


def test_group_norm_epsilon_is_flax_default():
    net = image_nets.ImageUNet(**NETS["unet"][1])
    eps = {m.eps for m in net.modules() if isinstance(m, torch.nn.GroupNorm)}
    assert eps == {1e-6}


def test_upscale_factor_must_be_power_of_two():
    with pytest.raises(ValueError, match="power of 2"):
        image_nets.ResCNN(1, 1, hidden_channels=4, n_blocks=1,
                          upscale_factor=3)
