"""The port's inpainting-line ops and networks against the JAX package on the
CPU: preprocess_data, the three losses and their gradients, the bilinear
resize, UNet / UNet2 / RestorationWrapper / AudioInpaintingPCWrapper
forwards with weights carried across by utils/convert.py, one training-mode
forward with its BatchNorm running statistics, the dropout's properties,
the MC-dropout PCA and baseline, and the PNG layer.

Small shapes: UNets at the shipped widths (64 -> 512) over a 32 x 64
spectrogram, batch 2, float32; weights made with numpy
(convert.random_unet_params, BatchNorm parameters and running statistics
drawn around their init). Tolerances: forwards within 1e-4 of the output's
peak; losses within 1e-6 relative and their gradients within 1e-5 of the
gradient's peak; running statistics within 1e-5 of their peak (both sides
update them in float32 in another order); PCA components up to a sign per
component within 1e-4 of their peak.
"""
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu import losses as jax_losses
from generative_audio_tpu.eval import mc_dropout as jax_mc
from generative_audio_tpu.models.nppc_model import (
    InpaintingRestorationModel as JaxRestoration, UNetModelConfig as JaxUNetCfg)
from generative_audio_tpu.models.pc_wrapper import (
    AudioInpaintingPCWrapper as JaxPCWrapper,
    AudioInpaintingPCWrapperConfig as JaxPCConfig)
from generative_audio_tpu.nn import unet as jax_unet
from generative_audio_tpu.ops import preprocess as jax_pre
from generative_audio_torch import losses
from generative_audio_torch.eval import mc_dropout
from generative_audio_torch.models import (
    AudioInpaintingPCWrapper, AudioInpaintingPCWrapperConfig,
    InpaintingRestorationModel, UNetModelConfig)
from generative_audio_torch.nn import unet
from generative_audio_torch.ops import preprocess
from generative_audio_torch.utils import convert, plot

torch.set_num_threads(2)
F_, T_, B = 32, 64, 2


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _peak_close(got, want, share=1e-4):
    want = np.asarray(want)
    assert np.shape(got) == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=share * np.abs(want).max())


def unet_variables(in_ch, out_ch, seed):
    """random_unet_params with BatchNorm scales, biases, running means and
    variances drawn around their init, so that eval mode reads them."""
    v = convert.random_unet_params(in_ch, out_ch, seed)
    rng = np.random.default_rng(seed + 100)

    def perturb(tree, kind):
        for k, node in tree.items():
            if k.startswith("bn"):
                n = next(iter(node.values())).shape
                if kind == "params":
                    node["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                    node["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
                else:
                    node["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
                    node["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            elif isinstance(node, dict):
                perturb(node, kind)

    perturb(v["params"], "params")
    perturb(v["batch_stats"], "stats")
    return v


def _mask4(batch=B, gap=(20, 30)):
    m = np.ones((batch, 1, F_, T_), np.float32)
    m[..., gap[0]:gap[1]] = 0.0
    return m


def _port_unet(variables, in_ch, out_ch, dropout=0.0):
    net = unet.UNet(in_ch, out_ch, dropout)
    net.load_state_dict(convert.convert_unet(variables))
    return net


# ------------------------------------------------------------ preprocess --
def test_preprocess_data_matches_jax():
    """float32 on both sides; the whole-batch mean and unbiased std in
    another summation order: 1e-5 of the peak."""
    clean = _rand((B, 2, F_, T_), 0)
    mask = np.ones((B, T_), np.float32)
    mask[:, 10:19] = 0
    masked = clean * mask[:, None, None, :]
    want = jax_pre.preprocess_data(jnp.asarray(clean), jnp.asarray(masked),
                                   jnp.asarray(mask), return_stats=True)
    got = preprocess.preprocess_data(*(torch.from_numpy(x) for x in
                                       (clean, masked, mask)),
                                     return_stats=True)
    for g, w in zip(got, want):
        _peak_close(g.numpy(), w, 1e-5)
    spec = _rand((B, 3, F_, T_), 1)
    for g, w in zip(preprocess.normalize_spectrograms(torch.from_numpy(spec)),
                    jax_pre.normalize_spectrograms(jnp.asarray(spec))):
        _peak_close(g.numpy(), w, 1e-5)


# ---------------------------------------------------------------- losses --
def _loss_inputs(seed):
    w = _rand((B, 3, F_, T_), seed)
    err = _rand((B, 1, F_, T_), seed + 1)
    mc = _rand((B, 3, F_, T_), seed + 2)
    svals = np.abs(_rand((B, 3), seed + 3)) + 0.5
    return w, err, mc, svals


@pytest.mark.parametrize("step", [0, 300, 900])
@pytest.mark.parametrize("name", ["real", "mc_aligned"])
def test_nppc_objectives_and_grads_match_jax(name, step):
    """Objective and reconst_err within 1e-6 relative, d objective / d w_mat
    within 1e-5 of its peak, at three points of the lambda ramp."""
    w, err, mc, svals = _loss_inputs(step)

    def jax_fn(w):
        if name == "real":
            r, o, _ = jax_losses.nppc_objective_real(
                w, jnp.asarray(err), jnp.float32(step), grace=500,
                lambda_scale=0.7)
        else:
            r, o, _ = jax_losses.nppc_objective_mc_aligned(
                w, jnp.asarray(mc), jnp.asarray(svals), jnp.float32(step),
                grace=500, lambda_scale=0.7)
        return o, r

    (want_o, want_r), want_g = jax.value_and_grad(jax_fn, has_aux=True)(
        jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    if name == "real":
        r, o, _ = losses.nppc_objective_real(wt, torch.from_numpy(err), step,
                                             grace=500, lambda_scale=0.7)
    else:
        r, o, _ = losses.nppc_objective_mc_aligned(
            wt, torch.from_numpy(mc), torch.from_numpy(svals), step,
            grace=500, lambda_scale=0.7)
    o.backward()
    np.testing.assert_allclose(o.item(), float(want_o), rtol=1e-6)
    np.testing.assert_allclose(r.detach().numpy(), want_r, rtol=1e-6)
    _peak_close(wt.grad.numpy(), want_g, 1e-5)


def test_masked_mse_loss_matches_jax():
    pred, target = _rand((B, 1, F_, T_), 5), _rand((B, 1, F_, T_), 6)
    mask = _mask4()

    def jax_fn(p):
        return jax_losses.masked_mse_loss(p, jnp.asarray(target),
                                          jnp.asarray(mask))

    want, want_g = jax.value_and_grad(jax_fn)(jnp.asarray(pred))
    pt = torch.tensor(pred, requires_grad=True)
    got = losses.masked_mse_loss(pt, torch.from_numpy(target),
                                 torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    _peak_close(pt.grad.numpy(), want_g, 1e-5)
    # the no-gap batch: the max(sum(gap), 1) guard gives 0, not NaN
    ones = torch.ones(B, 1, F_, T_)
    assert losses.masked_mse_loss(torch.from_numpy(pred),
                                  torch.from_numpy(target), ones).item() == 0


# -------------------------------------------------------------- networks --
@pytest.mark.parametrize("hw,new_hw", [((4, 8), (8, 16)), ((3, 5), (7, 9)),
                                       ((1, 4), (2, 8))])
def test_resize_align_corners_matches_jax(hw, new_hw):
    x = _rand((2, 3) + hw, 7)
    want = jax_unet.resize_align_corners(
        jnp.asarray(x.transpose(0, 2, 3, 1)), new_hw)
    got = unet.resize_align_corners(torch.from_numpy(x), new_hw)
    _peak_close(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), 1e-6)


@pytest.fixture(scope="module")
def rest_variables():
    return unet_variables(1, 1, seed=11)


def test_unet_eval_forward_matches_jax(rest_variables):
    x = _rand((B, 1, F_, T_), 12)
    net = jax_unet.UNet(1, 1, dropout=0.2)
    want = jax.jit(lambda v, x: net.apply(v, x, train=False))(
        rest_variables, x)
    with torch.no_grad():
        got = _port_unet(rest_variables, 1, 1, 0.2)(torch.from_numpy(x),
                                                    train=False)
    _peak_close(got.numpy(), want)


def test_unet_training_forward_and_running_stats_match_jax(rest_variables):
    """train=True at dropout 0: the output within 1e-4 of its peak and every
    BatchNorm's running mean and variance after the step within 1e-5 of
    its peak, against flax's biased-variance update (torch's BatchNorm2d
    would be off by n / (n - 1): 6.7% at down4's 16 values a channel)."""
    x = _rand((B, 1, F_, T_), 13)
    net = jax_unet.UNet(1, 1, dropout=0.0)
    want, mutated = jax.jit(lambda v, x: net.apply(
        v, x, train=True, mutable=["batch_stats"]))(rest_variables, x)
    port = _port_unet(rest_variables, 1, 1, 0.0)
    got = port(torch.from_numpy(x), train=True)
    _peak_close(got.detach().numpy(), want)
    stats = convert.to_jax_unet(port.state_dict())["batch_stats"]
    flat_w = jax.tree_util.tree_leaves_with_path(mutated["batch_stats"])
    assert len(flat_w) == 36
    for path, leaf in flat_w:
        node = stats
        for key in path:
            node = node[key.key]
        _peak_close(node, leaf, 1e-5)
        start = rest_variables["batch_stats"]
        for key in path:
            start = start[key.key]
        assert not np.array_equal(node, start)


def _unet2_variables(seed):
    """UNet2 variables in the JAX layout (in and out channels 1), numpy."""
    rng = np.random.default_rng(seed)
    blocks = {"enc1": (1, 16, 7), "enc2": (16, 32, 5), "enc3": (32, 64, 5),
              "enc4": (64, 128, 3), "enc5": (128, 128, 3),
              "enc6": (128, 128, 3), "dec6": (256, 128, 3),
              "dec5": (256, 128, 3), "dec4": (192, 64, 3),
              "dec3": (96, 32, 3), "dec2": (48, 16, 3), "dec1": (17, 1, 3)}
    params, stats = {}, {}
    for name, (n_in, n_out, k) in blocks.items():
        bound = (k * k * n_in) ** -0.5
        params[name] = {
            "conv": {"kernel": rng.uniform(-bound, bound, (k, k, n_in, n_out)
                                           ).astype(np.float32),
                     "bias": rng.uniform(-bound, bound, n_out
                                         ).astype(np.float32)},
            "bn": {"scale": rng.uniform(0.5, 1.5, n_out).astype(np.float32),
                   "bias": rng.normal(0, 0.1, n_out).astype(np.float32)}}
        stats[name] = {"bn": {
            "mean": rng.normal(0, 0.1, n_out).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, n_out).astype(np.float32)}}
    return {"params": params, "batch_stats": stats}


def test_unet2_and_wrappers_match_jax(rest_variables):
    """UNet2 at 64 x 128 (six stride-2 levels), RestorationWrapper over a
    UNet (InpaintingRestorationModel) and the PC wrapper, eval."""
    x2 = _rand((B, 1, 64, 128), 14)
    j2 = jax_unet.UNet2(1, 1)
    v2 = _unet2_variables(seed=24)
    want2 = jax.jit(lambda v, x: j2.apply(v, x, train=False))(v2, x2)
    p2 = unet.UNet2(1, 1)
    p2.load_state_dict(convert.convert_unet2(v2))
    with torch.no_grad():
        _peak_close(p2(torch.from_numpy(x2), train=False).numpy(), want2)

    x, mask = _rand((B, 1, F_, T_), 15), _mask4()
    jr = JaxRestoration(JaxUNetCfg(1, 1, 0.2))
    rv = {"params": {"net": rest_variables["params"]},
          "batch_stats": {"net": rest_variables["batch_stats"]}}
    want = jax.jit(lambda v, x, m: jr.apply(v, x, m, train=False))(
        rv, x, mask)
    pr = InpaintingRestorationModel(UNetModelConfig(1, 1, 0.2))
    pr.load_state_dict(convert.convert_inpainting_restoration(rv))
    with torch.no_grad():
        got = pr(torch.from_numpy(x), torch.from_numpy(mask))
    _peak_close(got.numpy(), want)
    assert np.array_equal(got.numpy()[mask == 1], x[mask == 1])

    head = unet_variables(2, 3, seed=16)
    jp = JaxPCWrapper(JaxPCConfig(in_channels=2, out_channels=3, n_dirs=3))
    hv = {"params": {"net": head["params"]},
          "batch_stats": {"net": head["batch_stats"]}}
    x_pc = _rand((B, 2, F_, T_), 17)
    want = jax.jit(lambda v, x, m: jp.apply(v, x, m, train=False))(
        hv, x_pc, mask)
    pp = AudioInpaintingPCWrapper(AudioInpaintingPCWrapperConfig(
        in_channels=2, out_channels=3, n_dirs=3))
    pp.net.load_state_dict(convert.convert_unet(head))
    with torch.no_grad():
        got = pp(torch.from_numpy(x_pc), torch.from_numpy(mask))
    _peak_close(got.numpy(), want)
    flat = got.reshape(B, 3, -1).double()
    gram = flat @ flat.transpose(1, 2)
    off = gram - torch.diag_embed(torch.diagonal(gram, dim1=1, dim2=2))
    assert off.abs().max() < 1e-4 * gram.abs().max()
    assert np.all(got.numpy()[:, :, mask[0, 0] == 1] == 0)


def test_convert_round_trip(rest_variables):
    """to_jax_unet(state_dict of convert_unet(v)) gives v back exactly."""
    back = convert.to_jax_unet(convert.convert_unet(rest_variables))
    for (pw, w), (pg, g) in zip(
            jax.tree_util.tree_leaves_with_path(rest_variables),
            jax.tree_util.tree_leaves_with_path(back)):
        assert pw == pg and np.array_equal(w, g)


# --------------------------------------------------------------- dropout --
def test_dropout_properties(rest_variables):
    """Held by its properties (flax's mask bits cannot be matched): eval is
    deterministic; mc_dropout changes the output and leaves the running
    statistics alone; one generator seed gives the same bits; the kept
    share is within 3 sigma of 1 - p; kept values are scaled by 1/(1-p)."""
    net = _port_unet(rest_variables, 1, 1, 0.5)
    x = torch.from_numpy(_rand((1, 1, F_, T_), 18))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        a, b = net(x, train=False), net(x, train=False)
        c = net(x, train=False, mc_dropout=True,
                generator=torch.Generator().manual_seed(1))
        d = net(x, train=False, mc_dropout=True,
                generator=torch.Generator().manual_seed(2))
        e = net(x, train=False, mc_dropout=True,
                generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.equal(c, e)
    assert (c - d).abs().max() > 1e-6 and (c - a).abs().max() > 1e-6
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
    y = torch.ones(64, 256, 64)
    for p in (0.2, 0.5):
        out = unet.dropout(y, p, torch.Generator().manual_seed(3))
        kept = (out != 0).double().mean().item()
        sigma = np.sqrt(p * (1 - p) / y.numel())
        assert abs(kept - (1 - p)) < 3 * sigma
        assert torch.all((out == 0) | (out == y / (1 - p)))


def test_mc_chunked_equals_unchunked(rest_variables):
    """Five passes at chunk 0 (one forward), 2 (the largest divisor: 1) and
    5 (each alone) bit for bit, pass i from its own generator."""
    from generative_audio_torch.models import InpaintingNPPCModel
    model = InpaintingNPPCModel()
    model.pretrained_restoration_model.load_state_dict(
        convert.convert_inpainting_restoration(
            {"params": {"net": rest_variables["params"]},
             "batch_stats": {"net": rest_variables["batch_stats"]}}))
    x, mask = torch.from_numpy(_rand((B, 1, F_, T_), 19)), \
        torch.from_numpy(_mask4())
    outs = [mc_dropout.mc_dropout_inference(
        model.mc_restoration, x, mask, mc_dropout.mc_generators(4, 5, "cpu"),
        chunk_size=c) for c in (0, 2, 5)]
    assert outs[0].shape == (5, B, 1, F_, T_)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert (outs[0][0] - outs[0][1]).abs().max() > 1e-6
    assert mc_dropout._chunk(50, 5) == 5 and mc_dropout._chunk(50, 7) == 5


# ------------------------------------------------------------------- PCA --
def test_compute_pca_batch_matches_jax_up_to_sign():
    """Distinct samples (a degenerate Gram matrix has no defined
    components): singular values, importance and mean within 1e-5
    relative, components and their scaled copies within 1e-4 of their peak
    after one sign a component."""
    samples = _rand((8, 3, 200), 20)
    got = [t.numpy() for t in mc_dropout.compute_pca_batch(
        torch.from_numpy(samples), 4)]
    want = [np.asarray(t) for t in jax_mc.compute_pca_batch(
        jnp.asarray(samples), 4)]
    for i in (2, 3, 4):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, atol=1e-6)
    sign = np.sign(np.sum(got[0] * want[0], axis=2, keepdims=True))
    _peak_close(got[0] * sign, want[0])
    _peak_close(got[1] * sign, want[1])


def test_calculate_unet_baseline_matches_jax():
    """An injected sampler on both sides: pass i returns numpy sample i (JAX
    finds i from its key, the port from its generator's seed)."""
    k = 6
    samples = _rand((k, B, 1, F_, T_), 21)
    mask = _mask4()
    keys = jax.random.split(jax.random.PRNGKey(3), k)

    def jax_apply(variables, x, m, rngs):
        i = jnp.argmax(jnp.all(jax.random.key_data(keys)
                               == jax.random.key_data(rngs["dropout"]),
                               axis=-1)
                       if jnp.issubdtype(keys.dtype, jax.dtypes.prng_key)
                       else jnp.all(keys == rngs["dropout"], axis=-1))
        return jnp.asarray(samples)[i]

    want = jax_mc.calculate_unet_baseline(
        jax_apply, None, jnp.zeros((B, 1, F_, T_)), jnp.asarray(mask),
        jax.random.PRNGKey(3), n_mc_samples=k, n_components=3)

    def port_apply(x, m, generators):
        return torch.cat([torch.from_numpy(samples[g.initial_seed()])
                          for g in generators])

    got = mc_dropout.calculate_unet_baseline(
        port_apply, torch.zeros(B, 1, F_, T_), torch.from_numpy(mask),
        mc_dropout.mc_generators(0, k, "cpu"), n_components=3,
        mc_chunk_size=2)
    for key in ("mean_prediction", "importance_weights", "singular_vals"):
        _peak_close(got[key].numpy(), want[key], 1e-5)
    sign = np.sign(np.sum(got["principal_components"].numpy()
                          * np.asarray(want["principal_components"]),
                          axis=(2, 3), keepdims=True))
    for key in ("principal_components", "scaled_principal_components"):
        _peak_close(got[key].numpy() * sign, want[key])
    # the objective squares its projections: no sign fix needed
    w = _rand((B, 3, F_, T_), 22)
    _, o_got, _ = losses.nppc_objective_mc_aligned(
        torch.from_numpy(w), got["scaled_principal_components"],
        got["singular_vals"], 700, grace=500)
    _, o_want, _ = jax_losses.nppc_objective_mc_aligned(
        jnp.asarray(w), want["scaled_principal_components"],
        want["singular_vals"], jnp.float32(700), grace=500)
    np.testing.assert_allclose(o_got.item(), float(o_want), rtol=1e-5)


# ------------------------------------------------------------------ PNGs --
def _png_size(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    w, h = struct.unpack(">II", data[16:24])
    raw = zlib.decompress(data[33 + 8:33 + 8 + struct.unpack(
        ">I", data[33:37])[0]])
    assert len(raw) == h * (3 * w + 1)
    return w, h


def test_plot_pngs(tmp_path):
    """Each figure of utils/plot: a valid 8-bit RGB PNG of the stated
    size."""
    spec = np.abs(_rand((20, 30), 23)) + 1e-3
    assert _png_size(plot.plot_spectrogram(spec, tmp_path / "s.png")) == \
        (20, 30)
    assert _png_size(plot.plot_alignment(spec, tmp_path / "a.png")) == (30, 20)
    wave = np.sin(np.arange(4000) / 20.0)
    w, h = _png_size(plot.plot_waveform([wave, -wave], tmp_path / "w.png"))
    assert (w, h) == (1000 + 2 * plot.GAP, 2 * 120 + 3 * plot.GAP)
    fig = plot.spectrogram_figure([spec, spec * 2])
    assert fig.shape == (2 * 20 + 3 * plot.GAP, 30 + 2 * plot.GAP, 3)
    lines = plot.line_plot([np.array([1.0, np.nan, 3.0, 2.0])], 50, 20)
    assert lines.shape == (20, 50, 3) and (lines != 255).any()
    bars = plot.bar_chart([[1.0, 2.0], [0.5, np.nan]])
    assert bars.shape[0] == 240 and (bars != 255).any()
