"""The port's image restoration and image NPPC models against the JAX
package on the CPU: the four distortions and make_distortion, the padding,
ImageRestorationModel.restore and ImageNPPCModel.get_dirs on the same
x_distorted for denoising_1, inpainting_1, colorization_1 and
super_resolution_1, with the pre-net none and res_cnn (the cases of
tests/test_image_nppc.py:134-186 and :358-388).

The nets are build_restoration_net / build_pc_net's fixed widths (UNet 32 ->
128, bottleneck 256; ResCNN 64 x 16 blocks) over synthetic digits (1 x 28 x
28) or an in-memory 3 x 16 x 16 data module, batch 2, float32; params made
with numpy in the JAX layout (convert.random_image_net_params). Tolerances:
restored images and directions within 1e-5 of the JAX output's peak; the
deterministic distortions exact, or within 1e-6 where the average pool sums
in another order; directions orthogonal within 1e-4 (cosine).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.data import image_data as jax_data
from generative_audio_tpu.models import image_nppc as jax_nppc
from generative_audio_tpu.models import image_restoration as jax_rest
from generative_audio_torch.data import image_data
from generative_audio_torch.models import image_nppc, image_restoration
from generative_audio_torch.utils import convert

torch.set_num_threads(2)


def _rand(shape, seed, low=0.0, high=1.0):
    return np.random.default_rng(seed).uniform(low, high, shape).astype(
        np.float32)


def _peak_close(got, want, share=1e-5):
    want = np.asarray(want)
    assert np.shape(got) == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=share * np.abs(want).max())


# ------------------------------------------------------------ distortions --
def test_denoising_clips_and_draws_from_the_generator():
    d = image_restoration.Denoising(noise_std=1.0, clip_noise=True)
    x = torch.full((2, 1, 8, 8), 0.5)
    out = d.distort(x, torch.Generator().manual_seed(3))
    again = d.distort(x, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    assert out.min() >= 0 and out.max() <= 1 and not torch.allclose(out, x)
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    jd = jax_rest.Denoising(noise_std=1.0, clip_noise=True)
    assert np.array_equal(out.numpy(), np.clip(
        np.asarray(x) + noise.numpy() * jd.noise_std, 0, 1))
    unclipped = image_restoration.Denoising(0.5).distort(
        x, torch.Generator().manual_seed(3))
    np.testing.assert_allclose(unclipped.numpy(), 0.5 + 0.5 * noise.numpy())


@pytest.mark.parametrize("kind,shape", [
    ("denoising_1", (1, 28, 28)), ("inpainting_1", (1, 28, 28)),
    ("inpainting_2", (3, 256, 256)), ("colorization_1", (3, 16, 16)),
    ("super_resolution_1", (3, 16, 16))])
def test_make_distortion_matches_jax(kind, shape):
    d = image_restoration.make_distortion(kind, shape, fill=0.25)
    jd = jax_rest.make_distortion(kind, shape, fill=0.25)
    assert type(d).__name__ == type(jd).__name__
    if kind.startswith("inpainting"):
        assert np.array_equal(d.mask.numpy(), np.asarray(jd.mask))
        assert d.fill == jd.fill
    x = _rand((2,) + shape, seed=1)
    pairs = [(d.naive_restore, jd.naive_restore), (d.project, jd.project)]
    if kind != "denoising_1":
        pairs.append((d.distort, jd.distort))
    for fn, jfn in pairs:
        got = fn(torch.from_numpy(x)).numpy()
        want = np.asarray(jfn(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_inpainting_mask_and_project():
    mask = image_restoration.gen_mask((1, 8, 8), 0, 3, 0, 7)
    assert np.array_equal(mask.numpy(), np.asarray(
        jax_rest.gen_mask((1, 8, 8), 0, 3, 0, 7)))
    d = image_restoration.Inpainting(mask, fill=0.25)
    out = d.distort(torch.ones(2, 1, 8, 8))
    assert torch.all(out[:, :, :4] == 0.25) and torch.all(out[:, :, 4:] == 1)
    assert torch.all(d.project(torch.ones(2, 1, 8, 8))[:, :, 4:] == 0)


def test_colorization_and_super_resolution():
    x = torch.from_numpy(_rand((2, 3, 8, 8), seed=2))
    c = image_restoration.Colorization()
    gray = c.distort(x)
    assert gray.shape == (2, 8, 8)
    assert c.naive_restore(gray[:, None]).shape == (2, 3, 8, 8)
    assert c.naive_restore(gray).shape == (2, 3, 8, 8)
    np.testing.assert_allclose(c.project(x).mean(1).numpy(), 0, atol=1e-6)
    s = image_restoration.SuperResolution(factor=2)
    lr = s.distort(x)
    assert lr.shape == (2, 3, 4, 4)
    assert s.naive_restore(lr).shape == x.shape
    np.testing.assert_allclose(s._avg_pool(s.project(x)).numpy(), 0,
                               atol=1e-6)
    noisy = image_restoration.SuperResolution(2, noise_std=0.1)
    assert torch.equal(noisy.distort(x), lr)        # no generator: no noise
    assert not torch.equal(noisy.distort(x, torch.Generator()), lr)
    assert torch.equal(noisy.project(x), x)         # noise: project is x


@pytest.mark.parametrize("shape,base", [((1, 1, 28, 28), 8),
                                        ((2, 3, 30, 17), 4),
                                        ((1, 1, 16, 16), 8),
                                        ((1, 2, 5, 7), None)])
def test_pad_to_multiple_matches_jax(shape, base):
    x = _rand(shape, seed=3)
    padded, pads = image_restoration.pad_to_multiple(torch.from_numpy(x),
                                                     base)
    jpadded, jpads = jax_rest.pad_to_multiple(jnp.asarray(x), base)
    assert np.array_equal(padded.numpy(), np.asarray(jpadded))
    assert (pads is None) == (jpads is None)
    back = image_restoration.unpad_from_multiple(padded, pads)
    assert torch.equal(back, torch.from_numpy(x))


# ----------------------------------------------------------------- models --
class _Array3ChModule:
    """An in-memory 3-channel data module (tests/test_image_nppc.py:347)."""
    shape = (3, 16, 16)
    mean = 0.5
    std = 0.5

    def __init__(self, n=8):
        arr = _rand((n, 3, 16, 16), seed=0)
        self.train_set = self.valid_set = self.test_set = list(arr)


def _data_module(distortion):
    if distortion in ("colorization_1", "super_resolution_1"):
        return _Array3ChModule(), _Array3ChModule()
    return (image_data.MNISTDataModule(n_valid=8, n_synthetic=32),
            jax_data.MNISTDataModule(n_valid=8, n_synthetic=32))


def _models(distortion, pre_net="none", n_dirs=3, seed=10):
    """(port restoration model, JAX one, JAX restoration variables, port
    NPPC model, JAX one, JAX NPPC variables) with the same numpy-made
    params."""
    dm, jdm = _data_module(distortion)
    cfg = image_restoration.ImageRestorationConfig(
        distortion_type=distortion, net_type="unet")
    jcfg = jax_rest.ImageRestorationConfig(distortion_type=distortion,
                                           net_type="unet")
    rest = image_restoration.ImageRestorationModel(cfg, data_module=dm)
    jrest = jax_rest.ImageRestorationModel(jcfg, data_module=jdm)
    rvars = convert.random_image_net_params(rest.base_net, seed)
    rest.base_net.load_state_dict(convert.convert_image_net(
        rvars, rest.base_net))
    ncfg = image_nppc.ImageNPPCConfig(n_dirs=n_dirs, pre_net_type=pre_net)
    nppc = image_nppc.ImageNPPCModel(ncfg, rest)
    jnppc = jax_nppc.ImageNPPCModel(jax_nppc.ImageNPPCConfig(
        n_dirs=n_dirs, pre_net_type=pre_net), jrest)
    wrapper = nppc.wrapper
    nvars = {"net": convert.random_image_net_params(wrapper.net, seed + 1)}
    wrapper.net.load_state_dict(convert.convert_image_net(nvars["net"],
                                                          wrapper.net))
    if wrapper.pre_net is not None:
        nvars["pre_net"] = convert.random_image_net_params(wrapper.pre_net,
                                                           seed + 2)
        wrapper.pre_net.load_state_dict(convert.convert_image_net(
            nvars["pre_net"], wrapper.pre_net))
    return rest, jrest, rvars, nppc, jnppc, nvars


CASES = [("denoising_1", "none"), ("inpainting_1", "none"),
         ("colorization_1", "none"), ("super_resolution_1", "none"),
         ("super_resolution_1", "res_cnn")]


def _unit_cos_off(w):
    """The largest |cos| between two directions of one item."""
    flat = w.reshape(w.shape[0], w.shape[1], -1).astype(np.float64)
    unit = flat / np.linalg.norm(flat, axis=-1, keepdims=True)
    gram = np.abs(np.einsum("bki,bli->bkl", unit, unit))
    return max(gram[b][~np.eye(w.shape[1], dtype=bool)].max()
               for b in range(w.shape[0]))


@pytest.mark.parametrize("distortion,pre_net", CASES)
def test_restore_and_dirs_match_jax(distortion, pre_net):
    rest, jrest, rvars, nppc, jnppc, nvars = _models(distortion, pre_net)
    assert rest.x_distorted_shape == jrest.x_distorted_shape
    assert rest.upscale_factor == jrest.upscale_factor
    x = torch.from_numpy(np.stack([np.asarray(rest.data_module.valid_set[i])
                                   for i in range(2)]))
    x_d = rest.distort(x, torch.Generator().manual_seed(1))
    if distortion != "denoising_1":        # deterministic: the same image
        want_d = np.asarray(jrest.distort(jnp.asarray(x.numpy()), None))
        np.testing.assert_allclose(x_d.numpy(), want_d, rtol=0, atol=1e-6)
    with torch.no_grad():
        x_r = rest.restore(x_d)
        w = nppc.get_dirs(x_d, x_r).numpy()
    want_r = np.asarray(jax.jit(jrest.restore)(rvars, jnp.asarray(x_d)))
    _peak_close(x_r.numpy(), want_r)
    want_w = np.asarray(jax.jit(jnppc.get_dirs)(
        nvars, jnp.asarray(x_d), jnp.asarray(x_r.numpy())))
    assert w.shape == (2, 3) + tuple(rest.x_shape)
    _peak_close(w, want_w)
    assert _unit_cos_off(w) < 1e-4
    if distortion == "inpainting_1":     # the known region is x_distorted's
        mask = rest.distortion.mask
        assert torch.allclose(x_r * (1 - mask), x_d * (1 - mask), atol=1e-6)


def test_unknown_types_raise():
    with pytest.raises(ValueError, match="distortion_type"):
        image_restoration.make_distortion("blur", (1, 8, 8))
    with pytest.raises(ValueError, match="net_type"):
        image_restoration.build_restoration_net("vit", 1, 1)
    with pytest.raises(ValueError, match="net_type"):
        image_nppc.build_pc_net("res_cnn", 1, 1)
    rest = image_restoration.ImageRestorationModel(
        image_restoration.ImageRestorationConfig(),
        data_module=image_data.MNISTDataModule(n_valid=4, n_synthetic=8))
    with pytest.raises(ValueError, match="pre_net_type"):
        image_nppc.ImageNPPCModel(image_nppc.ImageNPPCConfig(
            pre_net_type="edsr"), rest)
