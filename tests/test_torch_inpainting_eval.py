"""The port's inpainting validators and their helpers against the JAX
package on the CPU: RestorationValidator's per-sample and loader-level
numbers, NPPCValidator's metrics JSON (MC passes injected on both sides:
flax's dropout bits cannot be matched) and audio variations,
compute_metrics, organize_jsons, yin_pitch_track, and the figures' PNG
headers and sizes.

UNets at the shipped widths over a 32 x 64 spectrogram (a 62-point STFT,
hop 32), batch 1, float32, weights made with numpy. Tolerances: the gap's
MSE, RMSE and residual errors within 1e-4 relative (two UNet forwards in
float32, within 1e-4 of their peak); importance weights within 1e-4 of
their peak and principal angles within 0.05 degrees (a PCA up to sign, and
the angles' arccos near 0 degrees magnifies rounding); the numpy helpers
(compute_metrics, organize_jsons' rows, YIN) equal; the variation wavs
within 2 int16 steps (two iSTFTs of the same spectra) and their mean f0
within 1e-3 relative.
"""
import json
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from generative_audio_tpu.eval import nppc_validator as jax_val
from generative_audio_tpu.eval import restoration_validator as jax_rv
from generative_audio_tpu.eval.pitch import yin_pitch_track as jax_yin
from generative_audio_tpu.models import nppc_model as jax_nppc
from generative_audio_tpu.models.pc_wrapper import (
    AudioInpaintingPCWrapperConfig as JaxPCConfig)
from generative_audio_tpu.ops.preprocess import preprocess_data as jax_pre
from generative_audio_torch.eval import (
    NPPCValidator, NPPCValidatorConfig, RestorationValidator,
    RestorationValidatorConfig, compute_metrics, organize_jsons,
    yin_pitch_track)
from generative_audio_torch.models import (
    AudioInpaintingPCWrapperConfig, InpaintingNPPCConfig, InpaintingNPPCModel,
    UNetModelConfig)
from generative_audio_torch.ops.preprocess import preprocess_data
from generative_audio_torch.utils import convert
from generative_audio_torch.utils.plot import GAP

torch.set_num_threads(2)
F_, T_, N_MC = 32, 64, 6
STFT = dict(nfft=62, hop_length=32, win_length=62)


def _png_size(path):
    data = Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    return struct.unpack(">II", data[16:24])


def _sample(seed, batch=1):
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((batch, 2, F_, T_)).astype(np.float32)
    mask = np.ones((batch, T_), np.float32)
    mask[:, 24:32] = 0
    return clean * mask[:, None, None, :], mask, clean


@pytest.fixture(scope="module")
def models():
    """The JAX and the port's InpaintingNPPCModel (3 directions) on the same
    numpy-made variables; the restoration UNet's dropout 0.2."""
    jcfg = jax_nppc.InpaintingNPPCConfig(
        restoration=jax_nppc.UNetModelConfig(1, 1, 0.2),
        pc_wrapper=JaxPCConfig(2, 3, 0.0, 3))
    pcfg = InpaintingNPPCConfig(
        restoration=UNetModelConfig(1, 1, 0.2),
        pc_wrapper=AudioInpaintingPCWrapperConfig(2, 3, 0.0, 3))
    variables = convert.random_inpainting_nppc_params(pcfg, seed=50)
    port = InpaintingNPPCModel(pcfg)
    port.load_state_dict(convert.convert_inpainting_nppc(variables))
    return jax_nppc.InpaintingNPPCModel(jcfg), port, variables


def _restoration_variables(variables):
    return {k: v["pretrained_restoration_model"] for k, v in variables.items()}


def test_restoration_validator_matches_jax(models, tmp_path):
    jmodel, port, variables = models
    jrest = jax_nppc.InpaintingRestorationModel(
        jax_nppc.UNetModelConfig(1, 1, 0.2))
    batches = [_sample(s, batch=2) for s in (1, 2)]
    want = jax_rv.RestorationValidator(
        jax.jit(lambda v, x, m: jrest.apply(v, x, m, train=False)),
        _restoration_variables(variables),
        jax_rv.RestorationValidatorConfig(save_dir=str(tmp_path / "jax"),
                                          max_figures=0)
    ).validate_dataloader(batches, max_samples=3)
    got = RestorationValidator(
        lambda x, m: port.pretrained_restoration_model(x, m),
        RestorationValidatorConfig(save_dir=str(tmp_path / "port"),
                                   max_figures=2), device="cpu"
    ).validate_dataloader(batches, max_samples=3)
    assert got["num_samples"] == want["num_samples"] == 3
    np.testing.assert_allclose(got["per_sample_mse"], want["per_sample_mse"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["mean_gap_mse"], want["mean_gap_mse"],
                               rtol=1e-4)
    on_disk = json.loads((tmp_path / "port" / "restoration_validation.json")
                         .read_text())
    assert on_disk == got
    figures = sorted((tmp_path / "port").glob("spectrogram_comparison_*.png"))
    assert [f.name for f in figures] == ["spectrogram_comparison_0.png",
                                         "spectrogram_comparison_1.png"]
    assert _png_size(figures[0]) == (2 * T_ + 3 * GAP, 2 * F_ + 3 * GAP)


@pytest.fixture(scope="module")
def mc_samples():
    return np.random.default_rng(51).standard_normal(
        (N_MC, 1, 1, F_, T_)).astype(np.float32)


def _validators(models, mc_samples, tmp_path, sample_idx):
    """The JAX and the port's NPPCValidator; pass i of the MC baseline
    returns mc_samples[i] on both sides (JAX finds i from its key, the
    port from its generator's seed)."""
    jmodel, port, variables = models
    keys = jax.random.split(jax.random.PRNGKey(sample_idx), N_MC)
    samples = jnp.asarray(mc_samples)

    def jax_restoration(v, x, m, rngs=None):
        if rngs is None:
            return jmodel.apply(v, x, m,
                                method=jmodel.get_pred_spec_mag_norm)
        data = jax.random.key_data
        match = (jnp.all(data(keys) == data(rngs["dropout"]), axis=-1)
                 if jnp.issubdtype(keys.dtype, jax.dtypes.prng_key)
                 else jnp.all(keys == rngs["dropout"], axis=-1))
        return samples[jnp.argmax(match)]

    def port_restoration(x, m, generator=None):
        if generator is None:
            return port.get_pred_spec_mag_norm(x, m)
        return torch.cat([torch.from_numpy(
            mc_samples[g.initial_seed() - sample_idx * N_MC])
            for g in generator])

    cfg = dict(n_mc_samples=N_MC, n_components=3, **STFT)
    want = jax_val.NPPCValidator(
        lambda v, x, m: jmodel.apply(v, x, m), variables, jax_restoration,
        variables, jax_val.NPPCValidatorConfig(
            save_dir=str(tmp_path / "jax"), **cfg))
    got = NPPCValidator(port, port_restoration, NPPCValidatorConfig(
        save_dir=str(tmp_path / "port"), **cfg), device="cpu",
        transcribe_fn=lambda wav, sr: f"{len(wav)} samples")
    return want, got


def _inputs(seed):
    masked, mask, clean = _sample(seed)
    j = jax_pre(jnp.asarray(clean), jnp.asarray(masked), jnp.asarray(mask),
                return_stats=True)
    p = preprocess_data(*(torch.from_numpy(x) for x in (clean, masked, mask)),
                        return_stats=True)
    phase = np.arctan2(clean[0, 1], clean[0, 0])
    return j, p, phase


def test_nppc_validator_matches_jax(models, mc_samples, tmp_path):
    want_v, got_v = _validators(models, mc_samples, tmp_path, sample_idx=3)
    (jc, jm, jx, jmean, jstd), (pc, pm, px, pmean, pstd), phase = _inputs(7)
    full = (np.random.default_rng(8).standard_normal(6000) * 0.05
            ).astype(np.float32)
    kw = dict(sample_idx=3, clean_phase=phase, full_audio=full,
              gap_bounds=(700, 1100))
    want = want_v.validate_sample(jx, jm, jc, stats=(jmean, jstd),
                                  make_plots=False, **kw)
    got = got_v.validate_sample(px, pm, pc, stats=(pmean, pstd), **kw)
    for method in ("nppc", "mc_dropout"):
        for key in ("rmse", "residual_error"):
            np.testing.assert_allclose(got[method][key], want[method][key],
                                       rtol=1e-4)
    np.testing.assert_allclose(got["importance_weights"],
                               want["importance_weights"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["principal_angles"],
                               want["principal_angles"], rtol=0, atol=0.05)
    out = tmp_path / "port" / "sample_3"
    on_disk = json.loads((out / "metrics_sample_3.json").read_text())
    assert on_disk["nppc"] == got["nppc"]
    assert len(got["audio_variations"]) == 3 * 5
    for g, w in zip(got["audio_variations"], want["audio_variations"]):
        assert (g["pc"], g["alpha"], g["file"]) == (w["pc"], w["alpha"],
                                                    w["file"])
        assert g["transcription"] == "6000 samples"
        if w["mean_f0"] is None:
            assert g["mean_f0"] is None
        else:
            np.testing.assert_allclose(g["mean_f0"], w["mean_f0"], rtol=1e-3)
        _, a = wavfile.read(out / g["file"])
        _, b = wavfile.read(tmp_path / "jax" / "sample_3" / w["file"])
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 2
    # the zoomed grid: gap 24-32, one gap width each side -> 24 columns;
    # 1 + 3 rows, 13 alphas + 1 columns
    assert _png_size(out / "pc_spectrograms.png") == (
        14 * 24 + 15 * GAP, 4 * F_ + 5 * GAP)
    assert len(list((out / "spectrograms").glob("*.png"))) == 4 + 3 * 14
    rows = organize_jsons(tmp_path / "port", tmp_path / "bars.png")
    want_rows = jax_val.organize_jsons(tmp_path / "jax").to_dict("records")
    assert [r["sample"] for r in rows] == [r["sample"] for r in want_rows]
    assert _png_size(tmp_path / "bars.png")[1] == 240


def test_numpy_helpers_equal_jax(tmp_path):
    """compute_metrics, organize_jsons and the YIN tracker are the JAX
    package's numpy code: equal results."""
    rng = np.random.default_rng(60)
    dirs_a = rng.standard_normal((1, 4, F_, T_))
    dirs_b = rng.standard_normal((1, 4, F_, T_))
    pred, mean, clean = (rng.standard_normal((1, 1, F_, T_))
                         for _ in range(3))
    mask = np.ones((1, 1, F_, T_))
    mask[..., 10:20] = 0
    got = compute_metrics(dirs_a, dirs_b, pred, mean, clean, mask)
    assert got == jax_val.compute_metrics(dirs_a, dirs_b, pred, mean, clean,
                                          mask)
    for i in range(3):
        d = tmp_path / f"sample_{i}"
        d.mkdir()
        (d / f"metrics_sample_{i}.json").write_text(json.dumps(
            compute_metrics(dirs_a * (i + 1), dirs_b, pred, mean, clean,
                            mask)))
    assert organize_jsons(tmp_path) == \
        jax_val.organize_jsons(tmp_path).to_dict("records")
    t = np.arange(8000) / 16000
    voiced = np.sin(2 * np.pi * 180 * t) * (t > 0.2)
    for wav in (voiced, rng.standard_normal(8000) * 0.1):
        for g, w in zip(yin_pitch_track(wav), jax_yin(wav)):
            np.testing.assert_array_equal(g, w)
    f0, flags, _ = yin_pitch_track(voiced)
    assert abs(np.nanmedian(f0[flags]) - 180) < 2


def test_pitch_comparison_png(models, mc_samples, tmp_path):
    _, got_v = _validators(models, mc_samples, tmp_path, sample_idx=0)
    t = np.arange(16000) / 16000
    path = got_v.plot_pitch_comparison(
        {"a": np.sin(2 * np.pi * 150 * t), "b": np.sin(2 * np.pi * 220 * t)},
        tmp_path)
    assert _png_size(path) == (800, 240)
