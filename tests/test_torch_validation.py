"""Validation, best-model selection and the report of the port
(generative_audio_torch.eval.validator, train.enhance.EnhanceTrainer.validate
and .train, utils.report, data.dns_dataset.DNSValidationDataset,
cli.calculate_metrics) against the JAX package on the CPU.

Models: a small FullSubNet+ (257 bins as the STFT gives them, the 8-block TCN
towers at hidden width 16, sub-band LSTM H=32, 2 neighbours) and a small
FullSubNet v1 with the GRU body (full band H=16, sub-band H=32), float32,
weights in the JAX layout made with numpy from a seed
(utils/convert.random_*_params) and carried across by utils/convert.py. The sub-band
output layer is scaled by 0.1 and biased to the compressed mask of 1 on both
sides, so that the enhanced clip is the noisy one plus what the whole model
adds: with a random mask the output is near silence, SI_SDR sits near
-40 dB, and its rounding noise would say nothing of the port.

Tolerances, both sides float32 with sums in another order:
  * enhance_audio: 1e-4 of the output's peak (measured about 1e-5);
  * validate_dataset's means: STOI 1e-4, SI_SDR 1e-3 dB, WB_PESQ and NB_PESQ
    1e-2 (PESQ's alignment and VAD take thresholds, so a waveform that
    moved by rounding may move a frame decision).
Clip lengths (20 800 and 27 201 samples) are not multiples of 16 000: the
Inferencer would pad them to its length bucket and change the metrics, and
the validator must not.
"""
import json
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from generative_audio_tpu import train as JT
from generative_audio_tpu.data.dns_dataset import (
    DNSValidationDataset as JaxDNSValidationDataset)
from generative_audio_tpu.cli import calculate_metrics as jax_calc
from generative_audio_tpu.eval.validator import ModelValidator as JaxValidator
from generative_audio_tpu.models import FullSubNetPlusConfig as JaxPlusConfig
from generative_audio_tpu.models.fullsubnet import (
    FullSubNetConfig as JaxV1Config)
from generative_audio_tpu.train.enhance import _model as jax_model
from generative_audio_tpu.utils import report as jax_report
from generative_audio_torch import train as TT
from generative_audio_torch.cli import calculate_metrics as calc
from generative_audio_torch.data import DNSValidationDataset, write_wav
from generative_audio_torch.eval import Inferencer, InferencerConfig
from generative_audio_torch.eval.validator import ModelValidator
from generative_audio_torch.models import FullSubNetConfig, FullSubNetPlusConfig
from generative_audio_torch.ops.mask import compress_cIRM
from generative_audio_torch.utils import convert
from generative_audio_torch.utils import report
from test_pesq import _speech_like, _with_noise

torch.set_num_threads(2)

LENGTHS = (20800, 27201)
SMALL = dict(num_freqs=257, sb_num_neighbors=2, fb_num_neighbors=0,
             fb_model_hidden_size=16, sb_model_hidden_size=32)
KINDS = ("fullsubnet_plus", "fullsubnet")
MEAN_TOL = {"STOI": 1e-4, "SI_SDR": 1e-3, "WB_PESQ": 1e-2, "NB_PESQ": 1e-2}


def _configs(kind, **train):
    if kind == "fullsubnet":
        model = dict(SMALL, sequence_model="GRU")
        return (JT.EnhanceTrainConfig(model_type=kind,
                                      model_v1=JaxV1Config(**model), **train),
                TT.EnhanceTrainConfig(model_type=kind,
                                      model_v1=FullSubNetConfig(**model),
                                      **train))
    return (JT.EnhanceTrainConfig(model=JaxPlusConfig(**SMALL), **train),
            TT.EnhanceTrainConfig(model=FullSubNetPlusConfig(**SMALL),
                                  **train))


def _params(kind, jcfg):
    """Params in the JAX layout made with numpy from a seed (JAX's own init
    would trace the model first), with the sub-band output layer near the
    identity mask."""
    if kind == "fullsubnet":
        params = convert.random_fullsubnet_params(jcfg.model_v1, seed=1)
    else:
        params = convert.random_fullsubnet_plus_params(jcfg.model, seed=0)
    fc = params["sb_model"]["fc_output_layer"]
    fc["kernel"] = fc["kernel"] * np.float32(0.1)
    one = compress_cIRM(torch.ones(())).item()
    fc["bias"] = np.array([one, 0.0], np.float32)
    return params


def _state_dict(kind, params):
    if kind == "fullsubnet":
        return convert.convert_fullsubnet(params, "GRU")
    return convert.convert_fullsubnet_plus(params)


def _pair(seed, length, snr=10):
    clean = _speech_like(seed, seconds=length / 16000)[:length]
    return (_with_noise(clean, snr, seed=seed + 1).astype(np.float32),
            clean.astype(np.float32))


@pytest.fixture(scope="module")
def clips():
    return [_pair(60 + i, n) for i, n in enumerate(LENGTHS)]


@pytest.fixture(scope="module")
def models():
    """kind -> (JAX config, port config, JAX params, port state dict)."""
    out = {}
    for kind in KINDS:
        jcfg, tcfg = _configs(kind, compute_dtype="float32")
        params = _params(kind, jcfg)
        out[kind] = (jcfg, tcfg, params, _state_dict(kind, params))
    return out


def _port_model(kind, models):
    _, tcfg, _, sd = models[kind]
    state = TT.init_enhance_state(tcfg, seed=0, device="cpu")
    state.model.load_state_dict(sd)
    return state.model


@pytest.fixture(scope="module")
def validators(models):
    """kind -> (JAX ModelValidator, port ModelValidator), default metrics."""
    out = {}
    for kind in KINDS:
        jcfg, _, params, _ = models[kind]
        net = jax_model(jcfg)
        if kind == "fullsubnet":
            apply = lambda v, m, r, i, net=net: net.apply(v, m)  # noqa: E731
        else:
            apply = lambda v, m, r, i, net=net: net.apply(  # noqa: E731
                v, m, r, i)
        out[kind] = (JaxValidator(apply, {"params": params}),
                     ModelValidator(_port_model(kind, models), device="cpu",
                                    model_type=kind))
    return out


@pytest.mark.parametrize("index", range(len(LENGTHS)))
@pytest.mark.parametrize("kind", KINDS)
def test_enhance_audio_matches_jax(kind, index, validators, clips):
    want_v, got_v = validators[kind]
    noisy = clips[index][0]
    want = want_v.enhance_audio(noisy)
    got = got_v.enhance_audio(noisy)
    assert got.shape == noisy.shape and got.dtype == np.float32
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * peak)
    # the Inferencer pads the clip to its 16 000-sample bucket, and the
    # frames past the end change the result beyond the limit above (about
    # 1e-3 of the peak here), so a validator that served through it fails
    mode = ("full_band_crm_mask" if kind == "fullsubnet"
            else "mag_complex_full_band_crm_mask")
    served = Inferencer(got_v.model, InferencerConfig(inference_type=mode),
                        device="cpu").enhance(noisy)
    assert np.abs(served - want).max() > 1e-4 * peak


@pytest.mark.parametrize("kind", KINDS)
def test_validate_dataset_matches_jax(kind, validators, clips, tmp_path):
    want_v, got_v = validators[kind]
    want = want_v.validate_dataset(clips, tmp_path / "jax.json",
                                   log=lambda *_: None)
    lines = []
    got = got_v.validate_dataset(clips, tmp_path / "port" / "v.json",
                                 log=lines.append)
    assert list(got) == list(want) == ["WB_PESQ", "NB_PESQ", "STOI", "SI_SDR"]
    for name, tol in MEAN_TOL.items():
        assert want[name] is not None
        assert abs(got[name] - want[name]) <= tol, (name, got, want)
    written = json.loads((tmp_path / "port" / "v.json").read_text())
    assert written == got
    assert set(written) == set(json.loads((tmp_path / "jax.json").read_text()))
    assert len(lines) == 2 and lines[0].startswith("[1/2] WB_PESQ=")
    assert got_v.validate_dataset(clips, max_items=1,
                                  log=lambda *_: None)["STOI"] == \
        got_v.calculate_metrics(clips[0][1],
                                got_v.enhance_audio(clips[0][0]))["STOI"]


def test_calculate_metrics_records_none_for_unscoreable(validators):
    """PESQ on a silent clip and MOSNET without its wheel give None for that
    metric of that clip, as the JAX validator records them."""
    _, got_v = validators["fullsubnet_plus"]
    v = ModelValidator(got_v.model, device="cpu",
                       metric_names=("WB_PESQ", "MOSNET", "SI_SDR"))
    silent = np.zeros(16000, np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        scores = v.calculate_metrics(silent, silent)
    assert scores["WB_PESQ"] is None and scores["MOSNET"] is None
    assert list(scores) == ["WB_PESQ", "MOSNET", "SI_SDR"]
    with pytest.raises(ValueError, match="unknown model_type"):
        ModelValidator(got_v.model, device="cpu", model_type="unet")


def test_trainer_validate_matches_jax(models, clips):
    """EnhanceTrainer.validate of the port against the JAX trainer's on the
    same weights and clips: STOI, SI_SDR, WB_PESQ and the composite."""
    jcfg, tcfg, params, sd = models["fullsubnet_plus"]
    # the JAX trainer's validate on these weights; its constructor would
    # trace JAX's init first, which validate does not use
    jax_trainer = object.__new__(JT.EnhanceTrainer)
    jax_trainer.config, jax_trainer.state = jcfg, SimpleNamespace(
        params=params)
    want = jax_trainer.validate(clips[:1])
    got = TT.EnhanceTrainer(tcfg, pretrained_state_dict=sd,
                            device="cpu").validate(clips[:1])
    assert set(got) == set(want) == {"STOI", "SI_SDR", "WB_PESQ", "composite"}
    for name, tol in MEAN_TOL.items():
        if name in want:
            assert abs(got[name] - want[name]) <= tol, (name, got, want)
    # the composite is (STOI + (PESQ + 0.5) / 5) / 2 of those means
    assert abs(got["composite"] - want["composite"]) <= \
        (MEAN_TOL["STOI"] + MEAN_TOL["WB_PESQ"] / 5) / 2


def test_v1_trainer_validates_magnitude_only(models, validators, clips):
    """model_type="fullsubnet" validates through model(mag) alone, the same
    numbers as the v1 ModelValidator (held against JAX above)."""
    _, tcfg, _, sd = models["fullsubnet"]
    trainer = TT.EnhanceTrainer(tcfg, pretrained_state_dict=sd, device="cpu")
    got = trainer.validate(clips)
    _, v1 = validators["fullsubnet"]
    want = ModelValidator(v1.model, device="cpu", model_type="fullsubnet",
                          metric_names=("STOI", "SI_SDR", "WB_PESQ")
                          ).validate_dataset(clips, log=lambda *_: None)
    assert {k: got[k] for k in want} == want


def test_validate_falls_back_to_stoi_without_pesq(models):
    _, tcfg, _, sd = models["fullsubnet_plus"]
    trainer = TT.EnhanceTrainer(tcfg, pretrained_state_dict=sd, device="cpu")
    silent = [(np.zeros(16000, np.float32), np.zeros(16000, np.float32))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.warns(UserWarning, match="falls back to STOI"):
            scores = trainer.validate(silent)
    assert scores["WB_PESQ"] is None
    assert scores["composite"] == (scores["STOI"] or 0.0)


# ------------------------------------------------------------------ trap 3
def _batch(seed, length=8000):
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((2, length)) * 0.1).astype(np.float32)
    noisy = clean + (rng.standard_normal((2, length)) * 0.03).astype(
        np.float32)
    return noisy, clean


@pytest.mark.parametrize("training_flag", [True, False])
def test_step_after_validate_equals_step_without(models, clips,
                                                 training_flag):
    """Validation leaves training as it found it: parameters, optimizer
    state, step, the module's training flag and its device; the next
    training step equals one without the validation, bit for bit."""
    _, _, _, sd = models["fullsubnet_plus"]
    _, tcfg = _configs("fullsubnet_plus", compute_dtype="float32")
    loader = [_batch(70)]
    a, b = (TT.EnhanceTrainer(tcfg, pretrained_state_dict=sd, device="cpu")
            for _ in range(2))
    for t in (a, b):
        t.train_epoch(loader)
    a.state.model.train(training_flag)
    before = {k: v.clone() for k, v in a.state.model.state_dict().items()}
    opt_before = json.dumps(a.state.optimizer.state_dict()["param_groups"])
    a.validate(clips[:1])
    assert a.state.model.training is training_flag
    assert a.state.step == 1
    assert all(p.device.type == "cpu" for p in a.state.model.parameters())
    for k, v in a.state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert json.dumps(a.state.optimizer.state_dict()["param_groups"]) == \
        opt_before
    loss_a, loss_b = a.train_epoch(loader), b.train_epoch(loader)
    assert loss_a == loss_b
    for (k, x), y in zip(a.state.model.state_dict().items(),
                         b.state.model.state_dict().values()):
        assert torch.equal(x, y), k
    sa, sb = (t.state.optimizer.state_dict()["state"] for t in (a, b))
    for idx in sa:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[idx][name], sb[idx][name])


# --------------------------------------------------------------- selection
TINY = dict(num_freqs=32, sb_num_neighbors=2, fb_model_hidden_size=16,
            sb_model_hidden_size=8, num_groups_in_drop_band=2)


def _tiny_trainer(path, **kw):
    cfg = TT.EnhanceTrainConfig(model=FullSubNetPlusConfig(**TINY), n_fft=62,
                                hop_length=32, win_length=62,
                                compute_dtype="float32")
    return TT.EnhanceTrainer(cfg, checkpoint_dir=path, device="cpu", **kw)


def _tiny_loader():
    rng = np.random.default_rng(0)
    clean = rng.standard_normal((4, 2048)).astype(np.float32)
    noisy = clean + 0.3 * rng.standard_normal((4, 2048)).astype(np.float32)
    return [(noisy, clean)]


def _scripted(trainer, script, per_epoch):
    """Replace validate by scripted composites: "VAL" reads script["val"],
    anything else script["probe"], one value per epoch."""
    calls = {"n": 0}

    def fake_validate(dataset, max_items=10):
        kind = "val" if dataset == "VAL" else "probe"
        idx = calls["n"] // per_epoch
        calls["n"] += 1
        return {"composite": script[kind][min(idx, len(script[kind]) - 1)]}

    trainer.validate = fake_validate


@pytest.mark.parametrize("probe_weight,step,score", [
    (0.0, 2, 0.60), (0.5, 1, 0.5 * 0.50 + 0.5 * 0.90)])
def test_probe_inclusive_selection(tmp_path, probe_weight, step, score):
    """The counterpart of tests/test_training.py::
    test_enhance_probe_inclusive_selection: with probe_weight w the
    criterion is (1 - w) * val + w * probe, so the epoch that wins in
    distribution but loses the probe is not selected."""
    d = tmp_path / f"w{probe_weight}"
    trainer = _tiny_trainer(d)
    _scripted(trainer, {"val": [0.50, 0.60], "probe": [0.90, 0.20]},
              2 if probe_weight else 1)
    trainer.train(_tiny_loader(), epochs=2, val_dataset="VAL",
                  probe_dataset="PROBE" if probe_weight else None,
                  probe_weight=probe_weight, log=lambda *a: None)
    meta = json.loads((d / "best_score.json").read_text())
    assert meta["step"] == step
    assert meta["score"] == pytest.approx(score)
    assert meta["probe_weight"] == probe_weight


def test_probe_recorded_at_zero_weight(tmp_path):
    """A probe at weight 0 is evaluated and recorded (probe_history, the
    tracker) but never selects (tests/test_training.py::
    test_enhance_probe_recorded_at_zero_weight)."""
    logged = []

    class Tracker:
        def log(self, scalars, step):
            logged.append((step, scalars))

    trainer = _tiny_trainer(tmp_path / "c", tracker=Tracker())
    _scripted(trainer, {"val": [0.50, 0.60], "probe": [0.90, 0.20]}, 2)
    trainer.train(_tiny_loader(), epochs=2, val_dataset="VAL",
                  probe_dataset="PROBE", probe_weight=0.0,
                  log=lambda *a: None)
    assert [p for _, p in trainer.probe_history] == [0.90, 0.20]
    assert trainer.val_history == [(1, 0.50), (2, 0.60)]
    meta = json.loads((tmp_path / "c" / "best_score.json").read_text())
    assert meta["step"] == 2 and meta["probe_weight"] == 0.0
    assert meta["score"] == pytest.approx(0.60)
    assert meta["composite"] == pytest.approx(0.60)
    validation = [s for _, s in logged if "composite" in s]
    assert validation == [{"composite": 0.50, "probe_composite": 0.90},
                          {"composite": 0.60, "probe_composite": 0.20}]
    assert [s for s, _ in logged] == [1, 1, 2, 2]


def test_selection_criterion_reset_on_resume(tmp_path):
    """A resume under another probe_weight warns and resets best-model
    tracking (tests/test_training.py::
    test_enhance_selection_criterion_reset_on_resume)."""
    d = tmp_path / "c"
    trainer = _tiny_trainer(d)
    trainer.validate = lambda ds, max_items=10: {"composite": 0.9}
    trainer.train(_tiny_loader(), epochs=1, val_dataset="VAL",
                  probe_dataset="PROBE", probe_weight=0.5,
                  log=lambda *a: None)
    assert trainer.best_score == pytest.approx(0.9)

    resumed = _tiny_trainer(d)
    assert resumed.restore_latest()
    assert resumed.best_score == pytest.approx(0.9)
    resumed.validate = lambda ds, max_items=10: {"composite": 0.5}
    with pytest.warns(UserWarning, match="incommensurate"):
        resumed.train(_tiny_loader(), epochs=1, val_dataset="VAL",
                      log=lambda *a: None)
    meta = json.loads((d / "best_score.json").read_text())
    assert meta["score"] == pytest.approx(0.5)
    assert meta["probe_weight"] == 0.0


def test_new_best_resaves_latest(tmp_path):
    """After a new best, latest holds the updated best_score, so a resume
    restores it; validation_interval skips the epochs between; an epoch
    that does not improve keeps best/ as it was."""
    d = tmp_path / "c"
    trainer = _tiny_trainer(d)
    _scripted(trainer, {"val": [0.70]}, 1)
    trainer.train(_tiny_loader(), epochs=2, val_dataset="VAL",
                  validation_interval=2, log=lambda *a: None)
    assert trainer.val_history == [(2, 0.70)]
    latest = torch.load(trainer.ckpt.path("latest"), weights_only=True)
    assert latest["step"] == 2 and latest["best_score"] == pytest.approx(0.7)
    meta = trainer.ckpt.best_meta()
    assert meta["score"] == pytest.approx(0.7) and meta["step"] == 2
    best = torch.load(trainer.ckpt.path("best"), weights_only=True)
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(best["params"][k], v), k
    # a step checkpoint holds the score from before its validation
    step2 = torch.load(trainer.ckpt.path("step_00000002"), weights_only=True)
    assert step2["best_score"] == -float("inf")
    resumed = _tiny_trainer(d)
    assert resumed.restore_latest() and resumed.best_score == \
        pytest.approx(0.7)

    _scripted(resumed, {"val": [0.60]}, 1)
    resumed.train(_tiny_loader(), epochs=1, val_dataset="VAL",
                  log=lambda *a: None)
    assert resumed.ckpt.best_meta()["step"] == 2
    latest = torch.load(resumed.ckpt.path("latest"), weights_only=True)
    assert latest["step"] == 3 and latest["best_score"] == pytest.approx(0.7)


def test_train_validates_for_real_and_writes_report(models, clips, tmp_path):
    """The whole loop with real validation on the CPU: two epochs, a probe at
    weight 0.5, best.pt and best_score.json, latest with the same best
    score, report.html with the loss and validation series, the model left
    in training mode."""
    _, _, _, sd = models["fullsubnet_plus"]
    _, tcfg = _configs("fullsubnet_plus", compute_dtype="float32")
    trainer = TT.EnhanceTrainer(tcfg, checkpoint_dir=tmp_path / "c",
                                pretrained_state_dict=sd, device="cpu")
    probe = [_pair(80, 19001, snr=0)]
    trainer.train([_batch(71)], epochs=2, val_dataset=clips,
                  probe_dataset=probe, probe_weight=0.5, log=lambda *a: None)
    assert trainer.state.model.training
    assert len(trainer.val_history) == 2 and len(trainer.probe_history) == 2
    meta = trainer.ckpt.best_meta()
    assert meta["probe_weight"] == 0.5 and np.isfinite(meta["composite"])
    assert meta["score"] == trainer.best_score
    latest = torch.load(trainer.ckpt.path("latest"), weights_only=True)
    assert latest["best_score"] == pytest.approx(trainer.best_score)
    html = (tmp_path / "c" / "report.html").read_text()
    assert html.count("<polyline") == 2
    assert 'data-label="validation"' in html and "best_composite" in html


# ------------------------------------------------------------------ report
def _curves(module, monkeypatch, *args):
    """The (name, series, logy) each add_curve of `module`'s
    write_training_report receives."""
    seen = []

    def add_curve(self, name, series, xlabel="step", ylabel="value",
                  logy=False):
        seen.append((name, {k: np.asarray(v).tolist()
                            for k, v in series.items()}, logy))

    monkeypatch.setattr(module.HTMLReport, "add_curve", add_curve)
    module.write_training_report(*args)
    return seen


@pytest.mark.parametrize("losses,logy", [
    ([0.5, 0.3, 0.2], True), ([0.5, 0.0, -0.1], False), ([], False)])
def test_report_series_and_logy_rule_equal_jax(losses, logy, tmp_path,
                                               monkeypatch):
    """The same sections, (step, value) pairs and log-y rule as the JAX
    report: log-y exactly when every loss is positive."""
    args = ("t", losses, [(2, 0.6), (4, 0.7)], {"best_composite": 0.7})
    want = _curves(jax_report, monkeypatch, tmp_path / "j.html", *args)
    got = _curves(report, monkeypatch, tmp_path / "p.html", *args)
    assert got == want
    assert got[0][2] is logy


def test_report_draws_an_svg_polyline_per_series(tmp_path):
    path = report.write_training_report(
        tmp_path / "r" / "report.html", "run <1>", [0.5, 0.3, 0.2],
        [(2, 0.6), (4, 0.7)], {"best_composite": 0.7, "steps": 4})
    html = path.read_text()
    assert "<title>run &lt;1&gt;</title>" in html
    assert html.count("<svg") == 1 and html.count("<polyline") == 2
    train, val = html.split("<polyline")[1:]
    assert 'data-label="train"' in train and train.split('points="')[1] \
        .split('"')[0].count(",") == 3
    assert 'data-label="validation"' in val and val.split('points="')[1] \
        .split('"')[0].count(",") == 2
    assert "value (log)" in html and "<td>best_composite</td><td>0.7</td>" \
        in html
    flat = report.HTMLReport("x")
    flat.add_curve("c", {"a": [1.0, -2.0, float("nan")], "b": []})
    assert flat._sections[0].count("<polyline") == 2 and "(log)" not in \
        flat._sections[0]


def test_report_tables_and_grid_equal_jax():
    values = {"a": 1.25, "b": 3, "c": "text <x>", "d": float("-inf")}
    want, got = jax_report.HTMLReport("t"), report.HTMLReport("t")
    for rep in (want, got):
        rep.add_scalars("final <metrics>", values)
        rep.add_html("<p>note</p>")
    assert got._sections == want._sections
    imgs = np.random.default_rng(3).random((5, 3, 4, 6)).astype(np.float32)
    for kw in ({}, {"nrow": 2}, {"nrow": 5, "pad": 0, "pad_value": 0.5}):
        np.testing.assert_array_equal(report.imgs_to_grid(imgs, **kw),
                                      jax_report.imgs_to_grid(imgs, **kw))


# ------------------------------------------- DNS dataset and the metrics CLI
@pytest.fixture(scope="module")
def dns_dir(tmp_path_factory):
    """noisy/ and clean/ in the DNS test-set naming: two pairs by fileid,
    one noisy clip whose clean clip has its own name."""
    root = tmp_path_factory.mktemp("dns")
    (root / "noisy").mkdir()
    (root / "clean").mkdir()
    for i, (seed, n) in enumerate(((90, 24400), (92, 25000), (94, 24800))):
        noisy, clean = _pair(seed, n)
        name = f"book_{i}_fileid_{i}.wav"
        write_wav(root / "noisy" / name, noisy * 0.5, 16000)
        clean_name = f"clean_fileid_{i}.wav" if i < 2 else name
        write_wav(root / "clean" / clean_name, clean * 0.5, 16000)
    return root


def test_dns_validation_dataset_equals_jax(dns_dir, tmp_path):
    dirs = [str(dns_dir), str(tmp_path / "no_noisy_dir")]
    got, want = DNSValidationDataset(dirs), JaxDNSValidationDataset(dirs)
    assert len(got) == len(want) == 3
    assert got.pairs == want.pairs
    assert got.pairs[2][1] == dns_dir / "clean" / "book_2_fileid_2.wav"
    for i in range(3):
        (gn, gc, gname), (wn, wc, wname) = got[i], want[i]
        assert gname == wname
        np.testing.assert_array_equal(gn, wn)
        np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("style", ["plain", "dns_1"])
def test_calculate_metrics_pairs_and_rows_equal_jax(dns_dir, style):
    ref, est = dns_dir / "clean", dns_dir / "noisy"
    pairs = calc._align_pairs(ref, est, style)
    assert pairs == jax_calc._align_pairs(ref, est, style)
    assert len(pairs) == (3 if style == "dns_1" else 1)
    names = ["SI_SDR", "STOI", "WB_PESQ", "MOSNET"]
    for r, e in pairs:
        task = (str(r), str(e), names, 16000)
        row = calc._score_one(task)
        assert row["MOSNET"] is None
        want = jax_calc._score_one(task)
        assert {k: v for k, v in row.items() if k != "MOSNET"} == \
            {k: v for k, v in want.items() if k != "MOSNET"}


def test_calculate_metrics_main(dns_dir, tmp_path, capsys):
    out = tmp_path / "result.json"
    calc.main(["-R", str(dns_dir / "clean"), "-E", str(dns_dir / "noisy"),
               "-M", "SI_SDR,STOI", "--dataset_style", "dns_1", "--jobs", "1",
               "-O", str(out)])
    result = json.loads(out.read_text())
    rows = result["per_file"]
    assert [r["file"] for r in rows] == [f"book_{i}_fileid_{i}.wav"
                                        for i in range(3)]
    assert result["mean"]["STOI"] == pytest.approx(
        np.mean([r["STOI"] for r in rows]))
    assert json.loads(capsys.readouterr().out) == result["mean"]
    with pytest.raises(SystemExit, match="No .reference, estimated. pairs"):
        calc.main(["-R", str(tmp_path), "-E", str(tmp_path)])
