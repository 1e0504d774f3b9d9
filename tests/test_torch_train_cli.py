"""The port's training, validation and tools CLIs
(generative_audio_torch.cli.train, .validate, .tools) on the CPU, against
the JAX CLIs and against the port's own trainer and validator.

Model: the tiny FullSubNet+ of tests/test_cli.py's enhance test (32 bins from
a 62-point STFT, TCN towers at width 16, sub-band LSTM H=8, 2 neighbours,
one drop_band group) in float32, on a synthetic corpus of 3 clean clips and
2 noise clips, batch 2: one step an epoch. The CLI and the trainer fed the
same loader directly run the same float32 code in one process, so their
losses are equal (`==`); so are the validate CLI's means and
ModelValidator's on the same pairs, and the tools' outputs and the JAX
tools' (numpy on both sides).
"""
import json
import re

import numpy as np
import pytest
import torch

from generative_audio_torch.cli import tools
from generative_audio_torch.cli import train as train_cli
from generative_audio_torch.cli import validate as validate_cli
from generative_audio_torch.data import (
    AudioDataSetConfig, AudioDataset, BatchLoader, read_wav,
    write_synthetic_corpus, write_wav)

torch.set_num_threads(2)

MODEL = {"num_freqs": 32, "sb_num_neighbors": 2, "fb_model_hidden_size": 16,
         "sb_model_hidden_size": 8, "num_groups_in_drop_band": 1}
TRAIN = {"model": MODEL, "n_fft": 62, "hop_length": 32, "win_length": 62,
         "compute_dtype": "float32"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_corpus")
    clean_dir, noise_dir = write_synthetic_corpus(root, n_clean=3, n_noise=2,
                                                  seconds=3.0)
    rng = np.random.default_rng(3)
    val = root / "val"
    (val / "noisy").mkdir(parents=True)
    (val / "clean").mkdir(parents=True)
    x = rng.standard_normal(16000).astype(np.float32) * 0.1
    write_wav(val / "clean" / "v0.wav", x, 16000)
    write_wav(val / "noisy" / "v0.wav",
              x + rng.standard_normal(16000).astype(np.float32) * 0.03,
              16000)
    return {"clean": clean_dir, "noise": noise_dir, "val": val}


def _config(tmp_path, corpus, validation=True, seconds=0.25, **over):
    cfg = {
        "line": "enhance",
        "checkpoint_dir": str(tmp_path / "ckpt"),
        "train": TRAIN,
        "data": {"clean_path": str(corpus["clean"]),
                 "noisy_path": str(corpus["noise"]),
                 "sub_sample_length_seconds": seconds},
        "dataloader": {"global_batch_size": 2, "num_workers": 2},
    }
    if validation:
        cfg["validation"] = {"val_dir": str(corpus["val"]),
                             "probe_dir": str(corpus["val"]),
                             "probe_weight": 0.3, "validation_interval": 1}
    cfg.update(over)
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return path


def test_train_cli_validation_and_probe_like_jax(tmp_path, corpus,
                                                monkeypatch):
    """One epoch with validation and a probe: best_score.json carries the
    JAX CLI's keys and probe weight on the same config. The keys come from
    the CLI's `validation:` block and the trainer's selection, not from the
    numbers, so the JAX trainer's step and metrics are replaced by stand-ins
    (they would compile the JAX model for 30 s)."""
    import yaml
    from generative_audio_tpu.cli.train import main as jax_main
    from generative_audio_tpu.train import enhance as jax_enhance

    trainer = train_cli.main(["-C", str(_config(tmp_path / "torch", corpus)),
                              "--epochs", "1", "--device", "cpu"])
    ckpt = tmp_path / "torch" / "ckpt"
    meta = json.loads((ckpt / "best_score.json").read_text())
    assert trainer.state.step == 1 and np.isfinite(trainer.loss_history[0])
    assert (ckpt / "latest.pt").exists() and (ckpt / "report.html").exists()
    assert len(trainer.probe_history) == len(trainer.val_history) == 1
    assert meta["step"] == 1 and meta["score"] == trainer.best_score

    batches = []
    monkeypatch.setattr(jax_enhance.EnhanceTrainer, "train_epoch",
                        lambda self, loader, log=print:
                        batches.extend(loader) or 0.0)
    monkeypatch.setattr(jax_enhance.EnhanceTrainer, "validate",
                        lambda self, dataset, max_items=10:
                        {"STOI": 0.5, "SI_SDR": 1.0, "WB_PESQ": 2.0,
                         "composite": 0.6 + 0.1 * (len(dataset) - 1)})
    jax_cfg = json.loads(_config(tmp_path / "jax", corpus).read_text())
    jax_path = tmp_path / "jax" / "cfg.yaml"
    jax_path.write_text(yaml.safe_dump(jax_cfg))
    jax_main(["-C", str(jax_path), "--epochs", "1"])
    jax_meta = json.loads((tmp_path / "jax" / "ckpt" / "best_score.json")
                          .read_text())
    assert len(batches) == 1 and batches[0][0].shape == (2, 4000)
    assert set(meta) == set(jax_meta)
    assert meta["probe_weight"] == jax_meta["probe_weight"] == 0.3


def test_train_cli_resume_continues(tmp_path, corpus, monkeypatch):
    """-R restores the step count and best score, then trains on."""
    from generative_audio_torch.train import EnhanceTrainer
    cfg = str(_config(tmp_path, corpus))
    first = train_cli.main(["-C", cfg, "--epochs", "1", "--device", "cpu"])
    saved = torch.load(tmp_path / "ckpt" / "latest.pt", weights_only=True)
    assert saved["step"] == 1 and saved["best_score"] == first.best_score

    restored = []
    restore = EnhanceTrainer.restore_latest

    def recording(self):
        out = restore(self)
        restored.append((out, self.state.step, self.best_score))
        return out

    monkeypatch.setattr(EnhanceTrainer, "restore_latest", recording)
    second = train_cli.main(["-C", cfg, "-R", "--epochs", "2",
                             "--device", "cpu"])
    assert restored == [(True, 1, first.best_score)]
    assert second.state.step == 3
    assert (tmp_path / "ckpt" / "step_00000003.pt").exists()
    assert second.best_score >= first.best_score


@pytest.mark.parametrize("steps,epochs", [(None, 2), (3, 1)])
def test_train_cli_loss_history_equals_trainer(tmp_path, corpus, steps,
                                               epochs):
    """The CLI's losses == EnhanceTrainer.train fed the same loader's
    batches directly (the dataset seeded with the loader's seed, 0)."""
    from generative_audio_torch.data import LoopIterator
    from generative_audio_torch.train import (
        EnhanceTrainConfig, EnhanceTrainer)
    from generative_audio_torch.utils.config import build_dataclass
    argv = ["-C", str(_config(tmp_path / "cli", corpus, validation=False)),
            "--epochs", str(epochs), "--device", "cpu"]
    if steps:
        argv += ["--steps", str(steps)]
    cli = train_cli.main(argv)

    dataset = AudioDataset(AudioDataSetConfig(
        str(corpus["clean"]), str(corpus["noise"]),
        sub_sample_length_seconds=0.25), seed=0)
    loader = BatchLoader(dataset, 2, num_workers=2)
    if steps:
        loader = LoopIterator(loader, n_steps=steps)
    direct = EnhanceTrainer(build_dataclass(EnhanceTrainConfig, TRAIN),
                            checkpoint_dir=tmp_path / "direct",
                            device="cpu")
    direct.train(loader, epochs=epochs, log=lambda *_: None)
    assert cli.state.step == direct.state.step == epochs * (steps or 1)
    assert len(cli.loss_history) == epochs
    assert cli.loss_history == direct.loss_history
    for a, b in zip(cli.state.model.parameters(),
                    direct.state.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("line,item", [
    ("restoration", 8), ("nppc_inpainting", 8),
    ("image_restoration", 9), ("image_nppc", 9), ("distributed", 6)])
def test_train_cli_unported_raise(tmp_path, corpus, monkeypatch, line,
                                  item):
    """Queue A's items 6, 8 and 9 are ported. --distributed (item 6) takes
    the job from torchrun's environment: without its variables it raises a
    RuntimeError naming them (a 2-rank run: tests/test_torch_distributed.py).
    Items 8 and 9's lines refuse this enhance-line config in their own way
    (the restoration line's dataset has no noisy_path, the nppc_inpainting
    line takes no validation: block, the image lines take no data:
    block)."""
    if line == "distributed":
        argv = ["-C", str(_config(tmp_path, corpus)), "--distributed"]
    else:
        argv = ["-C", str(_config(tmp_path, corpus, line=line))]
    if item in (8, 9):
        with pytest.raises(ValueError, match="noisy_path|validation|no data"):
            train_cli.main(argv + ["--device", "cpu"])
        return
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "GAT_COORDINATOR", "GAT_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun's environment, which "
                       "lacks MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, "
                       "LOCAL_RANK"):
        train_cli.main(argv + ["--device", "cpu"])


def test_train_cli_defaults_to_cuda(tmp_path, corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would train")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["-C", str(_config(tmp_path, corpus))])
    with pytest.raises(ValueError, match="Unknown training line"):
        train_cli.main(["-C", str(_config(tmp_path, corpus, line="x")),
                        "--device", "cpu"])


@pytest.mark.parametrize("weights", ["state_dict", "checkpoint_dir"])
def test_validate_cli_equals_model_validator(tmp_path, corpus, weights):
    from generative_audio_torch.eval import ModelValidator
    from generative_audio_torch.models import (
        FullSubNetPlus, FullSubNetPlusConfig)
    from generative_audio_torch.train import CheckpointManager
    model_cfg = {k: v for k, v in MODEL.items()
                 if k != "num_groups_in_drop_band"}
    torch.manual_seed(5)
    model = FullSubNetPlus(FullSubNetPlusConfig(**model_cfg),
                           compute_dtype=torch.bfloat16, device="cpu")
    if weights == "state_dict":
        path = tmp_path / "model.pth"
        torch.save({"model": model.state_dict()}, path)
    else:
        path = tmp_path / "ckpt"
        CheckpointManager(path).save_best({"params": model.state_dict()},
                                          0.5, 1)
    data = {"clean_path": str(corpus["clean"]),
            "noisy_path": str(corpus["noise"]),
            "sub_sample_length_seconds": 1.25}
    cfg = tmp_path / "val.json"
    cfg.write_text(json.dumps({"model": model_cfg, "data": data,
                               "stft": {"nfft": 62, "hop_length": 32,
                                        "win_length": 62}}))
    out = tmp_path / "results.json"
    means = validate_cli.main(["-C", str(cfg), "-M", str(path), "-O",
                               str(out), "--max_items", "2", "--device",
                               "cpu"])
    written = json.loads(out.read_text())
    want = ModelValidator(model, n_fft=62, hop_length=32, win_length=62,
                          device="cpu").validate_dataset(
        AudioDataset(AudioDataSetConfig(**data), seed=0), max_items=2,
        log=lambda *_: None)
    assert written == means == want
    assert set(want) == {"WB_PESQ", "NB_PESQ", "STOI", "SI_SDR"}
    assert want["SI_SDR"] is not None and np.isfinite(want["SI_SDR"])


def _wavs(root, n=3, sr=16000, seconds=2.0, seed=0):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        t = np.arange(int(sr * seconds))
        wav = 0.1 * np.sin(2 * np.pi * 220 * (i + 1) * t / sr) \
            * (t % 8000 < 5000) + 0.01 * rng.standard_normal(len(t))
        write_wav(root / f"w{i}.wav", wav.astype(np.float32), sr)


def _tree(root):
    """{relative path: (sr, samples)} of every wav under root."""
    return {str(p.relative_to(root)): read_wav(p)
            for p in sorted(root.rglob("*.wav"))}


def _same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert list(ta) == list(tb) and ta
    for k in ta:
        assert ta[k][0] == tb[k][0]
        np.testing.assert_array_equal(ta[k][1], tb[k][1])


TOOL_CASES = ["gen_lst", "collect_lst", "resample_dir", "synthesize",
              "metric_txt", "dns_mos"]


@pytest.mark.parametrize("case", TOOL_CASES)
def test_tools_equal_jax(tmp_path, case):
    from generative_audio_tpu.cli import tools as jax_tools
    src = tmp_path / "src"
    _wavs(src / "a")
    _wavs(src, n=1, seconds=1.0, seed=1)
    write_wav(src / "short.wav", 0.1 * np.ones(1600, np.float32), 16000)
    t = np.arange(16000 * 3)
    write_wav(src / "clipped.wav", np.clip(
        2.0 * np.sin(2 * np.pi * 220 * t / 16000), -1, 1).astype(np.float32),
        16000)
    (src / "b").mkdir()
    write_wav(src / "b" / "x48.wav",
              (0.2 * np.sin(np.arange(4800) / 7.0)).astype(np.float32), 48000)
    quiet = lambda *a: None  # noqa: E731
    outs = {}
    for name, mod in (("torch", tools), ("jax", jax_tools)):
        out = tmp_path / name
        if case == "gen_lst":
            outs[name] = (mod.gen_lst(src, out / "all.lst"),
                          (out / "all.lst").read_text())
        elif case == "collect_lst":
            outs[name] = (mod.collect_lst([src], out / "speech.lst",
                                          wav_min_second=1.5,
                                          activity_threshold=0.3,
                                          total_hrs=1.0, seed=2, log=quiet),
                          (out / "speech.lst").read_text())
        elif case == "resample_dir":
            outs[name] = mod.resample_dir(src, out, sr=8000, num_workers=2)
        elif case == "synthesize":
            outs[name] = mod.synthesize_noisy_speech(
                src / "a", src, out, total_hours=0.0015, audio_length=2.0,
                total_snrlevels=3, seed=4, log=quiet)
        elif case == "metric_txt":
            mod.write_metric_txt(out.with_suffix(".1"),
                                 [("x.wav", 2.0), ("y.wav", 1.0),
                                  ("z.wav", 0.5)])
            mod.write_metric_txt(out.with_suffix(".2"),
                                 [("x.wav", 1.5), ("y.wav", 1.4)])
            outs[name] = (mod.read_metric_txt(out.with_suffix(".1")),
                          mod.compare_metric_files(out.with_suffix(".1"),
                                                   out.with_suffix(".2")))
        elif case == "dns_mos":
            sent = []

            def post(uri, headers, payload, sent=sent):
                sent.append((uri, headers, payload))
                return {"mos": len(payload) % 97 / 20.0}

            kw = dict(method="p835", auth_key="k", post_fn=post, log=quiet)
            rows = mod.dns_mos_score(src / "a", out / "s" / "score.csv", **kw)
            again = mod.dns_mos_score(src / "a", out / "s" / "score.csv",
                                      **kw)
            outs[name] = (rows, again, sent,
                          (out / "s" / "score.csv").read_text(),
                          (out / "s" / "file_mos.txt").read_text())
    assert outs["torch"] == outs["jax"]
    if case in ("resample_dir", "synthesize"):
        _same_tree(tmp_path / "torch", tmp_path / "jax")
    if case == "collect_lst":
        assert outs["torch"][0]["clipped"] == 1
        assert outs["torch"][0]["too_short"] == 3
    if case == "dns_mos":
        with pytest.raises(NotImplementedError, match="post_fn"):
            tools.dns_mos_score(src / "a", tmp_path / "x.csv")


def test_draw_hist_svg(tmp_path):
    """The bars are np.histogram's ten bins of each data set, as
    matplotlib's hist draws them."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=50), rng.normal(1.0, 2.0, size=30)
    tools.draw_hist(a, tmp_path / "one.svg")
    tools.draw_hist(a, tmp_path / "two.svg", data2=b, labels=("A", "B"))
    for name, sets in (("one.svg", [a]), ("two.svg", [a, b])):
        svg = (tmp_path / name).read_text()
        assert svg.startswith("<svg") and svg.endswith("</svg>")
        bars = re.findall(r'data-set="(\d)" data-count="(\d+)" '
                          r'data-lo="([^"]+)" data-hi="([^"]+)"', svg)
        for i, data in enumerate(sets):
            counts, edges = np.histogram(data, bins=10)
            mine = [(int(c), float(lo), float(hi))
                    for s, c, lo, hi in bars if int(s) == i]
            assert mine == [(int(c), float(lo), float(hi)) for c, lo, hi in
                            zip(counts, edges[:-1], edges[1:])]
    assert ">A<" in (tmp_path / "two.svg").read_text()


def test_tools_dispatcher(tmp_path, capsys):
    _wavs(tmp_path / "ds", n=1, seconds=0.5)
    tools.main(["gen_lst", "--dataset_dir", str(tmp_path / "ds"),
                "--output_lst", str(tmp_path / "o.lst")])
    assert "wrote 1 paths" in capsys.readouterr().out
    f1, f2 = tmp_path / "a.txt", tmp_path / "b.txt"
    tools.write_metric_txt(f1, [("x.wav", 2.0), ("y.wav", 1.0)])
    tools.write_metric_txt(f2, [("x.wav", 1.5)])
    tools.main(["analyse", "--file1", str(f1), "--file2", str(f2),
                "--output", str(tmp_path / "d.txt"), "--hist",
                str(tmp_path / "h.svg")])
    assert tools.read_metric_txt(tmp_path / "d.txt") == {"x.wav": 0.5}
    assert "(1 entries present in only one file)" in capsys.readouterr().out
    assert (tmp_path / "h.svg").read_text().count('class="bar"') == 20
    with pytest.raises(NotImplementedError):
        tools.main(["dns_mos", "--testset_dir", str(tmp_path / "ds"),
                    "--score_file", str(tmp_path / "s.csv")])
