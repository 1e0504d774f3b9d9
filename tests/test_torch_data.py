"""The port's host data layer (generative_audio_torch.ops.waveform, .data.
mixing, .rir, .audio_dataset, .dns_dataset, .loader, .sample_generator)
against the JAX package's on the CPU.

Both sides are numpy and scipy, so every comparison is exact (`==` on values,
dtypes and shapes), not a tolerance: a difference is a transcription fault.
The datasets differ from the JAX ones in one way, by design: the port draws
item i of epoch e from np.random.default_rng([seed, e, i]) where the JAX
dataset shares one generator. The JAX datasets are held item by item with
that generator set as their `_rng` before each item (a subclass here; the JAX
code is not touched). The loader's order is held against the JAX
BatchLoader at num_workers=1, where the JAX order is deterministic.
"""
import sys
import warnings

import numpy as np
import pytest
import torch

from generative_audio_tpu.data import audio_dataset as jax_audio_dataset
from generative_audio_tpu.data import dns_dataset as jax_dns
from generative_audio_tpu.data import loader as jax_loader
from generative_audio_tpu.data import mixing as jax_mixing
from generative_audio_tpu.data import rir as jax_rir
from generative_audio_tpu.ops import waveform as jax_waveform

from generative_audio_torch.data import (
    AudioDataSetConfig, AudioDataset, BatchLoader, DNSTrainConfig,
    DNSTrainDataset, LoopIterator, read_wav, write_synthetic_corpus,
    write_wav)
from generative_audio_torch.data import mixing, rir, sample_generator
from generative_audio_torch.cli.tools import gen_lst
from generative_audio_torch.ops import waveform

torch.set_num_threads(2)


def _same(a, b):
    """Exact equality of nested results: arrays by value, dtype and shape."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _speechish(seed, n=16000):
    """A tone burst between quiet stretches over a noise floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    env = ((t > 0.25) & (t < 0.7)).astype(np.float64)
    tone = sum(np.sin(2 * np.pi * 140 * k * t) / k for k in range(1, 6))
    return (0.3 * tone * env + 0.003 * rng.standard_normal(n)
            ).astype(np.float32)


def _wave(seed, n):
    return (np.random.default_rng(seed).standard_normal(n) * 0.2
            ).astype(np.float32)


# (name, args without a generator, whether the function takes rng=)
WAVEFORM_CASES = [
    ("norm_amplitude", lambda: (_wave(0, 800),), {}, False),
    ("norm_amplitude", lambda: (_wave(0, 800),), {"scalar": 2.0}, False),
    ("tailor_dB_FS", lambda: (_wave(1, 800), -30), {}, False),
    ("normalize_to_dbfs", lambda: (_wave(2, 800), -20.0), {}, False),
    ("is_clipped", lambda: (_wave(3, 800),), {}, False),
    ("is_clipped", lambda: (_wave(3, 800) * 10,), {}, False),
    ("subsample", lambda: (_wave(4, 900), 500), {}, True),
    ("subsample", lambda: (_wave(4, 300), 500), {}, True),
    ("subsample", lambda: (_wave(4, 500), 500), {}, True),
    ("subsample", lambda: (_wave(4, 900), 500),
     {"start_position": 17, "return_start_position": True}, True),
    ("subsample", lambda: (_wave(4, 900), 500),
     {"return_start_position": True}, True),
    ("aligned_subsample", lambda: (_wave(5, 900), _wave(6, 900), 400), {},
     True),
    ("aligned_subsample", lambda: (np.stack([_wave(5, 300)] * 2),
                                   np.stack([_wave(6, 300)] * 2), 400), {},
     True),
    ("overlap_cat", lambda: ([_wave(7 + i, 64) for i in range(4)],), {},
     False),
    ("activity_detector", lambda: (_speechish(8),), {}, False),
    ("energy_vad_segments", lambda: (_speechish(9),), {}, False),
    ("energy_vad_segments", lambda: (_speechish(9),),
     {"min_duration_ms": 400}, False),
    ("spectral_entropy_vad_segments", lambda: (_speechish(10),), {}, False),
    ("spectral_entropy_vad_segments", lambda: (_speechish(10)[:300],), {},
     False),
]


@pytest.mark.parametrize("name,args,kwargs,takes_rng", WAVEFORM_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(WAVEFORM_CASES)])
def test_waveform_equals_jax(name, args, kwargs, takes_rng):
    assert set(waveform.__all__) == set(jax_waveform.__all__)
    outs = []
    for module in (waveform, jax_waveform):
        kw = dict(kwargs)
        if takes_rng:
            kw["rng"] = np.random.default_rng(11)
        outs.append(getattr(module, name)(*args(), **kw))
    _same(*outs)


def _noises():
    return [_wave(20 + i, n) for i, n in enumerate((700, 1300, 400))]


MIXING_CASES = {
    "mix_with_snr": lambda m, g: m.mix_with_snr(_wave(30, 1000),
                                                _wave(31, 1000), 5.0),
    "mix_with_snr_clip": lambda m, g: m.mix_with_snr(_wave(30, 1000) * 8,
                                                     _wave(31, 1000), -5.0),
    "snr_mix": lambda m, g: m.snr_mix(_wave(32, 2000), _wave(33, 2000), 3,
                                      -25, 10, rng=g),
    "snr_mix_loud": lambda m, g: m.snr_mix(_wave(32, 2000), _wave(33, 2000),
                                           -5, -5, 10, rng=g),
    "snr_mix_rir": lambda m, g: m.snr_mix(
        _wave(32, 2000), _wave(33, 2000), 10, -25, 10,
        rir=np.exp(-np.arange(300) / 40.0).astype(np.float32)
        * _wave(34, 300), rng=g),
    "snr_mix_rir_bank": lambda m, g: m.snr_mix(
        _wave(32, 2000), _wave(33, 2000), 0, -25, 10,
        rir=np.stack([_wave(35 + i, 200) for i in range(3)]), rng=g),
    "build_noise_track": lambda m, g: m.build_noise_track(
        2500, lambda it=iter(_noises() * 3): next(it), 160, rng=g),
    "build_noise_track_short_silence": lambda m, g: m.build_noise_track(
        1500, lambda it=iter(_noises() * 3): next(it), 2000, rng=g),
    "speed_perturb_fast": lambda m, g: m.speed_perturb(_wave(36, 1600), 1.1),
    "speed_perturb_slow": lambda m, g: m.speed_perturb(_wave(36, 1600),
                                                       0.9),
    "speed_perturb_unit": lambda m, g: m.speed_perturb(_wave(36, 1600),
                                                       1.0),
}


@pytest.mark.parametrize("case", list(MIXING_CASES))
def test_mixing_equals_jax(case):
    assert set(mixing.__all__) == set(jax_mixing.__all__)
    fn = MIXING_CASES[case]
    _same(fn(mixing, np.random.default_rng(40)),
          fn(jax_mixing, np.random.default_rng(40)))


@pytest.mark.parametrize("room,src,mic,rt60,kw", [
    ((4.0, 5.0, 3.0), (1.0, 1.5, 1.2), (3.0, 3.5, 1.5), 0.2, {}),
    ((3.2, 3.0, 2.5), (0.7, 2.1, 1.0), (2.4, 0.6, 1.7), 0.15,
     {"length": 900, "max_order": 3}),
])
def test_image_source_rir_equals_jax(room, src, mic, rt60, kw):
    _same(rir.image_source_rir(room, src, mic, rt60=rt60, **kw),
          jax_rir.image_source_rir(room, src, mic, rt60=rt60, **kw))


def test_make_rir_bank_equals_jax(tmp_path):
    kw = dict(n=3, seed=5, rt60_range=(0.12, 0.2))
    scp = rir.make_rir_bank(tmp_path / "torch", **kw)
    jax_scp = jax_rir.make_rir_bank(tmp_path / "jax", **kw)
    paths = scp.read_text().split()
    jax_paths = jax_scp.read_text().split()
    assert [p.split("/")[-1] for p in paths] == \
        [p.split("/")[-1] for p in jax_paths] == \
        ["rir_000.wav", "rir_001.wav", "rir_002.wav"]
    for p, q in zip(paths, jax_paths):
        _same(read_wav(p), read_wav(q))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 clean clips of 1 s and 3 noise clips of 0.3 s, their scp lists and
    a bank of 3 RIRs."""
    root = tmp_path_factory.mktemp("torch_data_corpus")
    clean_dir, noise_dir = write_synthetic_corpus(root, n_clean=4,
                                                  n_noise=3, seconds=1.0)
    short = root / "short_noise"
    short.mkdir()
    for i in range(3):
        write_wav(short / f"n{i}.wav", _wave(50 + i, 4800), 16000)
    gen_lst(clean_dir, root / "clean.scp")
    gen_lst(short, root / "noise.scp")
    rir_scp = rir.make_rir_bank(root / "rir", n=3, seed=1,
                                rt60_range=(0.12, 0.2))
    return {"root": root, "clean_dir": clean_dir, "noise_dir": noise_dir,
            "short_noise": short, "clean_scp": root / "clean.scp",
            "noise_scp": root / "noise.scp", "rir_scp": rir_scp}


class _JaxDNSPerItem(jax_dns.DNSTrainDataset):
    """The JAX dataset with the port's per-item generator set as its _rng
    before each item."""

    def __init__(self, config, seed, epoch):
        super().__init__(config)
        self._seed, self._epoch = seed, epoch

    def __getitem__(self, item):
        self._rng = np.random.default_rng([self._seed, self._epoch, item])
        return super().__getitem__(item)


class _JaxAudioPerItem(jax_audio_dataset.AudioDataset):
    def __init__(self, config, seed, epoch):
        super().__init__(config)
        self._seed, self._epoch = seed, epoch

    def __getitem__(self, idx):
        self._rng = np.random.default_rng([self._seed, self._epoch, idx])
        return super().__getitem__(idx)


def _dns_config(corpus, **over):
    kw = dict(clean_dataset=str(corpus["clean_scp"]),
              noise_dataset=str(corpus["noise_scp"]),
              rir_dataset=str(corpus["rir_scp"]), reverb_proportion=0.5,
              snr_range=(-5, 20), sub_sample_length=0.5)
    kw.update(over)
    return kw


@pytest.mark.parametrize("over", [
    {}, {"reverb_proportion": 1.0, "sub_sample_length": 1.3},
    {"rir_dataset": None, "snr_range": (0, 3), "clean_dataset_offset": 1,
     "noise_dataset_limit": 2},
], ids=["rir-half", "rir-all-padded", "no-rir-offset-limit"])
def test_dns_train_dataset_equals_jax_item_by_item(corpus, over):
    kw = _dns_config(corpus, **over)
    port = DNSTrainDataset(DNSTrainConfig(**kw), seed=7)
    assert len(port) == len(jax_dns.DNSTrainDataset(
        jax_dns.DNSTrainConfig(**kw)))
    for epoch in (1, 2):
        port.set_epoch(epoch)
        ref = _JaxDNSPerItem(jax_dns.DNSTrainConfig(**kw), 7, epoch)
        for item in range(len(port)):
            _same(port[item], ref[item])


def test_dns_train_dataset_item_is_its_own(corpus):
    """An item does not depend on what was read before it."""
    ds = DNSTrainDataset(DNSTrainConfig(**_dns_config(corpus)), seed=3)
    ds.set_epoch(1)
    first = [ds[i] for i in range(len(ds))]
    for i in reversed(range(len(ds))):
        _same(ds[i], first[i])
    ds.set_epoch(2)
    assert not np.array_equal(ds[0][0], first[0][0])
    with pytest.raises(ValueError):
        DNSTrainDataset(DNSTrainConfig(**_dns_config(
            corpus, reverb_proportion=1.5)))


@pytest.mark.parametrize("floating", [0.0, 5.0])
def test_audio_dataset_equals_jax_item_by_item(corpus, floating, tmp_path):
    clean = tmp_path / "clean"
    clean.mkdir()
    for p in sorted(corpus["clean_dir"].glob("*.wav")):
        (clean / p.name).write_bytes(p.read_bytes())
    # an unreadable clip: the dataset skips forward to the next one
    (clean / "clean_1b.wav").write_bytes(b"RIFF not a wav")
    kw = dict(clean_path=str(clean), noisy_path=str(corpus["noise_dir"]),
              sub_sample_length_seconds=0.75, snr_range=(-3, 12),
              target_dB_FS_floating_value=floating)
    port = AudioDataset(AudioDataSetConfig(**kw), seed=4)
    for epoch in (1, 3):
        port.set_epoch(epoch)
        ref = _JaxAudioPerItem(jax_audio_dataset.AudioDataSetConfig(**kw), 4,
                               epoch)
        for item in range(len(port)):
            _same(port[item], ref[item])


def test_audio_dataset_unreadable_corpus_raises(tmp_path):
    (tmp_path / "c").mkdir()
    (tmp_path / "n").mkdir()
    for d in ("c", "n"):
        (tmp_path / d / "x.wav").write_bytes(b"garbage")
    ds = AudioDataset(AudioDataSetConfig(str(tmp_path / "c"),
                                         str(tmp_path / "n")), seed=0)
    with pytest.raises(RuntimeError, match="No readable clean audio"):
        ds[0]
    with pytest.raises(ValueError, match="No audio files"):
        AudioDataset(AudioDataSetConfig(str(tmp_path / "c"),
                                        str(tmp_path / "empty")))


class _Indexed:
    """Item i is (i as a float row, [i])."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full(3, i, np.float32), np.array([i])


@pytest.mark.parametrize("n,batch,shuffle,drop_last,num_hosts", [
    (10, 4, True, True, 1), (10, 4, True, False, 1), (10, 4, False, True, 1),
    (13, 4, True, True, 2), (12, 6, False, True, 2),
])
def test_batch_loader_order_equals_jax(n, batch, shuffle, drop_last,
                                       num_hosts):
    def run(cls, host_id):
        loader = cls(_Indexed(n), batch, shuffle=shuffle, drop_last=drop_last,
                     seed=3, num_workers=1, host_id=host_id,
                     num_hosts=num_hosts)
        return [list(loader) for _ in range(2)], len(loader)

    for host_id in range(num_hosts):
        got, n_got = run(BatchLoader, host_id)
        want, n_want = run(jax_loader.BatchLoader, host_id)
        assert n_got == n_want
        _same(got, want)
        assert all(len(b[1]) == batch // num_hosts
                   for epoch in got for b in epoch[:len(epoch) - 1])


def test_batch_loader_multihost_forces_drop_last():
    with pytest.warns(UserWarning, match="forcing drop_last=True"):
        loader = BatchLoader(_Indexed(10), 4, drop_last=False, num_hosts=2,
                             num_workers=1)
    with pytest.warns(UserWarning, match="forcing drop_last=True"):
        ref = jax_loader.BatchLoader(_Indexed(10), 4, drop_last=False,
                                     num_hosts=2, num_workers=1)
    assert loader.drop_last and ref.drop_last and len(loader) == len(ref) == 2
    _same(list(loader), list(ref))
    with pytest.raises(ValueError):
        BatchLoader(_Indexed(10), 5, num_hosts=2)


def test_batch_loader_collate_fn():
    got = list(BatchLoader(_Indexed(6), 3, shuffle=False, num_workers=2,
                           collate_fn=lambda s: [x[1][0] for x in s]))
    assert got == [[0, 1, 2], [3, 4, 5]]


@pytest.mark.parametrize("workers", [4, 16])
def test_batches_do_not_depend_on_workers(corpus, workers):
    """The same seed gives the same batches at 1 worker and at `workers`
    (16 with a short switch interval, more threads than cores), and an
    epoch's batches differ from the last epoch's."""
    cfg = DNSTrainConfig(**_dns_config(corpus))

    def epochs(num_workers):
        loader = BatchLoader(DNSTrainDataset(cfg, seed=9), 2, seed=9,
                             num_workers=num_workers, shuffle=False)
        return [list(loader) for _ in range(2)]

    one = epochs(1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        many = epochs(workers)
    finally:
        sys.setswitchinterval(interval)
    _same(one, many)
    assert not np.array_equal(one[0][0][0], one[1][0][0])


@pytest.mark.parametrize("n_steps,n_epochs", [(5, None), (3, None),
                                              (None, 2)])
def test_loop_iterator_equals_jax(n_steps, n_epochs):
    def run(loader_cls, loop_cls):
        loader = loader_cls(_Indexed(10), 4, seed=1, num_workers=1)
        loop = loop_cls(loader, n_steps=n_steps, n_epochs=n_epochs)
        return len(loop), list(loop), loader.epoch

    got, want = run(BatchLoader, LoopIterator), run(
        jax_loader.BatchLoader, jax_loader.LoopIterator)
    assert got[0] == want[0] and got[2] == want[2]
    _same(got[1], want[1])


def test_loop_iterator_empty_loader_raises():
    for loader_cls, loop_cls in ((BatchLoader, LoopIterator),
                                 (jax_loader.BatchLoader,
                                  jax_loader.LoopIterator)):
        loop = loop_cls(loader_cls(_Indexed(3), 4, num_workers=1), n_steps=2)
        with pytest.raises(RuntimeError, match="yielded no batches"):
            list(loop)
    with pytest.raises(ValueError):
        LoopIterator(BatchLoader(_Indexed(3), 1), n_steps=1, n_epochs=1)


def test_sample_generator_writes_pairs(corpus, tmp_path):
    cfg = AudioDataSetConfig(str(corpus["clean_dir"]),
                             str(corpus["noise_dir"]),
                             sub_sample_length_seconds=0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sample_generator.TestSampleGenerator(
            cfg, tmp_path / "out", snr=7.0, seed=2).generate(3)
    names = [f"sample_{i:04d}.wav" for i in range(3)]
    for sub in ("noisy", "clean"):
        assert sorted(p.name for p in (tmp_path / "out" / sub).iterdir()) \
            == names
    ref = AudioDataset(AudioDataSetConfig(str(corpus["clean_dir"]),
                                          str(corpus["noise_dir"]),
                                          sub_sample_length_seconds=0.5,
                                          snr_range=(7.0, 7.0)), seed=2)
    for i, name in enumerate(names):
        noisy, clean = ref[i]
        for sub, want in (("noisy", noisy), ("clean", clean)):
            sr, got = read_wav(tmp_path / "out" / sub / name)
            assert sr == 16000 and got.shape == (8000,)
            # write_wav stores int16 of x * 32767
            np.testing.assert_array_equal(
                got, (np.clip(want, -1, 1) * 32767).astype(np.int16)
                / np.float32(32768.0))
