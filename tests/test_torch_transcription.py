"""The port's transcription hooks and LibriSpeech downloader against the
JAX package on the CPU, with no network: a tiny random Whisper and wav2vec2
written with save_pretrained into a temporary directory (as
tests/test_transcription.py:10-80 builds them); the port's `(audio, sr) ->
str` equals the JAX factory's on the same directory, at 16 kHz and through
the 8 kHz resample path. The downloader: an unknown subset raises, an
extracted subset is skipped, and a local .tar.gz written by the test is
extracted without a download.

Also batched enhance_dir's modes: the port serves the two cRM modes
batched and raises NotImplementedError for the other six, where the JAX
batched path runs the (mag, real, imag) program whatever inference_type
says.
"""
import io
import json
import tarfile

import numpy as np
import pytest
import torch

from generative_audio_tpu.data import download as jax_download
from generative_audio_tpu.eval import transcription as jax_transcription
from generative_audio_torch.data import download
from generative_audio_torch.eval import Inferencer, InferencerConfig
from generative_audio_torch.eval import inferencer, transcription

transformers = pytest.importorskip("transformers")
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny_whisper_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_whisper")
    torch.manual_seed(0)
    cfg = transformers.WhisperConfig(
        vocab_size=64, num_mel_bins=8, d_model=16,
        encoder_layers=1, decoder_layers=1,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=16, decoder_ffn_dim=16,
        max_source_positions=1500, max_target_positions=48,
        decoder_start_token_id=1, pad_token_id=0, bos_token_id=1,
        eos_token_id=2, begin_suppress_tokens=None, suppress_tokens=None)
    model = transformers.WhisperForConditionalGeneration(cfg)
    model.generation_config.max_length = 8
    model.generation_config.forced_decoder_ids = None
    model.save_pretrained(d)
    fe = transformers.WhisperFeatureExtractor(feature_size=8)
    vocab = {f"<{i}>": i for i in range(58)}
    for i, special in enumerate(["<|endoftext|>", "<|startoftranscript|>",
                                 "<|notimestamps|>", "<|transcribe|>",
                                 "<|en|>", "<|nospeech|>"]):
        vocab[special] = 58 + i
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")
    tok = transformers.WhisperTokenizer(str(d / "vocab.json"),
                                        str(d / "merges.txt"))
    transformers.WhisperProcessor(fe, tok).save_pretrained(d)
    return d


@pytest.fixture(scope="module")
def tiny_w2v2_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_w2v2")
    torch.manual_seed(1)
    cfg = transformers.Wav2Vec2Config(
        vocab_size=12, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=16,
        conv_dim=(16, 16), conv_stride=(5, 2), conv_kernel=(10, 3),
        num_feat_extract_layers=2)
    transformers.Wav2Vec2ForCTC(cfg).save_pretrained(d)
    vocab = {c: i for i, c in enumerate(
        ["<pad>", "<s>", "</s>", "<unk>", "|", "a", "b", "k", "s", "t",
         "m", "n"])}
    (d / "vocab.json").write_text(json.dumps(vocab))
    tok = transformers.Wav2Vec2CTCTokenizer(str(d / "vocab.json"))
    fe = transformers.Wav2Vec2FeatureExtractor(
        feature_size=1, sampling_rate=16000, padding_value=0.0,
        do_normalize=True, return_attention_mask=False)
    transformers.Wav2Vec2Processor(fe, tok).save_pretrained(d)
    return d


def _clips():
    """(audio, sr): a tone and noise at 8 kHz (the resample path), noise at
    16 kHz."""
    rng = np.random.default_rng(0)
    tone = 0.1 * np.sin(2 * np.pi * 220 * np.arange(8000) / 8000)
    return [(tone.astype(np.float32), 8000),
            ((0.1 * rng.standard_normal(16000)).astype(np.float32), 16000),
            ((0.1 * rng.standard_normal(12000)).astype(np.float32), 8000)]


def test_whisper_matches_jax_factory(tiny_whisper_dir):
    fn = transcription.make_whisper_transcribe_fn(str(tiny_whisper_dir),
                                                  language=None, device="cpu")
    jfn = jax_transcription.make_whisper_transcribe_fn(str(tiny_whisper_dir),
                                                       language=None)
    for audio, sr in _clips():
        text = fn(audio, sr)
        assert isinstance(text, str) and text == jfn(audio, sr)


def test_phonemes_match_jax_factory(tiny_w2v2_dir):
    fn = transcription.make_phoneme_fn(str(tiny_w2v2_dir), device="cpu")
    jfn = jax_transcription.make_phoneme_fn(str(tiny_w2v2_dir))
    texts = []
    for audio, sr in _clips():
        text = fn(audio, sr)
        assert isinstance(text, str) and text == jfn(audio, sr)
        texts.append(text)
    assert any(texts)           # the random CTC head emits some phonemes


def test_factories_need_cuda_unless_asked_for_the_cpu(tiny_w2v2_dir,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transcription.make_phoneme_fn(str(tiny_w2v2_dir))


# -------------------------------------------------------------- download --
def test_download_urls_match_jax():
    assert download.LIBRISPEECH_URLS == jax_download.LIBRISPEECH_URLS


def test_unknown_subset_rejected(tmp_path):
    with pytest.raises(ValueError, match="unknown subset"):
        download.download_librispeech(tmp_path, subsets=("nope",))


def test_existing_subset_skipped(tmp_path, monkeypatch):
    def no_network(*args):
        raise AssertionError("tried to download")

    monkeypatch.setattr(download.urllib.request, "urlretrieve", no_network)
    (tmp_path / "LibriSpeech" / "test-clean").mkdir(parents=True)
    msgs = []
    root = download.download_librispeech(tmp_path, subsets=("test-clean",),
                                         log=msgs.append)
    assert root == tmp_path / "LibriSpeech"
    assert msgs == ["test-clean: already extracted, skipping"]


def test_local_archive_extracted(tmp_path, monkeypatch):
    def no_network(*args):
        raise AssertionError("tried to download")

    monkeypatch.setattr(download.urllib.request, "urlretrieve", no_network)
    payload = b"19-198-0000 A TEST\n"
    with tarfile.open(tmp_path / "dev-clean.tar.gz", "w:gz") as tf:
        info = tarfile.TarInfo("LibriSpeech/dev-clean/19/198/19-198.trans.txt")
        info.size = len(payload)
        tf.addfile(info, io.BytesIO(payload))
    msgs = []
    root = download.download_librispeech(tmp_path, subsets=("dev-clean",),
                                         log=msgs.append)
    assert (root / "dev-clean/19/198/19-198.trans.txt").read_bytes() == payload
    assert msgs == [f"extracting {tmp_path / 'dev-clean.tar.gz'} ..."]


def test_failed_download_names_the_archive(tmp_path, monkeypatch):
    def offline(url, path):
        raise download.urllib.error.URLError("offline")

    monkeypatch.setattr(download.urllib.request, "urlretrieve", offline)
    with pytest.raises(RuntimeError, match="test-clean.tar.gz"):
        download.download_librispeech(tmp_path, subsets=("test-clean",),
                                      log=lambda *a: None)


# ------------------------------------------ batched enhance_dir's modes --
class _Clips:
    items = [(np.zeros(800, np.float32), "clip0"),
             (np.zeros(900, np.float32), "clip1")]

    def __len__(self):
        return 2

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("mode", sorted(set(inferencer.MODES)
                                        - set(inferencer._BATCHED_MODES)))
def test_batched_enhance_dir_refuses_other_modes(tmp_path, mode):
    tinf = Inferencer(torch.nn.Identity(), InferencerConfig(
        inference_type=mode), device="cpu")
    with pytest.raises(NotImplementedError, match="cRM modes only"):
        tinf.enhance_dir(_Clips(), tmp_path, log=lambda *a: None,
                         batch_size=2)
    assert not list(tmp_path.iterdir())
