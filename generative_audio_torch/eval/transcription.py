"""Transcription and phoneme hooks for the NPPC validator.

Port of generative_audio_tpu/eval/transcription.py (reference
inpainting/validator/validator_nppc_model.py: Whisper transcription of each
PC audio variation, :540-635; wav2vec2 CTC phonemes, :481-515). Each
factory builds an `(audio [T] float, sr) -> str` callable from a
HuggingFace `transformers` checkpoint, to pass as NPPCValidator's
`transcribe_fn` or `phoneme_fn`. Give a local model directory where there is
no network; a hub name works only with one. `transformers` is imported
inside the factory, so that the module imports without it.

The model runs on `device` ("cuda" by default, which raises without a CUDA
device; or "cpu"); audio at another rate than 16 kHz is resampled first
through data.audio_io.resample.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from generative_audio_torch.data.audio_io import resample
from generative_audio_torch.utils.device import resolve_device

__all__ = ["make_whisper_transcribe_fn", "make_phoneme_fn"]


def _load_processor_and_model(model_path: str, model_cls_name: str, device):
    try:
        import transformers
    except ImportError as e:
        raise RuntimeError(
            "transformers is required for the transcription hooks") from e
    processor = transformers.AutoProcessor.from_pretrained(model_path)
    model = getattr(transformers, model_cls_name).from_pretrained(model_path)
    model.eval().to(device)
    return processor, model


def _at_16k(audio, sr: int) -> np.ndarray:
    audio = np.asarray(audio, np.float32)
    return audio if sr == 16000 else resample(audio, sr, 16000)


def make_whisper_transcribe_fn(
        model_path: str = "openai/whisper-base",
        language: Optional[str] = "en",
        device=None) -> Callable[[np.ndarray, int], str]:
    """(audio [T] float, sr) -> the transcription, by a Whisper checkpoint
    (reference validator_nppc_model.py:540, whisper.load_model("base"))."""
    dev = resolve_device(device)
    processor, model = _load_processor_and_model(
        model_path, "WhisperForConditionalGeneration", dev)
    kwargs = {} if language is None else {"language": language}

    def transcribe(audio: np.ndarray, sr: int) -> str:
        inputs = processor(_at_16k(audio, sr), sampling_rate=16000,
                           return_tensors="pt")
        with torch.no_grad():
            ids = model.generate(inputs.input_features.to(dev), **kwargs)
        return processor.batch_decode(ids.cpu(),
                                      skip_special_tokens=True)[0].strip()

    return transcribe


def make_phoneme_fn(
        model_path: str = "bookbot/wav2vec2-ljspeech-gruut",
        device=None) -> Callable[[np.ndarray, int], str]:
    """(audio [T] float, sr) -> the space-separated phonemes, by a wav2vec2
    CTC checkpoint (reference validator_nppc_model.py:481-515)."""
    dev = resolve_device(device)
    processor, model = _load_processor_and_model(model_path,
                                                 "Wav2Vec2ForCTC", dev)

    def phonemes(audio: np.ndarray, sr: int) -> str:
        inputs = processor(_at_16k(audio, sr), sampling_rate=16000,
                           return_tensors="pt", padding=True)
        with torch.no_grad():
            logits = model(inputs.input_values.to(dev)).logits
        ids = torch.argmax(logits, dim=-1).cpu()
        return processor.batch_decode(ids)[0].strip()

    return phonemes
