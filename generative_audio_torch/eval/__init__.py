"""Serving: the Inferencer."""
from generative_audio_torch.eval.inferencer import Inferencer, InferencerConfig  # noqa: F401
