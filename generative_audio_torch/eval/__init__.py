"""Serving: the Inferencer and the StreamingEnhancer."""
from generative_audio_torch.eval.inferencer import Inferencer, InferencerConfig  # noqa: F401
from generative_audio_torch.eval.streaming import StreamingEnhancer  # noqa: F401
