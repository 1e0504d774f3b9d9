"""Evaluation: the metrics registry, the validator, the Inferencer, the
StreamingEnhancer and the denoising-NPPC validator. Nothing here starts CUDA
at import."""
from generative_audio_torch.eval.inferencer import Inferencer, InferencerConfig  # noqa: F401
from generative_audio_torch.eval.metrics import (  # noqa: F401
    ESTOI, MOSNET, NB_PESQ, REGISTERED_METRICS, SDR, SI_SDR, STOI, WB_PESQ,
    MetricUnavailable, composite_validation_score, transform_pesq_range)
from generative_audio_torch.eval.nppc_denoising_validator import (  # noqa: F401
    DenoisingNPPCValidator, DenoisingNPPCValidatorConfig)
from generative_audio_torch.eval.streaming import StreamingEnhancer  # noqa: F401
from generative_audio_torch.eval.validator import ModelValidator  # noqa: F401
