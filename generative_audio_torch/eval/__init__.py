"""Evaluation: the metrics registry, the validator, the Inferencer, the
StreamingEnhancer, the NPPC validators of both lines, the restoration
validator, the MC-dropout baseline, the pitch tracker and MOSNet. Nothing
here starts CUDA at import."""
from generative_audio_torch.eval.inferencer import Inferencer, InferencerConfig  # noqa: F401
from generative_audio_torch.eval.metrics import (  # noqa: F401
    ESTOI, MOSNET, NB_PESQ, REGISTERED_METRICS, SDR, SI_SDR, STOI, WB_PESQ,
    MetricUnavailable, composite_validation_score, transform_pesq_range)
from generative_audio_torch.eval.mc_dropout import (  # noqa: F401
    calculate_unet_baseline, compute_pca_batch, mc_dropout_inference,
    mc_generators)
from generative_audio_torch.eval.mosnet import (  # noqa: F401
    MOSNet, MOSNetConfig, load_keras_h5, mosnet_features, mosnet_score)
from generative_audio_torch.eval.nppc_denoising_validator import (  # noqa: F401
    DenoisingNPPCValidator, DenoisingNPPCValidatorConfig)
from generative_audio_torch.eval.nppc_validator import (  # noqa: F401
    NPPCValidator, NPPCValidatorConfig, compute_metrics, organize_jsons)
from generative_audio_torch.eval.pitch import yin_pitch_track  # noqa: F401
from generative_audio_torch.eval.restoration_validator import (  # noqa: F401
    RestorationValidator, RestorationValidatorConfig)
from generative_audio_torch.eval.streaming import StreamingEnhancer  # noqa: F401
from generative_audio_torch.eval.validator import ModelValidator  # noqa: F401
