"""Training: the optimizer state, checkpoints, the enhancement trainer, the
inpainting restoration trainer and the two NPPC trainers."""
from generative_audio_torch.train.checkpoint import (  # noqa: F401
    CheckpointManager, resume_latest)
from generative_audio_torch.train.enhance import (  # noqa: F401
    EnhanceTrainConfig, EnhanceTrainer, enhance_loss_fn, init_enhance_state,
    make_enhance_train_step)
from generative_audio_torch.train.nppc import (  # noqa: F401
    NPPCDenoisingTrainConfig, NPPCDenoisingTrainer, NPPCInpaintingTrainConfig,
    NPPCInpaintingTrainer)
from generative_audio_torch.train.restoration import (  # noqa: F401
    RestorationTrainConfig, RestorationTrainer)
from generative_audio_torch.train.state import (  # noqa: F401
    TrainState, clip_by_global_norm_, global_norm, make_optimizer)
