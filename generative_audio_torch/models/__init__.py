"""Models of the port."""
from generative_audio_torch.models.fullsubnet import (  # noqa: F401
    FullSubNet, FullSubNetConfig)
from generative_audio_torch.models.fullsubnet_plus import (  # noqa: F401
    FullSubNetPlus, FullSubNetPlusConfig, MultiDirectionConfig,
    MultiDirectionFullSubNetPlus)
from generative_audio_torch.models.nppc_model import (  # noqa: F401
    DenoisingNPPCConfig, DenoisingNPPCModel, InpaintingNPPCConfig,
    InpaintingNPPCModel, InpaintingRestorationModel, StftConfig,
    UNetModelConfig)
from generative_audio_torch.models.pc_wrapper import (  # noqa: F401
    AudioInpaintingPCWrapper, AudioInpaintingPCWrapperConfig, AudioPCWrapper)
