"""Models of the port."""
from generative_audio_torch.models.fullsubnet_plus import (  # noqa: F401
    FullSubNetPlus, FullSubNetPlusConfig)
