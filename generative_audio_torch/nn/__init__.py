"""Blocks of the serving path (TSSE channel attention, TCN, sequence
models) and the inpainting line's UNets."""
from generative_audio_torch.nn.attention import (  # noqa: F401
    ChannelTimeSenseSELayer, make_channel_attention)
from generative_audio_torch.nn.recurrent import LSTMLayer, SequenceModel  # noqa: F401
from generative_audio_torch.nn.tcn import TCNBlock, TCNStack  # noqa: F401
from generative_audio_torch.nn.unet import (  # noqa: F401
    RestorationWrapper, UNet, UNet2, UNetConfig, resize_align_corners)
