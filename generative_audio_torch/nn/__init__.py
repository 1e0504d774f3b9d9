"""Blocks of the serving path (channel attention, TCN, sequence models),
the complex sequence model, the causal conv blocks, the inpainting line's
UNets and the image line's nets."""
from generative_audio_torch.nn.attention import (  # noqa: F401
    ChannelCBAMLayer, ChannelDeepTimeSenseSELayer, ChannelECALayer,
    ChannelSELayer, ChannelTimeSenseAttentionSELayer, ChannelTimeSenseSELayer,
    ChannelTimeSenseSEWeightLayer, ConvAttentionBlock, SelfAttentionLayer,
    make_channel_attention)
from generative_audio_torch.nn.image_nets import (  # noqa: F401
    AttentionBlock, ImageUNet, ResBlock, ResCNN, ResUNet, pixel_shuffle)
from generative_audio_torch.nn.recurrent import (  # noqa: F401
    ComplexSequenceModel, GRULayer, LSTMLayer, SequenceModel)
from generative_audio_torch.nn.tcn import (  # noqa: F401
    CausalConvBlock, CausalTransConvBlock, TCNBlock, TCNStack)
from generative_audio_torch.nn.unet import (  # noqa: F401
    RestorationWrapper, UNet, UNet2, UNetConfig, resize_align_corners)
