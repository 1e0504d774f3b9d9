"""Host-side data: wav I/O."""
from generative_audio_torch.data.audio_io import read_wav, write_wav  # noqa: F401
