"""Host-side data: audio I/O and the inference dataset."""
from generative_audio_torch.data.audio_io import (  # noqa: F401
    load_audio, read_wav, resample, to_mono, write_wav)
from generative_audio_torch.data.dns_dataset import InferenceDataset  # noqa: F401
