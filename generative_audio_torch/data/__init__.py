"""Host-side data: audio I/O, SNR mixing, synthetic RIRs, the training,
validation, inference and inpainting datasets, the image datasets, batch
loading, the LibriSpeech downloader and the native audio binding. Importing
it builds nothing."""
from generative_audio_torch.data.audio_io import (  # noqa: F401
    load_audio, read_wav, resample, to_mono, write_wav)
from generative_audio_torch.data.mixing import (  # noqa: F401
    build_noise_track, mix_with_snr, snr_mix, speed_perturb)
from generative_audio_torch.data.audio_dataset import (  # noqa: F401
    AudioDataSetConfig, AudioDataset)
from generative_audio_torch.data.dns_dataset import (  # noqa: F401
    DNSTrainConfig, DNSTrainDataset, DNSValidationDataset, InferenceDataset,
    parse_snr_range)
from generative_audio_torch.data.download import (  # noqa: F401
    LIBRISPEECH_URLS, download_librispeech)
from generative_audio_torch.data.image_data import (  # noqa: F401
    CelebAHQ256DataModule, CelebASRFlowDataModule, DatasetWrapper,
    ImageFilesDataset, MNISTDataModule, PairsDataset, SubsetDataset,
    crop_scaled_pair, make_data_module, split_batch, split_dataset,
    synthetic_digits)
from generative_audio_torch.data.inpainting_dataset import (  # noqa: F401
    AudioInpaintingConfig, AudioInpaintingDataset, AudioInpaintingSample,
    collate_inpainting, time_to_spec_mask)
from generative_audio_torch.data.loader import BatchLoader, LoopIterator  # noqa: F401
from generative_audio_torch.data.rir import image_source_rir, make_rir_bank  # noqa: F401
from generative_audio_torch.data.sample_generator import (  # noqa: F401
    TestSampleGenerator, write_synthetic_corpus)
from generative_audio_torch.data import native  # noqa: F401
