"""Tensor ops of the main path, the LSTM and GRU kernel wrappers, the NPPC
Gram-Schmidt, the seven norms, the conv-STFT, multichannel features and
beamforming, and the host-side waveform utilities (numpy) of the data
pipelines."""
from generative_audio_torch.ops.gru import (  # noqa: F401
    GRUScan, gru_dwhh, gru_dwhh_reference, gru_layer_tm_chunked,
    gru_scan_bwd_reference_tm, gru_scan_bwd_streams_reference_tm,
    gru_scan_bwd_streams_tm, gru_scan_bwd_tm, gru_scan_carry_reference_tm,
    gru_scan_carry_tm, gru_scan_reference_tm, gru_scan_tm)
from generative_audio_torch.ops.lstm import (  # noqa: F401
    LSTMLayerScan, LSTMScan, launch_counts, lstm_layer_reference_tm,
    lstm_layer_tm, lstm_layer_tm_chunked, lstm_scan_bwd_reference_tm,
    lstm_scan_bwd_tm, lstm_scan_carry_reference_tm, lstm_scan_carry_tm,
    lstm_scan_reference_tm, lstm_scan_tm, lstm_scan_train_reference_tm,
    lstm_scan_train_tm, reset_launch_counts)
from generative_audio_torch.ops.gram_schmidt import (  # noqa: F401
    gram_schmidt, gram_schmidt_to_crm, gram_schmidt_to_spec_mag)
from generative_audio_torch.ops.mask import (  # noqa: F401
    EPSILON, apply_crm, build_complex_ideal_ratio_mask,
    build_complex_ideal_ratio_mask_ri, build_ideal_ratio_mask, complex_mul,
    compress_cIRM, crm_to_spectrogram, crm_to_stft_components,
    decompress_cIRM)
from generative_audio_torch.ops.norms import (  # noqa: F401
    cumulative_laplace_norm, cumulative_layer_norm, forgetting_norm,
    get_norm, hybrid_norm, offline_gaussian_norm, offline_laplace_norm,
    sband_forgetting_norm)
from generative_audio_torch.ops.stft import (  # noqa: F401
    audio_to_stft, frame_signal, hann_window, istft, istft_ri, mag_phase,
    mc_stft, prepare_input_from_waveform, stft, stft_real_imag, stft_ri)
from generative_audio_torch.ops.conv_stft import (  # noqa: F401
    conv_istft, conv_stft, conv_stft_kernel)
from generative_audio_torch.ops.multichannel import (  # noqa: F401
    ChannelDirectionalFeatureComputer, ChannelWiseLayerNorm,
    DirectionalFeatureComputer, compute_ipd)
from generative_audio_torch.ops.beamforming import (  # noqa: F401
    apply_beamforming_vector, apply_beamforming_vector_ri, apply_crf_filter,
    apply_crf_filter_ri, get_power_spectral_density_matrix,
    get_power_spectral_density_matrix_ri)
from generative_audio_torch.ops.subband import band_unfold, drop_band  # noqa: F401
from generative_audio_torch.ops import waveform  # noqa: F401
