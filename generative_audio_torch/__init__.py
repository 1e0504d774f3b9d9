"""PyTorch/CUDA port of generative_audio_tpu, the FullSubNet+ serving path first.

The layout follows the JAX package: `ops/` (STFT, masks, norms, sub-band ops and the
LSTM scan wrappers), `nn/` (TSSE, TCN, sequence models), `models/` (FullSubNet+),
`eval/` (the Inferencer), `utils/` (device choice, weight conversion), `data/`
(wav I/O) and `csrc/` (the CUDA kernels, built with nvcc at first use).

Importing the package builds nothing and touches no device. The entry points
(`FullSubNetPlus`, `Inferencer`) run on CUDA unless the caller passes
`device="cpu"`, and raise when no CUDA device is found.
"""
