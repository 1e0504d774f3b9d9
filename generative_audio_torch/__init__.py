"""PyTorch/CUDA port of generative_audio_tpu: FullSubNet+ serving and training,
and the denoising and inpainting NPPC lines.

The layout follows the JAX package: `ops/` (STFT, masks, norms, sub-band ops and the
LSTM scan wrappers with their autograd Function), `nn/` (TSSE, TCN, sequence models,
the inpainting UNets), `models/` (FullSubNet+, the NPPC models), `losses.py`, `train/`
(optimizer state, checkpoints, the enhancement, restoration and NPPC trainers),
`eval/` (the Inferencer, metrics, the validator), `utils/`
(device choice, weight conversion both ways, config, logging, tracking, the report),
`data/` (audio I/O, mixing, datasets, the batch loader, the native audio binding),
`cli/` (inference, training, validation, metrics, corpus tools) and `csrc/` (the CUDA
kernels, built with nvcc at first use).

Importing the package builds nothing and touches no device. The entry points
(`FullSubNetPlus`, `Inferencer`, `EnhanceTrainer`) run on CUDA unless the caller
passes `device="cpu"`, and raise when no CUDA device is found.
"""
