"""PyTorch/CUDA port of generative_audio_tpu: FullSubNet+ serving and training,
the denoising and inpainting NPPC lines, and the image restoration and
image NPPC lines.

The layout follows the JAX package: `ops/` (STFT, masks, norms, sub-band ops and the
LSTM scan wrappers with their autograd Function), `nn/` (TSSE, TCN, sequence models,
the inpainting UNets, the image nets), `models/` (FullSubNet+, the NPPC models, the
image restoration and image NPPC models), `losses.py`, `train/`
(optimizer state, checkpoints, the enhancement, restoration, NPPC and image trainers),
`eval/` (the Inferencer, metrics, the validators, the transcription hooks), `utils/`
(device choice, weight conversion both ways, config, logging, tracking, the report),
`data/` (audio I/O, mixing, datasets, the image datasets, the batch loader, the
LibriSpeech downloader, the native audio binding),
`parallel/` (the multi-process job on torch.distributed, the device mesh, each
rank's rows), `cli/` (inference, training, the multi-process launcher, validation,
metrics, corpus tools) and `csrc/` (the CUDA kernels, built with nvcc at first use).

Importing the package builds nothing and touches no device. The entry points
(`FullSubNetPlus`, `Inferencer`, `EnhanceTrainer`) run on CUDA unless the caller
passes `device="cpu"`, and raise when no CUDA device is found.
"""
