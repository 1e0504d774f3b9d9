"""Device choice and float32 precision flags for the port's entry points,
and the timer on the card that chip_smoke.py and the port's scripts use."""
from __future__ import annotations

import contextlib
from typing import Union

import torch

__all__ = ["resolve_device", "conv_tf32", "cuda_ms"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Map `None` or "cuda" to a CUDA device and raise when there is none.

    The CPU is used only when the caller asks for it (`device="cpu"`); there
    is no silent fallback. On CUDA this sets the float32 precision flags:
    `torch.backends.cuda.matmul.allow_tf32 = False` and
    `torch.backends.cudnn.allow_tf32 = False`, so the float32 parts of the
    path (STFT, norms, TSSE, the TCN's norms) compute in full float32 as the
    JAX reference does. The bf16 parts (projections, TCN 1x1 convs, the LSTM)
    are unaffected by these flags.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def conv_tf32(enabled: bool = True):
    """cuDNN's float32 convolutions with TF32 (`enabled`, torch's default)
    or in full float32 inside the block, and the flag as it was after it.
    The inpainting line's trainers and validators run their UNets' forward
    and backward inside it with TF32; resolve_device turns the flag off for
    the rest of the port."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of fn on the card over `iters` calls
    after `warmup` calls, by CUDA events around the whole run."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
