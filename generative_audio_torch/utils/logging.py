"""Logging of the port's command-line tools and trainers. The port's own copy
of generative_audio_tpu/utils/logging.py: a console logger, a file handler
on it, a `log` function with the call shape of the reference's `print =
log` idiom, the ExecutionTime timer (audio_zen/utils.py:46-60) and
check_nan (audio_zen/utils.py:41-44), which takes a tensor or an array."""
from __future__ import annotations

import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["get_logger", "log", "init_logging_file", "ExecutionTime",
           "check_nan"]


def get_logger(name: str = "generative_audio_torch") -> logging.Logger:
    """An INFO logger writing "HH:MM:SS [LEVEL] message" lines to stdout."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def init_logging_file(path, name: str = "generative_audio_torch"
                      ) -> logging.Logger:
    """Attach a file handler writing to `path` to the logger `name`."""
    logger = get_logger(name)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s [%(levelname)s] %(message)s"))
    logger.addHandler(handler)
    return logger


def log(*args, **kwargs):
    """Drop-in for the reference's `print = log` idiom."""
    get_logger().info(" ".join(str(a) for a in args))


class ExecutionTime:
    """Wall-clock timer from construction. Ref audio_zen/utils.py:46-60."""

    def __init__(self):
        self.start_time = time.time()

    def duration(self) -> float:
        return time.time() - self.start_time


def check_nan(tensor, name: str = "tensor"):
    """Raise if `tensor` (a torch tensor, on any device, or anything numpy
    takes) holds a NaN; else return it. Ref audio_zen/utils.py:41-44."""
    if isinstance(tensor, torch.Tensor):
        found = bool(torch.isnan(tensor).any())
    else:
        found = bool(np.isnan(np.asarray(tensor)).any())
    if found:
        raise ValueError(f"Found NaN in {name}")
    return tensor
