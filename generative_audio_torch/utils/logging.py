"""The console logger of the port's command-line tools. The port's own copy
of generative_audio_tpu/utils/logging.py:get_logger."""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger"]


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
