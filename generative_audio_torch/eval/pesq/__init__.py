"""From-scratch ITU-T P.862 / P.862.2 (PESQ) implementation.

The port's own copy of generative_audio_tpu/eval/pesq/ (numpy and scipy
only, the same arithmetic, so a score equals the JAX package's exactly).
Without the `pesq` wheel, the reference's headline
quality metric (audio_zen/metrics.py:92-116) is reimplemented from the
published standard: buffer/level conventions (common.py), input and
alignment filters (filters.py), VAD + utterance time alignment
(align.py), derived Bark band tables (tables.py), the psychoacoustic
model (perceptual.py) and the end-to-end measure + MOS-LQO mappings
(core.py).

Scores are a calibrated reconstruction, pinned by committed golden
vectors (tests/test_pesq.py) and cross-checked against the `pesq`
wheel by a gated parity test whenever one is installed.
"""
from .core import PesqError, pesq, pesq_measure

__all__ = ["pesq", "pesq_measure", "PesqError"]
