"""The LibriSpeech downloader.

Port of generative_audio_tpu/data/download.py (reference
dataset/scripts/download_libri_speech_dataset.py, torchaudio's LIBRISPEECH
train-clean-360 + test-clean): plain urllib and tarfile. A subset already
extracted is skipped, an archive already in `dest_dir` is extracted without
a download, and a failed download raises, naming where to put the archive.
"""
from __future__ import annotations

import tarfile
import urllib.error
import urllib.request
from pathlib import Path
from typing import Sequence

__all__ = ["LIBRISPEECH_URLS", "download_librispeech"]

_BASE = "https://www.openslr.org/resources/12"
LIBRISPEECH_URLS = {
    "train-clean-100": f"{_BASE}/train-clean-100.tar.gz",
    "train-clean-360": f"{_BASE}/train-clean-360.tar.gz",
    "test-clean": f"{_BASE}/test-clean.tar.gz",
    "dev-clean": f"{_BASE}/dev-clean.tar.gz",
}


def download_librispeech(dest_dir, subsets: Sequence[str] =
                         ("train-clean-360", "test-clean"),
                         log=print) -> Path:
    """Download and extract LibriSpeech subsets into dest_dir/LibriSpeech/;
    returns that root."""
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    root = dest_dir / "LibriSpeech"
    for subset in subsets:
        if subset not in LIBRISPEECH_URLS:
            raise ValueError(f"unknown subset {subset!r}; "
                             f"choose from {sorted(LIBRISPEECH_URLS)}")
        if (root / subset).is_dir():
            log(f"{subset}: already extracted, skipping")
            continue
        url = LIBRISPEECH_URLS[subset]
        archive = dest_dir / f"{subset}.tar.gz"
        if not archive.exists():
            log(f"downloading {url} ...")
            try:
                urllib.request.urlretrieve(url, archive)
            except (urllib.error.URLError, OSError) as e:
                raise RuntimeError(
                    f"cannot download {url}; fetch the archive by other "
                    f"means into {archive}") from e
        log(f"extracting {archive} ...")
        with tarfile.open(archive) as tf:
            tf.extractall(dest_dir, filter="data")
    return root
