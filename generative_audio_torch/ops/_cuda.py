"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source in `generative_audio_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface and loaded with
`ctypes`; the headers they share (csrc/*.cuh) are found beside them. The
library is cached in `generative_audio_torch/_build/` (listed in .gitignore)
under a name that carries a hash of the source, the headers and the flags,
so an edited source is rebuilt. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "SOURCES", "find_nvcc", "build", "load",
           "check", "stream_handle"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, else PATH, else the toolkit torch was built against."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: List[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, one nvcc process
    per source, all started together. Returns each source's ptxas report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    reports = {}
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, lib)            # atomic: a reader never sees half a file
        reports[name] = log
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _declare(name, lib)
            _libs[name] = lib
        return lib


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "lstm_scan": {
        "lstm_scan_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "lstm_scan_fwd_carry": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _P],
        "lstm_scan_fwd_train": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "lstm_scan_staged": {
        "lstm_scan_fwd_unrolled": [_P, _P, _P, _I, _I, _I, _I, _P],
        "lstm_layer_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "lstm_scan_bwd": {
        "lstm_scan_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "lstm_scan_bwd_chains": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _P],
    },
    "gru_scan": {
        # ..., reverse, then the launch plan: cluster, rows, shared bytes
        "gru_scan_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "gru_scan_fwd_carry": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _P],
    },
    "gru_scan_bwd": {
        "gru_scan_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _P],
        "gru_scan_bwd_dwhh": [_P, _P, _P, _P, _I, _I, _I, _P],
    },
}
SOURCES = tuple(_SIGNATURES)
# Queries that launch nothing: (out_f32, carry, H, cluster, rows, int* n).
_QUERIES = {
    "gru_scan": {
        "gru_scan_max_clusters": [_I, _I, _I, _I, _I,
                                  ctypes.POINTER(ctypes.c_int)],
    },
}


def _declare(name: str, lib: ctypes.CDLL) -> None:
    for fn, argtypes in {**_SIGNATURES[name], **_QUERIES.get(name, {})}.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    err_fn = getattr(lib, f"{name}_error_string")
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p


def check(name: str, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = getattr(load(name), f"{name}_error_string")(err)
        raise RuntimeError(f"{what}: CUDA error {err}: {msg.decode()}")


def stream_handle(device) -> int:
    """The raw cudaStream_t of torch's current stream on `device`."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
