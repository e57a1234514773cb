"""ctypes bindings for the host audio front end (``native/audiokit.cpp``).

Counterpart of the JAX package's ``native``: the same C++ log-mel and peak
normalization. The library is built at first use with ``g++`` into
``build/audiokit/`` at the repository root (named by a digest of the source,
written under a temporary name and renamed, so concurrent processes never
load a half-written file), never into the package. Without a compiler the
entry points return None / False and the caller falls back to its own host
code. ctypes releases the GIL during a call, so the loader's worker threads
extract features in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_logger = logging.getLogger(__name__)
SOURCE = Path(__file__).resolve().parent / "audiokit.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "audiokit"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib: ctypes.CDLL | None = None
_load_attempted = False
_lock = threading.Lock()


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libaudiokit_{digest}.so"


def _build(out: Path) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        _logger.info("audiokit build skipped: no g++ on PATH")
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        _logger.info("audiokit build failed: %s", exc)
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built on first use; None when it cannot be built."""
    global _lib, _load_attempted
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        path = lib_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            _logger.info("audiokit load failed: %s", exc)
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.audiokit_log_mel.restype = ctypes.c_int
        lib.audiokit_log_mel.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, f32p]
        lib.audiokit_mel_frames.restype = ctypes.c_int64
        lib.audiokit_mel_frames.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.audiokit_normalize_peak.restype = None
        lib.audiokit_normalize_peak.argtypes = [f32p, ctypes.c_int64]
        _lib = lib
        _logger.info("audiokit native library loaded from %s", path)
        return _lib


def available() -> bool:
    return get_lib() is not None


def log_mel(audio: np.ndarray, sample_rate: int, n_fft: int, hop: int,
            win_length: int, n_mels: int) -> np.ndarray | None:
    """Native log-mel ``[n_mels, T]``; None when the library is unavailable or refuses."""
    lib = get_lib()
    if lib is None:
        return None
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    t_frames = int(lib.audiokit_mel_frames(len(audio), hop))
    out = np.empty((n_mels, t_frames), dtype=np.float32)
    rc = lib.audiokit_log_mel(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(audio), sample_rate, n_fft,
        hop, win_length, n_mels, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def normalize_peak_inplace(audio: np.ndarray) -> bool:
    """Peak-normalize a contiguous f32 array in place; False when it could not."""
    lib = get_lib()
    if lib is None or audio.dtype != np.float32 or not audio.flags.c_contiguous:
        return False
    lib.audiokit_normalize_peak(audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(audio))
    return True
