"""ctypes bindings for the native WAV decoder (`native/wavio.cpp`).

The port's own copy of the reference's `tpu_deer/data/native.py`. The
library is built at first use with g++ and the flags of `native/Makefile`
into `build/native/libwavio_<hash>.so` under the repository root (git-
ignored; the hash covers the source and the flags, so an edited source is
rebuilt), never into `native/`. Where the build or the load fails, the
decoder is unavailable: `load_wav_native` returns None, with one warning,
and the caller falls back to scipy, as the reference does.

`wav_read` decodes PCM 8/16/24/32-bit and float32 wavs, mixes to mono and
resamples (a 33-tap windowed-sinc low-pass when downsampling, then linear
interpolation) in one pass. ctypes releases the GIL for the call, so a
thread pool decodes in parallel.
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
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "wavio.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path() -> Path:
    """Where the library for the current source and flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libwavio_{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile `native/wavio.cpp` unless it is built already; raises on a
    missing compiler or a failed build."""
    target = library_path()
    if target.exists():
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing
    return target


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded decoder, built first if needed; None (after one warning)
    where it cannot be built or loaded."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
            lib.wav_read.restype = ctypes.c_long
            lib.wav_read.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_long]
            _lib = lib
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logger.warning(f"native wav decoder unavailable, decoding with "
                           f"scipy: {e}")
            _failed = True
    return _lib


def load_wav_native(path: str, target_sr: int = 16000) -> Optional[np.ndarray]:
    """Mono float32 at `target_sr` through the C library; None where the
    library is unavailable or the file cannot be decoded."""
    lib = get_lib()
    if lib is None:
        return None
    encoded = os.fsencode(path)
    n = lib.wav_read(encoded, target_sr, None, 0)
    if n < 0:
        return None
    out = np.empty(n, dtype=np.float32)
    written = lib.wav_read(encoded, target_sr,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    if written < 0:
        return None
    return out[:written]
