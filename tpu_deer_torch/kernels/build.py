"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `build/kernels/lib<name>_<hash>.so` under the repository root (the
directory is git-ignored). The file name carries a hash of the source and
of every header in `csrc/` (`*.cuh`), so an edited kernel or header is
rebuilt and a built one is reused. Nothing is compiled at import time:
`load_library` builds at first use.

Only sm_90a (Hopper) is targeted. There is no fallback: a missing nvcc or a
failed build raises. `current_stream` gives the wrappers the stream to
launch on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless it is built already.

    Returns nvcc's report (register and shared-memory use from `-Xptxas -v`),
    or "" when the library was already built."""
    target = _target(name)
    if target.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
         str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing
    return proc.stdout


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(_target(name)))
    return _loaded[name]


def current_stream(card: int) -> int:
    """PyTorch's current stream on CUDA device `card`, as a cudaStream_t.
    The raw call skips the Python layer of
    torch.cuda.current_stream(device).cuda_stream, a few microseconds a
    call, which counts against a kernel of tens of microseconds."""
    return torch._C._cuda_getCurrentRawStream(card)
