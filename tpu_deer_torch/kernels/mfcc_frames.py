"""K2: the fused MFCC-from-frames kernel, its wrapper and its plain twin.

Replaces `tpu_deer/ops/audio_frontend.py:_mfcc_kernel` (the Pallas kernel
launched by `_mfcc_pallas`). The CUDA source is `csrc/mfcc_frames.cu`; its
header comment says what bounds it on the card and how the design answers
that. Its caller is the streaming tick: one launch for the frames of every
stream.

`mfcc_frames` is the wrapper: for a CUDA tensor it launches the kernel (or
raises), for a CPU tensor it runs `mfcc_frames_plain`, the reference's
`_power_spectrum_xla` + `_mfcc_from_power` written with matmuls.
`mfcc_frames.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_deer_torch.kernels.build import load_library
from tpu_deer_torch.kernels.mfcc_signal import check_bases

EPS = 1e-10
SUPPORTED_N_FFT = (512, 1024)  # the kernel's template instances


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("mfcc_frames")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mfcc_frames_launch.argtypes = [i32] + [ptr] * 8 + [i32] * 4 + [ptr]
    lib.mfcc_frames_launch.restype = i32
    lib.mfcc_frames_error_string.argtypes = [i32]
    lib.mfcc_frames_error_string.restype = ctypes.c_char_p
    return lib


def _check(frames: torch.Tensor, bases: dict, n_fft: int) -> None:
    if n_fft not in SUPPORTED_N_FFT:
        raise ValueError(f"the fused MFCC-from-frames kernel supports n_fft "
                         f"in {SUPPORTED_N_FFT}, got {n_fft}")
    if frames.dim() != 2 or frames.shape[0] < 1 or frames.shape[1] != n_fft:
        raise ValueError(f"frames must be [R >= 1, n_fft={n_fft}], got shape "
                         f"{tuple(frames.shape)}")
    if frames.dtype != torch.float32:
        raise TypeError(f"frames must be float32, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {frames.device}")
    if frames.device.type == "cuda" and frames.data_ptr() % 16:
        raise ValueError("frames must start on a 16-byte boundary (the "
                         "kernel loads them as float4)")
    check_bases(bases, n_fft, frames.device)


def mfcc_frames_plain(frames: torch.Tensor, bases: dict, n_fft: int):
    """Plain PyTorch K2: window, then matmuls (the reference's XLA path)."""
    w = frames * bases["window"]
    re = torch.matmul(w, bases["cos"])
    im = torch.matmul(w, bases["sin"])
    power = re * re + im * im
    logmel = torch.log(torch.clamp(torch.matmul(power, bases["mel"]), min=EPS))
    mfcc = torch.matmul(logmel, bases["dct"])
    return mfcc, logmel, power


def mfcc_frames(frames: torch.Tensor, bases: dict, n_fft: int):
    """frames [R, n_fft] → (mfcc [R, n_mfcc], logmel [R, n_mels],
    power [R, n_fft/2+1]), all float32.

    A CUDA tensor launches kernel K2; a CPU tensor takes the plain twin.
    """
    _check(frames, bases, n_fft)
    if frames.device.type == "cpu":
        return mfcc_frames_plain(frames, bases, n_fft)
    lib = _library()
    n_mels, n_mfcc = bases["dct"].shape
    rows = frames.shape[0]
    empty = lambda width: torch.empty(
        (rows, width), dtype=torch.float32, device=frames.device)
    mfcc, logmel, power = empty(n_mfcc), empty(n_mels), empty(n_fft // 2 + 1)
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    with torch.cuda.device(frames.device):
        rc = lib.mfcc_frames_launch(
            frames.device.index, frames.data_ptr(), bases["cos_w"].data_ptr(),
            bases["sin_w"].data_ptr(), bases["mel"].data_ptr(),
            bases["dct"].data_ptr(), mfcc.data_ptr(), logmel.data_ptr(),
            power.data_ptr(), rows, n_fft, n_mels, n_mfcc, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"mfcc_frames launch failed: "
            f"{lib.mfcc_frames_error_string(rc).decode()} ({rc})"
        )
    mfcc_frames.launches += 1
    return mfcc, logmel, power


mfcc_frames.launches = 0
