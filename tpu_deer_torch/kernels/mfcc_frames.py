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

from tpu_deer_torch.kernels.build import current_stream, load_library
from tpu_deer_torch.kernels.mfcc_signal import check_bases, launch_args

EPS = 1e-10
SUPPORTED_N_FFT = (512, 1024)  # the kernel's template instances


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("mfcc_frames")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mfcc_frames_launch.argtypes = [i32] + [ptr] * 10 + [i32] * 5 + [ptr]
    lib.mfcc_frames_launch.restype = i32
    lib.mfcc_frames_config.argtypes = [i32] * 4 + [ptr]
    lib.mfcc_frames_config.restype = i32
    lib.mfcc_frames_error_string.argtypes = [i32]
    lib.mfcc_frames_error_string.restype = ctypes.c_char_p
    return lib


def _check(frames: torch.Tensor, n_fft: int) -> None:
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
    _check(frames, n_fft)
    if frames.device.type == "cpu":
        check_bases(bases, n_fft, frames.device)
        return mfcc_frames_plain(frames, bases, n_fft)
    pointers, n_mels, n_mfcc, blocks = launch_args(bases, n_fft, frames.device,
                                                   launch_config)
    lib = _library()
    card = frames.device.index
    rows = frames.shape[0]
    mfcc, logmel, power = (frames.new_empty((rows, width))
                           for width in (n_mfcc, n_mels, n_fft // 2 + 1))
    rc = lib.mfcc_frames_launch(
        card, frames.data_ptr(), *pointers, mfcc.data_ptr(), logmel.data_ptr(),
        power.data_ptr(), rows, n_fft, n_mels, n_mfcc, blocks,
        current_stream(card),
    )
    if rc != 0:
        raise RuntimeError(
            f"mfcc_frames launch failed: "
            f"{lib.mfcc_frames_error_string(rc).decode()} ({rc})"
        )
    mfcc_frames.launches += 1
    return mfcc, logmel, power


mfcc_frames.launches = 0


@functools.lru_cache(maxsize=None)
def launch_config(card: int, n_fft: int, n_mels: int,
                  n_mfcc: int) -> tuple[int, int]:
    """(dynamic shared memory of a block in bytes, blocks the card holds at
    once: the grid of a launch, whose warps walk over rows) for K2 at these
    sizes on CUDA device `card`. Sets the kernel's shared-memory limit
    there, so it runs once per card and shape before the first launch;
    launches nothing."""
    lib = _library()
    out = (ctypes.c_int * 2)()
    rc = lib.mfcc_frames_config(card, n_fft, n_mels, n_mfcc, out)
    if rc != 0 or out[1] < 1:
        raise RuntimeError(f"mfcc_frames_config failed: "
                           f"{lib.mfcc_frames_error_string(rc).decode()} "
                           f"({rc}, {out[1]} blocks fit)")
    return out[0], out[1]
