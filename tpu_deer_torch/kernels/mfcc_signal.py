"""K1: the fused MFCC-from-signal kernel, its wrapper and its plain twin.

Replaces `tpu_deer/ops/audio_frontend.py:_mfcc_signal_kernel` (the Pallas
kernel launched by `_mfcc_signal_pallas`). The CUDA source is
`csrc/mfcc_signal.cu`; its header comment says what bounds it on the card
and how the design answers that.

`mfcc_signal` is the wrapper: for a CUDA tensor it launches the kernel (or
raises), for a CPU tensor it runs `mfcc_signal_plain`, the same function
written with unfold and matmuls like the reference's `path="frames"`.
`mfcc_signal.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_deer_torch.kernels.build import load_library

EPS = 1e-10


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("mfcc_signal")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mfcc_signal_launch.argtypes = [i32] + [ptr] * 10 + [i32] * 7 + [ptr]
    lib.mfcc_signal_launch.restype = i32
    lib.mfcc_signal_error_string.argtypes = [i32]
    lib.mfcc_signal_error_string.restype = ctypes.c_char_p
    return lib


def _check(x_pad: torch.Tensor, bases: dict, n_fft: int, hop: int) -> None:
    if n_fft % hop != 0:
        raise ValueError(
            f"the fused MFCC kernel needs n_fft % hop == 0, got {n_fft}/{hop}"
        )
    if x_pad.dim() != 2:
        raise ValueError(f"x_pad must be [B, Tp], got shape {tuple(x_pad.shape)}")
    if x_pad.dtype != torch.float32:
        raise TypeError(f"x_pad must be float32, got {x_pad.dtype}")
    if not x_pad.is_contiguous():
        raise ValueError("x_pad must be contiguous")
    if x_pad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x_pad.device}")
    if x_pad.shape[0] < 1 or x_pad.shape[1] < n_fft:
        raise ValueError(
            f"x_pad [B, Tp] needs B >= 1 and Tp >= n_fft={n_fft}, "
            f"got {tuple(x_pad.shape)}"
        )
    check_bases(bases, n_fft, x_pad.device)


def check_bases(bases: dict, n_fft: int, device: torch.device) -> None:
    """Raise unless `bases` are audio_frontend._device_bases for this n_fft,
    contiguous float32 on `device` (K1 and K2 read the same bases)."""
    n_bins = n_fft // 2 + 1
    n_mels, n_mfcc = bases["dct"].shape
    # The bases (audio_frontend._device_bases) the two paths read.
    shapes = {
        "window": (n_fft,), "cos": (n_fft, n_bins), "sin": (n_fft, n_bins),
        "cos_w": (n_fft, n_bins), "sin_w": (n_fft, n_bins),
        "win_sq": (n_fft,), "mel": (n_bins, n_mels), "dct": (n_mels, n_mfcc),
    }
    for key, shape in shapes.items():
        t = bases[key]
        if tuple(t.shape) != shape:
            raise ValueError(f"bases[{key!r}] has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"bases[{key!r}] must be contiguous float32")
        if t.device != device:
            raise ValueError(f"bases[{key!r}] is on {t.device}, "
                             f"the input on {device}")


def mfcc_signal_plain(x_pad: torch.Tensor, bases: dict, n_fft: int, hop: int):
    """Plain PyTorch K1: frames by unfold, window, then matmuls.

    Same arithmetic as the reference's `path="frames"` (mfcc_frames on
    gathered frames + _timefeats_from_frames). The ZCR divides by a tensor,
    not a Python number: PyTorch's CUDA division by a host scalar multiplies
    by its reciprocal, which can differ from the kernel's division in the
    last bit.
    """
    frames = x_pad.unfold(-1, n_fft, hop)  # [B, N, n_fft] view, no copy
    w = frames * bases["window"]
    re = torch.matmul(w, bases["cos"])
    im = torch.matmul(w, bases["sin"])
    power = re * re + im * im
    logmel = torch.log(torch.clamp(torch.matmul(power, bases["mel"]), min=EPS))
    mfcc = torch.matmul(logmel, bases["dct"])
    rms = torch.sqrt(torch.mean(torch.square(w), dim=-1))
    changes = (torch.diff(torch.sign(frames), dim=-1) != 0).sum(dim=-1)
    denom = torch.full((), n_fft - 1, dtype=torch.float32, device=x_pad.device)
    zcr = changes.to(torch.float32) / denom
    return mfcc, logmel, power, torch.stack([rms, zcr], dim=-1)


def mfcc_signal(x_pad: torch.Tensor, bases: dict, n_fft: int, hop: int):
    """x_pad [B, Tp] (reflect-padded) → (mfcc [B,N,n_mfcc], logmel
    [B,N,n_mels], power [B,N,n_fft/2+1], timefeats [B,N,2]), all float32.

    A CUDA tensor launches kernel K1; a CPU tensor takes the plain twin.
    """
    _check(x_pad, bases, n_fft, hop)
    if x_pad.device.type == "cpu":
        return mfcc_signal_plain(x_pad, bases, n_fft, hop)
    lib = _library()
    n_mels, n_mfcc = bases["dct"].shape
    B, Tp = x_pad.shape
    n = 1 + (Tp - n_fft) // hop  # frames, as frame_signal counts them
    empty = lambda width: torch.empty(
        (B, n, width), dtype=torch.float32, device=x_pad.device)
    mfcc, logmel = empty(n_mfcc), empty(n_mels)
    power, timefeats = empty(n_fft // 2 + 1), empty(2)
    stream = torch.cuda.current_stream(x_pad.device).cuda_stream
    with torch.cuda.device(x_pad.device):
        rc = lib.mfcc_signal_launch(
            x_pad.device.index, x_pad.data_ptr(), bases["cos_w"].data_ptr(),
            bases["sin_w"].data_ptr(), bases["mel"].data_ptr(),
            bases["dct"].data_ptr(), bases["win_sq"].data_ptr(),
            mfcc.data_ptr(), logmel.data_ptr(), power.data_ptr(),
            timefeats.data_ptr(), B, Tp, n, n_fft, hop, n_mels, n_mfcc,
            stream,
        )
    mfcc_signal.launches += 1
    if rc != 0:
        raise RuntimeError(
            f"mfcc_signal launch failed: "
            f"{lib.mfcc_signal_error_string(rc).decode()} ({rc})"
        )
    return mfcc, logmel, power, timefeats


mfcc_signal.launches = 0
