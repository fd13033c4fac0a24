"""K1: the fused MFCC-from-signal kernel, its wrapper and its plain twin.

Replaces `tpu_deer/ops/audio_frontend.py:_mfcc_signal_kernel` (the Pallas
kernel launched by `_mfcc_signal_pallas`). The CUDA source is
`csrc/mfcc_signal.cu`; its header comment says what bounds it on the card
and how the design answers that.

`mfcc_signal` is the wrapper: for a CUDA tensor it launches the kernel (or
raises), for a CPU tensor it runs `mfcc_signal_plain`, the same function
written with unfold and matmuls like the reference's `path="frames"`.
`mfcc_signal.launches` counts kernel launches. The kernel's FFT takes a
power-of-two n_fft in `SUPPORTED_N_FFT`; the plain twin takes any n_fft.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_deer_torch.kernels.build import current_stream, load_library

EPS = 1e-10
SUPPORTED_N_FFT = (512, 1024, 2048)  # the kernel's template instances


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("mfcc_signal")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mfcc_signal_launch.argtypes = [i32] + [ptr] * 11 + [i32] * 8 + [ptr]
    lib.mfcc_signal_launch.restype = i32
    lib.mfcc_signal_config.argtypes = [i32] * 4 + [ptr]
    lib.mfcc_signal_config.restype = i32
    lib.mfcc_signal_error_string.argtypes = [i32]
    lib.mfcc_signal_error_string.restype = ctypes.c_char_p
    return lib


def _check(x_pad: torch.Tensor, n_fft: int, hop: int) -> None:
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
    if x_pad.device.type == "cuda" and n_fft not in SUPPORTED_N_FFT:
        raise ValueError(f"the fused MFCC kernel's FFT needs a power-of-two "
                         f"n_fft in {SUPPORTED_N_FFT}, got {n_fft}")


def check_bases(bases: dict, n_fft: int, device: torch.device) -> None:
    """Raise unless `bases` are audio_frontend._device_bases for this n_fft,
    contiguous on `device` (K1 and K2 read the same bases)."""
    n_bins = n_fft // 2 + 1
    n_mels, n_mfcc = bases["dct"].shape
    # The bases (audio_frontend._device_bases) the two paths read.
    shapes = {
        "window": (n_fft,), "cos": (n_fft, n_bins), "sin": (n_fft, n_bins),
        "mel": (n_bins, n_mels), "mel_band": (2, n_mels),
        "dct": (n_mels, n_mfcc),
    }
    for key, shape in shapes.items():
        t = bases[key]
        dtype = torch.int32 if key == "mel_band" else torch.float32
        if tuple(t.shape) != shape:
            raise ValueError(f"bases[{key!r}] has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"bases[{key!r}] must be contiguous {dtype}")
        if t.device != device:
            raise ValueError(f"bases[{key!r}] is on {t.device}, "
                             f"the input on {device}")


def kernel_bases(bases: dict) -> tuple:
    """The device pointers K1 and K2 take from the bases, in their order:
    row 1 of cos and sin (the FFT's twiddles), window, mel, the band table,
    dct."""
    row = 4 * bases["cos"].shape[1]  # bytes: row 1 starts one row in
    return (bases["cos"].data_ptr() + row, bases["sin"].data_ptr() + row,
            bases["window"].data_ptr(), bases["mel"].data_ptr(),
            bases["mel_band"].data_ptr(), bases["dct"].data_ptr())


_KERNEL_KEYS = ("cos", "sin", "window", "mel", "mel_band", "dct")
_launch_args: dict = {}  # (id(bases), n_fft, device, kernel) -> (tensors, args)


def launch_args(bases: dict, n_fft: int, device: torch.device,
                config) -> tuple:
    """(the bases' pointers (kernel_bases), n_mels, n_mfcc, blocks) for a
    launch on `device`, after check_bases and the kernel's
    launch_config(card, n_fft, n_mels, n_mfcc) -> (smem, blocks). A dict
    already checked at this n_fft on this device that still holds the same
    tensors is not checked again: the front-end passes the same cached dict
    (audio_frontend._device_bases) every time, and the wrappers' host time
    is most of a stream tick's K2 call."""
    key = (id(bases), n_fft, device, config)
    tensors = tuple(bases[k] for k in _KERNEL_KEYS)
    hit = _launch_args.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], tensors)):
        return hit[1]
    check_bases(bases, n_fft, device)
    n_mels, n_mfcc = bases["dct"].shape
    _, blocks = config(device.index, n_fft, n_mels, n_mfcc)
    args = (kernel_bases(bases), n_mels, n_mfcc, blocks)
    if len(_launch_args) >= 64:
        _launch_args.clear()
    _launch_args[key] = (tensors, args)
    return args


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
    _check(x_pad, n_fft, hop)
    if x_pad.device.type == "cpu":
        check_bases(bases, n_fft, x_pad.device)
        return mfcc_signal_plain(x_pad, bases, n_fft, hop)
    pointers, n_mels, n_mfcc, blocks = launch_args(bases, n_fft, x_pad.device,
                                                   launch_config)
    lib = _library()
    card = x_pad.device.index
    B, Tp = x_pad.shape
    n = 1 + (Tp - n_fft) // hop  # frames, as frame_signal counts them
    mfcc, logmel, power, timefeats = (
        x_pad.new_empty((B, n, width))
        for width in (n_mfcc, n_mels, n_fft // 2 + 1, 2))
    rc = lib.mfcc_signal_launch(
        card, x_pad.data_ptr(), *pointers, mfcc.data_ptr(), logmel.data_ptr(),
        power.data_ptr(), timefeats.data_ptr(), B, Tp, n, n_fft, hop, n_mels,
        n_mfcc, blocks, current_stream(card),
    )
    mfcc_signal.launches += 1
    if rc != 0:
        raise RuntimeError(
            f"mfcc_signal launch failed: "
            f"{lib.mfcc_signal_error_string(rc).decode()} ({rc})"
        )
    return mfcc, logmel, power, timefeats


mfcc_signal.launches = 0


@functools.lru_cache(maxsize=None)
def launch_config(card: int, n_fft: int, n_mels: int,
                  n_mfcc: int) -> tuple[int, int]:
    """(dynamic shared memory of a block in bytes, blocks the card holds at
    once: the grid of a launch, which walks over tiles of 8 frames) for K1
    at these sizes on CUDA device `card`. Sets the kernel's shared-memory
    limit there, so it runs once per card and shape before the first
    launch; launches nothing."""
    lib = _library()
    out = (ctypes.c_int * 2)()
    rc = lib.mfcc_signal_config(card, n_fft, n_mels, n_mfcc, out)
    if rc != 0 or out[1] < 1:
        raise RuntimeError(f"mfcc_signal_config failed: "
                           f"{lib.mfcc_signal_error_string(rc).decode()} "
                           f"({rc}, {out[1]} blocks fit)")
    return out[0], out[1]
