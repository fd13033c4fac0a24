"""K4: per-tensor int8 quantization with stochastic rounding, its wrappers
and its plain twins.

Replaces `tpu_deer/ops/quantization.py:quantize_int8_stochastic` (its Pallas
kernel). The CUDA source is `csrc/quantize_int8.cu`; its header comment says
what bounds it on the card and how the design answers that.

    scale = max(max |w|, 1e-8) * float32(1/127)           (float32 [1, 1])
    q     = clip(floor(w / scale + u), -127, 127)          (int8, w's shape)

with u = (bits >> 8) * 2^-24 from one 32-bit word per element. Two ways to
get the words:

- `quantize_int8_stochastic(w, seed)` draws them from Philox4x32-10: element
  e takes word e % 4 of the call at counter (lo32(e // 4), hi32(e // 4), 0,
  0) and key (lo32(seed), hi32(seed)). `philox4x32_10` below computes the
  same words in torch int64 arithmetic on any device, so the plain twin and
  the kernel give the same answer for a seed on either device.
- `quantize_int8_stochastic_bits(w, bits)` takes them from `bits`, an int32
  tensor of w's shape (the words reinterpreted; torch's uint32 has few
  ops). It is the counterpart of the reference's non-TPU body, which reads
  `jax.random.bits`: the tests feed both packages the same words and require
  equal outputs.

Each wrapper launches the kernel for a CUDA tensor (or raises) and runs its
plain twin for a CPU tensor; each counts its kernel calls in `.launches`.
Contiguous float32 only.

The kernel is one cooperative launch whose blocks each take a contiguous
share of w; `split` (pure, tested on the CPU) cuts w into those shares for
the card's resident blocks and shared memory (`launch_config`), and
`staged_capacity` is the largest w whose shares stay in shared memory whole.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpu_deer_torch.kernels.build import current_stream, load_library

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_INV127 = float(np.float32(1.0) / np.float32(127.0))  # exact in float32
# csrc/quantize_int8.cu: threads a block, and elements a 16-byte store of q
# holds (shares and stages are whole groups of them).
THREADS, GROUP = 1024, 16
# A block takes at least 4,096 elements (a group for a quarter of its
# threads): smaller w takes fewer blocks.
MIN_SHARE = 4096


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a · m for int64 a in [0, 2^32) and a 32-bit
    m, with m split in 16-bit halves so that no product passes 2^49."""
    p_lo, p_hi = a * (m & 0xFFFF), a * (m >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(counter: torch.Tensor, key: tuple[int, int]) -> torch.Tensor:
    """Philox4x32-10 (Random123) on int64 counters [..., 4] holding 32-bit
    words → words [..., 4], int64 in [0, 2^32), on the counters' device."""
    c = list(counter.unbind(-1))
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c[0], _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c[2], _PHILOX_M[1])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return torch.stack(c, -1)


def philox_bits(n: int, seed: int, device=None) -> torch.Tensor:
    """The n words that K4 draws for `seed`, as int32 [n] (the uint32 bits
    reinterpreted) on `device`."""
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zeros = torch.zeros_like(groups)
    counter = torch.stack([groups & _MASK32, groups >> 32, zeros, zeros], -1)
    words = philox4x32_10(counter, (seed & _MASK32, seed >> 32)).reshape(-1)[:n]
    return torch.where(words > 0x7FFFFFFF, words - 2**32, words).to(torch.int32)


def quantize_int8_stochastic_bits_plain(w: torch.Tensor, bits: torch.Tensor):
    """Plain PyTorch K4 on given words: the reference's `quantize_body` as
    XLA compiles it (the division by the constant 127 becomes a product with
    float32(1/127); w / scale stays a division)."""
    scale = torch.clamp(w.abs().amax(), min=1e-8) * _INV127
    u = ((bits >> 8) & 0xFFFFFF).to(torch.float32) * (1.0 / 16777216.0)
    q = torch.floor(w / scale + u).clamp_(-127, 127).to(torch.int8)
    return q, scale.reshape(1, 1)


def quantize_int8_stochastic_plain(w: torch.Tensor, seed: int = 0):
    """Plain PyTorch K4 on Philox words computed in torch on w's device."""
    bits = philox_bits(w.numel(), _check_seed(seed), w.device)
    return quantize_int8_stochastic_bits_plain(w, bits.reshape(w.shape))


def split(n: int, resident: int, stage_bytes: int) -> tuple[int, int, int]:
    """How K4 cuts w [n] into shares: (grid, share, staged). Block b of the
    grid rounds elements [b·share, min(n, (b + 1)·share)) and stages the
    first `staged` of them in shared memory; share and staged are multiples
    of GROUP (every share starts on a 64-byte boundary), grid <= resident
    (the blocks the card holds at once) and staged · 4 <= stage_bytes (the
    shared memory a block may stage, at least a MIN_SHARE's)."""
    if n < 1 or resident < 1 or stage_bytes < 4 * MIN_SHARE:
        raise ValueError(f"no split of {n} elements over {resident} blocks "
                         f"of {stage_bytes} B")
    cap = stage_bytes // (4 * GROUP) * GROUP
    grid = min(resident, -(-n // MIN_SHARE))
    per_block = -(-n // grid)
    share = -(-per_block // GROUP) * GROUP
    grid = -(-n // share)  # every block has an element
    return grid, share, min(share, cap)


def capacity(resident: int, stage_bytes: int) -> int:
    """The largest n whose split stages every element in shared memory."""
    return resident * (stage_bytes // (4 * GROUP) * GROUP)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("quantize_int8")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.quantize_int8_launch.argtypes = [i32] + [ptr] * 5 + [
        i64, i64, i32, i32, ctypes.c_ulonglong, ptr]
    lib.quantize_int8_launch.restype = i32
    lib.quantize_int8_config.argtypes = [i32, ptr]
    lib.quantize_int8_config.restype = i32
    lib.quantize_int8_error_string.argtypes = [i32]
    lib.quantize_int8_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def launch_config(card: int) -> tuple[int, int]:
    """(blocks CUDA device `card` holds at once, shared-memory bytes a block
    may stage) for K4. Sets the kernel's shared-memory limit there, so it
    runs once per card before the first launch; launches nothing."""
    lib = _library()
    out = (ctypes.c_int * 2)()
    rc = lib.quantize_int8_config(card, out)
    if rc != 0 or out[0] < 1:
        raise RuntimeError(f"quantize_int8_config failed: "
                           f"{lib.quantize_int8_error_string(rc).decode()} "
                           f"({rc}, {out[0]} blocks fit)")
    return out[0], out[1]


def staged_capacity(device) -> int:
    """The largest w (elements) that K4 stages in shared memory whole on
    CUDA device `device`; a larger one reads the rest of each share from L2."""
    device = torch.device(device)
    card = torch.cuda.current_device() if device.index is None else device.index
    return capacity(*launch_config(card))


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return seed


def _check(w: torch.Tensor, bits: torch.Tensor | None = None) -> None:
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    if w.numel() == 0:
        raise ValueError("w must not be empty")
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {w.device}")
    if bits is not None:
        if bits.dtype != torch.int32 or bits.shape != w.shape:
            raise TypeError(f"bits must be int32 of w's shape {tuple(w.shape)}, "
                            f"got {bits.dtype} {tuple(bits.shape)}")
        if not bits.is_contiguous() or bits.device != w.device:
            raise ValueError("bits must be contiguous on w's device")


def _launch(w: torch.Tensor, bits: torch.Tensor | None, seed: int):
    lib = _library()
    card = w.device.index
    n = w.numel()
    grid, share, staged = split(n, *launch_config(card))
    # Each block's max |w| (as bits) goes to a slot in q's buffer, past q
    # (16-byte aligned): at most 4 B per MIN_SHARE elements, and the scale
    # holds nothing but itself.
    slots = -(-n // GROUP) * GROUP
    buf = torch.empty(slots + 4 * grid, dtype=torch.int8, device=w.device)
    scale = torch.empty((1, 1), dtype=torch.float32, device=w.device)
    rc = lib.quantize_int8_launch(
        card, w.data_ptr(), None if bits is None else bits.data_ptr(),
        buf.data_ptr(), scale.data_ptr(), buf.data_ptr() + slots, n, share,
        staged, grid, seed, current_stream(card))
    if rc != 0:
        raise RuntimeError(f"quantize_int8 launch failed: "
                           f"{lib.quantize_int8_error_string(rc).decode()} ({rc})")
    return buf[:n].view(w.shape), scale


def quantize_int8_stochastic(w: torch.Tensor, seed: int = 0):
    """w (float32, any shape) → (int8 values of w's shape, float32 [1, 1]
    scale), rounding with Philox words keyed by `seed`. A CUDA tensor
    launches kernel K4; a CPU tensor takes the plain twin."""
    _check(w)
    seed = _check_seed(seed)
    if w.device.type == "cpu":
        return quantize_int8_stochastic_plain(w, seed)
    out = _launch(w, None, seed)
    quantize_int8_stochastic.launches += 1
    return out


def quantize_int8_stochastic_bits(w: torch.Tensor, bits: torch.Tensor):
    """As quantize_int8_stochastic, rounding with the given int32 words."""
    _check(w, bits)
    if w.device.type == "cpu":
        return quantize_int8_stochastic_bits_plain(w, bits)
    out = _launch(w, bits, 0)
    quantize_int8_stochastic_bits.launches += 1
    return out


quantize_int8_stochastic.launches = 0
quantize_int8_stochastic_bits.launches = 0
