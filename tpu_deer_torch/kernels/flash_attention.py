"""K3a-c: flash attention (forward and backward), wrappers, plain twins and
the autograd function over them.

Replaces the Pallas kernels of `tpu_deer/ops/flash_attention.py`: K3a
`_fwd_kernel` (O and lse), K3b `_bwd_dq_kernel` (dq) and K3c
`_bwd_dkv_kernel` (dk, dv). The CUDA source is `csrc/flash_attention.cu`;
its header comment says what bounds the kernels on the card and how the
design answers that.

`flash_attention(q, k, v, kv_mask)` is the reference's interface: q
[B, H, Tq, D], k and v [B, H, Tk, D], kv_mask [B, Tk] (1 = valid), float32,
differentiable in q, k and v. Each of the three wrappers launches its
kernel for CUDA tensors (raising for a head size other than 32 or 64, a
non-float32 or non-contiguous input) and runs its plain twin for CPU
tensors; `.launches` on each wrapper counts kernel launches.

A batch element whose whole key mask is 0 gets `reference_attention`'s
function (O = the mean of v, dq = dk = 0, dv = Σ dO / Tk), not the
reference kernel's: the reference pads keys to its block and scores the
padding too, so its result for such an element depends on the block size.

`flash_attention_plain` is the plain einsum version differentiated by
autograd: scores filled with -1e30 where the mask is 0 (a fill rather than
an added -1e30, so that no gradient reaches q or k through a masked key,
which is what gives dq = dk = 0 on an all-masked element).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from tpu_deer_torch.kernels.build import load_library

NEG_INF = -1e30  # the masked-score fill, as in the reference
# An lse below this marks a row with no valid key: -1e30 + log(Tk) rounds
# to -1e30 in float32 (the kernels use the same threshold).
NO_VALID_KEY = 0.5 * NEG_INF
SUPPORTED_HEAD_DIMS = (32, 64)  # the kernels' template instances


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, n_ptrs in (("flash_fwd_launch", 6), ("flash_bwd_dq_launch", 9),
                         ("flash_bwd_dkv_launch", 9)):
        fn = getattr(lib, name)
        fn.argtypes = [i32] + [ptr] * n_ptrs + [i32] * 5 + [ptr]
        fn.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_mask: torch.Tensor, *rows: torch.Tensor) -> None:
    """Raise unless the inputs are what the kernels take: contiguous
    float32 q [B, H, Tq, D], k = v [B, H, Tk, D], kv_mask [B, Tk], and
    `rows` shaped like q (o, dO) or like q without D (lse, δ), all on one
    device; on CUDA also D in SUPPORTED_HEAD_DIMS and 16-byte alignment."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q, k, v must be [B, H, T, D] with k and v alike, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, tq, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or tq < 1 or k.shape[2] < 1:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if tuple(kv_mask.shape) != (b, k.shape[2]):
        raise ValueError(f"kv_mask must be [B, Tk] = {(b, k.shape[2])}, got "
                         f"{tuple(kv_mask.shape)}")
    for t in (q, k, v, kv_mask, *rows):
        if t.dtype != torch.float32:
            raise TypeError(f"flash attention takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash attention takes contiguous tensors")
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if q.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError("flash attention needs 16-byte aligned tensors "
                             "(the kernels load rows as float4)")
    for t in rows:
        if tuple(t.shape) not in (tuple(q.shape), (b, h, tq)):
            raise ValueError(f"got a [{tuple(t.shape)}] tensor for a row "
                             f"input of q {tuple(q.shape)}")
    if q.device.type == "cuda":
        if d not in SUPPORTED_HEAD_DIMS:
            raise ValueError(f"the flash attention kernels take head size "
                             f"{SUPPORTED_HEAD_DIMS}, got {d}")
    elif q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")


def _launch(name: str, *tensors: torch.Tensor) -> None:
    """Launch `name` on the tensors' card and stream; tensors[0] is q and
    tensors[1] is k, as every entry point takes them."""
    lib = _library()
    q, k = tensors[:2]
    b, h, tq, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = getattr(lib, name)(q.device.index, *(t.data_ptr() for t in tensors),
                                b, h, tq, k.shape[2], d, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: "
                           f"{lib.flash_attention_error_string(rc).decode()} "
                           f"({rc})")


# ---------------------------------------------------------------------------
# Plain twins: the kernels' arithmetic with whole [Tq, Tk] matrices.
# ---------------------------------------------------------------------------
def _scores(q, k, kv_mask):
    """(s [B, H, Tq, Tk] filled with -1e30 where the key is masked,
    valid [B, 1, 1, Tk])."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    valid = (kv_mask > 0)[:, None, None, :]
    return torch.where(valid, s, NEG_INF), valid


def _probs(q, k, kv_mask, lse):
    """p recomputed from lse as the backward kernels do: 1/Tk on a row with
    no valid key."""
    s, valid = _scores(q, k, kv_mask)
    none = (lse < NO_VALID_KEY)[..., None]
    return torch.where(none, 1.0 / k.shape[2], torch.exp(s - lse[..., None])), valid


def flash_attention_fwd_plain(q, k, v, kv_mask):
    """Plain K3a: (O [B, H, Tq, D], lse [B, H, Tq])."""
    s, _ = _scores(q, k, kv_mask)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)
    return o, torch.logsumexp(s, dim=-1)


def flash_attention_bwd_dq_plain(q, k, v, kv_mask, o, do, lse):
    """Plain K3b: (δ = rowsum(dO ∘ O) [B, H, Tq], dq)."""
    delta = (do * o).sum(dim=-1)
    p, valid = _probs(q, k, kv_mask, lse)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = torch.where(valid, p * (dp - delta[..., None]), 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) / math.sqrt(q.shape[-1])
    return delta, dq


def flash_attention_bwd_dkv_plain(q, k, v, kv_mask, do, lse, delta):
    """Plain K3c: (dk, dv)."""
    p, valid = _probs(q, k, kv_mask, lse)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = torch.where(valid, p * (dp - delta[..., None]), 0.0)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) / math.sqrt(q.shape[-1])
    return dk, torch.einsum("bhqk,bhqd->bhkd", p, do)


def flash_attention_plain(q, k, v, kv_mask: Optional[torch.Tensor] = None):
    """softmax(q·kᵀ/√D, masked keys filled with -1e30)·v, differentiated by
    autograd (the reference's `reference_attention`)."""
    if kv_mask is None:
        kv_mask = torch.ones(q.shape[0], k.shape[2], device=q.device)
    s, _ = _scores(q, k, kv_mask)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


# ---------------------------------------------------------------------------
# Wrappers: the kernel for a CUDA tensor, the plain twin for a CPU one.
# ---------------------------------------------------------------------------
def flash_attention_fwd(q, k, v, kv_mask):
    """K3a: (O [B, H, Tq, D], lse [B, H, Tq])."""
    _check(q, k, v, kv_mask)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, kv_mask)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_fwd_launch", q, k, v, kv_mask, o, lse)
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd_dq(q, k, v, kv_mask, o, do, lse):
    """K3b: (δ [B, H, Tq], dq [B, H, Tq, D])."""
    _check(q, k, v, kv_mask, o, do, lse)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, kv_mask, o, do, lse)
    delta = torch.empty_like(lse)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq_launch", q, k, v, kv_mask, o, do, lse, delta, dq)
    flash_attention_bwd_dq.launches += 1
    return delta, dq


def flash_attention_bwd_dkv(q, k, v, kv_mask, do, lse, delta):
    """K3c: (dk, dv), each [B, H, Tk, D]."""
    _check(q, k, v, kv_mask, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, kv_mask, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv_launch", q, k, v, kv_mask, do, lse, delta, dk, dv)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """O = K3a(q, k, v, mask); the backward is K3b then K3c, p recomputed
    from the saved lse. The mask takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        o, lse = flash_attention_fwd(q, k, v, kv_mask)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta, dq = flash_attention_bwd_dq(q, k, v, kv_mask, o, do, lse)
        dk, dv = flash_attention_bwd_dkv(q, k, v, kv_mask, do, lse, delta)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over q [B, H, Tq, D], k and v [B, H, Tk, D] with an
    optional key mask [B, Tk] (1 = valid): softmax(q·kᵀ/√D)·v through
    kernels K3a-c on the card, their plain twins on the CPU."""
    if kv_mask is None:
        kv_mask = torch.ones(q.shape[0], k.shape[2], device=q.device)
    return FlashAttention.apply(q, k, v, kv_mask.to(torch.float32).contiguous())
