"""Token-embedding lookup whose gradient repeats bit for bit: the gradient
kernel's wrapper, its plain twin and the autograd function over them.

Not a TPU kernel. The reference looks rows up with flax `nn.Embed`
(`tpu_deer/models/encoders.py:328`), and XLA computes its gradient as a
scatter-add that gives the same bits on every run. PyTorch's CUDA embedding
backward adds with atomics in an order that varies by run, so seeded
training on the card would part after one step. The CUDA source is
`csrc/embedding_grad.cu`; its header comment says what bounds it and how
the design answers that.

`embedding_lookup(ids, weight)` is `weight[ids]` differentiable in `weight`:
dW[v] = Σ dX[i] over the positions i where ids[i] == v. The backward runs
`embedding_grad`, which launches the kernel for CUDA tensors (after a
stable sort of the ids, whose order depends on the ids alone) and runs the
plain twin, an `index_add_` into zeros, for CPU ones; `.launches` counts
kernel launches. `embedding_lookup_plain` is the same function with the
plain twin as its backward on any device.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tpu_deer_torch.kernels.build import load_library


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("embedding_grad")
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.embedding_grad_launch.argtypes = [ctypes.c_int] + [ptr] * 5 + [
        i64, i64, ctypes.c_int, ptr]
    lib.embedding_grad_launch.restype = ctypes.c_int
    lib.embedding_grad_scratch.argtypes = [i64, ctypes.c_int]
    lib.embedding_grad_scratch.restype = i64
    lib.embedding_grad_error_string.argtypes = [ctypes.c_int]
    lib.embedding_grad_error_string.restype = ctypes.c_char_p
    return lib


def _check(ids: torch.Tensor, grad: torch.Tensor, num_embeddings: int) -> None:
    """Raise unless ids (int64) and grad (contiguous float32 of ids' shape
    + [D]) are what the kernel takes, on one device."""
    if ids.dtype != torch.int64:
        raise TypeError(f"ids must be int64, got {ids.dtype}")
    if grad.dtype != torch.float32:
        raise TypeError(f"the embedding gradient takes float32, got {grad.dtype}")
    if grad.dim() < 1 or tuple(grad.shape[:-1]) != tuple(ids.shape):
        raise ValueError(f"grad must be ids' shape {tuple(ids.shape)} + [D], "
                         f"got {tuple(grad.shape)}")
    if not grad.is_contiguous():
        raise ValueError("the embedding gradient takes a contiguous grad")
    if ids.device != grad.device:
        raise ValueError(f"ids on {ids.device}, grad on {grad.device}")
    if grad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {grad.device}")
    if num_embeddings < 1 or grad.shape[-1] < 1:
        raise ValueError("the table needs at least one row and one column")


def embedding_grad_plain(ids: torch.Tensor, grad: torch.Tensor,
                         num_embeddings: int) -> torch.Tensor:
    """Plain PyTorch dW [num_embeddings, D]: an index_add_ into zeros."""
    d = grad.shape[-1]
    out = torch.zeros(num_embeddings, d, dtype=grad.dtype, device=grad.device)
    return out.index_add_(0, ids.reshape(-1), grad.reshape(-1, d))


def embedding_grad(ids: torch.Tensor, grad: torch.Tensor,
                   num_embeddings: int) -> torch.Tensor:
    """dW [num_embeddings, D] = Σ grad rows by id, in an order fixed by the
    ids: the kernel for CUDA tensors, the plain twin for CPU ones."""
    _check(ids, grad, num_embeddings)
    if grad.device.type == "cpu":
        return embedding_grad_plain(ids, grad, num_embeddings)
    d = grad.shape[-1]
    dw = torch.zeros(num_embeddings, d, dtype=torch.float32, device=grad.device)
    n = ids.numel()
    if n == 0:
        return dw
    lib = _library()
    sorted_ids, perm = torch.sort(ids.reshape(-1), stable=True)
    part = torch.empty(lib.embedding_grad_scratch(n, d), dtype=torch.float32,
                       device=grad.device)
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    with torch.cuda.device(grad.device):
        rc = lib.embedding_grad_launch(
            grad.device.index, sorted_ids.data_ptr(), perm.data_ptr(),
            grad.data_ptr(), dw.data_ptr(), part.data_ptr(), n,
            num_embeddings, d, stream)
    if rc != 0:
        raise RuntimeError(f"embedding_grad launch failed: "
                           f"{lib.embedding_grad_error_string(rc).decode()} "
                           f"({rc})")
    embedding_grad.launches += 1
    return dw


embedding_grad.launches = 0


class EmbeddingLookup(torch.autograd.Function):
    """weight[ids]; the weight's gradient from `embedding_grad` (or its
    plain twin when `plain`), computed only when the weight needs one. The
    ids take no gradient."""

    @staticmethod
    def forward(ctx, ids, weight, plain):
        ctx.save_for_backward(ids)
        ctx.num_embeddings = weight.shape[0]
        ctx.plain = plain
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[1]:
            return None, None, None
        (ids,) = ctx.saved_tensors
        fn = embedding_grad_plain if ctx.plain else embedding_grad
        return None, fn(ids, grad.contiguous(), ctx.num_embeddings), None


def embedding_lookup(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """weight[ids] ([*ids.shape, D]) with the kernel's gradient on the card."""
    return EmbeddingLookup.apply(ids, weight, False)


def embedding_lookup_plain(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """weight[ids] with the plain twin's gradient on any device."""
    return EmbeddingLookup.apply(ids, weight, True)
