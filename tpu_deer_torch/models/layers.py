"""Shared building blocks: residual MLP block, MLP, flax-style init, and
the compute-dtype casts of flax's `dtype=`.

A module built with `dtype=torch.bfloat16` keeps its parameters in float32
(flax's `param_dtype`) and computes as flax does with `dtype=jnp.bfloat16`:
`dense` casts input, weight and bias to the compute dtype and returns the
product in it; `layer_norm` takes its statistics and affine map in float32
and casts the result; ReLU, `softmax`, `sigmoid` and the residual and gate
adds then run in the compute dtype, `softmax` and `sigmoid` op by op as
XLA expands them (each op rounded to the dtype). In float32 the helpers
are the plain `nn.Linear`, `nn.LayerNorm`, `torch.softmax` and
`torch.sigmoid` calls.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# flax.linen.LayerNorm's default epsilon (torch's default is 1e-5).
LN_EPS = 1e-6

# Std of a unit normal truncated to [-2, 2]; flax's truncated lecun_normal
# divides by it so the truncated draw keeps variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default Dense kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def init_flax_style_(module: nn.Module,
                     generator: Optional[torch.Generator] = None) -> None:
    """flax's default initializers, drawn from `generator`: Linear and Conv
    kernels lecun_normal (fan_in = inputs × kernel taps) with zero bias;
    LayerNorm and GroupNorm ones/zeros; Embedding normal with variance
    1/features; LSTM input kernels lecun_normal and recurrent kernels
    orthogonal per gate (flax's OptimizedLSTMCell), biases zero."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, m.embedding_dim ** -0.5,
                                generator=generator)
            elif isinstance(m, nn.LSTM):
                for name, p in m.named_parameters():
                    if name.startswith("weight_ih"):
                        lecun_normal_(p, p.shape[1], generator)
                    elif name.startswith("weight_hh"):
                        for gate in p.chunk(4):
                            nn.init.orthogonal_(gate, generator=generator)
                    else:
                        nn.init.zeros_(p)


def torch_dtype(name: str) -> torch.dtype:
    """The floating compute dtype a config names, as `jnp.dtype(name)`
    reads it ("float32", "bfloat16", "float16", "float64", numpy's aliases
    such as "f4" or "half"). Raises ValueError for a name that is not a
    float type torch has."""
    if name == "bfloat16":
        return torch.bfloat16
    try:
        np_name = np.dtype(name).name
    except TypeError as e:
        raise ValueError(f"unknown compute dtype {name!r}") from e
    dtype = {"float16": torch.float16, "float32": torch.float32,
             "float64": torch.float64}.get(np_name)
    if dtype is None:
        raise ValueError(f"compute dtype {name!r} is not a float type")
    return dtype


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`layer` as flax's Dense(dtype=dtype): input, weight and bias cast to
    `dtype`, the product returned in it. The stored parameters stay as they
    are; their gradients come back in their own dtype.

    Below the parameters' precision the bias is added to the product after
    it was rounded to `dtype`, as flax adds it: a bias fused into the GEMM
    rounds once, and on the CPU ATen's bf16 addmm rounds another way."""
    if dtype == layer.weight.dtype:
        return F.linear(x.to(dtype), layer.weight, layer.bias)
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """`norm` as flax 0.12's LayerNorm(dtype=dtype) with its default
    force_float32_reductions: mean, variance and (x − mean)·rsqrt(var +
    eps)·scale + bias in float32 (at least), the result cast to `dtype`."""
    stat = torch.promote_types(dtype, torch.float32)
    return F.layer_norm(x.to(stat), norm.normalized_shape,
                        norm.weight.to(stat), norm.bias.to(stat),
                        norm.eps).to(dtype)


def _below_float32(x: torch.Tensor) -> bool:
    return torch.finfo(x.dtype).bits < 32


class _Logistic(torch.autograd.Function):
    """`lax.logistic` below float32: forward as XLA lowers it there,
    1 / (1 + exp(−x)) with every op rounded to x's dtype (one fused
    `torch.sigmoid` rounds once and differs in ~1/3 of bf16 values);
    backward JAX's derivative rule g·(y·(1 − y)), op by op. Autograd
    through the forward's ops would give 0·inf = NaN below x ≈ −88.7,
    where exp(−x) overflows."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1.0 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid (`_Logistic` below float32)."""
    if not _below_float32(x):
        return torch.sigmoid(x)
    return _Logistic.apply(x)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """jax.nn.softmax: below float32 exp(x − max) (the max taking no
    gradient), its sum (accumulated in float32) and the quotient each
    rounded to x's dtype, as JAX computes and differentiates it."""
    if not _below_float32(x):
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True).detach())
    return e / e.sum(dim=dim, keepdim=True)


class ResidualBlock(nn.Module):
    """x + LayerNorm(Dropout(ReLU(Linear(x)))) — LayerNorm on the branch."""

    def __init__(self, dim: int, dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = nn.Linear(dim, dim)
        self.dropout = nn.Dropout(dropout)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dropout(torch.relu(dense(self.dense, x, self.dtype)))
        return x + layer_norm(self.norm, h, self.dtype)


class MLP(nn.Module):
    """Linear stack with ReLU + dropout between layers; optional final
    ReLU or softmax (the reference's sigmoid is not used by the ported
    models)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dropout: float = 0.0, final_activation: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if final_activation not in (None, "relu", "softmax"):
            raise ValueError(f"unsupported final_activation {final_activation!r}")
        dims = [in_features, *features]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])
        )
        self.dropout = nn.Dropout(dropout)
        self.final_activation = final_activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = dense(layer, x, self.dtype)
            if i < len(self.layers) - 1:
                x = self.dropout(torch.relu(x))
        if self.final_activation == "relu":
            x = torch.relu(x)
        elif self.final_activation == "softmax":
            x = softmax(x, dim=-1)
        return x
