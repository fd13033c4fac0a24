"""Shared building blocks: residual MLP block, MLP, and flax-style init."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
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


class ResidualBlock(nn.Module):
    """x + LayerNorm(Dropout(ReLU(Linear(x)))) — LayerNorm on the branch."""

    def __init__(self, dim: int, dropout: float = 0.3):
        super().__init__()
        self.dense = nn.Linear(dim, dim)
        self.dropout = nn.Dropout(dropout)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.norm(self.dropout(torch.relu(self.dense(x))))


class MLP(nn.Module):
    """Linear stack with ReLU + dropout between layers; optional final
    ReLU or softmax (the reference's sigmoid is not used by the ported
    models)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dropout: float = 0.0, final_activation: Optional[str] = None):
        super().__init__()
        if final_activation not in (None, "relu", "softmax"):
            raise ValueError(f"unsupported final_activation {final_activation!r}")
        dims = [in_features, *features]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])
        )
        self.dropout = nn.Dropout(dropout)
        self.final_activation = final_activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.dropout(torch.relu(x))
        if self.final_activation == "relu":
            x = torch.relu(x)
        elif self.final_activation == "softmax":
            x = torch.softmax(x, dim=-1)
        return x
