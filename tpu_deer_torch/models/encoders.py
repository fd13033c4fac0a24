"""Modality encoders. Only the feature-level `ModalityEncoder` of the flagship
model is ported so far; the raw-sequence encoders come with the raw path."""

from __future__ import annotations

import torch
from torch import nn

from tpu_deer_torch.models.layers import LN_EPS, ResidualBlock


class ModalityEncoder(nn.Module):
    """Feature-vector encoder: input proj → ReLU → LayerNorm → N residual
    blocks → output proj."""

    def __init__(self, input_dim: int, output_dim: int = 256,
                 num_layers: int = 3, dropout: float = 0.3):
        super().__init__()
        self.input_proj = nn.Linear(input_dim, output_dim)
        self.input_norm = nn.LayerNorm(output_dim, eps=LN_EPS)
        self.blocks = nn.ModuleList(
            ResidualBlock(output_dim, dropout) for _ in range(num_layers)
        )
        self.output_proj = nn.Linear(output_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.input_norm(torch.relu(self.input_proj(x)))
        for block in self.blocks:
            h = block(h)
        return self.output_proj(h)
