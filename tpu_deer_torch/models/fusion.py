"""Gated hierarchical fusion of the flagship model. The rest of the
reference's fusion zoo is not ported yet."""

from __future__ import annotations

import torch
from torch import nn

from tpu_deer_torch.models.layers import LN_EPS, dense, layer_norm, sigmoid


class HierarchicalFusion(nn.Module):
    """av  = MLP(cat[audio, video]); tri = MLP(cat[av, text]);
    g = sigmoid(Linear(cat[av, text])); out = g * tri + (1 - g) * av,
    where each MLP is Linear → ReLU → Dropout → LayerNorm → Linear → ReLU,
    all in `dtype` (the gate and the blend too). Submodule names follow the
    reference's parameter tree."""

    def __init__(self, feature_dim: int = 256, fusion_dim: int = 512,
                 dropout: float = 0.3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.av_fusion_in = nn.Linear(2 * feature_dim, fusion_dim)
        self.av_fusion_norm = nn.LayerNorm(fusion_dim, eps=LN_EPS)
        self.av_fusion_out = nn.Linear(fusion_dim, fusion_dim)
        self.trimodal_fusion_in = nn.Linear(fusion_dim + feature_dim, fusion_dim)
        self.trimodal_fusion_norm = nn.LayerNorm(fusion_dim, eps=LN_EPS)
        self.trimodal_fusion_out = nn.Linear(fusion_dim, fusion_dim)
        self.fusion_gate = nn.Linear(fusion_dim + feature_dim, fusion_dim)
        self.dropout = nn.Dropout(dropout)
        self.dtype = dtype

    def _mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(dense(getattr(self, f"{name}_in"), x, self.dtype))
        h = layer_norm(getattr(self, f"{name}_norm"), self.dropout(h), self.dtype)
        return torch.relu(dense(getattr(self, f"{name}_out"), h, self.dtype))

    def forward(self, audio, video, text) -> torch.Tensor:
        av = self._mlp("av_fusion", torch.cat([audio, video], dim=-1))
        tri_in = torch.cat([av, text], dim=-1)
        gate = sigmoid(dense(self.fusion_gate, tri_in, self.dtype))
        tri = self._mlp("trimodal_fusion", tri_in)
        return gate * tri + (1.0 - gate) * av
