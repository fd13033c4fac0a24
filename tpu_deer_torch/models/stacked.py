"""The stacked layout of the flagship (`DEERModelConfig(stacked_compute=True)`).

Port of `tpu_deer/models/stacked.py`. The three modality encoders are
independent chains of the same shape after their input projections, and
the three DEER evidence MLPs read the same fused vector; here each set runs
as one chain of batched products over a leading member axis of 3, with
parameters [3, ...] (`models/layers.py:StackedLinear`). The math is that of
three separate modules: `stack_params` relabels and stacks a default-layout
`state_dict` into this layout, and the two forwards agree.

`_EncoderTrunk` and `_HeadMLP` hold all members at once (flax's `nn.vmap`
builds them from one member's module). The parameter names inside them are
those of one unstacked `ModalityEncoder` (minus `input_proj`) and of one
head's `evidence_network`, so that `tpu_deer_torch.convert` carries the
reference's stacked tree across member by member.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpu_deer_torch.models.layers import (
    StackedLayerNorm,
    StackedLinear,
    StackedMLP,
    dense,
)

ORDER = ("audio", "video", "text")


class _StackedResidualBlock(nn.Module):
    """`ResidualBlock` for every member: x + LN(Dropout(ReLU(Linear(x))))."""

    def __init__(self, members: int, dim: int, dropout: float,
                 dtype: torch.dtype):
        super().__init__()
        self.dense = StackedLinear(members, dim, dim, dtype)
        self.dropout = nn.Dropout(dropout)
        self.norm = StackedLayerNorm(members, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.norm(self.dropout(torch.relu(self.dense(x))))


class _EncoderTrunk(nn.Module):
    """The shape-identical tail of `ModalityEncoder` for every member:
    ReLU → LayerNorm → residual blocks → output projection, [M, B, D] →
    [M, B, D]."""

    def __init__(self, output_dim: int = 256, num_layers: int = 3,
                 dropout: float = 0.3, dtype: torch.dtype = torch.float32,
                 members: int = 3):
        super().__init__()
        self.input_norm = StackedLayerNorm(members, output_dim, dtype)
        self.blocks = nn.ModuleList(
            _StackedResidualBlock(members, output_dim, dropout, dtype)
            for _ in range(num_layers))
        self.output_proj = StackedLinear(members, output_dim, output_dim, dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.input_norm(torch.relu(h))
        for block in self.blocks:
            h = block(h)
        return self.output_proj(h)


class StackedModalityEncoders(nn.Module):
    """The three modality encoders as one batched chain: per-modality input
    projections (their widths differ), then one `_EncoderTrunk` over
    [3, B, D]. Returns (audio, video, text) embeddings."""

    def __init__(self, input_dims: Sequence[int], output_dim: int = 256,
                 num_layers: int = 3, dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for name, d in zip(ORDER, input_dims):
            self.add_module(f"{name}_proj", nn.Linear(d, output_dim))
        self.trunk = _EncoderTrunk(output_dim, num_layers, dropout, dtype,
                                   members=len(ORDER))
        self.dtype = dtype

    def forward(self, audio, video, text):
        h = torch.stack([dense(getattr(self, f"{name}_proj"), x, self.dtype)
                         for name, x in zip(ORDER, (audio, video, text))])
        out = self.trunk(h)
        return out[0], out[1], out[2]


class _HeadMLP(StackedMLP):
    """Every head's evidence MLP [hidden, hidden // 2, 4 · output_dim] on
    the same input: [B, F] → [heads, B, 4 · output_dim]."""

    def __init__(self, in_features: int, hidden_dim: int = 256,
                 dropout: float = 0.3, output_dim: int = 1,
                 dtype: torch.dtype = torch.float32, members: int = 3):
        super().__init__(members, in_features,
                         [hidden_dim, hidden_dim // 2, 4 * output_dim],
                         dropout, dtype)


class StackedEvidenceHeads(nn.Module):
    """The DEER evidence MLPs of all heads as one batched chain over the
    same fused input. Returns raw evidence [n_heads, B, 4 · output_dim];
    the caller applies the float32 NIG constraints per head."""

    def __init__(self, in_features: int, hidden_dim: int = 256,
                 dropout: float = 0.3, output_dim: int = 1,
                 dtype: torch.dtype = torch.float32, n_heads: int = 3):
        super().__init__()
        self.evidence_network = _HeadMLP(in_features, hidden_dim, dropout,
                                         output_dim, dtype, members=n_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.evidence_network(x)


def stack_params(state_dict: dict,
                 dim_names: Sequence[str] = ("valence", "arousal", "dominance")
                 ) -> dict:
    """A default-layout CompleteDEERModel `state_dict` in the
    stacked_compute=True layout: a relabel and `torch.stack` only, no math.
    Entries outside the encoders and heads pass through."""
    out: dict = {}
    enc = {m: {} for m in ORDER}
    heads = {n: {} for n in dim_names}
    for key, value in state_dict.items():
        top, _, rest = key.partition(".")
        if top.endswith("_encoder") and top[:-len("_encoder")] in enc:
            enc[top[:-len("_encoder")]][rest] = value
        elif top == "heads" and rest.partition(".")[0] in heads:
            name, _, leaf = rest.partition(".")
            heads[name][leaf] = value
        else:
            out[key] = value
    for m in ORDER:
        for leaf in ("weight", "bias"):
            out[f"stacked_encoders.{m}_proj.{leaf}"] = enc[m].pop(f"input_proj.{leaf}")
    for rest in enc["audio"]:
        out[f"stacked_encoders.trunk.{rest}"] = torch.stack(
            [enc[m][rest] for m in ORDER])
    for rest in heads[dim_names[0]]:
        out[f"stacked_heads.{rest}"] = torch.stack(
            [heads[n][rest] for n in dim_names])
    return out
