"""Multimodal fusion: the flagship's gated hierarchical fusion and the
reference's fusion zoo.

Port of `tpu_deer/models/fusion.py`. Every module computes in `dtype` as
the reference's does with flax's `dtype=` (`models/layers.py`), and names
its submodules after the reference's parameter tree, so that
`tpu_deer_torch.convert` carries weights across segment by segment:

  * HierarchicalFusion — the gated AV → trimodal fusion of the flagship;
  * AudioVisualFusion, TrimodalFusion, UncertaintyAwareGating and
    HierarchicalMultimodalFusion — the standalone two-stage attention
    fusion with optional uncertainty gating;
  * AttentionFusion, BilinearFusion, ConcatFusion, AdaptiveFusionGating and
    MoEFusion (with `_Expert`) — the strategies `DEERModelConfig.fusion_type`
    selects through `create_fusion_module`.

MoEFusion keeps its experts' parameters on a leading [E, ...] axis, as
flax's `nn.vmap` lays them out, and runs all experts in one batched product.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpu_deer_torch.models.attention import MultiHeadAttention
from tpu_deer_torch.models.layers import (
    LN_EPS,
    MLP,
    StackedMLP,
    dense,
    layer_norm,
    lecun_normal_,
    sigmoid,
    softmax,
)


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


class AudioVisualFusion(nn.Module):
    """Symmetric cross-attention AV fusion: both modalities projected to
    `output_dim`, a2v = attn(a, v, v), v2a = attn(v, a, a), fused =
    MLP(cat[a2v, v2a]); returns (fused, softmax(Linear(fused)) [B, 2])."""

    def __init__(self, audio_dim: int, video_dim: int, output_dim: int,
                 num_heads: int = 8, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.audio_proj = nn.Linear(audio_dim, output_dim)
        self.video_proj = nn.Linear(video_dim, output_dim)
        self.a2v = MultiHeadAttention(output_dim, num_heads, dropout, dtype=dtype)
        self.v2a = MultiHeadAttention(output_dim, num_heads, dropout, dtype=dtype)
        self.fuse_mlp = MLP(2 * output_dim, [2 * output_dim, output_dim],
                            dropout=dropout, dtype=dtype)
        self.weight_head = nn.Linear(output_dim, 2)
        self.dtype = dtype

    def forward(self, audio, video):
        a = dense(self.audio_proj, audio, self.dtype)[:, None, :]
        v = dense(self.video_proj, video, self.dtype)[:, None, :]
        a2v = self.a2v(a, v, v)[:, 0]
        v2a = self.v2a(v, a, a)[:, 0]
        fused = self.fuse_mlp(torch.cat([a2v, v2a], dim=-1))
        return fused, softmax(dense(self.weight_head, fused, self.dtype))


class TrimodalFusion(nn.Module):
    """AV and text projected, self-attended as a 2-token sequence and
    mean-pooled, then an MLP; returns (fused, softmax weights [B, 2])."""

    def __init__(self, av_dim: int, text_dim: int, output_dim: int,
                 num_heads: int = 8, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.av_proj = nn.Linear(av_dim, output_dim)
        self.text_proj = nn.Linear(text_dim, output_dim)
        self.self_attn = MultiHeadAttention(output_dim, num_heads, dropout,
                                            dtype=dtype)
        self.fuse_mlp = MLP(output_dim, [output_dim, output_dim],
                            dropout=dropout, dtype=dtype)
        self.weight_head = nn.Linear(output_dim, 2)
        self.dtype = dtype

    def forward(self, av, text):
        seq = torch.stack([dense(self.av_proj, av, self.dtype),
                           dense(self.text_proj, text, self.dtype)], dim=1)
        pooled = self.self_attn(seq, seq, seq).mean(dim=1)
        fused = self.fuse_mlp(pooled)
        return fused, softmax(dense(self.weight_head, fused, self.dtype))


class UncertaintyAwareGating(nn.Module):
    """Softmax gate [B, M] over M modalities from their features and, with
    `uncertainty_inputs=True`, their uncertainties [B, M], which also
    lower the logits before the softmax. (flax sizes the gate's input at
    the first call; a torch layer needs to know whether uncertainties come.)"""

    def __init__(self, input_dims: Sequence[int], hidden_dim: int = 128,
                 uncertainty_inputs: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        m = len(input_dims)
        for i, d in enumerate(input_dims):
            self.add_module(f"enc_{i}", nn.Linear(d, hidden_dim))
        self.gate = nn.Linear(m * hidden_dim + (m if uncertainty_inputs else 0), m)
        self.uncertainty_inputs = uncertainty_inputs
        self.dtype = dtype

    def forward(self, modalities, uncertainties=None):
        if (uncertainties is not None) != self.uncertainty_inputs:
            raise ValueError(
                f"built with uncertainty_inputs={self.uncertainty_inputs}, "
                f"called with uncertainties={'a tensor' if uncertainties is not None else None}")
        encoded = [torch.relu(dense(getattr(self, f"enc_{i}"), m, self.dtype))
                   for i, m in enumerate(modalities)]
        gate_in = torch.cat(encoded, dim=-1)
        if uncertainties is not None:
            gate_in = torch.cat([gate_in, uncertainties.to(gate_in.dtype)], -1)
        logits = dense(self.gate, gate_in, self.dtype)
        if uncertainties is not None:
            logits = logits - uncertainties
        return softmax(logits, dim=-1)


class HierarchicalMultimodalFusion(nn.Module):
    """AudioVisualFusion → TrimodalFusion → (optional) uncertainty gate over
    {av, tri} → Linear → LayerNorm. Returns {"fused", "av_attention",
    "trimodal_attention"}. Pass `uncertainty_inputs=True` to call it with
    uncertainties [B, 2] for the gate."""

    def __init__(self, audio_dim: int = 256, video_dim: int = 256,
                 text_dim: int = 256, output_dim: int = 512,
                 num_heads: int = 8, dropout: float = 0.1,
                 use_uncertainty_gating: bool = True,
                 uncertainty_inputs: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.av_fusion = AudioVisualFusion(audio_dim, video_dim, output_dim,
                                           num_heads, dropout, dtype)
        self.trimodal_fusion = TrimodalFusion(output_dim, text_dim, output_dim,
                                              num_heads, dropout, dtype)
        self.use_uncertainty_gating = use_uncertainty_gating
        if use_uncertainty_gating:
            self.uncertainty_gating = UncertaintyAwareGating(
                (output_dim, output_dim), uncertainty_inputs=uncertainty_inputs,
                dtype=dtype)
        self.out_proj = nn.Linear(output_dim, output_dim)
        self.out_norm = nn.LayerNorm(output_dim, eps=LN_EPS)
        self.dtype = dtype

    def forward(self, audio, video, text, uncertainties=None) -> dict:
        av, av_weights = self.av_fusion(audio, video)
        tri, tri_weights = self.trimodal_fusion(av, text)
        if self.use_uncertainty_gating:
            gates = self.uncertainty_gating([av, tri], uncertainties)
            fused = gates[:, 0:1] * av + gates[:, 1:2] * tri
        else:
            fused = tri
        out = layer_norm(self.out_norm, dense(self.out_proj, fused, self.dtype),
                         self.dtype)
        return {"fused": out, "av_attention": av_weights,
                "trimodal_attention": tri_weights}


class AttentionFusion(nn.Module):
    """Every modality projected to `output_dim`, a learned scalar score of
    tanh(projection), softmax over modalities, the weighted sum."""

    def __init__(self, input_dims: Sequence[int], output_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, d in enumerate(input_dims):
            self.add_module(f"proj_{i}", nn.Linear(d, output_dim))
        self.score = nn.Linear(output_dim, 1)
        self.dtype = dtype

    def forward(self, modalities) -> torch.Tensor:
        projected = torch.stack(
            [dense(getattr(self, f"proj_{i}"), m, self.dtype)
             for i, m in enumerate(modalities)], dim=1)  # [B, M, D]
        scores = dense(self.score, torch.tanh(projected), self.dtype)
        return (softmax(scores, dim=1) * projected).sum(dim=1)


class BilinearFusion(nn.Module):
    """a^T W b on the first two modalities (W [in_a, in_b, out], kept in
    flax's layout as `bilinear_kernel`, cast to `dtype`) plus a float32
    bias, plus a Linear of each further modality. As in the reference, the
    float32 bias promotes the result to float32 whatever `dtype` is."""

    def __init__(self, input_dims: Sequence[int], output_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bilinear_kernel = nn.Parameter(
            torch.empty(input_dims[0], input_dims[1], output_dim))
        self.bilinear_bias = nn.Parameter(torch.zeros(output_dim))
        for i, d in enumerate(input_dims[2:]):
            self.add_module(f"lin_{i}", nn.Linear(d, output_dim))
        self.dtype = dtype
        self.reset_flax_()

    def reset_flax_(self, generator=None) -> None:
        """flax's lecun_normal for the [i, j, k] kernel: fan_in = i · j
        (the `lin_*` layers are drawn as any Linear)."""
        with torch.no_grad():
            i, j, _ = self.bilinear_kernel.shape
            lecun_normal_(self.bilinear_kernel, i * j, generator)
            self.bilinear_bias.zero_()

    def forward(self, modalities) -> torch.Tensor:
        a, b = modalities[0], modalities[1]
        w = self.bilinear_kernel.to(self.dtype)
        out = torch.einsum("bi,ijk,bj->bk", a.to(self.dtype), w,
                           b.to(self.dtype)) + self.bilinear_bias
        for i, m in enumerate(modalities[2:]):
            out = out + dense(getattr(self, f"lin_{i}"), m, self.dtype)
        return out


class ConcatFusion(nn.Module):
    """Concatenation → MLP [output_dim, output_dim] (the factory's
    fallback)."""

    def __init__(self, input_dims: Sequence[int], output_dim: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = MLP(sum(input_dims), [output_dim, output_dim],
                       dropout=dropout, dtype=dtype)

    def forward(self, modalities) -> torch.Tensor:
        return self.mlp(torch.cat(list(modalities), dim=-1))


class AdaptiveFusionGating(nn.Module):
    """A learned softmax blend of the concat, attention and bilinear
    strategies (submodules named as flax auto-names them)."""

    def __init__(self, input_dims: Sequence[int], output_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ConcatFusion_0 = ConcatFusion(input_dims, output_dim, dtype=dtype)
        self.AttentionFusion_0 = AttentionFusion(input_dims, output_dim, dtype)
        self.BilinearFusion_0 = BilinearFusion(input_dims, output_dim, dtype)
        self.strategy_gate = nn.Linear(sum(input_dims), 3)
        self.dtype = dtype

    def forward(self, modalities) -> torch.Tensor:
        outs = [self.ConcatFusion_0(modalities),
                self.AttentionFusion_0(modalities),
                self.BilinearFusion_0(modalities)]
        weights = softmax(dense(self.strategy_gate,
                                torch.cat(list(modalities), dim=-1), self.dtype))
        # The bilinear branch is float32 (its bias); jnp.stack promotes.
        dt = outs[2].dtype
        stacked = torch.stack([o.to(dt) for o in outs], dim=1)  # [B, 3, D]
        return (weights[:, :, None] * stacked).sum(dim=1)


class _Expert(nn.Module):
    """The MoE experts: E copies of MLP [hidden, out] with their
    parameters stacked [E, ...] (`mlp.layers.{i}`); [B, in] → [E, B, out]."""

    def __init__(self, members: int, in_features: int, hidden: int, out: int,
                 dropout: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = StackedMLP(members, in_features, [hidden, out], dropout, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class MoEFusion(nn.Module):
    """Mixture of fusion experts with a dense softmax gate: every expert MLP
    runs on the concatenated modalities (one batched product over the
    [E, ...] expert axis) and the per-sample gate weights the blend."""

    def __init__(self, input_dims: Sequence[int], output_dim: int,
                 num_experts: int = 4, expert_hidden: int = 256,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gate = nn.Linear(sum(input_dims), num_experts)
        self.experts = _Expert(num_experts, sum(input_dims), expert_hidden,
                               output_dim, dropout, dtype)
        self.dtype = dtype

    def forward(self, modalities) -> torch.Tensor:
        x = torch.cat(list(modalities), dim=-1)
        gate = softmax(dense(self.gate, x, self.dtype))  # [B, E]
        outs = self.experts(x)  # [E, B, D]
        return torch.einsum("be,ebd->bd", gate.to(outs.dtype), outs)


def create_fusion_module(fusion_type: str, input_dims: Sequence[int],
                         output_dim: int, **kwargs) -> nn.Module:
    """'hierarchical' | 'attention' | 'bilinear' | 'adaptive' | 'moe'; any
    other name falls back to ConcatFusion, as the reference's factory."""
    if fusion_type == "hierarchical":
        a, v, t = input_dims
        return HierarchicalMultimodalFusion(audio_dim=a, video_dim=v,
                                            text_dim=t, output_dim=output_dim,
                                            **kwargs)
    if fusion_type == "attention":
        return AttentionFusion(tuple(input_dims), output_dim, **kwargs)
    if fusion_type == "bilinear":
        return BilinearFusion(tuple(input_dims), output_dim, **kwargs)
    if fusion_type == "adaptive":
        return AdaptiveFusionGating(tuple(input_dims), output_dim, **kwargs)
    if fusion_type == "moe":
        return MoEFusion(tuple(input_dims), output_dim, **kwargs)
    return ConcatFusion(tuple(input_dims), output_dim, **kwargs)
