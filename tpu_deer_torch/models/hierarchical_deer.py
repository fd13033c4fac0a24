"""Standalone hierarchical DEER models.

Port of `tpu_deer/models/hierarchical_deer.py`:

  * `HierarchicalDEERFusionModel` — linear modality projections →
    `CrossModalAttention` (text as the query over audio and video, with an
    uncertainty gate) → gate-weighted AV concat fusion → trimodal concat
    fusion → per-dimension DEER heads; returns the gate as `modality_gate`.
  * `RawSequenceDEERModel` — sequence encoders → fusion → DEER heads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.models.attention import CrossModalAttention
from tpu_deer_torch.models.encoders import (
    AudioSequenceEncoder,
    TextSequenceEncoder,
    VideoSequenceEncoder,
)
from tpu_deer_torch.models.fusion import HierarchicalFusion
from tpu_deer_torch.models.heads import MultiDimensionalDEER
from tpu_deer_torch.models.layers import MLP, dense, init_flax_style_


class HierarchicalDEERFusionModel(nn.Module):
    """audio [B, audio_dim], video [B, video_dim], text [B, text_dim] →
    per-dimension NIG outputs, `mu_all`, `uncertainty_all` and
    `modality_gate` [B, 2], computed in `dtype` (the NIG math in float32).
    Dropout follows `self.training`."""

    def __init__(self, audio_dim: int = 84, video_dim: int = 256,
                 text_dim: int = 768, hidden_dim: int = 256,
                 num_heads: int = 8, dropout: float = 0.3,
                 dim_names: Sequence[str] = ("valence", "arousal", "dominance"),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.audio_proj = nn.Linear(audio_dim, hidden_dim)
        self.video_proj = nn.Linear(video_dim, hidden_dim)
        self.text_proj = nn.Linear(text_dim, hidden_dim)
        self.cross_modal = CrossModalAttention(hidden_dim, num_heads,
                                               dropout=0.1, dtype=dtype)
        self.av_fusion = MLP(2 * hidden_dim, [hidden_dim, hidden_dim],
                             dropout=dropout, dtype=dtype)
        self.trimodal_fusion = MLP(2 * hidden_dim, [hidden_dim, hidden_dim],
                                   dropout=dropout, dtype=dtype)
        self.deer = MultiDimensionalDEER(hidden_dim, hidden_dim, dim_names,
                                         dropout, dtype)
        self.dtype = dtype

    def forward(self, audio, video, text) -> dict:
        dt = self.dtype
        a = dense(self.audio_proj, audio, dt)
        v = dense(self.video_proj, video, dt)
        t = dense(self.text_proj, text, dt)
        a_att, v_att, gate = self.cross_modal(a, v, t)
        av = self.av_fusion(torch.cat([gate[:, 0:1] * a_att,
                                       gate[:, 1:2] * v_att], dim=-1))
        out = self.deer(self.trimodal_fusion(torch.cat([av, t], dim=-1)))
        out["modality_gate"] = gate
        return out


def create_hierarchical_deer_model(seed: int = 42, device: DeviceLike = None,
                                   **kwargs) -> HierarchicalDEERFusionModel:
    """HierarchicalDEERFusionModel(**kwargs) with flax-style init drawn on
    the CPU from `seed`, returned in eval mode on `device` (None = the CUDA
    card)."""
    device = resolve_device(device)
    model = HierarchicalDEERFusionModel(**kwargs)
    init_flax_style_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


class RawSequenceDEERModel(nn.Module):
    """Raw-media DEER.

    Inputs: audio_frames [B, Ta, 84] (ops.audio_frontend.audio_frame_features),
    video_frames [B, Tv, H, W, 3] (channels last), token_ids [B, Tt] and an
    optional text_mask [B, Tt] (1 = token). Returns the per-dimension NIG
    outputs, `mu_all`, `uncertainty_all` and `temporal_attention` (the three
    encoders' pooling weights). Dropout follows `self.training`.
    """

    def __init__(self, encoder_dim: int = 256, fusion_dim: int = 512,
                 vocab_size: int = 30522, num_heads: int = 8,
                 dropout: float = 0.3,
                 dim_names: Sequence[str] = ("valence", "arousal", "dominance")):
        super().__init__()
        self.dim_names = tuple(dim_names)
        self.audio_encoder = AudioSequenceEncoder(
            84, encoder_dim, lstm_hidden=encoder_dim // 2)
        self.video_encoder = VideoSequenceEncoder(
            3, encoder_dim, conv_features=(16, 32, 64))
        self.text_encoder = TextSequenceEncoder(
            vocab_size, encoder_dim, model_dim=encoder_dim, num_layers=2,
            num_heads=num_heads)
        self.fusion = HierarchicalFusion(encoder_dim, fusion_dim, dropout)
        self.deer = MultiDimensionalDEER(fusion_dim, encoder_dim, dim_names,
                                         dropout)

    def forward(self, audio_frames, video_frames, token_ids,
                text_mask: Optional[torch.Tensor] = None) -> dict:
        a, a_attn = self.audio_encoder(audio_frames)
        v, v_attn = self.video_encoder(video_frames)
        t, t_attn = self.text_encoder(token_ids, text_mask)
        out = self.deer(self.fusion(a, v, t))
        out["temporal_attention"] = {"audio": a_attn, "video": v_attn,
                                     "text": t_attn}
        return out


def create_raw_sequence_model(seed: int = 42, device: DeviceLike = None,
                              **kwargs) -> RawSequenceDEERModel:
    """RawSequenceDEERModel(**kwargs) with flax-style init drawn on the CPU
    from `seed` (the same weights on every device; not the reference's
    numbers, which `tpu_deer_torch.convert` carries over). Returned in train
    mode on `device` (None = the CUDA card)."""
    device = resolve_device(device)
    model = RawSequenceDEERModel(**kwargs)
    init_flax_style_(model, torch.Generator().manual_seed(seed))
    return model.to(device)
