"""The raw-media DEER model: sequence encoders → fusion → DEER heads.

Port of `RawSequenceDEERModel` in `tpu_deer/models/hierarchical_deer.py`.
`HierarchicalDEERFusionModel` (and its `CrossModalAttention`) is not ported
yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.models.encoders import (
    AudioSequenceEncoder,
    TextSequenceEncoder,
    VideoSequenceEncoder,
)
from tpu_deer_torch.models.fusion import HierarchicalFusion
from tpu_deer_torch.models.heads import MultiDimensionalDEER
from tpu_deer_torch.models.layers import init_flax_style_


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
