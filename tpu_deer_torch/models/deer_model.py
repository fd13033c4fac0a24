"""The flagship CompleteDEERModel: trimodal evidential VAD regression.

Port of `tpu_deer/models/deer_model.py`: three feature-level encoders →
uncertainty-aware cross-modal attention → gated hierarchical fusion → three
DEER evidence heads → uncertainty calibration. 3,918,324 parameters at the
default config, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.models.attention import UncertaintyAwareAttention
from tpu_deer_torch.models.encoders import ModalityEncoder
from tpu_deer_torch.models.fusion import HierarchicalFusion
from tpu_deer_torch.models.heads import (
    DEERPredictionHead,
    UncertaintyCalibrationLayer,
)
from tpu_deer_torch.models.layers import init_flax_style_


@dataclasses.dataclass(frozen=True)
class DEERModelConfig:
    """Model hyperparameters, as the reference's DEERModelConfig."""

    audio_dim: int = 84
    video_dim: int = 256
    text_dim: int = 768
    encoder_dim: int = 256
    fusion_dim: int = 512
    emotion_dims: int = 3
    attention_heads: int = 8
    encoder_layers: int = 3
    dropout: float = 0.3
    evidence_weight: float = 1.0
    kl_weight: float = 0.1
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    gradient_clip: float = 1.0
    dim_names: Sequence[str] = ("valence", "arousal", "dominance")
    compute_dtype: str = "float32"
    fusion_type: str = "hierarchical"
    moe_experts: int = 4
    stacked_compute: bool = False


def _check_supported(cfg: DEERModelConfig) -> None:
    if cfg.fusion_type != "hierarchical":
        raise NotImplementedError(
            f"fusion_type={cfg.fusion_type!r}: only 'hierarchical' is ported")
    if cfg.stacked_compute:
        raise NotImplementedError("stacked_compute=True is not ported yet")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: only float32 is ported")


class CompleteDEERModel(nn.Module):
    """audio[B,84], video[B,256], text[B,768] → NIG VAD predictions +
    uncertainty. Dropout follows `self.training`; serve in eval mode."""

    def __init__(self, config: DEERModelConfig = DEERModelConfig()):
        super().__init__()
        _check_supported(config)
        self.config = cfg = config
        enc = lambda dim: ModalityEncoder(dim, cfg.encoder_dim,
                                          cfg.encoder_layers, cfg.dropout)
        self.audio_encoder = enc(cfg.audio_dim)
        self.video_encoder = enc(cfg.video_dim)
        self.text_encoder = enc(cfg.text_dim)
        self.uncertainty_attention = UncertaintyAwareAttention(
            cfg.encoder_dim, cfg.attention_heads, dropout=0.1)
        self.fusion = HierarchicalFusion(cfg.encoder_dim, cfg.fusion_dim,
                                         cfg.dropout)
        self.heads = nn.ModuleDict({
            name: DEERPredictionHead(cfg.fusion_dim, cfg.encoder_dim,
                                     cfg.dropout, output_dim=1)
            for name in cfg.dim_names
        })
        self.calibration = UncertaintyCalibrationLayer(cfg.emotion_dims)

    def forward(self, audio, video, text) -> dict:
        a = self.audio_encoder(audio)
        v = self.video_encoder(video)
        t = self.text_encoder(text)
        attended = self.uncertainty_attention(a, v, t)
        fused = self.fusion(attended["audio"], attended["video"],
                            attended["text"])
        out: dict = {
            "attention_weights": attended["attention_weights"],
            "modality_uncertainties": attended["modality_uncertainties"],
            "fused_features": fused,
        }
        mus, uncs = [], []
        for name in self.config.dim_names:
            head = self.heads[name](fused)
            out[f"{name}_params"] = head["params"]
            for k in ("mu", "nu", "alpha", "beta", "aleatoric_uncertainty",
                      "epistemic_uncertainty", "uncertainty"):
                out[f"{name}_{k}"] = head[k]
            mus.append(head["mu"])
            uncs.append(head["uncertainty"])
        out["mu_all"] = torch.cat(mus, dim=-1)
        out["uncertainty_all"] = torch.cat(uncs, dim=-1)
        out["calibrated_uncertainty"] = self.calibration(out["uncertainty_all"])
        return out


def count_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def create_complete_deer_model(config: DEERModelConfig | None = None,
                               seed: int = 42,
                               device: DeviceLike = None) -> CompleteDEERModel:
    """Build the flagship model with flax-style init drawn from `seed`.

    The weights are drawn on the CPU from a seeded generator, so a seed
    gives the same model on every device (but not the reference's weights:
    JAX draws other numbers; use `tpu_deer_torch.convert` to carry them).
    Returns the module in eval mode on `device` (None = the CUDA card).
    """
    device = resolve_device(device)
    model = CompleteDEERModel(config or DEERModelConfig())
    generator = torch.Generator().manual_seed(seed)
    init_flax_style_(model, generator)
    model.calibration.reset_parameters(generator)
    return model.to(device).eval()
