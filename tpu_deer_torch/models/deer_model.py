"""The flagship CompleteDEERModel: trimodal evidential VAD regression.

Port of `tpu_deer/models/deer_model.py`: three feature-level encoders →
uncertainty-aware cross-modal attention → gated hierarchical fusion → three
DEER evidence heads → uncertainty calibration. 3,918,324 parameters at the
default config, as in the reference.

`compute_dtype` (e.g. "bfloat16") is the dtype of the dense path, as the
reference's: the inputs are cast to it on entry and every encoder,
attention, fusion and evidence layer computes in it, while the parameters,
the NIG math and the calibration layer stay float32 (`models/layers.py`).
So `mu_all` and the uncertainties are float32; `attention_weights`,
`modality_uncertainties` and `fused_features` are in the compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn
from torch.func import functional_call, vmap

from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.models.attention import UncertaintyAwareAttention
from tpu_deer_torch.models.encoders import ModalityEncoder
from tpu_deer_torch.models.fusion import HierarchicalFusion
from tpu_deer_torch.models.heads import (
    DEERPredictionHead,
    UncertaintyCalibrationLayer,
)
from tpu_deer_torch.models.layers import init_flax_style_, torch_dtype


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

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (ValueError for a name that is not a float)."""
        return torch_dtype(self.compute_dtype)


def _check_supported(cfg: DEERModelConfig) -> None:
    if cfg.fusion_type != "hierarchical":
        raise NotImplementedError(
            f"fusion_type={cfg.fusion_type!r}: only 'hierarchical' is ported")
    if cfg.stacked_compute:
        raise NotImplementedError("stacked_compute=True is not ported yet")


class CompleteDEERModel(nn.Module):
    """audio[B,84], video[B,256], text[B,768] → NIG VAD predictions +
    uncertainty. Dropout follows `self.training`; serve in eval mode."""

    def __init__(self, config: DEERModelConfig = DEERModelConfig()):
        super().__init__()
        _check_supported(config)
        self.config = cfg = config
        self.dtype = dt = cfg.dtype
        enc = lambda dim: ModalityEncoder(dim, cfg.encoder_dim,
                                          cfg.encoder_layers, cfg.dropout, dt)
        self.audio_encoder = enc(cfg.audio_dim)
        self.video_encoder = enc(cfg.video_dim)
        self.text_encoder = enc(cfg.text_dim)
        self.uncertainty_attention = UncertaintyAwareAttention(
            cfg.encoder_dim, cfg.attention_heads, dropout=0.1, dtype=dt)
        self.fusion = HierarchicalFusion(cfg.encoder_dim, cfg.fusion_dim,
                                         cfg.dropout, dt)
        self.heads = nn.ModuleDict({
            name: DEERPredictionHead(cfg.fusion_dim, cfg.encoder_dim,
                                     cfg.dropout, output_dim=1, dtype=dt)
            for name in cfg.dim_names
        })
        self.calibration = UncertaintyCalibrationLayer(cfg.emotion_dims)

    def forward(self, audio, video, text) -> dict:
        dt = self.dtype
        a = self.audio_encoder(audio.to(dt))
        v = self.video_encoder(video.to(dt))
        t = self.text_encoder(text.to(dt))
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


def get_predictions_and_uncertainties(outputs: dict
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mu_all, calibrated_uncertainty) of the model's outputs."""
    return outputs["mu_all"], outputs["calibrated_uncertainty"]


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


def uncertainty_outputs(out: dict, dim_names: Sequence[str]) -> dict:
    """mu, the total, calibrated, aleatoric and epistemic uncertainty
    ([B, dims] each) from the model's outputs `out`: what the trainer's
    predictions, the serving engines and the teacher targets read (and
    `core/nig.py:combine_members` combines over members)."""
    cat = lambda key: torch.cat([out[f"{n}_{key}"] for n in dim_names], -1)
    return {"mu": out["mu_all"], "uncertainty": out["uncertainty_all"],
            "calibrated_uncertainty": out["calibrated_uncertainty"],
            "aleatoric": cat("aleatoric_uncertainty"),
            "epistemic": cat("epistemic_uncertainty")}


def structure(config: DEERModelConfig) -> CompleteDEERModel:
    """The flagship's module on the meta device: its structure, no weights
    (forwards pass them with `functional_call`)."""
    with torch.device("meta"):
        return CompleteDEERModel(config).eval()


def member_forward(model: CompleteDEERModel, params: dict, audio, video, text,
                   fn=lambda out: out, randomness: str = "error"):
    """`fn` of the model's outputs for every member of the stacked `params`,
    stacked on a leading member axis: one vmapped forward."""
    return vmap(lambda p: fn(functional_call(model, p, (audio, video, text))),
                randomness=randomness)(params)
