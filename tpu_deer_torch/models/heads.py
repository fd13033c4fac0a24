"""DEER prediction heads and the uncertainty calibration layer."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_deer_torch.core.nig import nig_params_from_evidence, nig_uncertainties
from tpu_deer_torch.models.layers import MLP, lecun_normal_


def evidence_outputs(evidence: torch.Tensor, output_dim: int = 1) -> dict:
    """Raw evidence [..., 4 · output_dim] (any dtype) → NIG params and
    uncertainties in float32: the evidence is cast up first."""
    evidence = evidence.to(torch.float32)
    evidence = evidence.reshape(*evidence.shape[:-1], output_dim, 4)
    params = nig_params_from_evidence(evidence)
    unc = nig_uncertainties(params)
    return {
        "params": params,
        "mu": params.mu,
        "nu": params.nu,
        "alpha": params.alpha,
        "beta": params.beta,
        "aleatoric_uncertainty": unc["aleatoric"],
        "epistemic_uncertainty": unc["epistemic"],
        "uncertainty": unc["total"],
    }


class DEERPredictionHead(nn.Module):
    """Evidence network for one emotion dimension (computed in `dtype`) →
    NIG params + uncertainties (float32: the evidence is cast up first)."""

    def __init__(self, in_features: int, hidden_dim: int = 256,
                 dropout: float = 0.3, output_dim: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.output_dim = output_dim
        self.evidence_network = MLP(
            in_features, [hidden_dim, hidden_dim // 2, 4 * output_dim],
            dropout=dropout, dtype=dtype,
        )

    def forward(self, x: torch.Tensor) -> dict:
        return evidence_outputs(self.evidence_network(x), self.output_dim)


class MultiDimensionalDEER(nn.Module):
    """Shared 2-layer feature processor (ReLU after both layers) + one DEER
    head per emotion dimension, named `head_{dim}` as in the reference."""

    def __init__(self, input_dim: int, hidden_dim: int = 256,
                 dim_names=("valence", "arousal", "dominance"),
                 dropout: float = 0.3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim_names = tuple(dim_names)
        self.feature_processor = MLP(input_dim, [hidden_dim, hidden_dim],
                                     dropout=dropout, final_activation="relu",
                                     dtype=dtype)
        for name in self.dim_names:
            self.add_module(f"head_{name}",
                            DEERPredictionHead(hidden_dim, hidden_dim, dropout,
                                               dtype=dtype))

    def forward(self, x: torch.Tensor) -> dict:
        h = self.feature_processor(x)
        out: dict = {}
        mus, totals = [], []
        for name in self.dim_names:
            head = getattr(self, f"head_{name}")(h)
            for k, v in head.items():
                out[f"{name}_{k}"] = v
            mus.append(head["mu"])
            totals.append(head["uncertainty"])
        out["mu_all"] = torch.cat(mus, dim=-1)
        out["uncertainty_all"] = torch.cat(totals, dim=-1)
        return out


# softplus(0.5413248) + 1e-3 ≈ 1: the calibration starts as the identity scale.
_TEMPERATURE_INIT = 0.5413248


class UncertaintyCalibrationLayer(nn.Module):
    """Learned per-dimension temperature + a shared monotone 1→32→16→1
    MLP-sigmoid map, applied to all dimensions in one batched pass.

    The temperature is positive by construction (softplus of the raw,
    pre-softplus parameter, + 1e-3), the map is monotone (|kernel|), and
    the input is detached: calibration is post-hoc. Parameters keep the
    reference's flat names and [in, out] kernel layout.
    """

    def __init__(self, num_dimensions: int = 3):
        super().__init__()
        self.temperature = nn.Parameter(
            torch.full((num_dimensions,), _TEMPERATURE_INIT))
        for name, (fan_in, fan_out) in (("cal1", (1, 32)), ("cal2", (32, 16)),
                                        ("cal3", (16, 1))):
            self.register_parameter(
                f"{name}_kernel", nn.Parameter(torch.empty(fan_in, fan_out)))
            self.register_parameter(
                f"{name}_bias", nn.Parameter(torch.zeros(fan_out)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.temperature.fill_(_TEMPERATURE_INIT)
            for name in ("cal1", "cal2", "cal3"):
                kernel = getattr(self, f"{name}_kernel")
                lecun_normal_(kernel, kernel.shape[0], generator)
                getattr(self, f"{name}_bias").zero_()

    def _monotone_dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        kernel = getattr(self, f"{name}_kernel")
        return x @ torch.abs(kernel) + getattr(self, f"{name}_bias")

    def forward(self, uncertainties: torch.Tensor) -> torch.Tensor:
        uncertainties = uncertainties.detach()
        temperature = F.softplus(self.temperature) + 1e-3
        scaled = uncertainties / temperature[None, :]
        b, d = scaled.shape
        flat = scaled.reshape(b * d, 1)
        h = torch.relu(self._monotone_dense("cal1", flat))
        h = torch.relu(self._monotone_dense("cal2", h))
        cal = torch.sigmoid(self._monotone_dense("cal3", h))
        return cal.reshape(b, d)
