"""DEER training losses.

Port of `tpu_deer/core/losses.py`: `DEERLossConfig`, `binned_ece_loss`,
`deer_loss` (v1 and v2), `multi_task_deer_loss`, and the uncertainty
regularization, reliability-diagram calibration and combined losses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from tpu_deer_torch.core import nig as nig_lib
from tpu_deer_torch.core.nig import NIGParams

EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class DEERLossConfig:
    """variant "v1": NLL + evidence reg + KL (weights evidence/kl);
    variant "v2": NLL + reg + KL-to-prior + differentiable binned ECE."""

    variant: str = "v2"
    evidence_weight: float = 1.0  # v1
    kl_weight: float = 1.0  # v1
    reg_weight: float = 0.1  # v2
    kl_weight_v2: float = 0.01
    ece_weight: float = 0.05
    ece_bins: int = 10


def binned_ece_loss(p: NIGParams, targets: torch.Tensor,
                    n_bins: int = 10) -> torch.Tensor:
    """Differentiable binned ECE: confidence 1 / (1 + beta / (alpha - 1)),
    accuracy 1 - |y - mu|, uniform bins over (0, 1], one-hot bin masks."""
    errors = torch.abs(targets - p.mu).reshape(-1)
    uncertainty = p.beta / (p.alpha - 1.0 + EPS)
    confidence = (1.0 / (1.0 + uncertainty)).reshape(-1)

    edges = torch.linspace(0.0, 1.0, n_bins + 1, device=confidence.device)
    in_bin = ((confidence[None, :] > edges[:-1, None])
              & (confidence[None, :] <= edges[1:, None])).to(confidence.dtype)
    counts = in_bin.sum(dim=1)
    safe = torch.clamp(counts, min=1.0)
    avg_conf = (in_bin * confidence[None, :]).sum(dim=1) / safe
    avg_acc = 1.0 - (in_bin * errors[None, :]).sum(dim=1) / safe
    weights = counts / confidence.shape[0]
    per_bin = torch.where(counts > 0, torch.abs(avg_conf - avg_acc), 0.0)
    return torch.sum(weights * per_bin)


def deer_loss(p: NIGParams, targets: torch.Tensor,
              config: DEERLossConfig = DEERLossConfig()) -> dict:
    """Single-head DEER loss: a dict of scalar loss components."""
    targets = torch.broadcast_to(targets.reshape(targets.shape[0], -1),
                                 p.mu.shape)
    sq_err = torch.square(targets - p.mu)
    out = {"mse": torch.mean(sq_err)}
    if config.variant == "v1":
        nll = torch.mean(nig_lib.nig_nll(p, targets))
        reg = torch.mean(nig_lib.evidence_regularizer(p, targets))
        kl = torch.mean(nig_lib.kl_regularizer(p))
        total = nll + config.evidence_weight * reg + config.kl_weight * kl
        out.update(nll_loss=nll, evidence_reg=reg, kl_reg=kl, total_loss=total)
    elif config.variant == "v2":
        nll = torch.mean(nig_lib.nig_nll_v2(p, targets))
        reg = torch.mean(nig_lib.evidence_regularizer_v2(p, targets))
        kl = torch.mean(nig_lib.kl_regularizer_v2(p))
        ece = binned_ece_loss(p, targets, config.ece_bins)
        total = (nll + config.reg_weight * reg + config.kl_weight_v2 * kl
                 + config.ece_weight * ece)
        out.update(nll_loss=nll, reg_loss=reg, kl_loss=kl, ece_loss=ece,
                   total_loss=total)
    else:
        raise ValueError(f"unknown DEER loss variant: {config.variant!r}")
    return out


def multi_task_deer_loss(
    params_per_dim: Sequence[NIGParams],
    targets: torch.Tensor,
    config: DEERLossConfig = DEERLossConfig(),
    task_weights: Optional[Sequence[float]] = None,
    cross_dim_weight: float = 0.05,
    dim_names: Sequence[str] = ("valence", "arousal", "dominance"),
) -> dict:
    """Per-dimension weighted DEER loss averaged over dimensions, plus the
    mean squared difference of batch-mean uncertainties over dimension
    pairs (cross-dimensional consistency)."""
    n = len(params_per_dim)
    if task_weights is None:
        task_weights = [1.0] * n
    out: dict = {}
    total = torch.zeros((), device=targets.device)
    for i, (p, name) in enumerate(zip(params_per_dim, dim_names)):
        dim_losses = deer_loss(p, targets[:, i:i + 1], config)
        total = total + task_weights[i] * dim_losses["total_loss"]
        for k, v in dim_losses.items():
            out[f"{name}_{k}"] = v

    if cross_dim_weight > 0 and n > 1:
        mean_unc = [torch.mean(p.beta / (p.alpha - 1.0 + EPS), dim=0)
                    for p in params_per_dim]
        consistency = torch.zeros((), device=targets.device)
        n_pairs = 0
        for i in range(n):
            for j in range(i + 1, n):
                consistency = consistency + torch.mean(
                    torch.square(mean_unc[i] - mean_unc[j]))
                n_pairs += 1
        consistency = consistency / n_pairs
        total = total + cross_dim_weight * consistency
        out["cross_dim_loss"] = consistency

    out["total_loss"] = total / n
    return out


def uncertainty_regularization_loss(p: NIGParams, diversity_weight: float = 0.1,
                                    sparsity_weight: float = 0.01) -> dict:
    """Diversity (-log of the batch variance of u) and sparsity (mean u)
    regularizers of u = beta / (alpha - 1)."""
    uncertainty = p.beta / (p.alpha - 1.0 + EPS)
    diversity = -torch.log(torch.mean(torch.var(uncertainty, dim=0,
                                                correction=0)) + EPS)
    sparsity = torch.mean(uncertainty)
    return {"reg_loss": diversity_weight * diversity + sparsity_weight * sparsity,
            "diversity_loss": diversity, "sparsity_loss": sparsity}


def calibration_loss(p: NIGParams, targets: torch.Tensor, n_bins: int = 15,
                     bin_strategy: str = "uniform",
                     max_error: float = 2.0) -> torch.Tensor:
    """Reliability-diagram calibration loss: accuracy 1 - clip(|err| /
    max_error, 0, 1), confidence 1 / (1 + u), bins uniform over [0, 1] or
    at confidence quantiles; the last bin includes its upper edge."""
    targets = torch.broadcast_to(targets.reshape(targets.shape[0], -1),
                                 p.mu.shape)
    errors = torch.abs(targets - p.mu).reshape(-1)
    uncertainty = p.beta / (p.alpha - 1.0 + EPS)
    confidence = (1.0 / (1.0 + uncertainty)).reshape(-1)
    accuracy = 1.0 - torch.clamp(errors / max_error, 0.0, 1.0)
    grid = torch.linspace(0.0, 1.0, n_bins + 1, device=confidence.device)
    edges = grid if bin_strategy == "uniform" else torch.quantile(confidence, grid)
    lower = confidence[None, :] >= edges[:-1, None]
    upper = confidence[None, :] < edges[1:, None]
    last = torch.arange(n_bins, device=confidence.device)[:, None] == n_bins - 1
    upper = torch.where(last, confidence[None, :] <= edges[1:, None], upper)
    in_bin = (lower & upper).to(confidence.dtype)
    counts = in_bin.sum(dim=1)
    safe = torch.clamp(counts, min=1.0)
    avg_conf = (in_bin * confidence[None, :]).sum(dim=1) / safe
    avg_acc = (in_bin * accuracy[None, :]).sum(dim=1) / safe
    weights = counts / confidence.shape[0]
    per_bin = torch.where(counts > 0, torch.abs(avg_conf - avg_acc), 0.0)
    return torch.sum(weights * per_bin)


def combined_deer_loss(
    params_per_dim: Sequence[NIGParams],
    targets: torch.Tensor,
    config: DEERLossConfig = DEERLossConfig(),
    task_weights: Optional[Sequence[float]] = None,
    cross_dim_weight: float = 0.05,
    uncertainty_reg_weight: float = 1.0,
    calibration_weight: float = 0.1,
) -> dict:
    """Multi-task DEER loss + uncertainty regularization + calibration loss
    over the dimensions stacked along the last axis."""
    out = multi_task_deer_loss(params_per_dim, targets, config, task_weights,
                               cross_dim_weight)
    total = out["total_loss"]
    stacked = NIGParams(*(torch.cat([getattr(p, f) for p in params_per_dim],
                                    dim=-1)
                          for f in ("mu", "nu", "alpha", "beta")))
    unc_reg = uncertainty_regularization_loss(stacked)
    out["uncertainty_reg_loss"] = unc_reg["reg_loss"]
    total = total + uncertainty_reg_weight * unc_reg["reg_loss"]
    cal = calibration_loss(stacked, targets)
    out["calibration_loss"] = cal
    out["total_loss"] = total + calibration_weight * cal
    return out
