"""Normal-Inverse-Gamma (NIG) evidential math.

Port of `tpu_deer/core/nig.py`: the parameter constraints, the
aleatoric/epistemic decomposition, the closed-form Student-t E|y - mu|, and
the training half (the v1 and v2 NLLs, evidence regularizers and KL-style
regularizers, all elementwise; reduce with a mean outside).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

EPS = 1e-8


class NIGParams(NamedTuple):
    """NIG parameters; each leaf has identical shape [..., output_dim].

    mu:    predicted mean
    nu:    virtual observation count for the mean (> 0)
    alpha: inverse-gamma shape (> 1)
    beta:  inverse-gamma rate (> 0)
    """

    mu: torch.Tensor
    nu: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor


def nig_params_from_evidence(evidence: torch.Tensor) -> NIGParams:
    """Raw outputs [..., 4*D] or [..., D, 4] → constrained NIG params:
    nu = softplus + 1e-6, alpha = softplus + 1, beta = softplus + 1e-6."""
    if evidence.shape[-1] % 4 == 0 and evidence.shape[-1] != 4:
        d = evidence.shape[-1] // 4
        evidence = evidence.reshape(*evidence.shape[:-1], d, 4)
    mu = evidence[..., 0]
    nu = F.softplus(evidence[..., 1]) + 1e-6
    alpha = F.softplus(evidence[..., 2]) + 1.0
    beta = F.softplus(evidence[..., 3]) + 1e-6
    return NIGParams(mu=mu, nu=nu, alpha=alpha, beta=beta)


def nig_uncertainties(p: NIGParams) -> dict[str, torch.Tensor]:
    """aleatoric = beta / (alpha - 1), epistemic = beta / (nu (alpha - 1))."""
    denom = torch.clamp(p.alpha - 1.0, min=EPS)
    aleatoric = p.beta / denom
    epistemic = p.beta / (p.nu * denom)
    return {
        "aleatoric": aleatoric,
        "epistemic": epistemic,
        "total": aleatoric + epistemic,
    }


def nig_expected_abs_error(p: NIGParams) -> torch.Tensor:
    """Closed-form E|y - mu| under the NIG's Student-t posterior predictive:
    df = 2 alpha, s^2 = beta (1 + nu) / (nu alpha), and
    E|T_df| = 2 sqrt(df) Gamma((df+1)/2) / (sqrt(pi) (df-1) Gamma(df/2))."""
    df = 2.0 * p.alpha
    scale = torch.sqrt(p.beta * (1.0 + p.nu) / (p.nu * p.alpha))
    log_mad = (
        0.5 * torch.log(df)
        + torch.lgamma(0.5 * (df + 1.0))
        - torch.lgamma(0.5 * df)
        - torch.log(df - 1.0)
    )
    return scale * (2.0 / math.sqrt(math.pi) * torch.exp(log_mad))


def nig_nll(p: NIGParams, targets: torch.Tensor) -> torch.Tensor:
    """NIG negative log-likelihood, v1 form:
    0.5 log(pi/nu) - alpha log(2 beta) + lgamma(alpha) - lgamma(alpha + 0.5)
    + (alpha + 0.5) log(beta + nu (y - mu)^2 / 2)."""
    sq_err = torch.square(targets - p.mu)
    return (
        0.5 * torch.log(math.pi / p.nu)
        - p.alpha * torch.log(2.0 * p.beta)
        + torch.lgamma(p.alpha)
        - torch.lgamma(p.alpha + 0.5)
        + (p.alpha + 0.5) * torch.log(p.beta + 0.5 * p.nu * sq_err)
    )


def nig_nll_v2(p: NIGParams, targets: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """NIG NLL, v2 form: -[0.5 log(nu / (2 pi + eps)) + alpha log(beta + eps)
    - lgamma(alpha + eps) - (alpha + 0.5) log(beta + nu (y - mu)^2 / 2 + eps)]."""
    err2 = torch.square(targets - p.mu)
    log_prob = (
        0.5 * torch.log(p.nu / (2.0 * math.pi + eps))
        + p.alpha * torch.log(p.beta + eps)
        - torch.lgamma(p.alpha + eps)
        - (p.alpha + 0.5) * torch.log(p.beta + 0.5 * p.nu * err2 + eps)
    )
    return -log_prob


def evidence_regularizer(p: NIGParams, targets: torch.Tensor) -> torch.Tensor:
    """v1: (nu (y - mu)^2 + 2 beta (1 + nu)) / (2 nu (1 + nu))."""
    sq_err = torch.square(targets - p.mu)
    return (p.nu * sq_err + 2.0 * p.beta * (1.0 + p.nu)) / (
        2.0 * p.nu * (1.0 + p.nu))


def evidence_regularizer_v2(p: NIGParams, targets: torch.Tensor) -> torch.Tensor:
    """v2: (y - mu)^2 (2 beta + nu (y - mu)^2)."""
    err2 = torch.square(targets - p.mu)
    return err2 * (2.0 * p.beta + p.nu * err2)


def kl_regularizer(p: NIGParams) -> torch.Tensor:
    """v1, clamped at 0: 0.5 (nu - 1) + alpha log(beta) - lgamma(alpha)
    + lgamma(alpha + 0.5) - 0.5 log(2 pi beta)."""
    kl = (
        0.5 * (p.nu - 1.0)
        + p.alpha * torch.log(p.beta)
        - torch.lgamma(p.alpha)
        + torch.lgamma(p.alpha + 0.5)
        - 0.5 * torch.log(2.0 * math.pi * p.beta)
    )
    return torch.clamp(kl, min=0.0)


def kl_regularizer_v2(p: NIGParams, eps: float = 1e-6) -> torch.Tensor:
    """v2: (alpha - 1)^2 + 0.1 log(beta + eps)^2."""
    return torch.square(p.alpha - 1.0) + 0.1 * torch.square(
        torch.log(p.beta + eps))


# Outputs whose member mean is the combined output as it is.
_MEAN_KEYS = ("attention_weights", "fused", "loss")


def combine_members(member: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Moment matching over a leading member (or MC-sample) axis, as the
    reference combines a deep ensemble's members and MC-dropout samples
    (Lakshminarayanan et al., 2017, adapted to NIG members). With the
    disagreement d = Var_k(mu_k) (population variance):

      mu = mean mu_k;  aleatoric = mean aleatoric_k;
      epistemic = mean epistemic_k + d;  uncertainty = aleatoric + epistemic;
      calibrated_uncertainty = mean calibrated_k + d;
      eabs / expected_abs_error = sqrt(mean(eabs_k)^2 + 2/pi d)
        (the member E|err| forecasts combined in variance space);
      attention_weights, fused, loss: the member mean.

    `member` holds `mu`, `aleatoric` and `epistemic` and any of the others;
    the result has the same keys. Every path that combines members
    (`EnsembleTrainer`, `predict_mc_dropout`, `InferenceEngine`, the
    exported programs, `add_teacher_targets`) calls this."""
    mu = member["mu"]
    d = torch.var(mu, dim=0, correction=0)
    aleatoric = member["aleatoric"].mean(0)
    epistemic = member["epistemic"].mean(0) + d
    out = {"mu": mu.mean(0), "aleatoric": aleatoric, "epistemic": epistemic,
           "uncertainty": aleatoric + epistemic}
    if "calibrated_uncertainty" in member:
        out["calibrated_uncertainty"] = member["calibrated_uncertainty"].mean(0) + d
    for key in ("eabs", "expected_abs_error"):
        if key in member:
            out[key] = torch.sqrt(torch.square(member[key].mean(0))
                                  + 2.0 / math.pi * d)
    for key in _MEAN_KEYS:
        if key in member:
            out[key] = member[key].mean(0)
    return out
