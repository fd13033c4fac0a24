"""Normal-Inverse-Gamma (NIG) evidential math for serving.

Port of the inference half of `tpu_deer/core/nig.py`: the parameter
constraints, the aleatoric/epistemic decomposition and the closed-form
Student-t E|y - mu|. The losses and NLLs come with training.
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
