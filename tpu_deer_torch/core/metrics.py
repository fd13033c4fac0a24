"""Regression and uncertainty metrics (port of `tpu_deer/core/metrics.py`).

Two halves, as in the reference:

  * device metrics on tensors — `ccc_sufficient_stats` / `ccc_from_stats`
    (Lin's CCC from six additive sums, so shards can be summed before the
    ratio), `concordance_correlation_coefficient`, `pearson_correlation`,
    MAE, RMSE and `uncertainty_calibration_error`. Non-finite pairs are
    masked with `torch.where`, never dropped by boolean indexing, so the
    shapes stay static. They compute in float32, as the jnp originals.
  * host metrics in numpy — `ccc_np`, `pearson_np`, `reliability_np`,
    `ece_np`, `evaluate_predictions`, `statistical_significance_test` and
    `cross_dataset_transfer_effectiveness`, for the trainers' validation and
    the evaluators.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

EPS = 1e-8


def _valid_mask(*tensors: torch.Tensor) -> torch.Tensor:
    mask = torch.ones_like(tensors[0], dtype=torch.bool)
    for t in tensors:
        mask = mask & torch.isfinite(t)
    return mask


def _flat(x) -> torch.Tensor:
    return torch.as_tensor(x).reshape(-1)


class CCCStats(NamedTuple):
    """Sufficient statistics for CCC; additive across shards."""

    n: torch.Tensor
    sum_x: torch.Tensor
    sum_y: torch.Tensor
    sum_x2: torch.Tensor
    sum_y2: torch.Tensor
    sum_xy: torch.Tensor


def ccc_sufficient_stats(y_true: torch.Tensor, y_pred: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> CCCStats:
    """n, Σx, Σy, Σx², Σy², Σxy over the pairs in `mask` (default: the
    finite pairs), in float32."""
    if mask is None:
        mask = _valid_mask(y_true, y_pred)
    zero = torch.zeros((), dtype=torch.float32, device=y_true.device)
    x = torch.where(mask, y_true.float(), zero)
    y = torch.where(mask, y_pred.float(), zero)
    return CCCStats(n=mask.float().sum(), sum_x=x.sum(), sum_y=y.sum(),
                    sum_x2=(x * x).sum(), sum_y2=(y * y).sum(),
                    sum_xy=(x * y).sum())


def _moments(s: CCCStats):
    n = torch.clamp(s.n, min=1.0)
    mean_x, mean_y = s.sum_x / n, s.sum_y / n
    var_x = s.sum_x2 / n - mean_x ** 2
    var_y = s.sum_y2 / n - mean_y ** 2
    cov = s.sum_xy / n - mean_x * mean_y
    return mean_x, mean_y, var_x, var_y, cov


def ccc_from_stats(s: CCCStats) -> torch.Tensor:
    """Lin's CCC = 2 cov / (var_x + var_y + (mean_x - mean_y)²), population
    variances; 0 where the denominator is below EPS or n is 0."""
    mean_x, mean_y, var_x, var_y, cov = _moments(s)
    denom = var_x + var_y + torch.square(mean_x - mean_y)
    zero = torch.zeros_like(denom)
    ccc = torch.where(denom.abs() > EPS, 2.0 * cov / denom, zero)
    return torch.where(s.n > 0, ccc, zero)


def concordance_correlation_coefficient(y_true, y_pred) -> torch.Tensor:
    """Lin's CCC over the finite pairs."""
    return ccc_from_stats(ccc_sufficient_stats(_flat(y_true), _flat(y_pred)))


def pearson_correlation(y_true, y_pred) -> torch.Tensor:
    """Pearson r over the finite pairs."""
    _, _, var_x, var_y, cov = _moments(
        ccc_sufficient_stats(_flat(y_true), _flat(y_pred)))
    denom = torch.sqrt(torch.clamp(var_x * var_y, min=EPS * EPS))
    return torch.where(denom > EPS, cov / denom, torch.zeros_like(denom))


def _masked_mean_error(y_true, y_pred, fn) -> torch.Tensor:
    y_true, y_pred = _flat(y_true), _flat(y_pred)
    mask = _valid_mask(y_true, y_pred)
    n = torch.clamp(mask.sum().float(), min=1.0)
    err = torch.where(mask, fn(y_true - y_pred), torch.zeros_like(y_true))
    return err.sum() / n


def mean_absolute_error(y_true, y_pred) -> torch.Tensor:
    """MAE over the finite pairs."""
    return _masked_mean_error(y_true, y_pred, torch.abs)


def root_mean_squared_error(y_true, y_pred) -> torch.Tensor:
    """RMSE over the finite pairs."""
    return torch.sqrt(_masked_mean_error(y_true, y_pred, torch.square))


def uncertainty_calibration_error(predictions, targets, uncertainties,
                                  n_bins: int = 10) -> torch.Tensor:
    """Expected calibration error with uncertainty-quantile bins: errors and
    uncertainties averaged over the output dims, confidence 1 - u and
    accuracy 1 - |err| per bin, ECE = Σ_b w_b |conf_b - acc_b|; 1.0 with
    fewer finite rows than bins. Bins are [n_bins, N] mask matrices. As in
    the reference, a non-finite row (its u set to +inf) turns the bin sums
    into 0·inf = NaN, so the result is NaN unless every row is finite;
    `ece_np` drops such rows instead."""
    predictions = torch.as_tensor(predictions)
    targets = torch.as_tensor(targets)
    uncertainties = torch.as_tensor(uncertainties)
    errors = (predictions - targets).abs()
    if errors.dim() > 1:
        errors = errors.mean(dim=tuple(range(1, errors.dim())))
        uncertainties = uncertainties.mean(
            dim=tuple(range(1, uncertainties.dim())))
    errors, uncertainties = errors.reshape(-1), uncertainties.reshape(-1)

    mask = _valid_mask(errors, uncertainties)
    # Invalid rows go to +inf, outside every bin.
    u = torch.where(mask, uncertainties, torch.full_like(uncertainties, torch.inf))
    e = torch.where(mask, errors, torch.zeros_like(errors))
    finite_u = torch.where(mask, uncertainties,
                           torch.full_like(uncertainties, torch.nan))
    q = torch.linspace(0.0, 1.0, n_bins + 1, dtype=finite_u.dtype,
                       device=finite_u.device)
    edges = torch.nanquantile(finite_u, q)
    edges[0] = 0.0
    edges[-1] = torch.where(mask, uncertainties,
                            torch.full_like(uncertainties, -torch.inf)).max() + 1e-6

    in_bin = ((u[None, :] >= edges[:-1, None])
              & (u[None, :] < edges[1:, None])).float()
    counts = in_bin.sum(dim=1)
    safe = torch.clamp(counts, min=1.0)
    avg_conf = 1.0 - (in_bin * u[None, :]).sum(dim=1) / safe
    avg_acc = 1.0 - (in_bin * e[None, :]).sum(dim=1) / safe
    total = torch.clamp(mask.float().sum(), min=1.0)
    per_bin = torch.where(counts > 0, (avg_conf - avg_acc).abs(),
                          torch.zeros_like(counts))
    ece = (counts / total * per_bin).sum()
    return torch.where(mask.sum() < n_bins, torch.ones_like(ece), ece)


def ccc_np(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Concordance correlation coefficient over the finite pairs, float64."""
    x = np.asarray(y_true, dtype=np.float64).ravel()
    y = np.asarray(y_pred, dtype=np.float64).ravel()
    mask = np.isfinite(x) & np.isfinite(y)
    if mask.sum() == 0:
        return 0.0
    x, y = x[mask], y[mask]
    mx, my = x.mean(), y.mean()
    vx, vy = x.var(), y.var()
    cov = (x * y).mean() - mx * my
    denom = vx + vy + (mx - my) ** 2
    return float(2.0 * cov / denom) if abs(denom) > EPS else 0.0


def pearson_np(a: np.ndarray, b: np.ndarray) -> float:
    """Pearson correlation over the finite pairs, float64."""
    a = np.asarray(a, dtype=np.float64).ravel()
    b = np.asarray(b, dtype=np.float64).ravel()
    mask = np.isfinite(a) & np.isfinite(b)
    if mask.sum() < 2:
        return 0.0
    a, b = a[mask], b[mask]
    denom = a.std() * b.std()
    return (float(((a - a.mean()) * (b - b.mean())).mean() / denom)
            if denom > EPS else 0.0)


def reliability_np(predictions: np.ndarray, targets: np.ndarray,
                   uncertainties: np.ndarray, n_bins: int = 10) -> dict:
    """Reliability-curve data with uncertainty-quantile bins, confidence
    1 - u and accuracy 1 - |err| (the definition `ece_np` reports).
    Returns {bin_confidence, bin_accuracy, bin_count, ece}."""
    errors = np.abs(np.asarray(predictions) - np.asarray(targets))
    unc = np.asarray(uncertainties, dtype=np.float64)
    if errors.ndim > 1:
        errors = errors.mean(axis=tuple(range(1, errors.ndim)))
        unc = unc.mean(axis=tuple(range(1, unc.ndim)))
    errors = errors.ravel()
    unc = unc.ravel()
    mask = np.isfinite(errors) & np.isfinite(unc)
    empty = {"bin_confidence": [], "bin_accuracy": [], "bin_count": [],
             "ece": 1.0}
    if mask.sum() < n_bins:
        return empty
    errors, unc = errors[mask], unc[mask]
    edges = np.quantile(unc, np.linspace(0, 1, n_bins + 1))
    edges[0] = 0.0
    edges[-1] = unc.max() + 1e-6
    ece = 0.0
    total = len(errors)
    bin_conf, bin_acc, bin_count = [], [], []
    for i in range(n_bins):
        sel = (unc >= edges[i]) & (unc < edges[i + 1])
        if sel.sum() == 0:
            continue
        avg_conf = 1.0 - unc[sel].mean()
        avg_acc = 1.0 - errors[sel].mean()
        ece += (sel.sum() / total) * abs(avg_conf - avg_acc)
        bin_conf.append(float(avg_conf))
        bin_acc.append(float(avg_acc))
        bin_count.append(int(sel.sum()))
    return {"bin_confidence": bin_conf, "bin_accuracy": bin_acc,
            "bin_count": bin_count, "ece": float(ece)}


def ece_np(predictions: np.ndarray, targets: np.ndarray,
           uncertainties: np.ndarray, n_bins: int = 10) -> float:
    return reliability_np(predictions, targets, uncertainties, n_bins)["ece"]


def evaluate_predictions(
    predictions: np.ndarray,
    targets: np.ndarray,
    uncertainties: Optional[np.ndarray] = None,
    dim_names: tuple[str, ...] = ("valence", "arousal", "dominance"),
) -> dict[str, float]:
    """Per-dimension CCC, MAE and RMSE with their averages; with
    uncertainties also ECE and the uncertainty-error correlation."""
    predictions = np.asarray(predictions)
    targets = np.asarray(targets)
    if predictions.ndim == 1:
        predictions = predictions[:, None]
        targets = targets[:, None]

    results: dict[str, float] = {}
    cccs, maes, rmses = [], [], []
    for i, name in enumerate(dim_names[: predictions.shape[1]]):
        t, p = targets[:, i], predictions[:, i]
        valid = np.isfinite(t) & np.isfinite(p)
        err = np.abs(t[valid] - p[valid])
        ccc = ccc_np(t, p)
        mae = float(err.mean()) if err.size else float("inf")
        rmse = float(np.sqrt((err**2).mean())) if err.size else float("inf")
        results[f"ccc_{name}"] = ccc
        results[f"mae_{name}"] = mae
        results[f"rmse_{name}"] = rmse
        cccs.append(ccc)
        maes.append(mae)
        rmses.append(rmse)
    results["ccc_average"] = float(np.mean(cccs))
    results["mae_average"] = float(np.mean(maes))
    results["rmse_average"] = float(np.mean(rmses))

    if uncertainties is not None:
        results["ece"] = ece_np(predictions, targets, uncertainties)
        err = np.abs(predictions - targets).mean(axis=1)
        unc = np.asarray(uncertainties)
        if unc.ndim > 1:
            unc = unc.mean(axis=1)
        results["uncertainty_error_correlation"] = pearson_np(err, unc)
    return results


def statistical_significance_test(predictions1: np.ndarray, targets: np.ndarray,
                                  predictions2: np.ndarray,
                                  alpha: float = 0.05) -> dict:
    """Paired t-test and Cohen's d between two models' absolute errors (the
    per-row mean over dimensions); effect size small, medium (|d| > 0.5) or
    large (|d| > 0.8)."""
    from scipy import stats as sp_stats

    errors1 = np.abs(np.asarray(predictions1) - np.asarray(targets))
    errors2 = np.abs(np.asarray(predictions2) - np.asarray(targets))
    if errors1.ndim > 1:
        errors1 = errors1.mean(axis=1)
        errors2 = errors2.mean(axis=1)
    t_stat, p_value = sp_stats.ttest_rel(errors1, errors2)
    pooled_std = np.sqrt((np.var(errors1) + np.var(errors2)) / 2.0)
    cohens_d = float((np.mean(errors1) - np.mean(errors2)) / pooled_std
                     if pooled_std > 0 else 0.0)
    effect = ("large" if abs(cohens_d) > 0.8 else
              "medium" if abs(cohens_d) > 0.5 else "small")
    return {"t_statistic": float(t_stat), "p_value": float(p_value),
            "cohens_d": cohens_d, "effect_size": effect,
            "significant": bool(p_value < alpha), "alpha": alpha}


def cross_dataset_transfer_effectiveness(source_performance: float,
                                         target_performance: float) -> float:
    """target / source performance clamped to [0, 1]; 0 when the source's is
    not positive."""
    if source_performance <= 0:
        return 0.0
    return max(0.0, min(1.0, target_performance / source_performance))
