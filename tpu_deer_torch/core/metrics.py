"""Host-side metrics in numpy: own copy of the reference's `ccc_np`,
`pearson_np`, `reliability_np`, `ece_np`, `evaluate_predictions` and
`statistical_significance_test` (`tpu_deer/core/metrics.py`), for the
trainers' validation and the evaluators. The jnp metrics and
`cross_dataset_transfer_effectiveness` are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

EPS = 1e-8


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
