"""Uncertainty quality: the uncertainty-error correlation, sparsification
and AUSE, and the uncertainty's distribution.

Own copy of `tpu_deer/eval/uncertainty.py` (numpy).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tpu_deer_torch.core.metrics import pearson_np


def sparsification_curve(errors: np.ndarray, uncertainties: np.ndarray,
                         n_steps: int = 20) -> dict:
    """Drop the most uncertain share f of the rows (f over n_steps points
    in [0, 0.99]) and take the mean error of the rest; the oracle drops by
    the true error. AUSE is the area between the two curves over the first
    point of the uncertainty curve (lower is better)."""
    errors = np.asarray(errors).ravel()
    uncertainties = np.asarray(uncertainties).ravel()
    n = len(errors)
    by_unc = np.argsort(-uncertainties)
    by_err = np.argsort(-errors)
    fractions = np.linspace(0.0, 0.99, n_steps)
    curve = np.asarray([errors[by_unc[int(f * n):]].mean() for f in fractions])
    oracle = np.asarray([errors[by_err[int(f * n):]].mean() for f in fractions])
    base = curve[0] if curve[0] > 0 else 1.0
    ause = float(np.trapezoid(curve - oracle, fractions) / base)
    return {"fractions": fractions, "sparsification": curve, "oracle": oracle,
            "ause": ause}


class UncertaintyAnalyzer:
    """The uncertainty-error correlation (over the rows' means and per
    dimension), AUSE with its curves, the uncertainty's statistics and,
    given both components, the aleatoric and epistemic shares."""

    def analyze(self, predictions: np.ndarray, targets: np.ndarray,
                uncertainties: np.ndarray, aleatoric: Optional[np.ndarray] = None,
                epistemic: Optional[np.ndarray] = None) -> dict:
        predictions = np.asarray(predictions)
        uncertainties = np.asarray(uncertainties)
        errors = np.abs(predictions - np.asarray(targets))
        dims = ("valence", "arousal", "dominance")
        per_dim = {dims[i] if i < 3 else f"dim_{i}":
                   pearson_np(errors[:, i], uncertainties[:, i])
                   for i in range(predictions.shape[1])}
        spars = sparsification_curve(errors.mean(axis=1),
                                     uncertainties.mean(axis=1))
        out = {
            "uncertainty_error_correlation": pearson_np(
                errors.mean(axis=1), uncertainties.mean(axis=1)),
            "per_dim_correlation": per_dim,
            "ause": spars["ause"],
            "sparsification": spars,
            "uncertainty_stats": {
                "mean": float(uncertainties.mean()),
                "std": float(uncertainties.std()),
                "min": float(uncertainties.min()),
                "max": float(uncertainties.max()),
                "median": float(np.median(uncertainties)),
            },
        }
        if aleatoric is not None and epistemic is not None:
            aleatoric, epistemic = np.asarray(aleatoric), np.asarray(epistemic)
            total = np.maximum(aleatoric + epistemic, 1e-8)
            out["decomposition"] = {
                "aleatoric_fraction": float(np.mean(aleatoric / total)),
                "epistemic_fraction": float(np.mean(epistemic / total)),
            }
        return out
