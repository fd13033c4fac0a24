"""Calibration analysis: a post-hoc uncertainty scale and reliability data.

Own copy of `tpu_deer/eval/calibration.py` (numpy).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tpu_deer_torch.core.metrics import ece_np


def fit_uncertainty_scale(predictions: np.ndarray, targets: np.ndarray,
                          uncertainties: np.ndarray,
                          scales: Optional[np.ndarray] = None) -> float:
    """The multiplicative scale of the uncertainty, from a grid (81 points
    log-spaced over [0.1, 10] by default), that minimizes ECE on a
    held-out split."""
    if scales is None:
        scales = np.logspace(-1.0, 1.0, 81)
    eces = [ece_np(predictions, targets, s * np.asarray(uncertainties))
            for s in scales]
    return float(scales[int(np.argmin(eces))])


class CalibrationAnalyzer:
    """Threshold-accuracy ECE: confidence = 1 - u / max(u); "accuracy" =
    the error is at most the median error; uniform confidence bins."""

    def __init__(self, n_bins: int = 10):
        self.n_bins = n_bins

    def analyze(self, predictions: np.ndarray, targets: np.ndarray,
                uncertainties: np.ndarray) -> dict:
        predictions = np.asarray(predictions)
        targets = np.asarray(targets)
        uncertainties = np.asarray(uncertainties)

        errors = np.abs(predictions - targets)
        if errors.ndim > 1:
            errors = errors.mean(axis=1)
            uncertainties = uncertainties.mean(axis=1)

        max_u = uncertainties.max() if uncertainties.max() > 0 else 1.0
        confidence = 1.0 - uncertainties / max_u
        accuracy = (errors <= np.median(errors)).astype(np.float64)

        edges = np.linspace(0.0, 1.0, self.n_bins + 1)
        bin_conf, bin_acc, bin_count = [], [], []
        ece = 0.0
        for i in range(self.n_bins):
            lo, hi = edges[i], edges[i + 1]
            sel = (confidence >= lo) & (
                confidence <= hi if i == self.n_bins - 1 else confidence < hi)
            if sel.sum() == 0:
                continue
            c = float(confidence[sel].mean())
            a = float(accuracy[sel].mean())
            ece += sel.sum() / len(confidence) * abs(c - a)
            bin_conf.append(c)
            bin_acc.append(a)
            bin_count.append(int(sel.sum()))

        return {
            "ece": float(ece),
            "reliability": {"bin_confidence": bin_conf,
                            "bin_accuracy": bin_acc, "bin_count": bin_count},
            "reliability_score": float(1.0 - ece),
        }
