"""Statistical validation: per-dimension correlations, bias tests and
bootstrap CIs of CCC.

Own copy of `tpu_deer/eval/statistics.py` (numpy and scipy): the bootstrap
draws every resample's indices from `np.random.default_rng(seed)` in one
call and computes each resample's CCC from batched sufficient statistics,
so the same seed gives the same interval as the reference.
"""

from __future__ import annotations

import numpy as np
from scipy import stats as sp_stats

from tpu_deer_torch.core import metrics as metrics_lib


def bootstrap_ccc_ci(y_true: np.ndarray, y_pred: np.ndarray,
                     n_resamples: int = 1000, confidence: float = 0.95,
                     seed: int = 0) -> tuple[float, float]:
    """Percentile bootstrap CI for Lin's CCC, vectorized over resamples."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_pred = np.asarray(y_pred, dtype=np.float64).ravel()
    n = len(y_true)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n_resamples, n))
    x = y_true[idx]  # [R, n]
    y = y_pred[idx]
    mean_x = x.mean(axis=1)
    mean_y = y.mean(axis=1)
    var_x = x.var(axis=1)
    var_y = y.var(axis=1)
    cov = (x * y).mean(axis=1) - mean_x * mean_y
    denom = var_x + var_y + (mean_x - mean_y) ** 2
    ccc = np.where(np.abs(denom) > 1e-12, 2.0 * cov / denom, 0.0)
    alpha = (1.0 - confidence) / 2.0
    return (float(np.quantile(ccc, alpha)),
            float(np.quantile(ccc, 1.0 - alpha)))


class StatisticalValidator:
    def __init__(self, n_bootstrap: int = 1000, confidence: float = 0.95,
                 seed: int = 0):
        self.n_bootstrap = n_bootstrap
        self.confidence = confidence
        self.seed = seed

    def validate(self, predictions: np.ndarray, targets: np.ndarray,
                 dims=("valence", "arousal", "dominance")) -> dict:
        """Per dimension: Pearson and Spearman with p-values, a one-sample
        t-test of the errors against 0 (bias), CCC and its bootstrap CI."""
        predictions = np.asarray(predictions)
        targets = np.asarray(targets)
        out: dict = {}
        for i, name in enumerate(dims[: predictions.shape[1]]):
            p, t = predictions[:, i], targets[:, i]
            pearson_r, pearson_p = sp_stats.pearsonr(t, p)
            spearman_r, spearman_p = sp_stats.spearmanr(t, p)
            terr = sp_stats.ttest_1samp(p - t, 0.0)
            out[name] = {
                "pearson_r": float(pearson_r),
                "pearson_p": float(pearson_p),
                "spearman_r": float(spearman_r),
                "spearman_p": float(spearman_p),
                "bias_t_statistic": float(terr.statistic),
                "bias_p_value": float(terr.pvalue),
                "ccc": metrics_lib.ccc_np(t, p),
                "ccc_ci": bootstrap_ccc_ci(t, p, self.n_bootstrap,
                                           self.confidence, self.seed),
            }
        return out
