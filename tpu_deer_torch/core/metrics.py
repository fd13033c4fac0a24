"""Host-side metrics in numpy (own copy of the reference's `ccc_np` and
`pearson_np` in `tpu_deer/core/metrics.py`), for the trainer's val CCC."""

from __future__ import annotations

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
