"""Split conformal prediction intervals on top of NIG uncertainty.

Own copy of `tpu_deer/eval/conformal.py`. Split conformal prediction wraps
the evidential model's point predictions and uncertainty estimates in intervals with a
*finite-sample, distribution-free* marginal coverage guarantee —
P(y in interval) >= 1 - alpha for exchangeable calibration/test data
(Vovk et al.; Papadopoulos et al. 2002 "inductive conformal prediction").

Two variants, both O(n log n) host-side numpy (eval only; nothing enters the
training graph):

- **absolute**: score s_i = |y_i - mu_i|; the interval half-width is the
  ceil((n+1)(1-alpha))/n empirical quantile of calibration scores. Every
  sample gets the same half-width.
- **normalized**: score s_i = |y_i - mu_i| / sigma_i with sigma_i from the
  NIG head (sqrt of total predictive variance). Intervals are per-sample
  adaptive — tight where the model is confident, wide where it is not —
  while keeping the same coverage guarantee. This is where evidential
  uncertainty pays off: better uncertainty => shorter intervals at the same
  coverage.

Complements `eval/calibration.py` (post-hoc scale fit): the scale fit makes
raw NIG variances *statistically* calibrated in expectation; conformal gives
hard coverage at a chosen level regardless of how well-specified the NIG
model is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = [
    "ConformalIntervals",
    "ConformalCalibrator",
    "conformal_quantile",
]


def conformal_quantile(scores: np.ndarray, alpha: float) -> float:
    """Finite-sample-corrected (1-alpha) quantile of calibration scores.

    Uses the ceil((n+1)(1-alpha))/n order statistic (the standard split
    conformal correction). If n is too small for the requested level
    (ceil((n+1)(1-alpha)) > n), returns +inf — the honest answer: no finite
    interval has guaranteed coverage.
    """
    scores = np.asarray(scores, dtype=np.float64).ravel()
    n = scores.size
    if n == 0:
        raise ValueError("conformal_quantile needs at least one score")
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")
    rank = int(np.ceil((n + 1) * (1.0 - alpha)))
    if rank > n:
        return float("inf")
    return float(np.sort(scores)[rank - 1])


@dataclass
class ConformalIntervals:
    """Per-sample intervals [lower, upper] plus diagnostics."""

    lower: np.ndarray  # [N, D]
    upper: np.ndarray  # [N, D]
    alpha: float
    half_width: np.ndarray  # per-dim scalar (absolute) broadcast to [N, D]

    def coverage(self, targets: np.ndarray) -> np.ndarray:
        """Empirical per-dim coverage of `targets` [N, D] -> [D]."""
        t = np.asarray(targets, dtype=np.float64)
        inside = (t >= self.lower) & (t <= self.upper)
        return inside.mean(axis=0)

    def mean_width(self) -> np.ndarray:
        """Mean interval width per dim -> [D] (efficiency metric)."""
        return (self.upper - self.lower).mean(axis=0)


class ConformalCalibrator:
    """Split conformal calibration for multi-dim regression (VAD).

    Fit on a held-out calibration split (predictions + uncertainties +
    targets), then produce intervals for new predictions. Each output dim is
    calibrated independently (marginal per-dim coverage).

    >>> cal = ConformalCalibrator(alpha=0.1, normalized=True)
    >>> cal.fit(mu_cal, sigma_cal, y_cal)
    >>> iv = cal.intervals(mu_test, sigma_test)
    >>> iv.coverage(y_test)   # ~>= 0.9 per dim
    """

    def __init__(self, alpha: float = 0.1, normalized: bool = True):
        self.alpha = float(alpha)
        self.normalized = bool(normalized)
        self.q_: Optional[np.ndarray] = None  # [D]

    @staticmethod
    def _as_2d(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        return x[:, None] if x.ndim == 1 else x

    def fit(
        self,
        mu: np.ndarray,
        sigma: Optional[np.ndarray],
        targets: np.ndarray,
    ) -> "ConformalCalibrator":
        """Compute per-dim conformal quantiles from a calibration split.

        mu, targets: [N, D] (or [N]); sigma: same shape, required when
        `normalized=True` (total predictive std from the NIG head).
        """
        mu = self._as_2d(mu)
        targets = self._as_2d(targets)
        err = np.abs(targets - mu)
        if self.normalized:
            if sigma is None:
                raise ValueError("normalized conformal needs sigma")
            sig = np.maximum(self._as_2d(sigma), 1e-8)
            scores = err / sig
        else:
            scores = err
        self.q_ = np.array(
            [conformal_quantile(scores[:, d], self.alpha)
             for d in range(scores.shape[1])]
        )
        return self

    def intervals(
        self, mu: np.ndarray, sigma: Optional[np.ndarray] = None
    ) -> ConformalIntervals:
        """Intervals for new predictions (same shapes as fit)."""
        if self.q_ is None:
            raise RuntimeError("call fit() before intervals()")
        mu = self._as_2d(mu)
        if self.normalized:
            if sigma is None:
                raise ValueError("normalized conformal needs sigma")
            half = np.maximum(self._as_2d(sigma), 1e-8) * self.q_[None, :]
        else:
            half = np.broadcast_to(self.q_[None, :], mu.shape).copy()
        return ConformalIntervals(
            lower=mu - half, upper=mu + half, alpha=self.alpha, half_width=half
        )

    def report(
        self,
        mu: np.ndarray,
        sigma: Optional[np.ndarray],
        targets: np.ndarray,
    ) -> dict:
        """Coverage/width summary on a test split -> JSON-ready dict."""
        iv = self.intervals(mu, sigma)
        return {
            "alpha": self.alpha,
            "normalized": self.normalized,
            "nominal_coverage": 1.0 - self.alpha,
            "empirical_coverage": iv.coverage(targets).tolist(),
            "mean_width": iv.mean_width().tolist(),
            "quantiles": np.asarray(self.q_).tolist(),
        }
