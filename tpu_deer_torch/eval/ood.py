"""Feature-space out-of-distribution detection (shrinkage Mahalanobis).

The port's own copy of `tpu_deer/eval/ood.py`: the detector is fitted and
thresholded on the host in numpy (same arithmetic, same `.npz` format, so a
detector saved by either package loads in the other), and its score runs
on the serving device through the torch twins `input_norm_features_device`
and `mahalanobis_score_device`, next to the model's forward.

Two feature spaces, chosen at fit time (`space=`):

  * ``"input_norm"``: per-modality L2-normalized raw features,
    concatenated; a global gain change maps to the same point, so the
    detector is gain-invariant by construction.
  * ``"fused"``: the model's fused representation (`CompleteDEERModel`
    output `fused_features`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

__all__ = [
    "MahalanobisOOD",
    "mahalanobis_score_device",
    "input_norm_features",
    "input_norm_features_device",
    "ood_auroc",
]


def input_norm_features(*modalities) -> np.ndarray:
    """Per-modality L2-normalized concatenation (numpy, host side)."""
    parts = []
    for x in modalities:
        x = np.asarray(x, np.float32)
        parts.append(x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-8))
    return np.concatenate(parts, axis=-1)


def input_norm_features_device(*modalities: torch.Tensor) -> torch.Tensor:
    """Torch twin of `input_norm_features`, on the tensors' device."""
    return torch.cat(
        [x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)
         for x in modalities], dim=-1)


def mahalanobis_score_device(features: torch.Tensor, mean: torch.Tensor,
                             whitener: torch.Tensor) -> torch.Tensor:
    """Squared Mahalanobis score ||(x - m) @ W||^2, with precision = W @ W.T."""
    z = (features - mean) @ whitener
    return torch.sum(torch.square(z), dim=-1)


def ood_auroc(scores_in: np.ndarray, scores_out: np.ndarray) -> float:
    """AUROC of `scores_out` (positives) vs `scores_in` via rank statistic."""
    s_in = np.asarray(scores_in, np.float64).ravel()
    s_out = np.asarray(scores_out, np.float64).ravel()
    allv = np.concatenate([s_in, s_out])
    ranks = np.argsort(np.argsort(allv, kind="mergesort"), kind="mergesort")
    r_out = ranks[len(s_in):].astype(np.float64) + 1.0
    n_in, n_out = len(s_in), len(s_out)
    u = r_out.sum() - n_out * (n_out + 1) / 2.0
    return float(u / (n_in * n_out))


@dataclass
class _FitState:
    mean: np.ndarray        # [D]
    whitener: np.ndarray    # [D, D], precision = W @ W.T
    train_scores: np.ndarray  # sorted, for quantile thresholds
    shrinkage: float
    space: str = "fused"    # what features fit() saw: "input_norm"|"fused"


class MahalanobisOOD:
    """Shrinkage-regularized Mahalanobis OOD detector.

    Fit on in-distribution features, score new samples by squared
    Mahalanobis distance to the training cloud, and threshold at a chosen
    training-quantile false-positive rate. Shrinkage toward the scaled
    identity keeps the covariance invertible when N < D.

    >>> det = MahalanobisOOD().fit_modalities(audio, video, text)
    >>> flag = det.is_ood(input_norm_features(a2, v2, t2), fpr=0.01)
    >>> det.save("ood_detector.npz"); MahalanobisOOD.load("ood_detector.npz")
    """

    def __init__(self, shrinkage: float = 0.05, space: str = "fused"):
        if not 0.0 <= shrinkage <= 1.0:
            raise ValueError(f"shrinkage must be in [0, 1], got {shrinkage}")
        if space not in ("fused", "input_norm"):
            raise ValueError(f"space must be 'fused'|'input_norm', got {space}")
        self.shrinkage = float(shrinkage)
        self.space = space
        self._state: Optional[_FitState] = None

    # -- fitting -----------------------------------------------------------
    def fit_modalities(self, *modalities: np.ndarray) -> "MahalanobisOOD":
        """Fit in "input_norm" space from per-modality feature arrays."""
        self.space = "input_norm"
        return self.fit(input_norm_features(*modalities))

    def fit(self, features: np.ndarray) -> "MahalanobisOOD":
        x = np.asarray(features, np.float64)
        if x.ndim != 2 or x.shape[0] < 2:
            raise ValueError(
                f"fit expects [N>=2, D] features, got shape {x.shape}"
            )
        n, d = x.shape
        mean = x.mean(axis=0)
        xc = x - mean
        cov = xc.T @ xc / (n - 1)
        # Shrink toward the scaled identity; the extra 1e-6 absolute floor
        # guards the all-constant-feature corner where trace(cov) == 0.
        tr = float(np.trace(cov)) / d
        lam = self.shrinkage if n > d else max(self.shrinkage, 0.1)
        cov = (1.0 - lam) * cov + (lam * tr + 1e-6) * np.eye(d)
        # precision = L^-T L^-1 for cov = L L^T; whitener W = L^-T gives
        # precision = W @ W.T exactly as mahalanobis_score_device expects.
        chol = np.linalg.cholesky(cov)
        whitener = np.linalg.solve(chol, np.eye(d)).T
        self._state = _FitState(
            mean=mean.astype(np.float32),
            whitener=whitener.astype(np.float32),
            train_scores=np.array([], np.float32),
            shrinkage=lam,
            space=self.space,
        )
        self._state.train_scores = np.sort(self.score(x)).astype(np.float32)
        return self

    def calibrate(self, features: np.ndarray) -> "MahalanobisOOD":
        """Recompute the threshold quantiles on held-out in-distribution
        features: fit() stores in-sample scores, which are biased low when
        N is not >> D."""
        st = self._require_fit()
        st.train_scores = np.sort(self.score(features)).astype(np.float32)
        return self

    def _require_fit(self) -> _FitState:
        if self._state is None:
            raise RuntimeError("call fit() (or load()) before scoring")
        return self._state

    # -- scoring -----------------------------------------------------------
    def score(self, features: np.ndarray) -> np.ndarray:
        """Squared Mahalanobis distance per sample -> [N] float32."""
        st = self._require_fit()
        x = np.asarray(features, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        z = (x - st.mean[None, :]) @ st.whitener
        return np.sum(np.square(z), axis=-1)

    def threshold(self, fpr: float = 0.01) -> float:
        """Score cutoff with training false-positive rate `fpr`."""
        st = self._require_fit()
        if not 0.0 < fpr < 1.0:
            raise ValueError(f"fpr must be in (0, 1), got {fpr}")
        ts = st.train_scores
        if ts.size == 0:
            raise RuntimeError("detector has no stored training scores")
        # ceil((n+1)(1-fpr)) order statistic: the finite-sample correction
        # that guarantees P(train score > thr) <= fpr.
        rank = int(np.ceil((ts.size + 1) * (1.0 - fpr)))
        return float(ts[min(rank, ts.size) - 1])

    def is_ood(self, features: np.ndarray, fpr: float = 0.01) -> np.ndarray:
        return self.score(features) > self.threshold(fpr)

    def score_modalities(self, *modalities: np.ndarray) -> np.ndarray:
        """Score per-modality arrays through the detector's feature space."""
        if self._require_fit().space != "input_norm":
            raise ValueError(
                "score_modalities requires an 'input_norm' detector; this "
                f"one was fitted on '{self._state.space}' features"
            )
        return self.score(input_norm_features(*modalities))

    # -- serving handoff ----------------------------------------------------
    @property
    def device_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(mean, whitener) float32 arrays for mahalanobis_score_device."""
        st = self._require_fit()
        return st.mean, st.whitener

    def report(self, features_in: np.ndarray,
               probes: dict[str, np.ndarray]) -> dict:
        """The median train score, the 1% FPR threshold and the AUROC of
        each probe's features against `features_in`."""
        s_in = self.score(features_in)
        return {
            "train_score_p50": float(np.median(self._require_fit().train_scores)),
            "threshold_fpr01": self.threshold(0.01),
            "auroc": {name: ood_auroc(s_in, self.score(f))
                      for name, f in probes.items()},
        }

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        st = self._require_fit()
        np.savez(
            path,
            mean=st.mean,
            whitener=st.whitener,
            train_scores=st.train_scores,
            shrinkage=np.float32(st.shrinkage),
            space=np.array(st.space),
        )

    @classmethod
    def load(cls, path: str) -> "MahalanobisOOD":
        with np.load(path) as z:
            # detectors saved before the space field existed are fused-space
            space = str(z["space"]) if "space" in z.files else "fused"
            det = cls(shrinkage=float(z["shrinkage"]), space=space)
            det._state = _FitState(
                mean=z["mean"],
                whitener=z["whitener"],
                train_scores=z["train_scores"],
                shrinkage=float(z["shrinkage"]),
                space=space,
            )
        return det
