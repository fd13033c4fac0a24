"""Model evaluator: predictions → the full metric bundle.

Port of `tpu_deer/eval/evaluator.py`: `EvaluationResults` (per-dimension
CCC, MAE, RMSE and ECE, bootstrap CIs of CCC, the uncertainty-error
correlation, timing and parameter count), `DEERModelEvaluator` on arrays or
on a trainer and a dataset (through `DEERTrainer.predict`), and
`evaluate_deer_model`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from tpu_deer_torch.core import metrics as metrics_lib
from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.eval.calibration import fit_uncertainty_scale
from tpu_deer_torch.eval.statistics import bootstrap_ccc_ci

DIMS = ("valence", "arousal", "dominance")


@dataclasses.dataclass
class EvaluationResults:
    ccc: dict[str, float]
    mae: dict[str, float]
    rmse: dict[str, float]
    ece: float
    ece_per_dim: dict[str, float]
    uncertainty_error_correlation: float
    confidence_intervals: dict[str, tuple[float, float]]
    eval_time_s: float
    n_samples: int
    n_parameters: int = 0
    # ECE of the raw NIG total uncertainty (the headline `ece` uses the
    # deployable calibrated uncertainty when driven through evaluate_model).
    ece_raw: float = float("nan")
    posthoc_scale: float = 1.0

    @property
    def ccc_average(self) -> float:
        return float(np.mean(list(self.ccc.values())))

    @property
    def mae_average(self) -> float:
        return float(np.mean(list(self.mae.values())))

    @property
    def rmse_average(self) -> float:
        return float(np.mean(list(self.rmse.values())))

    def to_dict(self) -> dict:
        return {
            "ccc": self.ccc,
            "ccc_average": self.ccc_average,
            "mae": self.mae,
            "mae_average": self.mae_average,
            "rmse": self.rmse,
            "rmse_average": self.rmse_average,
            "ece": self.ece,
            "ece_per_dim": self.ece_per_dim,
            "uncertainty_error_correlation": self.uncertainty_error_correlation,
            "confidence_intervals": {
                k: list(v) for k, v in self.confidence_intervals.items()},
            "eval_time_s": self.eval_time_s,
            "n_samples": self.n_samples,
            "n_parameters": self.n_parameters,
            "ece_raw": self.ece_raw,
            "posthoc_scale": self.posthoc_scale,
        }


class DEERModelEvaluator:
    """Evaluate predictions and uncertainties against targets, from arrays
    or from a trainer and a dataset."""

    def __init__(self, n_bootstrap: int = 1000, bootstrap_ci: float = 0.95,
                 seed: int = 0):
        self.n_bootstrap = n_bootstrap
        self.bootstrap_ci = bootstrap_ci
        self.seed = seed

    def evaluate_arrays(self, predictions: np.ndarray, targets: np.ndarray,
                        uncertainties: Optional[np.ndarray] = None,
                        n_parameters: int = 0) -> EvaluationResults:
        t0 = time.time()
        predictions = np.asarray(predictions)
        targets = np.asarray(targets)
        ccc, mae, rmse, ece_dim, cis = {}, {}, {}, {}, {}
        for i, name in enumerate(DIMS[: predictions.shape[1]]):
            p, t = predictions[:, i], targets[:, i]
            err = np.abs(t - p)
            ccc[name] = metrics_lib.ccc_np(t, p)
            mae[name] = float(err.mean())
            rmse[name] = float(np.sqrt((err**2).mean()))
            if self.n_bootstrap > 0:
                cis[name] = bootstrap_ccc_ci(
                    t, p, n_resamples=self.n_bootstrap,
                    confidence=self.bootstrap_ci, seed=self.seed)
            if uncertainties is not None:
                ece_dim[name] = metrics_lib.ece_np(
                    p[:, None], t[:, None], uncertainties[:, i:i + 1])
        ece = 1.0
        unc_err_corr = 0.0
        if uncertainties is not None:
            ece = metrics_lib.ece_np(predictions, targets, uncertainties)
            err = np.abs(predictions - targets).mean(axis=1)
            unc = np.asarray(uncertainties).mean(axis=1)
            unc_err_corr = metrics_lib.pearson_np(err, unc)
        return EvaluationResults(
            ccc=ccc, mae=mae, rmse=rmse, ece=ece, ece_per_dim=ece_dim,
            uncertainty_error_correlation=unc_err_corr,
            confidence_intervals=cis, eval_time_s=time.time() - t0,
            n_samples=len(predictions), n_parameters=n_parameters)

    def evaluate_model(self, trainer, dataset: ArrayDataset,
                       n_parameters: int = 0,
                       calibration_dataset: Optional[ArrayDataset] = None,
                       calibration_scale: Optional[float] = None,
                       ) -> EvaluationResults:
        """Evaluate a trained model on a dataset. The headline ECE is on the
        deployable (calibrated) uncertainty, times a post-hoc scale fitted
        on `calibration_dataset` when one is given (or `calibration_scale`);
        `ece_raw` and the uncertainty-error correlation use the raw NIG
        total uncertainty."""
        out = trainer.predict(dataset)
        labels = dataset.arrays["labels"]
        deployable = out.get("calibrated_uncertainty", out["uncertainty"])
        scale = 1.0
        if calibration_scale is not None:
            scale = float(calibration_scale)
        elif calibration_dataset is not None:
            cal_out = trainer.predict(calibration_dataset)
            cal_unc = cal_out.get("calibrated_uncertainty",
                                  cal_out["uncertainty"])
            scale = fit_uncertainty_scale(
                cal_out["mu"], calibration_dataset.arrays["labels"], cal_unc)
        res = self.evaluate_arrays(out["mu"], labels, scale * deployable,
                                   n_parameters)
        res.ece_raw = metrics_lib.ece_np(out["mu"], labels, out["uncertainty"])
        err = np.abs(out["mu"] - labels).mean(axis=1)
        res.uncertainty_error_correlation = metrics_lib.pearson_np(
            err, np.asarray(out["uncertainty"]).mean(axis=1))
        res.posthoc_scale = scale
        return res


def evaluate_deer_model(trainer, dataset: ArrayDataset, n_bootstrap: int = 200,
                        seed: int = 0) -> EvaluationResults:
    return DEERModelEvaluator(n_bootstrap=n_bootstrap, seed=seed).evaluate_model(
        trainer, dataset)
