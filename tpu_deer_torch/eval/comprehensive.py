"""ComprehensiveEvaluator: evaluate, compare two models, and a text report.

Own copy of `tpu_deer/eval/comprehensive.py` (numpy).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tpu_deer_torch.core import metrics as metrics_lib
from tpu_deer_torch.eval.calibration import CalibrationAnalyzer
from tpu_deer_torch.eval.uncertainty import UncertaintyAnalyzer

DIMS = ("valence", "arousal", "dominance")


class ComprehensiveEvaluator:
    def evaluate(self, predictions: np.ndarray, targets: np.ndarray,
                 uncertainties: Optional[np.ndarray] = None) -> dict:
        """`evaluate_predictions`, with the uncertainty and calibration
        analyses when uncertainties are given."""
        out = metrics_lib.evaluate_predictions(predictions, targets, uncertainties)
        if uncertainties is not None:
            out["uncertainty_analysis"] = UncertaintyAnalyzer().analyze(
                predictions, targets, uncertainties)
            out["calibration_analysis"] = CalibrationAnalyzer().analyze(
                predictions, targets, uncertainties)
        return out

    def compare_models(self, predictions_a: np.ndarray, predictions_b: np.ndarray,
                       targets: np.ndarray, name_a: str = "model_a",
                       name_b: str = "model_b") -> dict:
        """Both models' metrics and the paired significance test."""
        return {
            name_a: metrics_lib.evaluate_predictions(predictions_a, targets),
            name_b: metrics_lib.evaluate_predictions(predictions_b, targets),
            "significance": metrics_lib.statistical_significance_test(
                predictions_a, targets, predictions_b),
        }

    def generate_report(self, predictions: np.ndarray, targets: np.ndarray,
                        uncertainties: Optional[np.ndarray] = None,
                        model_name: str = "Multimodal DEER") -> str:
        """The evaluation as a text report."""
        res = self.evaluate(predictions, targets, uncertainties)
        lines = ["=" * 64, f"EVALUATION REPORT — {model_name}", "=" * 64, "",
                 f"Samples evaluated: {len(np.asarray(predictions))}", "",
                 "Regression performance (per dimension):"]
        for d in DIMS:
            if f"ccc_{d}" in res:
                lines.append(
                    f"  {d:<10} CCC {res[f'ccc_{d}']:+.4f}   "
                    f"MAE {res[f'mae_{d}']:.4f}   RMSE {res[f'rmse_{d}']:.4f}")
        lines += ["",
                  f"  {'average':<10} CCC {res['ccc_average']:+.4f}   "
                  f"MAE {res['mae_average']:.4f}   RMSE {res['rmse_average']:.4f}"]
        if uncertainties is not None:
            ua = res["uncertainty_analysis"]
            ca = res["calibration_analysis"]
            lines += [
                "",
                "Uncertainty quality:",
                f"  ECE (quantile bins)          {res['ece']:.4f}",
                f"  reliability score            {ca['reliability_score']:.4f}",
                f"  uncertainty-error corr.      "
                f"{ua['uncertainty_error_correlation']:+.4f}",
                f"  AUSE (sparsification)        {ua['ause']:.4f}",
                f"  mean / median uncertainty    "
                f"{ua['uncertainty_stats']['mean']:.4f} / "
                f"{ua['uncertainty_stats']['median']:.4f}",
            ]
        lines += ["", "=" * 64]
        return "\n".join(lines)
