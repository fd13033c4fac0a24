"""Evaluation: metrics bundles, uncertainty quality, calibration, statistics."""

from tpu_deer_torch.eval.calibration import CalibrationAnalyzer
from tpu_deer_torch.eval.comprehensive import ComprehensiveEvaluator
from tpu_deer_torch.eval.uncertainty import UncertaintyAnalyzer, sparsification_curve
