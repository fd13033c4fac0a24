"""The port's uncertainty analysis, comprehensive evaluator and significance
test against the JAX package's on the same seeded numpy arrays (all numpy
in float64 on both sides, so rtol 1e-12), the report string identical; and
the headline twin (`tpu_deer_torch/experiments/synthetic_headline.py`) at a
tiny size on the CPU, whose payload has exactly the keys of the reference
experiment's committed result (`experiments/RESULTS_synthetic.json`).
"""

import json
import os

import numpy as np
import pytest
import torch

from tpu_deer.core import metrics as jmetrics
from tpu_deer.eval import comprehensive as jcomp
from tpu_deer.eval import uncertainty as junc
from tpu_deer_torch.core import metrics as tmetrics
from tpu_deer_torch.eval import ComprehensiveEvaluator, UncertaintyAnalyzer
from tpu_deer_torch.eval import sparsification_curve
from tpu_deer_torch.experiments import synthetic_headline

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(seed, n=500):
    """Targets, two models' predictions, an uncertainty that follows the
    first model's error, and its aleatoric and epistemic parts."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n, 3))
    scale = rng.uniform(0.05, 0.5, size=(n, 3))
    a = y + scale * rng.normal(size=(n, 3))
    b = y + 1.2 * scale * rng.normal(size=(n, 3))
    alea = scale**2 * rng.uniform(0.5, 1.5, size=(n, 3))
    epi = 0.3 * alea * rng.uniform(size=(n, 3))
    return y, a, b, alea + epi, alea, epi


def _assert_same(got, ref, path="result"):
    """Equal structure; floats and arrays at rtol 1e-12, the rest equal."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _assert_same(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple, np.ndarray)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-12, atol=0, err_msg=path)
    elif isinstance(ref, (bool, str, int)) or ref is None:
        assert got == ref and type(got) is type(ref), path
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0, err_msg=path)


@pytest.mark.parametrize("seed", [0, 1])
def test_sparsification_curve_matches_jax(seed):
    y, a, _, unc, _, _ = _arrays(seed)
    err = np.abs(a - y).mean(axis=1)
    for n_steps in (20, 7):
        _assert_same(sparsification_curve(err, unc.mean(axis=1), n_steps),
                     junc.sparsification_curve(err, unc.mean(axis=1), n_steps))


@pytest.mark.parametrize("decomposed", [False, True])
def test_uncertainty_analyzer_matches_jax(decomposed):
    y, a, _, unc, alea, epi = _arrays(2)
    kw = dict(aleatoric=alea, epistemic=epi) if decomposed else {}
    got = UncertaintyAnalyzer().analyze(a, y, unc, **kw)
    _assert_same(got, junc.UncertaintyAnalyzer().analyze(a, y, unc, **kw))
    assert ("decomposition" in got) == decomposed


@pytest.mark.parametrize("with_unc", [False, True])
def test_comprehensive_evaluate_and_report_match_jax(with_unc):
    y, a, _, unc, _, _ = _arrays(3)
    u = unc if with_unc else None
    ours, ref = ComprehensiveEvaluator(), jcomp.ComprehensiveEvaluator()
    _assert_same(ours.evaluate(a, y, u), ref.evaluate(a, y, u))
    got = ours.generate_report(a, y, u, model_name="m")
    assert got == ref.generate_report(a, y, u, model_name="m")


@pytest.mark.parametrize("shift", [0.0, 0.05, 0.4])
def test_compare_models_and_significance_match_jax(shift):
    """Shifts that give a small, a medium and a large effect."""
    y, a, b, _, _, _ = _arrays(4)
    b = b + shift * np.sign(b - y)
    got = ComprehensiveEvaluator().compare_models(a, b, y, "a", "b")
    _assert_same(got, jcomp.ComprehensiveEvaluator().compare_models(a, b, y, "a", "b"))
    for alpha in (0.05, 1e-30):
        _assert_same(tmetrics.statistical_significance_test(a, y, b, alpha),
                     jmetrics.statistical_significance_test(a, y, b, alpha))
    assert got["significance"]["effect_size"] == ("small", "medium", "large")[
        [0.0, 0.05, 0.4].index(shift)]


def _keys(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}.")
    return out


def test_headline_twin_writes_the_reference_payload(tmp_path):
    out = str(tmp_path / "headline")
    assert synthetic_headline.main(
        ["--platform", "cpu", "--n_train", "2048", "--epochs", "2",
         "--batch_size", "256", "--out", out]) == 0
    with open(out + ".json") as f:
        got = json.load(f)
    with open(os.path.join(ROOT, "experiments", "RESULTS_synthetic.json")) as f:
        ref = json.load(f)
    assert _keys(got) == _keys(ref)
    assert got["platform"] == "cpu" and got["n_params"] == 3_918_324
    assert got["epochs_run"] == 2 and got["test"]["n_samples"] == 256
    assert all(np.isfinite(got["test"]["ccc"][d])
               for d in ("valence", "arousal", "dominance"))
    with open(out + ".md") as f:
        md = f.read()
    assert "| CCC average |" in md and "EVALUATION REPORT" in md
    saved = np.load(out + "_predictions.npz")
    assert saved["mu"].shape == (256, 3) and len(saved["history_train_loss"]) == 2
    # The plots are ported: --figures_from renders them from the
    # saved predictions.
    figures = tmp_path / "figures"
    assert synthetic_headline.main(["--figures_from", out + "_predictions.npz",
                                    "--figures", str(figures)]) == 0
    assert {"interactive_report.html", "report_data.json"} <= set(
        os.listdir(figures))
