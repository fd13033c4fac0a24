"""The statistics twins on the CPU against the reference's functions and
committed results:

  * headline_ci: fed the reference's committed headline runs, the twin's
    aggregate is `experiments/RESULTS_headline_ci.json`'s within 1e-12;
  * conformal_study: on the reference's committed predictions every row
    equals `experiments/RESULTS_conformal.json`'s (rtol 1e-6), and on a
    4,096-row slice the port's calibrator gives the reference's
    `ConformalCalibrator` rows (rtol 1e-6);
  * seed_study: the t-interval and the aggregate of the reference's
    committed per-seed rows equal its `_ci95` and its committed aggregate
    within 1e-12;
  * ood_study: the score table (AUROC, TPR at the 1% training-FPR
    threshold, the three detectors and the epistemic channel) on fixed
    arrays equals the one built with the reference's `eval/ood.py` within
    1e-6.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from experiments import seed_study as ref_seeds
from tpu_deer.eval import conformal as jconformal
from tpu_deer.eval import ood as jood
from tpu_deer_torch.experiments import conformal_study, headline_ci, ood_study
from tpu_deer_torch.experiments import seed_study

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(ROOT, "experiments")


def _load(name):
    with open(os.path.join(EXP, name)) as f:
        return json.load(f)


def _close(got, want, rtol, atol=0.0, path="payload"):
    """Nested dicts and lists of numbers equal within the tolerance; other
    leaves exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], rtol, atol, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, rtol, atol, f"{path}[{i}]")
    elif isinstance(want, (bool, str)) or want is None:
        assert got == want, path
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=path)


def test_headline_ci_reproduces_reference_aggregate(tmp_path):
    for name in ("RESULTS_synthetic.json", "RESULTS_synthetic_seed1.json",
                 "RESULTS_synthetic_seed2.json"):
        shutil.copy(os.path.join(EXP, name), tmp_path / name)
    out = str(tmp_path / "ci")
    assert headline_ci.main(["--platform", "cpu", "--dir", str(tmp_path),
                             "--pattern", "RESULTS_synthetic*.json",
                             "--out", out]) == 0
    with open(out + ".json") as f:
        got = json.load(f)
    ref = _load("RESULTS_headline_ci.json")
    assert got["n_seeds"] == ref["n_seeds"] == 3
    assert [r["source"] for r in got["runs"]] == [r["source"] for r in ref["runs"]]
    _close(got["aggregate"], ref["aggregate"], rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["committed", "reference_calibrator"])
def test_conformal_rows_match_reference(case, tmp_path):
    npz = os.path.join(EXP, "RESULTS_synthetic_predictions.npz")
    if case == "committed":
        _close(conformal_study.conformal_rows(npz), _load("RESULTS_conformal.json"),
               rtol=1e-6)
        return
    d = np.load(npz)
    sliced = str(tmp_path / "slice.npz")
    np.savez(sliced, **{k: d[k][:4096] for k in d.files})
    got = conformal_study.conformal_rows(sliced)
    mu, y = d["mu"][:4096].astype(np.float64), d["labels"][:4096].astype(np.float64)
    sig = np.sqrt(np.maximum(d["uncertainty"][:4096].astype(np.float64), 1e-12))
    perm = np.random.default_rng(0).permutation(4096)
    cal, tst = perm[:2048], perm[2048:]
    want = []
    for alpha in conformal_study.ALPHAS:
        for name, s in (("absolute", None), ("normalized/raw", sig)):
            c = jconformal.ConformalCalibrator(alpha=alpha, normalized=s is not None)
            c.fit(mu[cal], None if s is None else s[cal], y[cal])
            want.append({"variant": name, **c.report(
                mu[tst], None if s is None else s[tst], y[tst])})
    got = [r for r in got if r["variant"] in ("absolute", "normalized/raw")]
    _close(got, want, rtol=1e-6)


def test_seed_study_aggregate_matches_reference():
    ref = _load("RESULTS_seeds.json")
    for vals in (np.array([0.3]), np.array([0.9, 0.91]),
                 np.array([r["cohens_d"] for r in ref["seeds"]])):
        np.testing.assert_allclose(seed_study.ci95(vals), ref_seeds._ci95(vals),
                                   rtol=0, atol=1e-12)
    _close(seed_study.aggregate(ref["seeds"]), ref["aggregate"], rtol=0,
           atol=1e-12)
    assert list(seed_study.aggregate(ref["seeds"])) == list(ref["aggregate"])


def test_ood_score_table_matches_reference():
    """Latent-structured fixed arrays: fit rows, clean test rows and a
    shifted and a misaligned probe; fused features and epistemic stand-ins
    drawn alongside."""
    rng = np.random.default_rng(11)
    latent = lambda n: rng.standard_normal((n, 6))
    mix = {m: rng.standard_normal((6, d)) for m, d in
           (("audio", 12), ("video", 10), ("text", 14))}

    def arrays(n):
        z = latent(n)
        return {m: (z @ w + 0.3 * rng.standard_normal((n, w.shape[1])))
                .astype(np.float32) for m, w in mix.items()}

    fit, test = arrays(500), arrays(200)
    probes = {"shifted": {m: v + 0.5 for m, v in test.items()},
              "misaligned": dict(test, video=test["video"][rng.permutation(200)])}
    pred = lambda n: {"fused": rng.standard_normal((n, 16)).astype(np.float32),
                      "epistemic": rng.random((n, 3)).astype(np.float32)}
    fused_fit, p_test = pred(500)["fused"], pred(200)
    p_probe = {name: pred(200) for name in probes}

    dets = ood_study.fit_detectors(fit, fused_fit)
    s_probe = {n: ood_study.scores(dets, probes[n], p_probe[n]) for n in probes}
    got = ood_study.score_table(ood_study.scores(dets, test, p_test), s_probe,
                                dets[0].threshold(0.01))

    # The reference's fit, scores and rows (experiments/ood_study.py:130-178)
    # through its eval/ood.py.
    n_cal = len(fused_fit) // 5
    mods = lambda a: (a["audio"], a["video"], a["text"])
    raw_cat = lambda a: np.concatenate(mods(a), axis=1)
    det_fused = jood.MahalanobisOOD().fit(fused_fit[n_cal:]).calibrate(
        fused_fit[:n_cal])
    norm_fit = jood.input_norm_features(*mods(fit))
    det_norm = jood.MahalanobisOOD(space="input_norm").fit(
        norm_fit[n_cal:]).calibrate(norm_fit[:n_cal])
    det_raw = jood.MahalanobisOOD().fit(raw_cat(fit))

    def all_scores(a, pred):
        return {"epistemic": pred["epistemic"].mean(axis=1),
                ood_study.SHIPPED: det_norm.score_modalities(*mods(a)),
                "mahalanobis (fused)": det_fused.score(pred["fused"]),
                "mahalanobis (raw input)": det_raw.score(raw_cat(a))}

    s_test = all_scores(test, p_test)
    s_probe = {n: all_scores(probes[n], p_probe[n]) for n in probes}
    thr = det_norm.threshold(0.01)
    want = []
    for det in s_test:
        row = {"detector": det, "auroc": {}, "tpr_at_1pct_fpr": {}}
        for n in probes:
            row["auroc"][n] = jood.ood_auroc(s_test[det], s_probe[n][det])
        if det == ood_study.SHIPPED:
            row["tpr_at_1pct_fpr"] = {n: float(np.mean(s_probe[n][det] > thr))
                                      for n in probes}
            row["test_fpr_at_threshold"] = float(np.mean(s_test[det] > thr))
        want.append(row)
    assert [r["detector"] for r in got] == list(s_test)
    _close(got, want, rtol=1e-6, atol=1e-6)
