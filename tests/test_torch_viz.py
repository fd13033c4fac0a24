"""The port's plots (`viz/report.py`, `viz/html_report.py`) against the JAX
package's on the same arrays, on the CPU. Data, not pixels: the files each
writes, the JSON data export, the interactive report's embedded payload,
and the arrays every static figure is drawn from (each call of matplotlib's
plot, scatter, bar, hist and imshow recorded on both sides), to 1e-6.
Without matplotlib the port writes the dashboard and the data export and
says why.
"""

import json
import os
import re

import numpy as np
import pytest
from matplotlib.axes import Axes
from matplotlib.figure import Figure
from mpl_toolkits.mplot3d import Axes3D

from tpu_deer.viz import report as jreport
from tpu_deer_torch.experiments import synthetic_headline
from tpu_deer_torch.viz import report


def _inputs(n=120, seed=0):
    rng = np.random.default_rng(seed)
    targets = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    preds = (targets + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    aleatoric = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    epistemic = rng.uniform(0.01, 0.3, (n, 3)).astype(np.float32)
    attention = rng.dirichlet(np.ones(3), n).astype(np.float32)
    history = {"train_loss": [3.0, 2.1, 1.7, 1.5], "val_loss": [2.5, 2.0, 1.9, 1.8],
               "val_ccc": [0.1, 0.3, 0.45, 0.5],
               "learning_rate": [1e-4, 2e-4, 2e-4, 1e-4]}
    return dict(predictions=preds, targets=targets,
                uncertainties=aleatoric + epistemic, attention_weights=attention,
                history=history, aleatoric=aleatoric, epistemic=epistemic)


DRAWN = ((Axes, ("plot", "scatter", "bar", "hist", "imshow")),
         (Axes3D, ("scatter",)))


@pytest.fixture(autouse=True)
def unrendered(monkeypatch):
    """Figures are written as empty files: the data is compared, not the
    pixels, and rasterizing them is most of the time."""
    def savefig(self, fname, *args, **kw):
        open(fname, "wb").close()

    monkeypatch.setattr(Figure, "savefig", savefig)


@pytest.fixture
def drawn(monkeypatch):
    """The numeric arguments of every draw call, in order."""
    calls = []
    for cls, names in DRAWN:
        for name in names:
            original = getattr(cls, name)

            def record(self, *args, _name=name, _original=original, **kw):
                arrays = []
                for a in args:
                    arr = np.asarray(a) if not isinstance(a, str) else None
                    if arr is not None and arr.dtype.kind in "fiub":
                        arrays.append(arr.astype(np.float64))
                calls.append((_name, arrays))
                return _original(self, *args, **kw)

            monkeypatch.setattr(cls, name, record)
    return calls


def _payload(path):
    with open(path) as f:
        html = f.read()
    m = re.search(r'<script id="report-data" type="application/json">(.*?)</script>',
                  html, re.S)
    return json.loads(m.group(1))


def _assert_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list) and want and not isinstance(want[0], (int, float)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, str):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=1e-6,
                                   atol=1e-9, err_msg=path)


def test_report_matches_reference(tmp_path, drawn):
    x = _inputs()
    want = jreport.create_comprehensive_report(**x, output_dir=str(tmp_path / "jax"))
    ref_calls = list(drawn)
    drawn.clear()
    got = report.create_comprehensive_report(**x, output_dir=str(tmp_path / "port"))
    assert {k: os.path.basename(v) for k, v in got.items()} == {
        k: os.path.basename(v) for k, v in want.items()}
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    # The arrays each figure is drawn from, call by call.
    assert [name for name, _ in drawn] == [name for name, _ in ref_calls]
    for i, ((name, g), (_, w)) in enumerate(zip(drawn, ref_calls)):
        assert len(g) == len(w), (i, name)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9,
                                       err_msg=f"call {i} ({name})")
    with open(got["report_data"]) as f:
        data = json.load(f)
    with open(want["report_data"]) as f:
        ref = json.load(f)
    _assert_close(data["metrics"], ref["metrics"], "metrics")
    assert {k: os.path.basename(v) for k, v in data["plots"].items()} == {
        k: os.path.basename(v) for k, v in ref["plots"].items()}
    _assert_close(_payload(got["interactive"]), _payload(want["interactive"]),
                  "payload")


def test_report_without_matplotlib(tmp_path, monkeypatch):
    def missing():
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(report, "_pyplot", missing)
    x = _inputs(seed=1)
    paths = report.create_comprehensive_report(**x, output_dir=str(tmp_path))
    assert paths["static"] == report.NO_MATPLOTLIB
    assert sorted(os.listdir(tmp_path)) == ["interactive_report.html",
                                            "report_data.json"]
    with open(paths["report_data"]) as f:
        data = json.load(f)
    assert data["plots"]["static"] == report.NO_MATPLOTLIB
    assert np.isfinite(data["metrics"]["ccc_average"])


def test_headline_figures_from_saved_predictions(tmp_path):
    """The headline twin's --figures_from renders the reference's set of
    figures from a predictions file, as `experiments/synthetic_headline.py`
    does."""
    x = _inputs(seed=2)
    npz = str(tmp_path / "pred.npz")
    np.savez(npz, labels=x["targets"], mu=x["predictions"],
             calibrated_uncertainty=x["uncertainties"], aleatoric=x["aleatoric"],
             epistemic=x["epistemic"],
             history_train_loss=np.asarray(x["history"]["train_loss"]),
             history_val_ccc=np.asarray(x["history"]["val_ccc"]))
    out = tmp_path / "figures"
    assert synthetic_headline.main(["--figures_from", npz, "--figures",
                                    str(out)]) == 0
    assert sorted(os.listdir(out)) == sorted([
        "calibration.png", "interactive_report.html", "per_dim_metrics.png",
        "report_data.json", "sparsification.png", "summary.png",
        "training_curves.png", "uncertainty_decomposition.png",
        "uncertainty_vs_error.png", "va_space.png", "vad_3d.png"])
    assert "from saved predictions" in _payload(out / "interactive_report.html")["title"]
