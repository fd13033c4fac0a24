"""The port's main-path data, config, evaluation and CLI against the JAX
package on the CPU.

Synthetic splits and batch order must be bit-identical (numpy on both
sides, own copies). The evaluator is compared on the same predictions
(float64 metrics; rtol 1e-9 covers the summation order of the reference's
float32 CCC in `StatisticalValidator`). The quick pipeline runs both
packages at a narrow width (as tests/test_cli.py) from the same converted
init (the port's, converted) with dropout off (`model.dropout` 0, and the
model's fixed attention dropout through the wrapper of
test_torch_trainer.py) on one device:
best val CCC, evaluation.json and conformal.json within 1e-4 (float32
training in another summation order, 32 steps; see NARROW for the lr).
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from tpu_deer import cli as jcli
from tpu_deer.core import metrics as jmetrics
from tpu_deer.data import pipeline as jpipe
from tpu_deer.data import synthetic as jsyn
from tpu_deer.eval import calibration as jcal
from tpu_deer.eval import conformal as jconf
from tpu_deer.eval import evaluator as jeval
from tpu_deer.eval import statistics as jstats
from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JModelConfig
from tpu_deer.utils import config as jconfig
from tpu_deer_torch import cli as tcli
from tpu_deer_torch.convert import state_dict_to_flax
from tpu_deer_torch.core import metrics as tmetrics
from tpu_deer_torch.data import pipeline as tpipe
from tpu_deer_torch.data import synthetic as tsyn
from tpu_deer_torch.eval import calibration as tcal
from tpu_deer_torch.eval import conformal as tconf
from tpu_deer_torch.eval import evaluator as teval
from tpu_deer_torch.eval import statistics as tstats
from tpu_deer_torch.utils import config as tconfig

torch.set_num_threads(1)

# The quick recipe at a narrow width, dropout off, and lr 3e-4 for its 3e-3:
# the v2 loss's ECE term bins confidences, so float noise can move a sample
# to the next bin and its gradient jumps; at 3e-3 from the first step such
# flips part the two runs by ~2e-3 in test CCC within 32 steps.
NARROW = {"model.encoder_dim": 64, "model.fusion_dim": 128,
          "model.encoder_layers": 1, "model.dropout": 0.0,
          "training.num_epochs": 2, "training.batch_size": 32,
          "training.learning_rate": 3e-4}


@pytest.mark.parametrize("cfg", [
    dict(n_train=50, n_val=20, n_test=10, seed=3),
    dict(n_train=40, n_val=8, n_test=8, latent_dim=12, seed=4),
    dict(n_train=40, n_val=8, n_test=8, hard_from_features=False, label_seed=9),
    "benchmark_v2",
])
def test_synthetic_splits_bit_identical(cfg):
    if cfg == "benchmark_v2":
        ref = jsyn.make_synthetic_splits(jsyn.benchmark_v2(64, seed=5))
        got = tsyn.make_synthetic_splits(tsyn.benchmark_v2(64, seed=5))
    else:
        ref = jsyn.make_synthetic_splits(jsyn.SyntheticConfig(**cfg))
        got = tsyn.make_synthetic_splits(tsyn.SyntheticConfig(**cfg))
    assert sorted(got) == sorted(ref) == ["test", "train", "val"]
    for split, arrays in ref.items():
        assert sorted(got[split]) == sorted(arrays)
        for key, r in arrays.items():
            g = got[split][key]
            assert g.dtype == r.dtype and np.array_equal(g, r), (split, key)


@pytest.mark.parametrize("n,bs,shuffle,drop_last,procs", [
    (37, 8, True, False, 1), (37, 8, True, True, 1), (5, 8, True, False, 1),
    (40, 8, False, False, 1), (36, 8, True, False, 2)])
def test_batch_iterator_same_order_and_masks(n, bs, shuffle, drop_last, procs):
    arrays = {"x": np.arange(n, dtype=np.float32)[:, None]}
    for rank in range(procs):
        kw = dict(shuffle=shuffle, drop_last=drop_last, seed=7,
                  process_index=rank, process_count=procs)
        ref_it = jpipe.BatchIterator(jpipe.ArrayDataset(arrays), bs, **kw)
        it = tpipe.BatchIterator(tpipe.ArrayDataset(arrays), bs, **kw)
        assert len(it) == len(ref_it)
        for epoch in (0, 1, 2):
            ref = list(ref_it.epoch_indices(epoch))
            got = list(it.epoch_indices(epoch))
            assert len(got) == len(ref)
            for (gi, gm), (ri, rm) in zip(got, ref):
                assert gi.dtype == ri.dtype and np.array_equal(gi, ri)
                assert gm.dtype == rm.dtype and np.array_equal(gm, rm)
        for gb, rb in zip(it.epoch(0), ref_it.epoch(0)):
            assert all(np.array_equal(gb[k], rb[k]) for k in rb)
    padded = tpipe.pad_to_multiple(arrays, 16)
    ref = jpipe.pad_to_multiple(arrays, 16)
    assert all(np.array_equal(padded[k], ref[k]) for k in ref)


def test_config_round_trip(tmp_path):
    cfg = tconfig.default_config()
    assert cfg == jconfig.default_config()
    cfg["training"].update(num_epochs=7, learning_rate=1e-5, frozen=["a.b"])
    path = str(tmp_path / "c.yaml")
    tconfig.save_yaml_config(cfg, path)
    with open(path) as f:
        assert yaml.safe_load(f) == cfg
    assert tconfig.load_yaml_config(path) == cfg
    assert tconfig.load_yaml_config(path) == jconfig.load_yaml_config(path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("config.yaml", "quick_config.yaml", "uncertainty.yaml"):
        p = os.path.join(repo, "configs", name)
        assert tconfig.load_yaml_config(p) == jconfig.load_yaml_config(p)
    assert tconfig.load_yaml_config("/nonexistent.yaml") == tconfig.default_config()


def _predictions(n=120, seed=0):
    rng = np.random.default_rng(seed)
    y = np.tanh(rng.normal(size=(n, 3))).astype(np.float32)
    mu = (y + 0.3 * rng.normal(size=(n, 3))).astype(np.float32)
    unc = np.abs(mu - y + 0.2 * rng.normal(size=(n, 3))).astype(np.float32)
    return mu, y, unc


def _assert_nested_close(got, ref, rtol, atol, path=""):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            if k != "eval_time_s":
                _assert_nested_close(got[k], ref[k], rtol, atol, f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_nested_close(g, r, rtol, atol, f"{path}[{i}]")
    elif isinstance(ref, (str, bool)) or ref is None:
        assert got == ref, path
    else:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=path)


class _Deterministic:
    """The reference's model with every dropout off, train step included."""

    def __init__(self, model):
        self._model = model
        self.config = model.config

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self._model.apply(variables, *args, deterministic=True, **kw)


class _FakeTrainer:
    def __init__(self, out):
        self.out = out

    def predict(self, dataset):
        return self.out[dataset.name]


def test_evaluator_and_metrics_match_jax():
    mu, y, unc = _predictions()
    cal_mu, cal_y, cal_unc = _predictions(seed=1)
    tol = dict(rtol=1e-9, atol=1e-12)
    for fn in ("evaluate_predictions", "reliability_np", "ece_np"):
        _assert_nested_close(getattr(tmetrics, fn)(mu, y, unc),
                             getattr(jmetrics, fn)(mu, y, unc), **tol)
    got = teval.DEERModelEvaluator(n_bootstrap=200, seed=3).evaluate_arrays(
        mu, y, unc, n_parameters=5)
    ref = jeval.DEERModelEvaluator(n_bootstrap=200, seed=3).evaluate_arrays(
        mu, y, unc, n_parameters=5)
    _assert_nested_close(got.to_dict(), ref.to_dict(), **tol)
    outs = {"test": {"mu": mu, "uncertainty": unc, "calibrated_uncertainty": unc / 2},
            "cal": {"mu": cal_mu, "uncertainty": cal_unc,
                    "calibrated_uncertainty": cal_unc / 2}}
    results = []
    for ev, ds in ((teval, tpipe.ArrayDataset), (jeval, jpipe.ArrayDataset)):
        results.append(ev.DEERModelEvaluator(n_bootstrap=50).evaluate_model(
            _FakeTrainer(outs), ds({"labels": y}, "test"),
            calibration_dataset=ds({"labels": cal_y}, "cal")).to_dict())
    _assert_nested_close(*results, **tol)
    assert results[0]["posthoc_scale"] != 1.0
    _assert_nested_close(tstats.StatisticalValidator(200).validate(mu, y),
                         jstats.StatisticalValidator(200).validate(mu, y),
                         rtol=1e-6, atol=1e-7)
    _assert_nested_close(tcal.CalibrationAnalyzer().analyze(mu, y, unc),
                         jcal.CalibrationAnalyzer().analyze(mu, y, unc), **tol)
    assert tcal.fit_uncertainty_scale(mu, y, unc) == jcal.fit_uncertainty_scale(
        mu, y, unc)
    for normalized in (True, False):
        rep = [c.ConformalCalibrator(0.1, normalized).fit(cal_mu, cal_unc, cal_y)
               .report(mu, unc, y) for c in (tconf, jconf)]
        _assert_nested_close(*rep, **tol)


def _pipelines(root):
    """The quick pipeline of each package, stage by stage, on one device.
    The reference's pipeline takes the port's seeded init, converted, in
    place of its create_model (whose init would compile for seconds)."""
    jp = jcli.MultimodalDEERPipeline(output_dir=root, experiment_name="jax",
                                     quick=True, overrides=NARROW)
    jp.mesh = None  # one device, as the port
    tp = tcli.MultimodalDEERPipeline(output_dir=root, experiment_name="port",
                                     quick=True, overrides=NARROW, device="cpu")
    tp.create_model()
    jp.model_config = JModelConfig(**{
        f: getattr(tp.model_config, f) for f in (
            "audio_dim", "video_dim", "text_dim", "encoder_dim", "fusion_dim",
            "emotion_dims", "attention_heads", "encoder_layers", "dropout",
            "compute_dtype", "fusion_type", "moe_experts")})
    jp.model, jp.ensemble_members = JModel(jp.model_config), 1
    jp.params = state_dict_to_flax(tp.model.state_dict())
    for m in tp.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    out = {}
    for name, p in (("jax", jp), ("port", tp)):
        p.create_datasets()
        p.create_trainer()
        if name == "jax":
            p.trainer.model = _Deterministic(p.trainer.model)
        train = p.run_training()
        p.run_evaluation()
        with open(p.path("results", "evaluation.json")) as f:
            p.generate_final_report(train, json.load(f))
        out[name] = (p, train)
    return out


def test_quick_pipeline_matches_jax(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipelines"))
    runs = _pipelines(root)
    (jp, jtrain), (tp, ttrain) = runs["jax"], runs["port"]
    np.testing.assert_allclose(ttrain["best_val_ccc"], jtrain["best_val_ccc"],
                               rtol=0, atol=1e-4)
    assert ttrain["serving_channel"] == jtrain["serving_channel"]
    for name in ("evaluation.json", "conformal.json"):
        with open(jp.path("results", name)) as f:
            ref = json.load(f)
        with open(tp.path("results", name)) as f:
            got = json.load(f)
        _assert_nested_close(got, ref, rtol=0, atol=1e-4, path=name)
    for name in ("training_history.json", "final_report.md", "ood_detector.npz"):
        assert os.path.exists(tp.path("results", name)), name
    ref_det = np.load(jp.path("results", "ood_detector.npz"))
    det = np.load(tp.path("results", "ood_detector.npz"))
    assert sorted(det.files) == sorted(ref_det.files)
    for key in ref_det.files:
        if ref_det[key].dtype.kind in "USO":
            assert np.array_equal(det[key], ref_det[key]), key
        else:
            np.testing.assert_allclose(det[key], ref_det[key], rtol=1e-6,
                                       atol=1e-6, err_msg=key)
    assert os.path.isdir(tp.path("models", "best"))
    with open(tp.path("configs", "config.yaml")) as f:
        assert yaml.safe_load(f) == tp.config


def test_main_full_then_evaluate_on_cpu(tmp_path):
    cfg = tconfig.default_config()
    cfg["model"].update(encoder_dim=32, fusion_dim=64, encoder_layers=1)
    cfg_path = str(tmp_path / "small.yaml")
    tconfig.save_yaml_config(cfg, cfg_path)
    common = ["--config", cfg_path, "--output_dir", str(tmp_path),
              "--experiment_name", "e", "--platform", "cpu", "--quick",
              "--epochs", "1"]
    assert tcli.main(["--mode", "full", *common]) == 0
    exp = tmp_path / "e"
    with open(exp / "results" / "pipeline_summary.json") as f:
        summary = json.load(f)
    plots = summary["plots"]
    for name in ("interactive", "report_data", "summary", "training_curves"):
        assert os.path.exists(plots[name]), name
    assert summary["test_results"]["synthetic"]["n_samples"] == 128
    for path in ("configs/config.yaml", "results/training_history.json",
                 "results/evaluation.json", "results/conformal.json",
                 "results/final_report.md", "results/ood_detector.npz",
                 "models/best/state.pt", "logs/metrics.jsonl"):
        assert (exp / path).exists(), path
    os.remove(exp / "results" / "evaluation.json")
    assert tcli.main(["--mode", "evaluate", "--model_path",
                      str(exp / "models"), *common]) == 0
    assert (exp / "results" / "evaluation.json").exists()
    assert tcli.main(["--mode", "test", "--platform", "cpu"]) == 0


def _small_config(tmp_path):
    cfg = tconfig.default_config()
    cfg["model"].update(encoder_dim=32, fusion_dim=64, encoder_layers=1)
    path = str(tmp_path / "small.yaml")
    tconfig.save_yaml_config(cfg, path)
    return path


@pytest.mark.parametrize("argv", [["--mode", "visualize"],
                                  ["--mode", "export", "--ensemble", "2"],
                                  ["--ensemble", "2"], ["--raw"]],
                         ids=["visualize", "export_ensemble", "ensemble", "raw"])
def test_main_runs_what_was_refused(argv, tmp_path):
    """The paths the CLI refused before deep ensembles, the plots and the
    raw-media pipeline were ported, run on the CPU at a narrow width; each
    checks what it wrote."""
    out = tmp_path / "out"
    assert tcli.main([*argv, "--config", _small_config(tmp_path), "--output_dir",
                      str(out), "--experiment_name", "e", "--platform", "cpu",
                      "--quick", "--epochs", "1"]) == 0
    if argv == ["--raw"]:  # the IEMOCAP layout, generated (seed 42, 96/24/24)
        with open(out / "e" / "results" / "raw_results.json") as f:
            raw = json.load(f)
        assert raw["raw_layout"] == "iemocap" and raw["test"]["n_samples"] == 24
        assert np.isfinite(raw["test"]["ccc_average"])
    elif argv[-1] == "visualize":
        plots = out / "e" / "plots"
        with open(plots / "report_data.json") as f:
            data = json.load(f)
        assert np.isfinite(data["metrics"]["ccc_average"])
        for name in ("interactive", "summary", "attention_heatmap",
                     "decomposition"):
            assert os.path.exists(data["plots"][name]), name
    elif argv[1] == "export":
        with open(out / "exported_model" / "manifest.json") as f:
            manifest = json.load(f)
        assert manifest["ensemble_members"] == 2
        assert manifest["n_params"] == 2 * sum(
            v.numel() for v in tcli.MultimodalDEERPipeline(
                config_path=_small_config(tmp_path), output_dir=str(tmp_path),
                experiment_name="n", device="cpu").create_model().parameters())
    else:
        exp = out / "e"
        with open(exp / "results" / "pipeline_summary.json") as f:
            summary = json.load(f)
        with open(exp / "models" / "best" / "meta.json") as f:
            assert json.load(f)["metrics"]["ensemble_members"] == 2
        state = torch.load(exp / "models" / "best" / "state.pt",
                           weights_only=True)["model"]
        assert all(v.shape[0] == 2 for v in state.values())
        res = summary["test_results"]["synthetic"]
        assert res["n_samples"] == 128 and np.isfinite(res["ccc_average"])
        assert (exp / "results" / "conformal.json").exists()
        assert os.path.exists(summary["plots"]["report_data"])


def test_main_auto_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for platform in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(["--mode", "test", "--platform", platform])


def test_configured_corpus_path_raises(tmp_path):
    """A configured corpus path that exists loads through the registry (an
    IEMOCAP-layout fixture, hashed text) and its text backend reaches the
    pipeline; a configured directory that holds no corpus is skipped by the
    registry (the loader's FileNotFoundError becomes its warning), so the
    pipeline falls back to the synthetic fixture."""
    from tpu_deer_torch.data.raw_corpus import generate_raw_fixture

    corpus = str(tmp_path / "iemocap")
    generate_raw_fixture(corpus, n_train=8, n_val=4, n_test=4, duration_s=0.3,
                         seed=0)
    p = tcli.MultimodalDEERPipeline(
        output_dir=str(tmp_path), experiment_name="x", quick=True,
        overrides={"datasets.paths": {"IEMOCAP": corpus},
                   "datasets.pretrain_text": False}, device="cpu")
    data = p.create_datasets()
    assert {split: len(d["iemocap"]) for split, d in data.items()} == {
        "train": 8, "val": 4, "test": 4}
    assert p.text_backends == {"iemocap": "hashed"}
    assert data["train"]["iemocap"].arrays["audio"].shape == (8, 84)
    empty = tcli.MultimodalDEERPipeline(
        output_dir=str(tmp_path), experiment_name="y", quick=True,
        overrides={"datasets.paths": {"IEMOCAP": str(tmp_path / "x")}},
        device="cpu")
    assert set(empty.create_datasets()["train"]) == {"synthetic"}
