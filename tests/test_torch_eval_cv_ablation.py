"""The port's device metrics, the four small leftovers, cross-validation and
the ablation study against the JAX package on the CPU.

Metrics: the same float32 inputs with NaNs through the jnp metrics and the
port's tensor metrics, rtol 1e-6 (float32 sums in another order). The
leftovers: `nig_predictive_interval` rtol 1e-5 (a float32 chain of
softplus, divisions and a square root, rounded by XLA's and ATen's own
kernels: 2e-6 apart at most); `compare_models` and
`MahalanobisOOD.report` exact (the same numpy and scipy code);
`get_predictions_and_uncertainties` the same outputs of one converted
model at atol 1e-5 (the flagship's forward, tests/test_torch_model.py).

Cross-validation and ablation train a narrow flagship (encoder 64, fusion
128, one layer) with dropout off on both sides, from the port's seeded
init converted to flax (the reference's model factory and trainer are
replaced in its module for the test: its model with the attention dropout
off, as tests/test_torch_trainer.py does; its trainers of one
configuration share their jitted steps, so it compiles them once). The
folds are compared index for index; one fold's and one subset's
evaluation within rtol 1e-4, atol 1e-5, the trainer comparison's metric
tolerance.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deer.core import metrics as jm
from tpu_deer.core import nig as jnig
from tpu_deer.data.pipeline import ArrayDataset as JDataset
from tpu_deer.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer.eval import ablation as jab
from tpu_deer.eval import cross_validation as jcv
from tpu_deer.eval import ood as jood
from tpu_deer.eval import statistics as jstats
from tpu_deer.models import deer_model as jdm
from tpu_deer.train.trainer import DEERTrainer as JTrainer
from tpu_deer.train.trainer import TrainingConfig as JConfig
from tpu_deer_torch.convert import state_dict_to_flax
from tpu_deer_torch.core import metrics as tm
from tpu_deer_torch.core import nig as tnig
from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.eval import ablation as tab
from tpu_deer_torch.eval import cross_validation as tcv
from tpu_deer_torch.eval import ood as tood
from tpu_deer_torch.eval import statistics as tstats
from tpu_deer_torch.models import deer_model as tdm
from tpu_deer_torch.train.trainer import TrainingConfig

torch.set_num_threads(1)

WIDTH = dict(encoder_dim=64, fusion_dim=128, encoder_layers=1, dropout=0.0)
TRAIN = dict(learning_rate=3e-3, batch_size=16, num_epochs=1, warmup_epochs=0,
             scheduler="constant", dataset_weights={"synthetic": 1.0}, seed=0)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
SKIP = {"eval_time_s"}


def _data(n, seed=3):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    t = (0.6 * p + 0.5 * rng.normal(size=(n, 3))).astype(np.float32)
    u = rng.random((n, 3)).astype(np.float32)
    return p, t, u


def _with_nans(p, t, u):
    p, t, u = p.copy(), t.copy(), u.copy()
    p[3, 1] = np.nan
    t[7, 0] = np.inf
    u[11, 2] = np.nan
    return p, t, u


@pytest.mark.parametrize("nans", [False, True], ids=["finite", "nans"])
@pytest.mark.parametrize("fn", ["concordance_correlation_coefficient",
                                "pearson_correlation", "mean_absolute_error",
                                "root_mean_squared_error"])
def test_device_metrics_match_jax(fn, nans):
    p, t, _ = _data(64)
    if nans:
        p, t, _ = _with_nans(p, t, _)
    ref = float(getattr(jm, fn)(jnp.asarray(t), jnp.asarray(p)))
    got = getattr(tm, fn)(torch.from_numpy(t), torch.from_numpy(p))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)


@pytest.mark.parametrize("case", ["finite", "nans", "few_rows"])
def test_calibration_error_and_stats_match_jax(case):
    """ECE with uncertainty-quantile bins (NaN wherever a row is non-finite,
    as the reference's 0·inf gives; 1.0 below n_bins rows) and the six
    sufficient statistics, which add across shards."""
    p, t, u = _data(6 if case == "few_rows" else 80)
    if case == "nans":
        p, t, u = _with_nans(p, t, u)
    ref = float(jm.uncertainty_calibration_error(p, t, u))
    got = float(tm.uncertainty_calibration_error(
        torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(u)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)
    js = jm.ccc_sufficient_stats(jnp.asarray(t[:, 0]), jnp.asarray(p[:, 0]))
    ts = tm.ccc_sufficient_stats(torch.from_numpy(t[:, 0]), torch.from_numpy(p[:, 0]))
    for a, b in zip(ts, js):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    halves = [tm.ccc_sufficient_stats(torch.from_numpy(t[s, 0]),
                                      torch.from_numpy(p[s, 0]))
              for s in (slice(0, 3), slice(3, None))]
    summed = tm.CCCStats(*(a + b for a, b in zip(*halves)))
    np.testing.assert_allclose(float(tm.ccc_from_stats(summed)),
                               float(jm.ccc_from_stats(js)), rtol=1e-5)


@pytest.mark.parametrize("src, tgt", [(0.8, 0.6), (0.5, 0.9), (0.0, 0.4),
                                      (-0.2, 0.1), (0.7, -0.3)])
def test_transfer_effectiveness_matches_jax(src, tgt):
    assert tm.cross_dataset_transfer_effectiveness(src, tgt) == \
        jm.cross_dataset_transfer_effectiveness(src, tgt)


def test_leftovers_match_jax():
    rng = np.random.default_rng(5)
    raw = rng.normal(size=(4, 6, 4)).astype(np.float32)
    jp = jnig.nig_params_from_evidence(jnp.asarray(raw))
    tp = tnig.nig_params_from_evidence(torch.from_numpy(raw))
    for coverage in (0.9, 0.95):
        for got, ref in zip(tnig.nig_predictive_interval(tp, coverage),
                            jnig.nig_predictive_interval(jp, coverage)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)

    p, t, _ = _data(50)
    q = p + 0.3 * rng.normal(size=p.shape).astype(np.float32)
    assert tstats.StatisticalValidator().compare_models(p, q, t) == \
        jstats.StatisticalValidator().compare_models(p, q, t)

    feats = rng.normal(size=(300, 8)).astype(np.float32)
    probes = {"shifted": feats[:60] + 2.0, "same": feats[:60]}
    tdet = tood.MahalanobisOOD().fit(feats[:240])
    jdet = jood.MahalanobisOOD().fit(feats[:240])
    assert tdet.report(feats[240:], probes) == jdet.report(feats[240:], probes)

    cfg = dict(encoder_dim=32, fusion_dim=64, encoder_layers=1)
    model = tdm.create_complete_deer_model(tdm.DEERModelConfig(**cfg), seed=2,
                                           device="cpu")
    x = [rng.normal(size=(5, d)).astype(np.float32) for d in (84, 256, 768)]
    with torch.no_grad():
        got = tdm.get_predictions_and_uncertainties(
            model(*(torch.from_numpy(a) for a in x)))
    module = jdm.CompleteDEERModel(jdm.DEERModelConfig(**cfg))
    forward = jax.jit(lambda p, a, v, t: jdm.get_predictions_and_uncertainties(
        module.apply({"params": p}, a, v, t, deterministic=True)))
    ref = forward(state_dict_to_flax(model.state_dict()), *x)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


class _Deterministic:
    """The reference's model with every dropout off, train step included."""

    def __init__(self, model):
        self._model = model
        self.config = model.config

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self._model.apply(variables, *args, deterministic=True, **kw)


# (model config, training config, steps an epoch) → the jitted steps of the
# first reference trainer built with them.
_STEPS: dict = {}


class _JTrainer(JTrainer):
    """The reference's trainer on the deterministic model. Trainers built
    with one model config, training config and epoch length take the first
    one's jitted steps: what the steps trace from the trainer (the configs,
    the optimizer and its schedule) is fixed by those, so their programs
    are the same, and the reference compiles them once for the module."""

    def __init__(self, model, *args, **kwargs):
        super().__init__(model, *args, **kwargs)
        self.model = _Deterministic(model)
        key = (repr(model.config), repr(self.config), self.steps_per_epoch)
        names = ("_train_step", "_eval_step", "_eval_step_fused", "_eval_step_nig")
        first = _STEPS.setdefault(key, {n: getattr(self, n) for n in names})
        self.__dict__.update(first)


def _port_model(config, seed=42, device=None):
    model = tdm.create_complete_deer_model(config, seed=seed, device="cpu")
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _jax_model(config, seed=42):
    """The reference's module with the port's init for `seed`, converted."""
    port = _port_model(tdm.DEERModelConfig(**WIDTH), seed)
    return jdm.CompleteDEERModel(config), state_dict_to_flax(port.state_dict())


@pytest.fixture
def paired(monkeypatch):
    """Both packages' model factories and the reference's trainer set for
    a parity run."""
    for mod in (jcv, jab):
        monkeypatch.setattr(mod, "create_complete_deer_model", _jax_model)
        monkeypatch.setattr(mod, "DEERTrainer", _JTrainer)
    for mod in (tcv, tab):
        monkeypatch.setattr(mod, "create_complete_deer_model", _port_model)


def _splits(n_train=96, n_val=32, n_test=32, seed=4):
    return make_synthetic_splits(SyntheticConfig(
        n_train=n_train, n_val=n_val, n_test=n_test, seed=seed))


def _assert_results_match(got: dict, ref: dict):
    assert set(got) == set(ref)
    for key, r in ref.items():
        if key in SKIP:
            continue
        if isinstance(r, dict):
            _assert_results_match(got[key], r)
        elif isinstance(r, (str, list)):
            assert got[key] == r, key
        else:
            np.testing.assert_allclose(got[key], r, err_msg=key, **METRIC_TOL)


@pytest.mark.parametrize("n, folds, seed", [(37, 5, 0), (40, 4, 3), (96, 2, 1)])
def test_cv_folds_match_jax(n, folds, seed):
    args = (None, None, folds, seed)
    ref = list(jcv.CrossValidationEvaluator(*args)._folds(n))
    got = list(tcv.CrossValidationEvaluator(*args, device="cpu")._folds(n))
    assert len(got) == len(ref) == folds
    for (gt, gv), (rt, rv) in zip(got, ref):
        np.testing.assert_array_equal(gt, rt)
        np.testing.assert_array_equal(gv, rv)


def test_cv_fold_matches_jax(paired, monkeypatch):
    """The first of two folds trained and evaluated on both sides (106 rows
    a fold, 96 of them trained on: six steps an epoch, as the ablation's,
    so the reference's steps are shared)."""
    arrays = _splits(n_train=212)["train"]
    first = lambda folds: (lambda self, n: itertools.islice(folds(self, n), 1))
    monkeypatch.setattr(jcv.CrossValidationEvaluator, "_folds",
                        first(jcv.CrossValidationEvaluator._folds))
    monkeypatch.setattr(tcv.CrossValidationEvaluator, "_folds",
                        first(tcv.CrossValidationEvaluator._folds))
    ref = jcv.CrossValidationEvaluator(
        jdm.DEERModelConfig(**WIDTH), JConfig(**TRAIN), n_folds=2, seed=1
    ).run(JDataset(arrays, "synthetic"))
    got = tcv.CrossValidationEvaluator(
        tdm.DEERModelConfig(**WIDTH), TrainingConfig(**TRAIN), n_folds=2, seed=1,
        device="cpu").run(ArrayDataset(arrays, "synthetic"))
    assert len(got["folds"]) == 1
    _assert_results_match(got["folds"][0], ref["folds"][0])
    for key in ("ccc_mean", "mae_mean"):
        np.testing.assert_allclose(got[key], ref[key], **METRIC_TOL)


@pytest.mark.parametrize("keep", [("audio",), ("video", "text"),
                                  ("audio", "video", "text")])
def test_ablation_masks_match_jax(keep):
    arrays = _splits(24, 8, 8)["train"]
    ref = jab._mask_modalities(JDataset(arrays, "s"), keep).arrays
    got = tab._mask_modalities(ArrayDataset(arrays, "s"), keep).arrays
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    for mod in ("audio", "video", "text"):
        assert (np.abs(got[mod]).sum() == 0) != (mod in keep)


def test_ablation_subset_matches_jax(paired):
    s = _splits()
    ref = jab.AblationStudy(jdm.DEERModelConfig(**WIDTH), JConfig(**TRAIN),
                            subsets=[("audio", "text")]).run(
        *(JDataset(s[k], "synthetic") for k in ("train", "val", "test")))
    got = tab.AblationStudy(tdm.DEERModelConfig(**WIDTH), TrainingConfig(**TRAIN),
                            subsets=[("audio", "text")], device="cpu").run(
        *(ArrayDataset(s[k], "synthetic") for k in ("train", "val", "test")))
    assert list(got) == list(ref) == ["A+T"]
    _assert_results_match(got["A+T"], ref["A+T"])


def test_staged_datasets_stay_alive():
    """The trainers cache staged arrays by the dataset's id. The ablation
    study trains on a dataset it builds and drops, then builds the masked
    test set, which may take the first one's id (this test's ablation
    comparison once failed so in a full run). An entry lives exactly as
    long as its dataset: a freed dataset's entry goes with it, and a live
    one's stays. The raw trainer's entries hold their arrays dict."""
    import gc
    import weakref

    from tpu_deer_torch.train.raw_trainer import RawSequenceTrainer
    from tpu_deer_torch.train.trainer import DEERTrainer

    arrays = _splits(16, 8, 8)["train"]
    trainer = DEERTrainer(_port_model(tdm.DEERModelConfig(**WIDTH)),
                          TrainingConfig(**TRAIN), device="cpu")
    kept = ArrayDataset(dict(arrays), "kept")
    trainer._stage(kept)
    trainer._stage_combined({"k": kept})
    for stage in (trainer._stage, lambda d: trainer._stage_combined({"s": d})):
        ds = ArrayDataset({k: v + 1.0 for k, v in arrays.items()}, "s")
        ref = weakref.ref(ds)
        stage(ds)
        del ds
        gc.collect()
        assert ref() is None  # the cache does not hold the dataset
    assert list(trainer._staged) == [id(kept)]
    assert list(trainer._combined) == [(("k", id(kept)),)]
    again = ArrayDataset({k: v - 1.0 for k, v in arrays.items()}, "s")
    np.testing.assert_array_equal(trainer._stage(again)["audio"].numpy(),
                                  again.arrays["audio"])
    np.testing.assert_array_equal(trainer._stage(kept)["audio"].numpy(),
                                  kept.arrays["audio"])

    raw = RawSequenceTrainer.__new__(RawSequenceTrainer)
    raw._staged, raw.device = {}, torch.device("cpu")
    raw_arrays = {k: np.zeros((2, 1), np.float32) for k in
                  ("signal", "video_frames", "token_ids", "token_mask", "labels")}
    raw._stage(raw_arrays)
    held = id(raw_arrays)
    del raw_arrays
    gc.collect()
    assert raw._staged[held][0] is not None
