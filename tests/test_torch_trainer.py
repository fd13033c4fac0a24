"""The port's DEERTrainer and CheckpointManager against the JAX package on the
CPU.

Two training runs on each side from the same converted init at a narrow
width (encoder 64, fusion 128, one layer) with dropout off, 2 epochs each:
run A with the cosine schedule and warmup on one dataset; run B with
gradient accumulation over 2 micro-steps (carried across the epoch
boundary: 7 steps an epoch), EMA with validation on the EMA weights, two
datasets under the curriculum with their weights, the exponential schedule
and a frozen prefix. The reference's model has a fixed attention dropout of
0.1 besides `model.dropout`; its trainer runs here through a wrapper that
applies the model deterministically, and every port Dropout has p = 0.

Tolerances: per-epoch train loss rtol 1e-5 and parameters atol 1e-4, as the
raw trainer's comparison (float32 forward and backward in another summation
order; Adam scales the float noise of near-zero gradients up to about lr);
validation metrics rtol 1e-4, atol 1e-5 (computed from those predictions).
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from tpu_deer.data.pipeline import ArrayDataset as JDataset
from tpu_deer.data.pipeline import BatchIterator as JIterator
from tpu_deer.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JModelConfig
from tpu_deer.train.checkpoint import CheckpointManager as JCheckpoints
from tpu_deer.train.trainer import DEERTrainer as JTrainer
from tpu_deer.train.trainer import TrainingConfig as JConfig
from tpu_deer_torch.convert import flax_to_state_dict, state_dict_to_flax
from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    create_complete_deer_model,
)
from tpu_deer_torch.train import checkpoint as tcheckpoint
from tpu_deer_torch.train.checkpoint import CheckpointManager
from tpu_deer_torch.train.trainer import (
    DEERTrainer,
    TrainingConfig,
    create_trainer,
    run_complete_training_pipeline,
)

torch.set_num_threads(1)

WIDTH = dict(encoder_dim=64, fusion_dim=128, encoder_layers=1)
RUNS = {
    "A": dict(scheduler="cosine", warmup_epochs=1, num_epochs=2, batch_size=16,
              learning_rate=3e-3, dataset_weights={"synthetic": 1.0},
              save_frequency=1, seed=0),
    "B": dict(scheduler="exponential", num_epochs=2, batch_size=16,
              learning_rate=1e-3, grad_accum_steps=2, ema_decay=0.9,
              ema_eval=True, frozen_prefixes=("audio_encoder",),
              dataset_weights={"iemocap": 1.0, "meld": 0.6},
              save_frequency=1, seed=1),
}
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)


class _Deterministic:
    """The reference's model with every dropout off, train step included."""

    def __init__(self, model):
        self._model = model
        self.config = model.config

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self._model.apply(variables, *args, deterministic=True, **kw)


def _splits(n_train, n_val, seed):
    return make_synthetic_splits(SyntheticConfig(n_train=n_train, n_val=n_val,
                                                 n_test=8, seed=seed))


def _datasets(run):
    """{name: (train arrays, val arrays)} for a run."""
    if run == "A":
        s = _splits(96, 40, 5)
        return {"synthetic": (s["train"], s["val"])}
    a, b = _splits(64, 24, 6), _splits(48, 20, 7)
    return {"iemocap": (a["train"], a["val"]), "meld": (b["train"], b["val"])}


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


@functools.lru_cache(maxsize=None)
def _init():
    """The reference's module and the port's seeded init as flax params
    (the port's init converted, which spares JAX an init compile)."""
    model = create_complete_deer_model(DEERModelConfig(**WIDTH), seed=3,
                                       device="cpu")
    return JModel(JModelConfig(**WIDTH)), state_dict_to_flax(model.state_dict())


def _run(run, tmp):
    """(reference trainer, results, ckpt dir), (port trainer, results, dir)."""
    jm, params = _init()
    data = _datasets(run)
    steps = sum(len(tr["labels"]) // RUNS[run]["batch_size"] for tr, _ in data.values())
    out = []
    for side in ("jax", "port"):
        root = str(tmp.mktemp(f"trainer_{run}_{side}"))
        if side == "jax":
            trainer = JTrainer(jm, params, JConfig(**RUNS[run]), steps_per_epoch=steps)
            trainer.model = _Deterministic(jm)
            ckpt, wrap = JCheckpoints(root), JDataset
        else:
            model = CompleteDEERModel(DEERModelConfig(**WIDTH))
            model.load_state_dict(flax_to_state_dict(params))
            trainer = DEERTrainer(_no_dropout(model), TrainingConfig(**RUNS[run]),
                                  steps_per_epoch=steps, device="cpu")
            ckpt, wrap = CheckpointManager(root), ArrayDataset
        results = trainer.train(
            {n: wrap(tr, n) for n, (tr, _) in data.items()},
            {n: wrap(va, n) for n, (_, va) in data.items()}, checkpoints=ckpt)
        out.append((trainer, results, root))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runs on both sides, trained once for the module."""
    return {run: _run(run, tmp_path_factory) for run in RUNS}


def _assert_metrics_match(got: dict, ref: dict, label: str):
    assert set(got) == set(ref), label
    for key, r in ref.items():
        if isinstance(r, str):
            assert got[key] == r, (label, key)
        else:
            np.testing.assert_allclose(got[key], r, err_msg=f"{label} {key}",
                                       **METRIC_TOL)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_two_epochs_match_jax(runs, run):
    (jt, jres, _), (tt, tres, _) = runs[run]
    np.testing.assert_allclose(tres["history"]["train_loss"],
                               jres["history"]["train_loss"], rtol=1e-5)
    for key in ("val_loss", "val_ccc", "val_mae", "val_ece"):
        np.testing.assert_allclose(tres["history"][key], jres["history"][key],
                                   err_msg=key, **METRIC_TOL)
    np.testing.assert_allclose(tres["history"]["learning_rate"],
                               jres["history"]["learning_rate"], rtol=1e-6)
    assert tres["serving_channel"] == jres["serving_channel"]
    assert tres["final_step"] == jres["final_step"]
    np.testing.assert_allclose(tres["best_val_ccc"], jres["best_val_ccc"],
                               **METRIC_TOL)
    got = dict(jax.tree_util.tree_flatten_with_path(
        state_dict_to_flax(tt.model.state_dict()))[0])
    ref = jax.tree_util.tree_flatten_with_path(jt.state.params)[0]
    assert len(got) == len(ref)
    for path, r in ref:
        np.testing.assert_allclose(got[path], np.asarray(r), rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    if run == "B":  # the frozen prefix did not move; the EMA matches
        init = flax_to_state_dict(_init()[1])
        for name, p in tt.model.state_dict().items():
            if name.startswith("audio_encoder"):
                assert torch.equal(p, init[name]), name
        ema = dict(jax.tree_util.tree_flatten_with_path(
            state_dict_to_flax(tt.ema_params))[0])
        for path, r in jax.tree_util.tree_flatten_with_path(jt.ema_params)[0]:
            np.testing.assert_allclose(ema[path], np.asarray(r), rtol=0,
                                       atol=1e-4)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_checkpoint_metadata_matches_jax(runs, run):
    (_, _, jroot), (_, _, troot) = runs[run]
    names = sorted(os.listdir(jroot))
    assert sorted(os.listdir(troot)) == names and "best" in names
    for name in names:
        with open(os.path.join(jroot, name, "meta.json")) as f:
            ref = json.load(f)
        with open(os.path.join(troot, name, "meta.json")) as f:
            got = json.load(f)
        assert got["step"] == ref["step"] and got["format"] == "torch"
        _assert_metrics_match(got["metrics"], ref["metrics"], name)


@functools.lru_cache(maxsize=None)
def _host_pair(scheduler, accum):
    """(reference, port) trainers for host-side logic: no training."""
    jm, params = _init()
    cfg = dict(scheduler=scheduler, num_epochs=5, warmup_epochs=2,
               grad_accum_steps=accum, learning_rate=2e-3, seed=4,
               dataset_weights={"a": 1.0, "b": 0.5, "c": 0.8})
    model = CompleteDEERModel(DEERModelConfig(**WIDTH))
    return (JTrainer(jm, params, JConfig(**cfg), steps_per_epoch=7),
            DEERTrainer(model, TrainingConfig(**cfg), steps_per_epoch=7,
                        device="cpu"))


@pytest.mark.parametrize("scheduler", ["cosine", "exponential", "plateau",
                                       "constant"])
@pytest.mark.parametrize("accum", [1, 2])
def test_schedules_match_jax(scheduler, accum):
    """Every update count the run reaches and beyond (float32 vs float64)."""
    jt, tt = _host_pair(scheduler, accum)
    assert tt.total_steps == jt.total_steps
    counts = range(tt.total_steps + 5)
    np.testing.assert_allclose([tt.schedule(c) for c in counts],
                               [float(jt.schedule(c)) for c in counts],
                               rtol=2e-6, atol=1e-12)
    if scheduler == "cosine":
        assert tt.schedule(0) == 0.0  # the first update runs at lr 0


def test_spike_and_plateau_decisions_match_jax():
    jt, tt = _host_pair("plateau", 1)
    losses = [1.0, 0.9, 0.85, 0.84, 3.0, 0.83, float("nan"), 0.82, 0.8, -0.5,
              -0.6, 5.0, 0.79, 0.78]
    fracs = [0.0] * 8 + [0.02] + [0.0] * 5
    for loss, frac in zip(losses, fracs):
        assert tt._spike_update(loss, frac) == jt._spike_update(loss, frac)
        assert tt._spike_scale == pytest.approx(jt._spike_scale, rel=1e-12)
        assert tt._spike_history == jt._spike_history
    metrics = [0.1, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.21, 0.21, 0.21, 0.21,
               0.21, 0.21, 0.21]
    for m in metrics:
        tt._plateau_update(m)
        jt._plateau_update(m)
        assert (tt._plateau_scale, tt._plateau_wait) == (
            jt._plateau_scale, jt._plateau_wait)
    assert tt._plateau_scale < 1.0


def test_curriculum_iterator_matches_jax():
    jt, tt = _host_pair("cosine", 1)
    sizes = {"a": 50, "b": 23, "c": 37}
    rng = np.random.default_rng(0)
    arrays = {n: {"labels": rng.normal(size=(k, 3)).astype(np.float32)}
              for n, k in sizes.items()}
    for epoch in range(5):
        seqs = []
        for trainer, ds, it in ((jt, JDataset, JIterator),
                                (tt, ArrayDataset, BatchIterator)):
            iters = {n: it(ds(a, n), 8, shuffle=True, drop_last=n != "b", seed=2)
                     for n, a in arrays.items()}
            seqs.append(list(trainer._multi_dataset_iterator(iters, epoch)))
        assert len(seqs[0]) == len(seqs[1]) > 0
        for (jn, ji, jm), (tn, ti, tm) in zip(*seqs):
            assert str(tn) == str(jn)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm, jm)


def _port_trainer(num_epochs, seed=0):
    """A port trainer with dropout on (model dropout 0.3 and attention
    0.1) on the run-A data."""
    model = CompleteDEERModel(DEERModelConfig(**WIDTH))
    model.load_state_dict(flax_to_state_dict(_init()[1]))
    cfg = TrainingConfig(**{**RUNS["A"], "num_epochs": num_epochs,
                            "scheduler": "cosine", "seed": seed,
                            "spike_backoff": False, "spike_rollback": False})
    return DEERTrainer(model, cfg, steps_per_epoch=6, device="cpu")


def test_resume_is_exact(tmp_path):
    """4 epochs straight equal 2 epochs, then a new trainer resuming for 2
    more from the checkpoint (parameters, moments, step and the dropout
    generator), with dropout on. The plateau and spike state live on the
    host and are not checkpointed, as in the reference, so spike detection
    is off here."""
    (tr, va), = _datasets("A").values()
    data = ({"synthetic": ArrayDataset(tr)}, {"synthetic": ArrayDataset(va)})
    straight = _port_trainer(4)
    straight.train(*data, checkpoints=CheckpointManager(str(tmp_path / "s")))
    first = _port_trainer(4)
    ckpt = CheckpointManager(str(tmp_path / "r"))
    first.train(*data, num_epochs=2, checkpoints=ckpt)
    resumed = _port_trainer(4)
    res = resumed.train(*data, checkpoints=ckpt, resume=True)
    assert res["final_step"] == straight.step == 24
    assert len(res["history"]["train_loss"]) == 2
    assert resumed.history["train_loss"] == straight.history["train_loss"][2:]
    for name, p in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], p), name
    assert torch.equal(resumed.generator.get_state(),
                       straight.generator.get_state())


def test_dropout_draws_follow_the_seed():
    """Dropout on: the same trainer seed repeats whatever the global RNG
    does; another seed differs."""
    (tr, va), = _datasets("A").values()
    data = ({"synthetic": ArrayDataset(tr)}, {"synthetic": ArrayDataset(va)})
    params = []
    for seed, global_seed in ((0, 1), (0, 2), (5, 1)):
        torch.manual_seed(global_seed)
        t = _port_trainer(1, seed=seed)
        t.train(*data)
        params.append(t.model.state_dict())
    assert all(torch.equal(params[0][k], params[1][k]) for k in params[0])
    assert not all(torch.equal(params[0][k], params[2][k]) for k in params[0])


def test_checkpoint_manager_prunes_and_copies_best(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep_last=2)
    for step in (1, 2, 3, 4):
        ckpt.save({"w": torch.full((3,), float(step)), "step": step}, step,
                  metrics={"loss": np.float32(step)}, is_best=step == 2)
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    assert torch.equal(ckpt.restore("best")["w"], torch.full((3,), 2.0))
    assert ckpt.restore()["step"] == 4
    assert ckpt.metadata("best") == {"step": 2, "metrics": {"loss": 2.0},
                                     "format": "torch"}
    state = torch.load(os.path.join(tmp_path, "step_00000003", "state.pt"),
                       weights_only=True)
    assert torch.equal(state["w"], torch.full((3,), 3.0))


def test_async_checkpoint_failures_drain(tmp_path, monkeypatch):
    """A failed async write surfaces once, at the next save, which is still
    queued; wait() drains the whole queue, raises the first of several
    failures and leaves no stale one behind."""
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    real_save, calls = torch.save, {"n": 0}

    def flaky_save(obj, path):
        calls["n"] += 1
        if calls["n"] in (1, 3, 4):
            raise OSError(f"disk full {calls['n']}")
        return real_save(obj, path)

    monkeypatch.setattr(tcheckpoint.torch, "save", flaky_save)
    state = {"w": torch.ones(4)}
    ckpt.save(state, step=1)
    ckpt._pool.submit(lambda: None).result()  # the flaky write is done
    with pytest.raises(OSError, match="disk full 1"):
        ckpt.save(state, step=2)
    ckpt.wait()
    assert ckpt.all_steps() == [2]
    ckpt.save(state, step=3)
    ckpt.save(state, step=4)
    with pytest.raises(OSError, match="disk full 3"):
        ckpt.wait()
    ckpt.wait()  # drained: nothing stale
    assert ckpt.all_steps() == [2]


def test_factories(tmp_path):
    """create_trainer builds the seeded model and its trainer;
    run_complete_training_pipeline trains and writes logs and checkpoints."""
    trainer = create_trainer(DEERModelConfig(**WIDTH), steps_per_epoch=3,
                             seed=5, device="cpu")
    ref = create_complete_deer_model(DEERModelConfig(**WIDTH), seed=5,
                                     device="cpu")
    assert trainer.config.seed == 5 and trainer.total_steps == 300
    for name, p in ref.state_dict().items():
        assert torch.equal(trainer.model.state_dict()[name], p), name
    (tr, va), = _datasets("A").values()
    res = run_complete_training_pipeline(
        DEERModelConfig(**WIDTH), TrainingConfig(num_epochs=1, batch_size=16),
        {"synthetic": ArrayDataset(tr)}, {"synthetic": ArrayDataset(va)},
        experiment_dir=str(tmp_path), device="cpu")
    assert res["final_step"] == 6 and res["epochs_run"] == 1
    assert np.isfinite(res["best_val_ccc"])
    assert os.path.exists(tmp_path / "logs" / "metrics.jsonl")
    assert os.path.isdir(tmp_path / "models" / "best")


def test_unported_knobs_raise(tmp_path):
    model = CompleteDEERModel(DEERModelConfig(**WIDTH))
    for kw in (dict(remat=True), dict(storage_dtype="bfloat16")):
        with pytest.raises(NotImplementedError):
            DEERTrainer(model, TrainingConfig(**kw), device="cpu")
    with pytest.raises(NotImplementedError):
        DEERTrainer(model, TrainingConfig(), mesh=object(), device="cpu")
    trainer = DEERTrainer(model, TrainingConfig(rng_impl="threefry2x32"),
                          device="cpu")
    # MC dropout and teacher targets are ported: a bad sample count
    # raises, and a stamped dataset trains with its distillation terms.
    with pytest.raises(ValueError, match="n_samples"):
        trainer.predict_mc_dropout(None, n_samples=0)
    (tr, va), = _datasets("A").values()
    distill = ArrayDataset({**tr, "teacher_mu": tr["labels"],
                            "teacher_unc": np.abs(tr["labels"]) + 0.1})
    trainer = DEERTrainer(model, TrainingConfig(batch_size=16, num_epochs=1),
                          steps_per_epoch=6, device="cpu")
    metrics = trainer.train_epoch({"synthetic": BatchIterator(
        distill, 16, shuffle=True, drop_last=True)}, 0)
    assert metrics["distill_mu"] > 0 and metrics["distill_unc"] > 0
    for foreign in ("state.msgpack", "manifest.json"):  # JAX's formats
        root = str(tmp_path / foreign)
        os.makedirs(os.path.join(root, "step_00000001"))
        open(os.path.join(root, "step_00000001", foreign), "wb").close()
        with pytest.raises(NotImplementedError):
            CheckpointManager(root).restore()
