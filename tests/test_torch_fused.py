"""The port's fused epochs (`TrainingConfig(fused_epochs=True)`) on the CPU.

(a) Two fused epochs against the JAX trainer's two fused epochs (one
`lax.scan` an epoch), from the same converted init at a narrow width
(encoder 64, fusion 128, one layer) with dropout off: run A on one dataset
without accumulation (cosine schedule, warmup); run B on two datasets with
unequal weights under the curriculum, accumulating 2 micro-steps across the
epoch boundary (7 steps an epoch), with EMA and the exponential schedule.
Tolerances as `tests/test_torch_trainer.py`'s: per-epoch train loss rtol
1e-5 and parameters atol 1e-4 (float32 forward and backward in another
order; Adam scales the float noise of near-zero gradients up to about lr);
validation metrics rtol 1e-4, atol 1e-5.

(b) The port's fused path against its per-step path from one init and
seed with dropout on: the same step function on the same rows and the
same dropout draws, so parameters agree within atol 1e-6 and the trainer's
generator ends in the same state; data over `STAGE_BYTES_LIMIT` take the
per-step path itself. (c) A fused run resumed from an epoch-boundary
checkpoint repeats the straight run exactly. On a card the step is a CUDA
graph; `tests/test_torch_graph_cuda.py` holds it against eager steps there.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tpu_deer.data.pipeline import ArrayDataset as JDataset
from tpu_deer.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JModelConfig
from tpu_deer.train.trainer import DEERTrainer as JTrainer
from tpu_deer.train.trainer import TrainingConfig as JConfig
from tpu_deer_torch.convert import flax_to_state_dict, state_dict_to_flax
from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    create_complete_deer_model,
)
from tpu_deer_torch.train.checkpoint import CheckpointManager
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

torch.set_num_threads(1)

WIDTH = dict(encoder_dim=64, fusion_dim=128, encoder_layers=1)
RUNS = {
    "A": dict(scheduler="cosine", warmup_epochs=1, num_epochs=2, batch_size=16,
              learning_rate=3e-3, dataset_weights={"synthetic": 1.0},
              fused_epochs=True, seed=0),
    "B": dict(scheduler="exponential", num_epochs=2, batch_size=16,
              learning_rate=1e-3, grad_accum_steps=2, ema_decay=0.9,
              dataset_weights={"iemocap": 1.0, "meld": 0.6},
              fused_epochs=True, seed=1),
}
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)


class _Deterministic:
    """The reference's model with every dropout off, train step included."""

    def __init__(self, model):
        self._model = model
        self.config = model.config

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self._model.apply(variables, *args, deterministic=True, **kw)


def _datasets(run):
    """{name: (train arrays, val arrays)} for a run."""
    split = lambda n, v, seed: make_synthetic_splits(SyntheticConfig(
        n_train=n, n_val=v, n_test=8, seed=seed))
    if run == "A":
        s = split(96, 40, 5)
        return {"synthetic": (s["train"], s["val"])}
    a, b = split(64, 24, 6), split(48, 20, 7)
    return {"iemocap": (a["train"], a["val"]), "meld": (b["train"], b["val"])}


def _steps(run):
    return sum(len(tr["labels"]) // RUNS[run]["batch_size"]
               for tr, _ in _datasets(run).values())


@functools.lru_cache(maxsize=None)
def _init():
    """The port's seeded init as flax params (spares JAX an init compile)."""
    model = create_complete_deer_model(DEERModelConfig(**WIDTH), seed=3,
                                       device="cpu")
    return state_dict_to_flax(model.state_dict())


def _port_trainer(run, dropout, **overrides):
    model = CompleteDEERModel(DEERModelConfig(**WIDTH))
    model.load_state_dict(flax_to_state_dict(_init()))
    if not dropout:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    cfg = TrainingConfig(**{**RUNS[run], **overrides})
    return DEERTrainer(model, cfg, steps_per_epoch=_steps(run), device="cpu")


def _train(trainer, run, wrap=ArrayDataset, **kw):
    data = _datasets(run)
    return trainer.train({n: wrap(tr, n) for n, (tr, _) in data.items()},
                         {n: wrap(va, n) for n, (_, va) in data.items()}, **kw)


@pytest.fixture(scope="module")
def jax_runs():
    """Each run's two fused epochs on both sides, trained once."""
    out = {}
    for run in RUNS:
        jm = JModel(JModelConfig(**WIDTH))
        jt = JTrainer(jm, _init(), JConfig(**RUNS[run]),
                      steps_per_epoch=_steps(run))
        jt.model = _Deterministic(jm)
        tt = _port_trainer(run, dropout=False)
        out[run] = ((jt, _train(jt, run, JDataset)), (tt, _train(tt, run)))
    return out


@pytest.mark.parametrize("run", sorted(RUNS))
def test_fused_epochs_match_jax(jax_runs, run):
    (jt, jres), (tt, tres) = jax_runs[run]
    assert tt._run is not None and tt._run.eager == tres["final_step"]
    np.testing.assert_allclose(tres["history"]["train_loss"],
                               jres["history"]["train_loss"], rtol=1e-5)
    for key in ("val_loss", "val_ccc", "val_mae", "val_ece"):
        np.testing.assert_allclose(tres["history"][key], jres["history"][key],
                                   err_msg=key, **METRIC_TOL)
    np.testing.assert_allclose(tres["history"]["learning_rate"],
                               jres["history"]["learning_rate"], rtol=1e-6)
    assert tres["final_step"] == jres["final_step"]
    trees = [(state_dict_to_flax(tt.model.state_dict()), jt.state.params)]
    if run == "B":
        trees.append((state_dict_to_flax(tt.ema_params), jt.ema_params))
    for port, ref in trees:
        got = dict(jax.tree_util.tree_flatten_with_path(port)[0])
        ref = jax.tree_util.tree_flatten_with_path(ref)[0]
        assert len(got) == len(ref)
        for path, r in ref:
            np.testing.assert_allclose(got[path], np.asarray(r), rtol=0,
                                       atol=1e-4,
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("case", ["A", "B", "B over the stage limit"])
def test_fused_matches_per_step_with_dropout(case):
    run = case[0]
    fused = _port_trainer(run, dropout=True)
    if "limit" in case:
        fused.STAGE_BYTES_LIMIT = 0
    step = _port_trainer(run, dropout=True, fused_epochs=False)
    res = [_train(t, run) for t in (fused, step)]
    assert (fused._run is None) == ("limit" in case)
    assert res[0]["final_step"] == res[1]["final_step"] == 2 * _steps(run)
    np.testing.assert_allclose(res[0]["history"]["train_loss"],
                               res[1]["history"]["train_loss"], rtol=1e-6)
    assert torch.equal(fused.generator.get_state(), step.generator.get_state())
    ref = step.model.state_dict()
    for name, p in fused.model.state_dict().items():
        torch.testing.assert_close(p, ref[name], rtol=0, atol=1e-6, msg=name)
    assert fused.optimizer.state["count"] == step.optimizer.state["count"]
    assert int(fused.optimizer.count) == fused.optimizer.state["count"]


def test_fused_resume_is_exact(tmp_path):
    """4 fused epochs straight equal 2, then a new trainer resuming for 2
    more from the epoch-boundary checkpoint, with dropout on and
    accumulation across the boundary (spike detection off: its state is
    not checkpointed, as in the reference)."""
    kw = dict(num_epochs=4, spike_backoff=False, spike_rollback=False,
              save_frequency=1)
    straight = _port_trainer("B", dropout=True, **kw)
    _train(straight, "B", checkpoints=CheckpointManager(str(tmp_path / "s")))
    ckpt = CheckpointManager(str(tmp_path / "r"))
    _train(_port_trainer("B", dropout=True, **kw), "B", num_epochs=2,
           checkpoints=ckpt)
    resumed = _port_trainer("B", dropout=True, **kw)
    res = _train(resumed, "B", checkpoints=ckpt, resume=True)
    assert res["final_step"] == straight.step == 4 * _steps("B")
    assert resumed.history["train_loss"] == straight.history["train_loss"][2:]
    for name, p in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], p), name
    for name, p in straight.ema_params.items():
        assert torch.equal(resumed.ema_params[name], p), name
    assert torch.equal(resumed.generator.get_state(),
                       straight.generator.get_state())
