"""The port's distillation (`train/distill.py`, the teacher terms of the
trainer's loss) against the JAX package on the CPU.

The teacher is the port's seeded init (one model, or a K = 2 ensemble)
carried to the reference by `convert`; the stamped targets are held at
rtol 1e-4 (float32 forwards in another summation order), the loss and its
distillation terms on one batch at rtol 1e-5 (the reference's model has a
fixed attention dropout of 0.1, which its wrapper here turns off, and every
port Dropout has p = 0).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deer.data.pipeline import ArrayDataset as JDataset
from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JModelConfig
from tpu_deer.train.distill import add_teacher_targets as j_add_teacher_targets
from tpu_deer.train.trainer import DEERTrainer as JTrainer
from tpu_deer.train.trainer import TrainingConfig as JConfig
from tpu_deer_torch.convert import state_dict_to_flax, state_dict_to_stacked_flax
from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.models.deer_model import (
    DEERModelConfig,
    create_complete_deer_model,
)
from tpu_deer_torch.train.distill import add_teacher_targets
from tpu_deer_torch.train.ensemble import create_deer_ensemble
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

torch.set_num_threads(1)

SMALL = dict(audio_dim=12, video_dim=16, text_dim=20, encoder_dim=24,
             fusion_dim=32, encoder_layers=1, attention_heads=2, dropout=0.0)


class _Deterministic:
    """The reference's model with every dropout off, train step included."""

    def __init__(self, model):
        self._model = model
        self.config = model.config

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self._model.apply(variables, *args, deterministic=True, **kw)


@functools.lru_cache(maxsize=None)
def _splits():
    return make_synthetic_splits(SyntheticConfig(
        n_train=40, n_val=8, n_test=8, audio_dim=12, video_dim=16, text_dim=20,
        seed=8))


def _student():
    model = create_complete_deer_model(DEERModelConfig(**SMALL), seed=4,
                                       device="cpu")
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


@pytest.mark.parametrize("ensemble", [False, True], ids=["single", "ensemble"])
def test_stamped_targets_match_reference(ensemble):
    """40 rows in batches of 16: the last batch wrap-padded."""
    train = _splits()["train"]
    jm = JModel(JModelConfig(**SMALL))
    if ensemble:
        model, stack = create_deer_ensemble(DEERModelConfig(**SMALL), 2, seed=3,
                                            device="cpu")
        got = add_teacher_targets(model, ArrayDataset(train, "t"), batch_size=16,
                                  ensemble=True, params=stack)
        jparams = state_dict_to_stacked_flax(stack)
    else:
        model = create_complete_deer_model(DEERModelConfig(**SMALL), seed=3,
                                           device="cpu")
        got = add_teacher_targets(model, ArrayDataset(train, "t"), batch_size=16)
        jparams = state_dict_to_flax(model.state_dict())
    want = j_add_teacher_targets(jm, jparams, JDataset(train, "t"),
                                 batch_size=16, ensemble=ensemble)
    assert set(got.arrays) == set(want.arrays)
    for key in ("teacher_mu", "teacher_unc"):
        assert got.arrays[key].shape == (40, 3) and got.arrays[key].dtype == np.float32
        np.testing.assert_allclose(got.arrays[key], np.asarray(want.arrays[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    for key, v in train.items():
        assert got.arrays[key] is v or np.array_equal(got.arrays[key], v)


def _stamped():
    s = _splits()["train"]
    rng = np.random.default_rng(0)
    return {**s, "teacher_mu": rng.uniform(-1, 1, (40, 3)).astype(np.float32),
            "teacher_unc": rng.uniform(0.01, 2.0, (40, 3)).astype(np.float32)}


def test_loss_terms_match_reference_loss_fn():
    batch = {k: v[:16] for k, v in _stamped().items()}
    model = _student()
    cfg = dict(distill_mu_weight=0.7, distill_unc_weight=0.3)
    total, aux = DEERTrainer(model, TrainingConfig(**cfg), device="cpu")._loss_fn(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 0.8)
    jm = JModel(JModelConfig(**SMALL))
    ref = JTrainer(jm, state_dict_to_flax(model.state_dict()), JConfig(**cfg))
    ref.model = _Deterministic(jm)
    want_total, want_aux = jax.jit(ref._loss_fn)(
        ref.state.params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), jnp.float32(0.8))
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-5)
    for key in ("loss", "distill_mu", "distill_unc", "mse",
                "calibration_alignment", "mean_uncertainty"):
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(aux["distill_mu"]) > 0 and float(aux["distill_unc"]) > 0


@pytest.mark.parametrize("both", [True, False], ids=["every_dataset", "one_dataset"])
def test_fused_epochs_stage_targets_only_where_every_dataset_has_them(both):
    """Fused and per-step epochs on stamped data take the same steps; the
    fused path stages the targets only where every dataset has them (a
    partial column would misalign the global indices), as the reference's
    `_stage_combined`."""
    stamped = _stamped()
    plain = {k: v for k, v in stamped.items() if not k.startswith("teacher_")}
    data = {"a": ArrayDataset(stamped, "a"),
            "b": ArrayDataset(stamped if both else plain, "b")}
    out = {}
    for fused in (True, False):
        tr = DEERTrainer(_student(), TrainingConfig(
            batch_size=16, dataset_weights={"a": 1.0, "b": 0.5},
            fused_epochs=fused), steps_per_epoch=4, device="cpu")
        its = {n: BatchIterator(d, 16, shuffle=True, drop_last=True, seed=0)
               for n, d in data.items()}
        out[fused] = tr.train_epoch(its, 0)
        if fused:
            staged = tr._run.data
            assert ("teacher_mu" in staged) == both
    assert out[False]["distill_mu"] > 0
    assert (out[True]["distill_mu"] > 0) == both
    if both:
        for key, v in out[False].items():
            np.testing.assert_allclose(out[True][key], v, rtol=1e-6, atol=1e-7,
                                       err_msg=key)
