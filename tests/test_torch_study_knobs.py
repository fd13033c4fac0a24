"""The trainer's knobs that the uncertainty studies vary
(`TrainingConfig.loss_variant`, `evidence_weight`, `kl_weight`,
`aleatoric_moment_weight`) and `DEERTrainer.predict(return_nig=True)`,
against the JAX package on the CPU.

The port's seeded init at a small width is carried to the reference by
`convert`; dropout is off on both sides (every port Dropout p = 0, the
reference's model applied deterministically, as it has a fixed attention
dropout of 0.1). The reference's `_loss_fn` under each case's
TrainingConfig is traced into one jitted program (one compile for the
five). Tolerances: the total and every scalar of the step at rtol 1e-5
(float32 forwards in another summation order); the predictions and the NIG
parameters at rtol 1e-4, atol 1e-5, the serving tests' output tolerance.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_reference import Deterministic
from tpu_deer.data.pipeline import ArrayDataset as JDataset
from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JModelConfig
from tpu_deer.train.trainer import DEERTrainer as JTrainer
from tpu_deer.train.trainer import TrainingConfig as JConfig
from tpu_deer_torch.convert import state_dict_to_flax
from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.models.deer_model import (
    DEERModelConfig,
    create_complete_deer_model,
)
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

torch.set_num_threads(1)

SMALL = dict(audio_dim=12, video_dim=16, text_dim=20, encoder_dim=24,
             fusion_dim=32, encoder_layers=1, attention_heads=2, dropout=0.0)
# The settings of uncertainty_sweep.py's grid point (3, 1),
# nig_calibration_study.py's kl-0.01, kl-0 and loss-v1 probes, and the
# aleatoric moment matching of uncertainty_diag.py and the calibration
# study.
CASES = {
    "v2-evidence3-kl1": dict(evidence_weight=3.0, kl_weight=1.0),
    "v2-kl0.01": dict(kl_weight=0.01),
    "v2-kl0": dict(kl_weight=0.0),
    "v1-evidence0.1": dict(loss_variant="v1", evidence_weight=0.1),
    "moment0.1": dict(aleatoric_moment_weight=0.1),
}
AUX = ("loss", "distill_mu", "distill_unc", "nll", "mse",
       "calibration_alignment", "aleatoric_moment", "mean_uncertainty")
WEIGHT = 0.8


@functools.lru_cache(maxsize=None)
def _splits():
    return make_synthetic_splits(SyntheticConfig(
        n_train=32, n_val=8, n_test=64, audio_dim=12, video_dim=16, text_dim=20,
        seed=9))


@functools.lru_cache(maxsize=None)
def _init():
    model = create_complete_deer_model(DEERModelConfig(**SMALL), seed=6,
                                       device="cpu")
    return {k: v.clone() for k, v in model.state_dict().items()}


def _port(**config):
    model = create_complete_deer_model(DEERModelConfig(**SMALL), device="cpu")
    model.load_state_dict(_init())
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return DEERTrainer(model, TrainingConfig(batch_size=16, **config),
                       device="cpu")


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's trainer at the default config on the same init."""
    jm = JModel(JModelConfig(**SMALL))
    trainer = JTrainer(jm, state_dict_to_flax(_init()), JConfig(batch_size=16))
    trainer.model = Deterministic(jm)
    return trainer


@functools.lru_cache(maxsize=None)
def _reference_losses():
    """{case: (total, aux)} of the reference's `_loss_fn` under each case's
    config on the training rows, from one jitted program."""
    base = _reference()
    trainers = {}
    for name, kw in CASES.items():  # the one trainer under each config
        trainers[name] = copy.copy(base)
        trainers[name].config = JConfig(batch_size=16, **kw)
    batch = {k: jnp.asarray(v) for k, v in _splits()["train"].items()
             if k != "is_hard"}
    params = base.state.params

    def losses(params, batch, rng, weight):
        return {name: t._loss_fn(params, batch, rng, weight)
                for name, t in trainers.items()}

    out = jax.jit(losses)(params, batch, jax.random.PRNGKey(0),
                          jnp.float32(WEIGHT))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_fn_matches_reference(case):
    batch = {k: torch.from_numpy(v) for k, v in _splits()["train"].items()
             if k != "is_hard"}
    total, aux = _port(**CASES[case])._loss_fn(batch, WEIGHT)
    want_total, want_aux = _reference_losses()[case]
    np.testing.assert_allclose(float(total.detach()), want_total, rtol=1e-5)
    assert set(aux) == set(AUX) == set(want_aux)
    for key in AUX:
        np.testing.assert_allclose(float(aux[key]), want_aux[key], rtol=1e-5,
                                   err_msg=key)
    if CASES[case].get("aleatoric_moment_weight"):
        assert float(aux["aleatoric_moment"]) > 0


def test_predict_return_nig_matches_reference():
    """64 rows in batches of 16 (the last batch whole): every channel of
    `predict(return_nig=True)`, the NIG parameters included."""
    test = _splits()["test"]
    got = _port().predict(ArrayDataset(test, "t"), return_nig=True)
    want = _reference().predict(JDataset(test, "t"), return_nig=True)
    assert set(got) == set(want)
    for key in ("mu", "eabs", "alpha", "nu", "beta", "uncertainty",
                "calibrated_uncertainty", "aleatoric", "epistemic"):
        assert got[key].shape == (64, 3), key
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
