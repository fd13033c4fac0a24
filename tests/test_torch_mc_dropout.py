"""The port's `DEERTrainer.predict_mc_dropout` on the CPU: against the JAX
package's with the dropout off (the same weights, converted), against a
host loop over the samples with it on, per seed, at S = 1, and its
refusals.

With every dropout off the S samples are one forward, so the two packages'
moment matching must agree (rtol 1e-4, atol 1e-5: float32 forwards in
another summation order; the reference's model has a fixed attention
dropout of 0.1, which its wrapper here turns off). With dropout on, the
vmapped samples are held against one seeded forward of the batch repeated
S times, whose draws are laid out as the vmapped [S, B, ...] draws, split
into its S samples and moment-matched in float64 in a host loop (1e-5).
"""

import functools

import numpy as np
import pytest
import torch

from tpu_deer.data.pipeline import ArrayDataset as JDataset
from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JModelConfig
from tpu_deer.train.trainer import DEERTrainer as JTrainer
from tpu_deer.train.trainer import TrainingConfig as JConfig
from tpu_deer_torch.convert import state_dict_to_flax
from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.models.deer_model import (
    DEERModelConfig,
    create_complete_deer_model,
    uncertainty_outputs,
)
from tpu_deer_torch.train.rng import forked_rng, seed_global
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

torch.set_num_threads(1)

SMALL = dict(audio_dim=12, video_dim=16, text_dim=20, encoder_dim=24,
             fusion_dim=32, encoder_layers=1, attention_heads=2)
KEYS = ("mu", "uncertainty", "calibrated_uncertainty", "aleatoric", "epistemic")


class _Deterministic:
    """The reference's model with every dropout off."""

    def __init__(self, model):
        self._model = model
        self.config = model.config

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self._model.apply(variables, *args, deterministic=True, **kw)


@functools.lru_cache(maxsize=None)
def _data():
    return make_synthetic_splits(SyntheticConfig(
        n_train=8, n_val=40, n_test=8, audio_dim=12, video_dim=16, text_dim=20,
        seed=6))["val"]


def _trainer(dropout):
    model = create_complete_deer_model(DEERModelConfig(**SMALL, dropout=dropout),
                                       seed=2, device="cpu")
    if not dropout:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    return DEERTrainer(model, TrainingConfig(batch_size=16), device="cpu")


def test_dropout_off_matches_reference():
    tr = _trainer(0.0)
    got = tr.predict_mc_dropout(ArrayDataset(_data(), "v"), n_samples=3,
                                batch_size=16)
    ref = JTrainer(JModel(JModelConfig(**SMALL, dropout=0.0)),
                   state_dict_to_flax(tr.model.state_dict()),
                   JConfig(batch_size=16))
    ref.model = _Deterministic(ref.model)
    want = ref.predict_mc_dropout(JDataset(_data(), "v"), n_samples=3,
                                  batch_size=16)
    assert set(got) == set(want) == set(KEYS)
    for key in KEYS:
        assert got[key].shape == (40, 3)
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)


def _host_loop(tr, ds, n_samples, batch_size, seed):
    """One seeded forward of each batch repeated S times; its S samples
    moment-matched in float64, one at a time."""
    outs, masks = {k: [] for k in KEYS}, []
    tr.model.train()
    with torch.no_grad(), forked_rng(tr.device):
        seed_global(tr.device, seed)
        for idx, mask in BatchIterator(ds, batch_size, shuffle=False).epoch_indices(0):
            batch = tr._batch_from_indices(ds, idx)
            out = uncertainty_outputs(tr.model(*(
                batch[k].repeat(n_samples, 1) for k in ("audio", "video", "text"))),
                tr.model.config.dim_names)
            b = len(idx)
            samples = [{k: v[i * b:(i + 1) * b].double().numpy()
                        for k, v in out.items()} for i in range(n_samples)]
            mean = lambda key: np.mean([s[key] for s in samples], axis=0)
            d = np.var([s["mu"] for s in samples], axis=0)
            res = {"mu": mean("mu"), "aleatoric": mean("aleatoric"),
                   "epistemic": mean("epistemic") + d,
                   "calibrated_uncertainty": mean("calibrated_uncertainty") + d}
            res["uncertainty"] = res["aleatoric"] + res["epistemic"]
            for k in KEYS:
                outs[k].append(res[k])
            masks.append(mask.astype(bool))
    tr.model.eval()
    keep = np.concatenate(masks)
    return {k: np.concatenate(v)[keep] for k, v in outs.items()}


@pytest.mark.parametrize("n_samples", [1, 5])
def test_vmapped_samples_match_host_loop(n_samples):
    tr = _trainer(0.3)
    ds = ArrayDataset(_data(), "v")
    got = tr.predict_mc_dropout(ds, n_samples=n_samples, batch_size=16, seed=4)
    want = _host_loop(tr, ds, n_samples, 16, 4)
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    if n_samples == 1:
        # One sample: no disagreement; the outputs are that forward's.
        np.testing.assert_allclose(got["uncertainty"],
                                   got["aleatoric"] + got["epistemic"], rtol=1e-6)
    assert not tr.model.training


def test_seeded_draws_repeat_and_differ():
    tr = _trainer(0.3)
    ds = ArrayDataset(_data(), "v")
    a = tr.predict_mc_dropout(ds, n_samples=4, batch_size=16, seed=1)
    b = tr.predict_mc_dropout(ds, n_samples=4, batch_size=16, seed=1)
    c = tr.predict_mc_dropout(ds, n_samples=4, batch_size=16, seed=2)
    for key in KEYS:
        assert np.array_equal(a[key], b[key]), key
    assert not np.array_equal(a["mu"], c["mu"])
    # Dropout moves the samples apart: the epistemic channel gains their
    # disagreement over the deterministic forward's.
    det = tr.predict(ds, batch_size=16)
    assert float(np.mean(a["epistemic"] - det["epistemic"])) > 0


@pytest.mark.parametrize("n_samples", [0, -3])
def test_bad_n_samples_raise(n_samples):
    with pytest.raises(ValueError, match="n_samples"):
        _trainer(0.3).predict_mc_dropout(ArrayDataset(_data(), "v"),
                                         n_samples=n_samples)
