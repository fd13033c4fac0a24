"""The port's stacked layout (`models/stacked.py`, `stacked_compute=True`)
against the JAX package on the CPU: `stack_params` against the reference's,
the stacked forward against the default one on the same weights, and two
dropout-off train steps of the stacked MoE flagship against the
reference's DEERTrainer (one reference compile covers the stacked encoders
and heads and the MoE experts).

Narrow width (encoder 16, fusion 32, one layer, 4 heads); the port's seeded
init carried to flax by tpu_deer_torch.convert. Outputs rtol 1e-4, atol
1e-5; train losses rtol 1e-5, parameters atol 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_deer.data.pipeline import ArrayDataset as JDataset
from tpu_deer.data.pipeline import BatchIterator as JIterator
from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JModelConfig
from tpu_deer.models.stacked import stack_params as jstack_params
from tpu_deer.train.trainer import DEERTrainer as JTrainer
from tpu_deer.train.trainer import TrainingConfig as JConfig
from tpu_deer_torch.convert import flax_to_state_dict, state_dict_to_flax
from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    create_complete_deer_model,
)
from tpu_deer_torch.models.stacked import stack_params
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

torch.set_num_threads(1)

NARROW = dict(encoder_dim=16, fusion_dim=32, encoder_layers=1,
              attention_heads=4)
TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(rng, b=6):
    return tuple(torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
                 for d in (84, 256, 768))


def test_stack_params_matches_jax():
    """A relabel and a stack only: the port's stack_params of a state_dict
    equals the reference's stack_params of the same weights, converted."""
    model = create_complete_deer_model(DEERModelConfig(**NARROW), seed=2,
                                       device="cpu")
    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jstack_params(state_dict_to_flax(model.state_dict()))))
    got = stack_params(model.state_dict())
    assert set(got) == set(want)
    for key, w in want.items():
        assert torch.equal(got[key], w), key
    assert got["stacked_heads.evidence_network.layers.0.weight"].shape == (3, 16, 32)


@pytest.mark.parametrize("fusion_type", ["hierarchical", "moe"])
def test_stacked_forward_equals_default(fusion_type, rng):
    """The default model and the stacked one on stack_params of its weights
    give the same outputs, in eval mode and with dropout drawn per member
    (the masks differ, so only eval is compared exactly)."""
    cfg = dict(NARROW, fusion_type=fusion_type)
    default = create_complete_deer_model(DEERModelConfig(**cfg), seed=4,
                                         device="cpu")
    stacked = CompleteDEERModel(DEERModelConfig(**cfg, stacked_compute=True))
    stacked.load_state_dict(stack_params(default.state_dict()), strict=True)
    stacked.eval()
    x = _inputs(rng)
    with torch.no_grad():
        a, b = default(*x), stacked(*x)
    assert set(a) == set(b)
    for key in ("mu_all", "uncertainty_all", "calibrated_uncertainty",
                "fused_features", "valence_alpha", "dominance_epistemic_uncertainty"):
        np.testing.assert_allclose(b[key].numpy(), a[key].numpy(), err_msg=key,
                                   **TOL)
    stacked.train()
    torch.manual_seed(0)
    out = stacked(*x)
    out["mu_all"].sum().backward()
    grad = stacked.stacked_encoders.trunk.blocks[0].dense.weight.grad
    assert grad.shape == (3, 16, 16) and torch.all(grad.abs().sum((1, 2)) > 0)


class _Deterministic:
    """The reference's model with every dropout off, train step included."""

    def __init__(self, model):
        self._model = model
        self.config = model.config

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self._model.apply(variables, *args, deterministic=True, **kw)


def test_two_train_steps_match_jax_stacked_moe():
    """Two dropout-off steps (batch 16, lr 1e-3) of the stacked layout with
    MoE fusion, from the same weights: losses and every parameter."""
    cfg = dict(NARROW, stacked_compute=True, fusion_type="moe", moe_experts=3)
    model = create_complete_deer_model(DEERModelConfig(**cfg), seed=3,
                                       device="cpu")
    params = state_dict_to_flax(model.state_dict())
    jm = JModel(JModelConfig(**cfg))
    train = make_synthetic_splits(SyntheticConfig(n_train=32, n_val=8,
                                                  n_test=8, seed=5))["train"]
    tcfg = dict(learning_rate=1e-3, batch_size=16, num_epochs=1,
                warmup_epochs=0, scheduler="constant", seed=0,
                dataset_weights={"synthetic": 1.0})
    ref = JTrainer(jm, params, JConfig(**tcfg), steps_per_epoch=2)
    ref.model = _Deterministic(jm)
    want = ref.train_epoch({"synthetic": JIterator(
        JDataset(train, "synthetic"), 16, shuffle=True, drop_last=True,
        seed=0)}, 0)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    ours = DEERTrainer(model.train(), TrainingConfig(**tcfg), steps_per_epoch=2,
                       device="cpu")
    got = ours.train_epoch({"synthetic": BatchIterator(
        ArrayDataset(train, "synthetic"), 16, shuffle=True, drop_last=True,
        seed=0)}, 0)
    assert ours.step == 2
    for key in ("loss", "mse", "calibration_alignment"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    after = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                      ref.state.params))
    assert set(after) == set(ours.model.state_dict())
    for name, v in ours.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), after[name].numpy(), atol=1e-4,
                                   rtol=0, err_msg=name)
