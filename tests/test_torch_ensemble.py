"""The port's deep ensembles (`train/ensemble.py`) against the JAX package
and against K single-model trainers on the CPU (serving, export and int8:
`tests/test_torch_ensemble_serving.py`).

The members start from the port's seeded init, carried to the reference by
`convert.state_dict_to_stacked_flax`, at a narrow width (the reference's
own ensemble tests' SMALL config) with K = 2-3. The reference's model has a
fixed attention dropout of 0.1 besides `model.dropout`; where masks would
have to match, its trainer runs through a wrapper that applies the model
deterministically and every port Dropout has p = 0.

Tolerances: combined outputs rtol 1e-4, atol 1e-5 (float32 forwards in
another summation order); train losses rtol 1e-5 and parameters atol 1e-4
(as `tests/test_torch_trainer.py`); the ensemble against K single-model
trainers at the reference's own rtol 2e-5, atol 2e-6
(`tests/test_ensemble.py`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deer.data.pipeline import ArrayDataset as JDataset
from tpu_deer.data.pipeline import BatchIterator as JIterator
from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JModelConfig
from tpu_deer.train.ensemble import EnsembleTrainer as JEnsembleTrainer
from tpu_deer.train.trainer import TrainingConfig as JConfig
from tpu_deer_torch import server
from tpu_deer_torch.convert import (
    stacked_flax_to_state_dict,
    state_dict_to_stacked_flax,
)
from tpu_deer_torch.core.nig import combine_members
from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    member_forward,
)
from tpu_deer_torch.serve import InferenceEngine
from tpu_deer_torch.train.ensemble import EnsembleTrainer, create_deer_ensemble
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

torch.set_num_threads(1)

SMALL = dict(audio_dim=12, video_dim=16, text_dim=20, encoder_dim=24,
             fusion_dim=32, encoder_layers=1, attention_heads=2, dropout=0.0)
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
MEMBER_TOL = dict(rtol=2e-5, atol=2e-6)


class _Deterministic:
    """The reference's model with every dropout off, train step included."""

    def __init__(self, model):
        self._model = model
        self.config = model.config

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self._model.apply(variables, *args, deterministic=True, **kw)


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


@functools.lru_cache(maxsize=None)
def _splits(n_train=32, n_val=24, seed=5):
    return make_synthetic_splits(SyntheticConfig(
        n_train=n_train, n_val=n_val, n_test=8, audio_dim=12, video_dim=16,
        text_dim=20, seed=seed))


def _ensemble(k=2, seed=7, **cfg):
    """(port structure, port stack, reference module, reference stack)."""
    model, stack = create_deer_ensemble(DEERModelConfig(**{**SMALL, **cfg}), k,
                                        seed=seed, device="cpu")
    return (model, stack, JModel(JModelConfig(**{**SMALL, **cfg})),
            state_dict_to_stacked_flax(stack))


def _tcfg(**kw):
    base = dict(learning_rate=1e-3, batch_size=16, num_epochs=2,
                warmup_epochs=0, scheduler="constant", spike_backoff=False,
                spike_rollback=False, dataset_weights={"synthetic": 1.0},
                early_stopping_patience=10**9, seed=0)
    return {**base, **kw}


def test_stacked_converters_round_trip():
    _, stack, _, flax_stack = _ensemble(3)
    back = stacked_flax_to_state_dict(flax_stack)
    assert set(back) == set(stack)
    for name, v in stack.items():
        assert torch.equal(back[name], v), name
    # Members differ by their init seeds.
    w = stack["fusion.fusion_gate.weight"]
    assert not torch.equal(w[0], w[1]) and w.shape[0] == 3


def test_combined_outputs_match_reference_eval_step():
    model, stack, jm, jstack = _ensemble(3, seed=1)
    val = _splits()["val"]
    ours = EnsembleTrainer(model, stack, TrainingConfig(**_tcfg()),
                           steps_per_epoch=2, device="cpu")
    got = ours._eval_step({k: torch.from_numpy(v) for k, v in val.items()})
    ref = JEnsembleTrainer(jm, jstack, JConfig(**_tcfg()), steps_per_epoch=2)
    want = jax.jit(ref._eval_step_impl)(
        jstack, {k: jnp.asarray(v) for k, v in val.items()})
    for key in ("mu", "uncertainty", "calibrated_uncertainty", "aleatoric",
                "epistemic", "eabs", "loss"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   err_msg=key, **OUT_TOL)


def test_two_train_steps_match_reference_ensemble_trainer():
    model, stack, jm, jstack = _ensemble(2, seed=3)
    train = _splits()["train"]
    ref = JEnsembleTrainer(jm, jstack, JConfig(**_tcfg()), steps_per_epoch=2)
    ref.model = _Deterministic(jm)
    want = ref.train_epoch({"synthetic": JIterator(
        JDataset(train, "synthetic"), 16, shuffle=True, drop_last=True,
        seed=0)}, 0)
    ours = EnsembleTrainer(_no_dropout(model), stack, TrainingConfig(**_tcfg()),
                           steps_per_epoch=2, device="cpu")
    got = ours.train_epoch({"synthetic": BatchIterator(
        ArrayDataset(train, "synthetic"), 16, shuffle=True, drop_last=True,
        seed=0)}, 0)
    assert ours.step == 2
    for key in ("loss", "mse", "calibration_alignment", "mean_uncertainty"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    params = stacked_flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, ref.state.params))
    for name, v in ours.params.items():
        np.testing.assert_allclose(v.detach().numpy(), params[name].numpy(),
                                   atol=1e-4, err_msg=name)


def _single_runs(model_cfg, stack, tcfg, data, k):
    out = []
    for i in range(k):
        single = CompleteDEERModel(model_cfg)
        single.load_state_dict({n: v[i] for n, v in stack.items()})
        tr = DEERTrainer(_no_dropout(single), tcfg, steps_per_epoch=2,
                         device="cpu")
        tr.train(*data)
        out.append(tr.model.state_dict())
    return out


@pytest.mark.parametrize("clip", [1e3, 0.05], ids=["clip_idle", "clip_fires"])
def test_ensemble_equals_independent_single_trainers(clip):
    """K members train as K independent DEERTrainer runs, with the global
    clip taken per member (1e3: it never fires; 0.05: on every step)."""
    model, stack, _, _ = _ensemble(2, seed=7)
    s = _splits()
    data = ({"synthetic": ArrayDataset(s["train"], "synthetic")},
            {"synthetic": ArrayDataset(s["val"], "synthetic")})
    tcfg = TrainingConfig(**_tcfg(gradient_clip=clip, scheduler="cosine"))
    ens = EnsembleTrainer(_no_dropout(model), stack, tcfg, steps_per_epoch=2,
                          device="cpu")
    norms = []
    clip_fn = ens.optimizer.clip

    def recording(grads):
        norms.append(torch.stack([torch.linalg.vector_norm(torch.cat(
            [g[i].flatten() for g in grads])) for i in range(2)]))
        return clip_fn(grads)

    ens.optimizer.clip = recording
    ens.train(*data)
    assert len(norms) == 4
    fired = all(bool((n > clip).all()) for n in norms)
    assert fired == (clip < 1.0)
    assert fired or all(bool((n < clip).all()) for n in norms)
    singles = _single_runs(model.config, stack, tcfg, data, 2)
    for i, want in enumerate(singles):
        got = ens.member_params(i)
        for name, v in want.items():
            np.testing.assert_allclose(got[name].numpy(), v.numpy(),
                                       err_msg=f"member {i} {name}", **MEMBER_TOL)


def test_fused_epochs_equal_per_step_with_dropout():
    model, stack, _, _ = _ensemble(2, seed=9, dropout=0.3)
    train = ArrayDataset(_splits()["train"], "synthetic")
    out = {}
    for fused in (True, False):
        tr = EnsembleTrainer(model, stack, TrainingConfig(**_tcfg(
            fused_epochs=fused)), steps_per_epoch=2, device="cpu")
        it = {"synthetic": BatchIterator(train, 16, shuffle=True,
                                         drop_last=True, seed=0)}
        losses = [tr.train_epoch(it, e)["loss"] for e in range(2)]
        out[fused] = (losses, tr.params)
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for name, v in out[True][1].items():
        np.testing.assert_allclose(v.detach().numpy(),
                                   out[False][1][name].detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_refusals():
    model, stack, _, _ = _ensemble(2)
    with pytest.raises(ValueError, match="n_members"):
        create_deer_ensemble(DEERModelConfig(**SMALL), 0, device="cpu")
    single = CompleteDEERModel(DEERModelConfig(**SMALL))
    with pytest.raises(ValueError, match="leading member axis"):
        EnsembleTrainer(model, dict(single.named_parameters()),
                        TrainingConfig(**_tcfg()), device="cpu")
    tr = EnsembleTrainer(model, stack, TrainingConfig(**_tcfg()), device="cpu")
    ds = ArrayDataset(_splits()["val"], "synthetic")
    with pytest.raises(NotImplementedError, match="return_nig"):
        tr.predict(ds, return_nig=True)
    with pytest.raises(NotImplementedError, match="return_fused"):
        tr.predict(ds, return_fused=True)
    with pytest.raises(NotImplementedError, match="MC dropout"):
        tr.predict_mc_dropout(ds, n_samples=2)
    with pytest.raises(IndexError):
        tr.member_params(2)
    with pytest.raises(ValueError, match="stacked member params"):
        InferenceEngine(model, ensemble=True, device="cpu")
    parser = server.build_arg_parser
    for argv in (["--exported", "x", "--ensemble", "2"],
                 ["--checkpoint", "x", "--ensemble", "2", "--stream_slots", "4"]):
        with pytest.raises(SystemExit):
            server.main(argv)
    assert parser().parse_args(["--checkpoint", "x", "--ensemble", "3"]).ensemble == 3


def test_bf16_vmapped_forward_and_gradient_through_logistic():
    """The bf16 sigmoid (`_Logistic`) under vmap: the vmapped members equal
    each member's own forward, and gradients stay finite where the op by
    op expansion's would be NaN (x below -88.7)."""
    model, stack, _, _ = _ensemble(2, seed=5, compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    x = [torch.from_numpy(rng.normal(size=(4, d)).astype(np.float32))
         for d in (12, 16, 20)]
    x[0][0] = -1e4  # drives pre-sigmoid values far below -88.7
    out = member_forward(model, stack, *x, lambda o: o["attention_weights"])
    for i in range(2):
        single = CompleteDEERModel(model.config)
        single.load_state_dict({n: v[i] for n, v in stack.items()})
        ref = single.eval()(*x)["attention_weights"].detach()
        np.testing.assert_allclose(out[i].float().numpy(), ref.float().numpy(),
                                   atol=8e-3)
    params = {k: v.clone().requires_grad_(True) for k, v in stack.items()}
    mu = member_forward(model, params, *x, lambda o: o["mu_all"])
    grads = torch.autograd.grad(mu.sum(), list(params.values()), allow_unused=True)
    assert all(g is None or bool(torch.isfinite(g).all()) for g in grads)
    combined = combine_members(member_forward(
        model, stack, *x, lambda o: {"mu": o["mu_all"],
                                     "aleatoric": o["uncertainty_all"],
                                     "epistemic": o["uncertainty_all"]}))
    assert combined["mu"].shape == (4, 3)
