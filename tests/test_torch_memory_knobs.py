"""The memory knobs of the port's trainers (`TrainingConfig.remat` and
`storage_dtype`) against the JAX package on the CPU.

Every run starts from the port's seeded init at tests/test_trainer.py's
SMALL_MODEL width, carried to the reference by `state_dict_to_flax`, and
takes 3 steps of batch 64 (constant lr 1e-3, no spike control). Where
masks would have to match, dropout is off on both sides (the reference's
trainer then runs through a wrapper that applies its model
deterministically). The reference's four programs are traced once for
the module and compiled together (`_jax`).

Tolerances:
  * remat against plain on the port, dropout on, per step and fused: equal
    in every bit (the recomputation draws the forward's masks);
  * bf16 storage at float32 compute (with accumulation over 2 and the
    EMA) against the JAX trainer with the same knobs: parameters and EMA
    equal in every bit (the float32 forward and backward round to the same
    bf16 gradients; the update copies optax's arithmetic op by op), the
    loss to rtol 1e-5;
  * remat at float32, dropout off, against the JAX trainer's `remat=True`:
    the trainer parity tolerances (loss rtol 1e-5, parameters atol 1e-4);
  * a K = 2 ensemble with remat and bf16 storage against the JAX
    EnsembleTrainer with both: the loss to rtol 1e-5, every parameter
    within one bf16 step (a step of a parameter above 2^-6 exceeds the
    float32 trainers' atol 1e-4), at most 0.1% of them off; remat equal to
    the port's plain step in every bit;
  * bf16 storage under bf16 compute: mean |Δp| at most 0.25 of JAX's own
    bf16-vs-float32 compute gap on the same inputs (the yardstick of
    tests/test_torch_bf16.py), max |Δp| at most that gap's max (see the
    test);
  * fused against per-step, a resumed run against the straight one, and a
    checkpoint's round trip: equal in every bit.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deer.data.pipeline import ArrayDataset as JDataset
from tpu_deer.data.pipeline import BatchIterator as JIterator
from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JModelConfig
from tpu_deer.ops.quantization import quantize_tree as j_quantize_tree
from tpu_deer.serve import InferenceEngine as JEngine
from tpu_deer.train.ensemble import EnsembleTrainer as JEnsembleTrainer
from tpu_deer.train.trainer import DEERTrainer as JTrainer
from tpu_deer.train.trainer import TrainingConfig as JConfig
from tpu_deer_torch.convert import (
    flax_to_state_dict,
    stacked_flax_to_state_dict,
    state_dict_to_flax,
    state_dict_to_stacked_flax,
)
from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.export import export_inference
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    create_complete_deer_model,
)
from tpu_deer_torch.models.layers import dense
from tpu_deer_torch.ops.quantization import quantize_tree
from tpu_deer_torch.serve import InferenceEngine
from tpu_deer_torch.train.checkpoint import CheckpointManager
from tpu_deer_torch.train.ensemble import EnsembleTrainer, create_deer_ensemble
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

torch.set_num_threads(1)

# tests/test_trainer.py's SMALL_MODEL and SMALL_DATA (3 batches of 64).
SMALL = dict(audio_dim=16, video_dim=16, text_dim=16, encoder_dim=32,
             fusion_dim=64, attention_heads=4, encoder_layers=1, dropout=0.1)
DATA = SyntheticConfig(n_train=192, n_val=64, n_test=8, audio_dim=16,
                       video_dim=16, text_dim=16, label_noise=0.02,
                       hard_fraction=0.0)
TCFG = dict(learning_rate=1e-3, batch_size=64, num_epochs=1, warmup_epochs=0,
            scheduler="constant", spike_backoff=False, spike_rollback=False,
            dataset_weights={"synthetic": 1.0}, seed=0)
STEPS = 3
MEAN_FRAC = 0.25
BF16 = torch.bfloat16
BF16_KW = dict(storage_dtype="bfloat16", grad_accum_steps=2, ema_decay=0.9)
# The reference's train runs: name → (compute dtype, ensemble?, fields),
# the slowest compile first.
JAX_RUNS = {
    "ensemble": ("float32", True, dict(remat=True, storage_dtype="bfloat16")),
    "remat": ("float32", False, dict(remat=True)),
    "bf16": ("float32", False, BF16_KW),
    "bf16_compute": ("bfloat16", False, BF16_KW),
}


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
def _splits():
    return make_synthetic_splits(DATA)


@functools.lru_cache(maxsize=None)
def _init():
    """The port's seeded init (a state_dict) and the same as flax params."""
    model = create_complete_deer_model(DEERModelConfig(**SMALL), seed=0,
                                       device="cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    return state, state_dict_to_flax(state)


@functools.lru_cache(maxsize=None)
def _ensemble_init():
    return create_deer_ensemble(DEERModelConfig(**SMALL), 2, seed=7, device="cpu")


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _jax_trainer(compute="float32", ensemble=False, **kw):
    """A reference trainer from the port's init (an EnsembleTrainer from
    `_ensemble_init` where `ensemble`), with dropout off."""
    jm = JModel(JModelConfig(compute_dtype=compute, **SMALL))
    cfg = JConfig(**{**TCFG, **kw})
    if ensemble:
        trainer = JEnsembleTrainer(
            jm, state_dict_to_stacked_flax(_ensemble_init()[1]), cfg,
            steps_per_epoch=STEPS)
    else:
        trainer = JTrainer(jm, _init()[1], cfg, steps_per_epoch=STEPS)
    trainer.model = _Deterministic(jm)
    return trainer


@functools.lru_cache(maxsize=None)
def _jax():
    """The module's reference trainers, {name: trainer} for JAX_RUNS: each
    train step is traced here and compiled on a thread while the next is
    traced (XLA's compile releases the GIL), which fills each jitted
    step's cache."""
    trainers = {name: _jax_trainer(compute, ens, **kw)
                for name, (compute, ens, kw) in JAX_RUNS.items()}
    batch = trainers["bf16"]._batch_from_indices(
        JDataset(_splits()["train"], "synthetic"), np.arange(64))
    one = jnp.asarray(1.0, jnp.float32)
    with ThreadPoolExecutor(len(trainers)) as pool:
        compiled = [pool.submit(t._train_step.lower(t.state, batch, one, one).compile)
                    for t in trainers.values()]
        for c in compiled:
            c.result()
    return trainers


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The reference's 3 steps of run `name`: (float32 params as a
    state_dict, the epoch's mean loss, the EMA or None)."""
    trainer = _jax()[name]
    loss = trainer.train_epoch({"synthetic": JIterator(
        JDataset(_splits()["train"], "synthetic"), 64, shuffle=True,
        drop_last=True, seed=0)}, 0)["loss"]
    to_sd = stacked_flax_to_state_dict if JAX_RUNS[name][1] else flax_to_state_dict
    ema = trainer.ema_params
    return (to_sd(_f32(trainer.state.params)), loss,
            None if ema is None else to_sd(_f32(ema)))


def _port(compute="float32", dropout=False, **kw):
    state, _ = _init()
    model = CompleteDEERModel(DEERModelConfig(compute_dtype=compute, **SMALL))
    model.load_state_dict(state)
    if not dropout:
        _no_dropout(model)
    return DEERTrainer(model, TrainingConfig(**{**TCFG, **kw}),
                       steps_per_epoch=STEPS, device="cpu")


def _iterators():
    return {"synthetic": BatchIterator(ArrayDataset(_splits()["train"], "synthetic"),
                                       64, shuffle=True, drop_last=True, seed=0)}


def _datasets():
    return ({"synthetic": ArrayDataset(_splits()["train"], "synthetic")},
            {"synthetic": ArrayDataset(_splits()["val"], "synthetic")})


def _assert_equal_params(a: dict, b: dict):
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


def _assert_equal_to_ref(ours: dict, ref: dict):
    for name, v in ours.items():
        assert v.dtype == BF16 and torch.equal(v.detach().float(), ref[name]), name


def _assert_within_gap(name, got: dict, ref: dict, ref_f32: dict):
    """|port − JAX bf16| against |JAX bf16 − JAX float32|, over every
    parameter: mean err ≤ MEAN_FRAC · mean gap, max err ≤ max gap."""
    flat = lambda d: np.concatenate([np.asarray(d[k], np.float32).ravel()
                                     for k in sorted(d)])
    got = flat({k: v.detach().float() for k, v in got.items()})
    ref, ref_f32 = flat(ref), flat(ref_f32)
    gap, err = np.abs(ref - ref_f32), np.abs(got - ref)
    assert gap.max() > 0, f"{name}: bf16 and float32 agree"
    assert err.max() <= gap.max(), (
        f"{name}: max err {err.max():.3g} > gap {gap.max():.3g}")
    assert err.mean() <= MEAN_FRAC * gap.mean(), (
        f"{name}: mean err {err.mean():.3g} > {MEAN_FRAC} × gap {gap.mean():.3g}")


# -- remat ---------------------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True], ids=["per_step", "fused"])
def test_remat_equals_plain_with_dropout(fused):
    """The recomputed forward draws the forward's dropout masks: remat's
    steps equal the plain steps in every bit."""
    runs = {}
    for remat in (False, True):
        trainer = _port(dropout=True, remat=remat, fused_epochs=fused)
        runs[remat] = trainer, trainer.train_epoch(_iterators(), 0)
    assert runs[True][1] == runs[False][1]
    _assert_equal_params(runs[True][0].params, runs[False][0].params)


def test_remat_matches_jax_remat():
    """remat, dropout off, 3 steps against the JAX trainer's `remat=True`
    (`jax.checkpoint` of the forward) from one converted init, at the
    trainer parity tolerances."""
    trainer = _port(remat=True)
    got = trainer.train_epoch(_iterators(), 0)
    params, loss, _ = _jax_run("remat")
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    for name, v in trainer.params.items():
        np.testing.assert_allclose(v.detach().numpy(), params[name].numpy(),
                                   atol=1e-4, err_msg=name)


# -- bf16 storage ----------------------------------------------------------------
def test_bf16_storage_dtypes():
    """After tests/test_trainer.py::TestBF16::test_bf16_storage_trains:
    parameters, moments, the EMA and the accumulated gradient in bf16, as
    the reference's leaves are."""
    ref = _jax()["bf16"]
    assert {l.dtype for l in jax.tree_util.tree_leaves(
        (ref.state.params, ref.state.opt_state))
        if jnp.issubdtype(l.dtype, jnp.floating)} == {jnp.dtype(jnp.bfloat16)}
    trainer = _port(**BF16_KW)
    state = trainer.optimizer.state_dict()
    assert {p.dtype for p in trainer.params.values()} == {BF16}
    assert all(p.is_leaf and p.requires_grad for p in trainer.params.values())
    for key in ("mu", "nu", "ema", "acc"):
        assert {v.dtype for v in state[key].values()} == {BF16}, key
    assert np.isfinite(trainer.train_epoch(_iterators(), 0)["loss"])
    assert {p.dtype for p in trainer.params.values()} == {BF16}


def test_bf16_storage_matches_jax_exactly():
    """bf16 storage at float32 compute with accumulation over 2 and the
    EMA, dropout off, 3 micro-steps against the JAX trainer's: the
    parameters and the EMA equal the reference's in every bit (the clip
    fires: the gradient norm at init is above 1)."""
    trainer = _port(**BF16_KW)
    got = trainer.train_epoch(_iterators(), 0)
    params, loss, ema = _jax_run("bf16")
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    assert got["grad_norm"] > trainer.config.gradient_clip
    _assert_equal_to_ref(trainer.params, params)
    _assert_equal_to_ref(trainer.ema_params, ema)


def test_bf16_storage_at_bf16_compute_matches_jax():
    """bf16 storage under bf16 compute against the JAX trainer's, held to
    JAX's own bf16-vs-float32 compute gap at bf16 storage (its "bf16"
    run): mean err at most 0.25 of the mean gap, max err at most the max
    gap. The port's bf16 forward and backward sum in another order than
    XLA's (up to 8% of a gradient entry, as with float32 storage), and a
    bf16 parameter whose update lands near a rounding boundary then moves
    by a whole step on one side only: 1.3% of the parameters differ, the
    max err is 1.0 of the max gap (0.93 of the smaller storage gap), the
    mean err 0.14 of the mean gap. So the max bound is the gap itself,
    not half of it."""
    trainer = _port("bfloat16", **BF16_KW)
    got = trainer.train_epoch(_iterators(), 0)
    params, loss, ema = _jax_run("bf16_compute")
    params_f32, loss_f32, ema_f32 = _jax_run("bf16")
    assert abs(got["loss"] - loss) <= 0.5 * abs(loss - loss_f32)
    _assert_within_gap("params", trainer.params, params, params_f32)
    # One real update: the EMA moved once, from the init, on both sides.
    _assert_equal_to_ref(trainer.ema_params, ema)


@pytest.mark.parametrize("knob", [dict(remat=True),
                                  dict(storage_dtype="bfloat16", ema_decay=0.9)],
                         ids=["remat", "bf16"])
def test_fused_equals_per_step(knob):
    """Dropout on: the fused epoch's steps equal the per-step path's."""
    runs = [_port(dropout=True, fused_epochs=fused, **knob) for fused in (False, True)]
    metrics = [t.train_epoch(_iterators(), 0) for t in runs]
    assert metrics[0]["loss"] == metrics[1]["loss"]
    _assert_equal_params(runs[0].params, runs[1].params)
    _assert_equal_params(runs[0].ema_params or {}, runs[1].ema_params or {})


def test_bf16_checkpoint_resume_and_serving(tmp_path):
    """A bf16 checkpoint round-trips bit for bit; a run resumed from it
    repeats the straight one; `from_checkpoint` serves the stored bf16
    leaves as the reference's engine serves them (flax promotes them in
    each Dense), and `quantize_tree` takes them as the reference's does.
    The reference's export writes bf16 leaves into params.npz as numpy's
    void |V2, which its ExportedEngine cannot load; the port refuses them
    at export."""
    kw = dict(storage_dtype="bfloat16", ema_decay=0.9, num_epochs=2)
    straight = _port(dropout=True, **kw)
    straight.train(*_datasets())
    first = _port(dropout=True, **{**kw, "num_epochs": 1})
    root = str(tmp_path / "ckpt")
    first.train(*_datasets(), checkpoints=CheckpointManager(root))
    saved = CheckpointManager(root).restore()
    for got, want in ((saved["model"], first.params),
                      (saved["optimizer"]["ema"], first.ema_params),
                      (saved["optimizer"]["nu"], first.optimizer.state["nu"])):
        for n, v in want.items():
            assert got[n].dtype == BF16 and torch.equal(got[n], v), n
    resumed = _port(dropout=True, **kw)
    resumed.train(*_datasets(), checkpoints=CheckpointManager(root), resume=True)
    _assert_equal_params(resumed.params, straight.params)

    x = [_splits()["val"][k][:32] for k in ("audio", "video", "text")]
    engine = InferenceEngine.from_checkpoint(root, device="cpu")
    assert {v.dtype for v in engine.model.parameters()} == {BF16}
    served = CheckpointManager(root).restore_params("best")
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16),
        state_dict_to_flax({k: v.float() for k, v in served.items()}))
    want = JEngine(JModel(JModelConfig(**SMALL)), jparams,
                   serving_channel=engine.serving_channel).predict(*x)
    got = engine.predict(*x)
    for key in ("mu", "uncertainty", "calibrated_uncertainty", "epistemic"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    q, scales = quantize_tree(served)
    jq, _ = j_quantize_tree(jparams)
    for n, v in flax_to_state_dict(_f32(jq)).items():
        assert torch.equal(q[n].float(), v), n
    assert {q[n].dtype for n in q if scales[n].numel() == 0} == {BF16}
    int8 = InferenceEngine.from_checkpoint(root, device="cpu", quantize_weights=True)
    assert np.isfinite(int8.predict(*x)["mu"]).all()
    with pytest.raises(ValueError, match="below float32"):
        export_inference(engine.model, str(tmp_path / "exported"),
                         batch_buckets=(32,), platforms=("cpu",))


# -- ensembles -------------------------------------------------------------------
def test_ensemble_knobs_match_jax():
    """A K = 2 EnsembleTrainer with remat and bf16 storage, dropout off, 3
    steps against the reference's EnsembleTrainer with both (its
    `jax.checkpoint` of each member's forward, the per-member clip, no
    accumulation): every parameter within one bf16 step of the
    reference's (at the larger of its magnitude and the learning rate's),
    at most 0.1% of them off it (XLA's batched member products sum in
    another order, and its rematerialized program moves one more: 2 of
    the 109,128 differ); the port's remat equals its plain step in every
    bit."""
    model, stack = _ensemble_init()
    runs = []
    for remat in (True, False):
        ours = EnsembleTrainer(
            _no_dropout(model), stack,
            TrainingConfig(remat=remat, storage_dtype="bfloat16", **TCFG),
            steps_per_epoch=STEPS, device="cpu")
        runs.append((ours, ours.train_epoch(_iterators(), 0)))
    params, loss, _ = _jax_run("ensemble")
    np.testing.assert_allclose(runs[0][1]["loss"], loss, rtol=1e-5)
    off = total = 0
    for name, v in runs[0][0].params.items():
        assert v.dtype == BF16, name
        got, want = v.detach().float(), params[name]
        # One bf16 step (2^-7 of the power of two) at the larger of the
        # two values and the learning rate: a parameter near 0 is a sum
        # of updates of about lr, rounded at their magnitude.
        mag = torch.maximum(got.abs(), want.abs()).clamp_min(TCFG["learning_rate"])
        step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert bool(((got - want).abs() <= step).all()), name
        off, total = off + int((got != want).sum()), total + got.numel()
    assert off <= 1e-3 * total
    assert runs[1][1]["loss"] == runs[0][1]["loss"]
    _assert_equal_params(runs[1][0].params, runs[0][0].params)


# -- dense ------------------------------------------------------------------------
def test_dense_bf16_weights_and_compute_equal_flax():
    """`dense` with bf16 weights under bf16 compute adds the bias to the
    rounded product, as flax's Dense does: equal in every bit."""
    import flax.linen as nn

    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    layer = torch.nn.Linear(16, 32)
    with torch.no_grad():
        layer.bias.normal_(generator=torch.Generator().manual_seed(0))
    layer = layer.to(BF16)
    got = dense(layer, torch.from_numpy(x), BF16)
    params = {"kernel": jnp.asarray(layer.weight.detach().float().T.numpy(),
                                    jnp.bfloat16),
              "bias": jnp.asarray(layer.bias.detach().float().numpy(), jnp.bfloat16)}
    want = nn.Dense(32, dtype=jnp.bfloat16).apply({"params": params},
                                                  jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
