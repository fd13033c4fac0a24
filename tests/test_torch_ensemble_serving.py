"""The port's ensemble serving (`serve.py` with `ensemble=True`), its
export and its member-stacked int8 against the JAX package on the CPU, and
the stacked checkpoint's round trip.

The members start from the port's seeded init at the reference's SMALL
width (`tests/test_ensemble.py`), K = 2-3, carried to the reference by
`convert.state_dict_to_stacked_flax`. Tolerances: outputs rtol 1e-4, atol
1e-5 (float32 forwards in another summation order); int8 trees exactly;
the served checkpoint against the trainer's own predict rtol 1e-6.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JModelConfig
from tpu_deer.ops.quantization import quantize_tree as j_quantize_tree
from tpu_deer.serve import InferenceEngine as JEngine
from tpu_deer_torch import server
from tpu_deer_torch.convert import (
    stacked_flax_quantized_to_state_dict,
    state_dict_to_stacked_flax,
)
from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.export import ExportedEngine, export_inference
from tpu_deer_torch.models.deer_model import DEERModelConfig
from tpu_deer_torch.ops.quantization import dequantize_tree, quantize_tree
from tpu_deer_torch.serve import InferenceEngine
from tpu_deer_torch.train.checkpoint import CheckpointManager
from tpu_deer_torch.train.ensemble import EnsembleTrainer, create_deer_ensemble
from tpu_deer_torch.train.trainer import TrainingConfig

torch.set_num_threads(1)

SMALL = dict(audio_dim=12, video_dim=16, text_dim=20, encoder_dim=24,
             fusion_dim=32, encoder_layers=1, attention_heads=2, dropout=0.0)
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
BUCKETS = (8,)


def _ensemble(k=2, seed=7):
    """(port structure, port stack, reference module, reference stack)."""
    model, stack = create_deer_ensemble(DEERModelConfig(**SMALL), k, seed=seed,
                                        device="cpu")
    return model, stack, JModel(JModelConfig(**SMALL)), state_dict_to_stacked_flax(stack)


def _splits():
    return make_synthetic_splits(SyntheticConfig(
        n_train=32, n_val=24, n_test=8, audio_dim=12, video_dim=16, text_dim=20,
        seed=5))


def _tcfg(**kw):
    return {**dict(learning_rate=1e-3, batch_size=16, num_epochs=2,
                   warmup_epochs=0, scheduler="constant",
                   dataset_weights={"synthetic": 1.0}, seed=0), **kw}


def test_checkpoint_round_trip_and_streaming_refusal(tmp_path):
    model, stack, _, _ = _ensemble(2, seed=4)
    s = _splits()
    val = ArrayDataset(s["val"], "synthetic")
    tr = EnsembleTrainer(model, stack, TrainingConfig(**_tcfg(num_epochs=1)),
                         steps_per_epoch=2, device="cpu")
    tr.train({"synthetic": ArrayDataset(s["train"], "synthetic")},
             {"synthetic": val}, checkpoints=CheckpointManager(str(tmp_path)))
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.metadata("best")["metrics"]["ensemble_members"] == 2
    restored = ckpt.restore_params("best")
    for i in range(2):
        for name, v in tr.member_params(i).items():
            assert torch.equal(restored[name][i], v), name
    engine = InferenceEngine.from_checkpoint(
        str(tmp_path), DEERModelConfig(**SMALL), ensemble_members=2,
        batch_buckets=(32,), device="cpu")
    got = engine.predict(*(val.arrays[k] for k in ("audio", "video", "text")))
    want = tr.predict(val)
    for key in ("mu", "uncertainty", "calibrated_uncertainty"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["expected_abs_error"], want["eabs"],
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="member"):
        InferenceEngine.from_checkpoint(str(tmp_path), DEERModelConfig(**SMALL),
                                        device="cpu")
    with pytest.raises(ValueError, match="single parameter set"):
        server.PredictionService.from_checkpoint(
            str(tmp_path), DEERModelConfig(**SMALL), stream_slots=2,
            ensemble_members=2, device="cpu")


def test_member_stacked_quantize_tree_equals_reference():
    _, stack, _, jstack = _ensemble(3, seed=2)
    q, scales = quantize_tree(stack, member_stacked=True)
    jq, js = j_quantize_tree(jstack, member_stacked=True)
    want_q, want_s = stacked_flax_quantized_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jq), jax.tree_util.tree_map(np.asarray, js))
    assert set(q) == set(want_q) == set(scales) == set(want_s)
    for name in q:
        assert q[name].dtype == want_q[name].dtype, name
        assert torch.equal(q[name], want_q[name]), name
        assert torch.equal(scales[name], want_s[name]), name
    quantized = [k for k, v in scales.items() if v.numel()]
    assert quantized and all(scales[k].shape == (3, q[k].shape[1]) for k in quantized
                             if k.endswith(".weight"))
    deq = dequantize_tree(q, scales)
    for name in quantized:
        err = (deq[name] - stack[name]).abs().max()
        assert err <= scales[name].max() * 0.5 + 1e-7, name


@functools.lru_cache(maxsize=None)
def _reference_engine(quantize):
    _, _, jm, jstack = _ensemble(3, seed=11)
    return JEngine(jm, jstack, batch_buckets=BUCKETS, quantize_weights=quantize,
                   ensemble=True)


def _inputs(n=11):
    rng = np.random.default_rng(0)
    return [rng.normal(size=(n, d)).astype(np.float32) for d in (12, 16, 20)]


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_ensemble_engine_matches_reference_engine(quantize, tmp_path):
    """The engine in float and int8 against the reference's engine; the int8
    ensemble also exported (stacked int8 kernels and [K, out] scales in the
    artifact) and served by ExportedEngine."""
    model, stack, _, _ = _ensemble(3, seed=11)
    x = _inputs()
    want = _reference_engine(quantize).predict(*x)
    engine = InferenceEngine(model, batch_buckets=BUCKETS, ensemble=True,
                             params=stack, quantize_weights=quantize, device="cpu")
    got = engine.predict(*x)
    for key in ("mu", "uncertainty", "calibrated_uncertainty", "aleatoric",
                "epistemic", "expected_abs_error", "attention_weights"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   err_msg=key, **OUT_TOL)
    if not quantize:
        return
    manifest = export_inference(model, str(tmp_path), batch_buckets=BUCKETS,
                                platforms=("cpu",), quantize=True,
                                ensemble=True, params=stack)
    assert manifest["ensemble_members"] == 3 and manifest["quantized"]
    exported = ExportedEngine(str(tmp_path), device="cpu").predict(*x)
    for key in ("mu", "uncertainty", "calibrated_uncertainty",
                "expected_abs_error"):
        np.testing.assert_allclose(exported[key], np.asarray(want[key]),
                                   err_msg=key, **OUT_TOL)
