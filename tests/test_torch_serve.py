"""The slice as a whole on the CPU: media → features → InferenceEngine.predict,
port against reference with the reference's weights (tpu_deer_torch.convert).

Tolerances: audio features rtol 1e-4, atol 1e-5 (float32 front-end sums in
another order; the vector is unit-variance, so atol covers entries near 0);
video and text features are the same numpy code on both sides and must be
equal; predictions rtol 1e-4, atol 1e-5 (float32 GEMM order and flax's
LayerNorm variance formula, as in test_torch_model.py).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from _jax_reference import create_complete_deer_model as jax_create
from tpu_deer.data.features import MultimodalFeatureExtractor as JExtractor
from tpu_deer.serve import InferenceEngine as JEngine
from tpu_deer_torch.convert import flax_to_state_dict
from tpu_deer_torch.data.features import (
    AudioFeatureExtractor,
    MultimodalFeatureExtractor,
    TextFeatureExtractor,
)
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    create_complete_deer_model,
)
from tpu_deer_torch.serve import InferenceEngine, bucketed_predict
from tpu_deer_torch.server import StreamingSessionService
from tpu_deer_torch.stream import StreamingRecognizer

torch.set_num_threads(1)

TEXTS = ["I am so happy to see you", "this is terrible, leave me alone",
         "well, I suppose it's fine"]


@functools.lru_cache(maxsize=None)
def _engines():
    """(reference engine, port engine) on the same flagship weights."""
    jmodel, params = jax_create(seed=0)
    jengine = JEngine(jmodel, params)
    model = CompleteDEERModel()
    model.load_state_dict(
        flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jengine, InferenceEngine(model, device="cpu")


def _assert_predictions_match(ref, got, n):
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape and len(got[key]) == n, key
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def _media(rng):
    sr = 16000
    signals = []
    for dur, f0 in ((0.7, 140.0), (1.6, 210.0), (2.5, 260.0)):  # 2 s, 4 s buckets
        t = np.arange(int(dur * sr)) / sr
        s = sum(np.sin(2 * np.pi * h * f0 * t) / h for h in (1, 2, 3))
        signals.append((0.3 * s + 0.02 * rng.normal(size=t.size)).astype(np.float32))
    frames = [rng.uniform(size=(8, 64, 64)).astype(np.float32) for _ in range(3)]
    return signals, frames


def test_slice_matches_jax(rng, monkeypatch):
    monkeypatch.delenv("TPU_DEER_BERT_DIR", raising=False)
    monkeypatch.delenv("TPU_DEER_TEXT_ENCODER_DIR", raising=False)
    signals, frames = _media(rng)
    jx, port = JExtractor(), MultimodalFeatureExtractor(device="cpu")
    feats = {}
    for name, ext in (("ref", jx), ("port", port)):
        feats[name] = (
            ext.audio.extract_batch(signals),
            np.stack([ext.video.extract_from_frames(f) for f in frames]),
            ext.text.extract_batch(TEXTS),
        )
    np.testing.assert_allclose(feats["port"][0], feats["ref"][0],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(feats["port"][1], feats["ref"][1])
    np.testing.assert_array_equal(feats["port"][2], feats["ref"][2])
    jengine, engine = _engines()
    _assert_predictions_match(jengine.predict(*feats["ref"]),
                              engine.predict(*feats["port"]), n=3)


@pytest.mark.parametrize("n", [1, 9, 300])
def test_request_sizes_match_jax(n, rng):
    """1 fills a bucket, 9 pads to 64, 300 chunks into 256 + 44 (→ 64)."""
    feats = tuple(rng.normal(size=(n, d)).astype(np.float32)
                  for d in (84, 256, 768))
    jengine, engine = _engines()
    _assert_predictions_match(jengine.predict(*feats), engine.predict(*feats), n)


def test_bucketed_predict_pads_and_chunks():
    seen = []

    def fake(a, v, t):
        seen.append(len(a))
        return {"x": a[:, :1]}

    a = np.arange(300, dtype=np.float32)[:, None]
    out = bucketed_predict(fake, (1, 8, 64, 256), a, a, a)
    assert seen == [256, 64]
    np.testing.assert_array_equal(out["x"], a)


def test_outputs_are_sane():
    engine = InferenceEngine(create_complete_deer_model(seed=1, device="cpu"),
                             device="cpu")
    rng = np.random.default_rng(0)
    out = engine.predict(*(rng.normal(size=(5, d)).astype(np.float32)
                           for d in (84, 256, 768)))
    np.testing.assert_allclose(out["attention_weights"].sum(-1), 1.0, rtol=1e-6)
    assert (out["expected_abs_error"] > 0).all()
    assert all(np.isfinite(v).all() for v in out.values())


@pytest.mark.parametrize("entry", ["create_complete_deer_model",
                                   "AudioFeatureExtractor",
                                   "MultimodalFeatureExtractor",
                                   "InferenceEngine",
                                   "StreamingRecognizer",
                                   "StreamingSessionService"])
def test_entry_points_default_to_cuda(entry):
    """Without device= the port runs on the card, and on a host without one
    it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    call = {
        "create_complete_deer_model": lambda: create_complete_deer_model(seed=0),
        "AudioFeatureExtractor": AudioFeatureExtractor,
        "MultimodalFeatureExtractor": MultimodalFeatureExtractor,
        "InferenceEngine": lambda: InferenceEngine(CompleteDEERModel()),
        "StreamingRecognizer": lambda: StreamingRecognizer(CompleteDEERModel()),
        "StreamingSessionService": lambda: StreamingSessionService(
            CompleteDEERModel(), start=False),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("kw", [dict(quantize_weights=True, ensemble=True),
                                dict(ensemble=True)])
def test_unported_serving_options_raise(kw):
    # Ensembles are served; without stacked members they raise.
    with pytest.raises(ValueError, match="stacked member params"):
        InferenceEngine(CompleteDEERModel(), device="cpu", **kw)


def test_unported_text_backends_raise(monkeypatch):
    # BERT is not ported and raises; the MLM-encoder backend is ported, and a
    # directory that does not exist leaves the hashed backend, as in the
    # reference.
    with pytest.raises(NotImplementedError):
        TextFeatureExtractor(bert_dir="/nonexistent")
    monkeypatch.setenv("TPU_DEER_TEXT_ENCODER_DIR", "/nonexistent/encoder")
    assert TextFeatureExtractor().backend == "hashed"
    monkeypatch.setenv("TPU_DEER_BERT_DIR", "/nonexistent/bert")
    with pytest.raises(NotImplementedError):
        TextFeatureExtractor()


def test_warmup_and_graphs_on_the_cpu(rng):
    """On the CPU the engines stay eager: warmup() runs each bucket once and
    captures nothing, and the recognizer's warmup() leaves every stream's
    state as it was."""
    model = create_complete_deer_model(seed=1, device="cpu")
    engine = InferenceEngine(model, batch_buckets=(1, 8), device="cpu")
    assert not engine.graphs
    feats = [rng.normal(size=(3, d)).astype(np.float32) for d in (84, 256, 768)]
    before = engine.predict(*feats)
    engine.warmup()
    assert engine.bucket_graphs.capture_s == {}
    after = engine.predict(*feats)
    for key in before:
        np.testing.assert_array_equal(after[key], before[key], err_msg=key)
    rec = StreamingRecognizer(model, n_streams=2, device="cpu")
    assert not rec.graphs
    rec.push(rng.normal(size=(2, 4096)).astype(np.float32))
    state = [f.clone() for f in rec.state]
    rec.warmup()
    assert rec.capture_s is None
    for got, ref in zip(rec.state, state):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_stream_state_is_written_in_place(rng):
    """A tick and a reset write the recognizer's state buffers in place (a
    CUDA graph of the tick reads and writes those addresses)."""
    rec = StreamingRecognizer(create_complete_deer_model(seed=1, device="cpu"),
                              n_streams=3, device="cpu")
    fields = list(rec.state)
    chunks = rng.normal(size=(3, 4096)).astype(np.float32)
    rec.push(chunks)
    rec.push(chunks, active=np.array([True, False, True]))
    assert all(a is b for a, b in zip(rec.state, fields))
    assert float(rec.state.n_frames[1]) == 16.0  # idle on the second tick
    rec.reset_streams([0])
    assert all(a is b for a, b in zip(rec.state, fields))
    assert all(not f[0].any() for f in rec.state)
    assert float(rec.state.n_frames[2]) == 32.0
