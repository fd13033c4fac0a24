"""The port's HTTP serving layer (tpu_deer_torch.server) and InferenceEngine's
OOD hook against the JAX reference on the CPU, on the same weights
(tpu_deer_torch.convert) and the same detector.

JSON responses and engine outputs rtol 1e-4, atol 1e-5 (float32 model
outputs, as tests/test_torch_model.py; ood_score is a sum of squares over
~100 whitened features, so it gets rtol 1e-4 alone); booleans and the
response keys must be equal.
"""

import base64
import functools
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from _jax_reference import create_complete_deer_model as jax_create
from tpu_deer import server as jserver
from tpu_deer import stream as jstream
from tpu_deer.eval import ood as jood
from tpu_deer.models.deer_model import DEERModelConfig as JConfig
from tpu_deer.ops.audio_frontend import AudioFrontendConfig as JFrontend
from tpu_deer.serve import InferenceEngine as JEngine
from tpu_deer_torch import server as tserver
from tpu_deer_torch import stream as tstream
from tpu_deer_torch.convert import flax_to_state_dict
from tpu_deer_torch.eval import ood as tood
from tpu_deer_torch.models.deer_model import CompleteDEERModel, DEERModelConfig
from tpu_deer_torch.ops.audio_frontend import AudioFrontendConfig
from tpu_deer_torch.serve import InferenceEngine

torch.set_num_threads(1)

NARROW = dict(audio_dim=84, video_dim=8, text_dim=8, encoder_dim=16,
              fusion_dim=32, attention_heads=2, encoder_layers=1)
DIMS = (84, 8, 8)
JSC = jstream.StreamingConfig(frontend=JFrontend(n_fft=512, hop_length=128),
                              chunk_samples=2048)
TSC = tstream.StreamingConfig(
    frontend=AudioFrontendConfig(n_fft=512, hop_length=128),
    chunk_samples=2048)
CONFORMAL = {"alpha": 0.1, "normalized": True,
             "quantiles": np.array([1.0, 2.0, 3.0])}


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX model, its params, the port's model with the same weights)."""
    jmodel, params = jax_create(JConfig(**NARROW), seed=0)
    params = jax.tree_util.tree_map(np.asarray, params)
    model = CompleteDEERModel(DEERModelConfig(**NARROW))
    model.load_state_dict(flax_to_state_dict(params))
    return jmodel, params, model.eval()


def _detectors(space, seed=3):
    """The reference's and the port's detector, fitted on the same rows."""
    rng = np.random.default_rng(seed)
    if space == "input_norm":
        fit = [rng.normal(size=(128, d)).astype(np.float32) for d in DIMS]
        return (jood.MahalanobisOOD().fit_modalities(*fit),
                tood.MahalanobisOOD().fit_modalities(*fit))
    fit = rng.normal(size=(128, NARROW["fusion_dim"])).astype(np.float32)
    return jood.MahalanobisOOD().fit(fit), tood.MahalanobisOOD().fit(fit)


def _assert_same(got, ref, msg=""):
    """Same keys; numbers within rtol 1e-4, atol 1e-5; the rest equal."""
    assert set(got) == set(ref), msg
    for key, r in ref.items():
        if key == "ood_score":
            np.testing.assert_allclose(got[key], r, rtol=1e-4, err_msg=msg)
        elif isinstance(r, (str, bool)) or np.asarray(r).dtype == bool:
            assert np.array_equal(got[key], r), (msg, key)
        else:
            np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                       np.asarray(r, np.float64), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{msg} {key}")


def _feats(rng, n):
    return [rng.normal(size=(n, d)).astype(np.float32) for d in DIMS]


# ---------------------------------------------------------------------------
# InferenceEngine with an OOD detector
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("space", ["input_norm", "fused"])
def test_engine_ood_matches_jax(space, rng):
    jmodel, params, model = _models()
    jdet, tdet = _detectors(space)
    feats = _feats(rng, 3)
    ref = JEngine(jmodel, params, batch_buckets=(4,), ood_detector=jdet,
                  ood_fpr=0.2).predict(*feats)
    engine = InferenceEngine(model, batch_buckets=(4,), ood_detector=tdet,
                             ood_fpr=0.2, device="cpu")
    got = engine.predict(*feats)
    assert got["is_ood"].dtype == bool and got["ood_score"].shape == (3,)
    _assert_same(got, ref)


# ---------------------------------------------------------------------------
# PredictionService and StreamingSessionService against the JAX services
# ---------------------------------------------------------------------------
def test_predict_json_matches_jax(rng):
    jmodel, params, model = _models()
    jdet, tdet = _detectors("input_norm")
    jsvc = jserver.PredictionService(
        JEngine(jmodel, params, batch_buckets=(1, 4), ood_detector=jdet),
        DIMS, conformal=CONFORMAL)
    svc = tserver.PredictionService(
        InferenceEngine(model, batch_buckets=(1, 4), ood_detector=tdet,
                        device="cpu"), DIMS, conformal=CONFORMAL)
    for n in (1, 3):
        payload = {k: v.tolist() for k, v in
                   zip(("audio", "video", "text"), _feats(rng, n))}
        got, ref = svc.predict_json(payload), jsvc.predict_json(payload)
        _assert_same(got, ref, f"n={n}")
        assert got["deployable_uncertainty"] == got["expected_abs_error"]
    assert svc.requests_served == 2


def test_stream_push_matches_jax(rng):
    """Two sessions, three pushes each (one with a context refresh), on
    services with an OOD detector: every response equals the reference's."""
    jmodel, params, model = _models()
    jdet, tdet = _detectors("input_norm")
    jsvc = jserver.StreamingSessionService(
        jmodel, params, n_streams=2, stream_cfg=JSC, max_wait_ms=1.0,
        ood_detector=jdet, ood_fpr=0.1)
    svc = tserver.StreamingSessionService(
        model, n_streams=2, stream_cfg=TSC, max_wait_ms=1.0,
        ood_detector=tdet, ood_fpr=0.1, device="cpu")
    try:
        video = rng.normal(size=8).astype(np.float32)
        sids = [(s.start(video=video), s.start()) for s in (jsvc, svc)]
        for tick in range(3):
            ctx = dict(text=np.full(8, 0.5, np.float32)) if tick == 1 else {}
            for i in range(2):
                chunk = rng.normal(size=2048).astype(np.float32)
                ref = jsvc.push(sids[0][i], chunk, **ctx)
                got = svc.push(sids[1][i], chunk, **ctx)
                assert isinstance(got["is_ood"], bool)
                _assert_same(got, ref, f"tick {tick} session {i}")
        for s, pair in zip((jsvc, svc), sids):
            for sid in pair:
                s.end(sid)
        assert not svc.sessions and svc.ticks == jsvc.ticks == 6
    finally:
        jsvc.close()
        svc.close()


# ---------------------------------------------------------------------------
# Over HTTP
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def stream_server():
    _, _, model = _models()
    streaming = tserver.StreamingSessionService(
        model, n_streams=2, stream_cfg=TSC, max_wait_ms=5.0, device="cpu")
    service = tserver.PredictionService(
        InferenceEngine(model, batch_buckets=(1,), device="cpu"), DIMS,
        streaming=streaming)
    server = tserver.serve(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", service
    server.shutdown()
    server.server_close()
    streaming.close()
    thread.join(timeout=10)


def _post(url, path, payload):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _health(url):
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        return json.loads(r.read())


def test_session_lifecycle_over_http(stream_server, rng):
    url, service = stream_server
    sid = _post(url, "/stream/start", {"video": [0.0] * 8})["session_id"]
    chunk = rng.normal(size=2048).astype(np.float32)
    out = _post(url, "/stream/push", {"session_id": sid,
                                      "audio": chunk.tolist()})
    assert np.asarray(out["mu"]).shape == (3,)
    assert np.all(np.isfinite(out["mu"]))
    assert out["serving_channel"] == "eabs"
    assert out["deployable_uncertainty"] == out["expected_abs_error"]
    pcm = (np.clip(chunk, -1, 1) * 32767).astype("<i2").tobytes()
    out2 = _post(url, "/stream/push", {
        "session_id": sid, "pcm16_b64": base64.b64encode(pcm).decode()})
    assert np.asarray(out2["mu"]).shape == (3,)
    health = _health(url)
    assert health["stream_sessions"] == 1 and health["stream_ticks"] >= 2
    assert health["stream_slots"] == 2
    assert _post(url, "/stream/end", {"session_id": sid})["ended"]
    assert _health(url)["stream_sessions"] == 0


def test_slot_exhaustion_and_bad_requests(stream_server):
    url, _ = stream_server
    sids = [_post(url, "/stream/start", {})["session_id"] for _ in range(2)]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, "/stream/start", {})
    assert e.value.code == 400
    assert "no free stream slots" in json.loads(e.value.read())["error"]
    for sid in sids:
        _post(url, "/stream/end", {"session_id": sid})
    for path, payload, msg in [
        ("/stream/push", {"session_id": "nope", "audio": [0.0] * 2048},
         "unknown session"),
        ("/stream/push", {"audio": [0.0] * 2048}, "session_id"),
        ("/predict", {"audio": [0.0] * 84, "video": [0.0] * 8},
         "missing field 'text'"),
        ("/predict", {"audio": [0.0] * 7, "video": [0.0] * 8,
                      "text": [0.0] * 8}, "must be"),
    ]:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, path, payload)
        assert e.value.code == 400
        assert msg in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert e.value.code == 404


def test_predict_over_http_matches_engine(stream_server, rng):
    url, service = stream_server
    feats = _feats(rng, 2)
    out = _post(url, "/predict", {k: v.tolist() for k, v in
                                  zip(("audio", "video", "text"), feats)})
    ref = service.engine.predict(*feats)
    np.testing.assert_allclose(out["mu"], ref["mu"], rtol=1e-6)


# ---------------------------------------------------------------------------
# MicroBatcher and the dispatchers' ordering
# ---------------------------------------------------------------------------
class _FakeEngine:
    """Records per-dispatch batch sizes; returns row-identifying outputs."""

    def __init__(self):
        self.calls = []

    def predict(self, a, v, t):
        self.calls.append(len(a))
        return {"mu": np.repeat(a[:, :1], 3, axis=1)}


def _rows(value, n=1, width=4):
    return (np.full((n, width), float(value), np.float32),
            np.zeros((n, width), np.float32), np.zeros((n, width), np.float32))


def test_micro_batcher_rows_equal_direct_predict(rng):
    """Five requests of 1-3 rows coalesce into one engine call whose rows
    equal a direct predict of each request."""
    _, _, model = _models()
    engine = InferenceEngine(model, batch_buckets=(1, 8, 16), device="cpu")
    mb = tserver.MicroBatcher(engine, max_batch=16, max_wait_ms=1.0,
                              start=False)
    requests = [_feats(rng, n) for n in (1, 3, 2, 1, 3)]
    futs = [mb.submit(*r) for r in requests]
    assert mb._drain_once() == 10
    mb.flush()
    assert mb.batches_dispatched == 1
    for req, fut in zip(requests, futs):
        got, ref = fut.result(timeout=5), engine.predict(*req)
        assert set(got) == set(ref)
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    mb.close()


def test_micro_batcher_max_batch_keeps_order():
    eng = _FakeEngine()
    mb = tserver.MicroBatcher(eng, max_batch=4, max_wait_ms=1.0, start=False)
    futs = [mb.submit(*_rows(i, n=3)) for i in range(2)]
    assert mb._drain_once() == 3  # 3 + 3 > 4: the second request waits
    assert mb._drain_once() == 3
    mb.flush()
    assert eng.calls == [3, 3]
    for i, fut in enumerate(futs):
        np.testing.assert_allclose(fut.result(timeout=1)["mu"], float(i))


@pytest.mark.parametrize("case", ["engine_failure", "close"])
def test_micro_batcher_failures_reach_every_request(case):
    class Boom:
        def predict(self, a, v, t):
            raise RuntimeError("device fault")

    engine = Boom() if case == "engine_failure" else _FakeEngine()
    mb = tserver.MicroBatcher(engine, max_batch=8, max_wait_ms=1.0,
                              start=False)
    futs = [mb.submit(*_rows(0)) for _ in range(3)]
    if case == "engine_failure":
        mb._drain_once()
        match = "device fault"
    else:
        mb.close()
        match = "closed"
        with pytest.raises(RuntimeError, match="closed"):
            mb.submit(*_rows(0))
    for fut in futs:
        with pytest.raises(RuntimeError, match=match):
            fut.result(timeout=1)


def test_live_micro_batcher_serves_and_closes():
    eng = _FakeEngine()
    mb = tserver.MicroBatcher(eng, max_batch=32, max_wait_ms=20.0)
    futs = [mb.submit(*_rows(i)) for i in range(6)]
    for i, fut in enumerate(futs):
        np.testing.assert_allclose(fut.result(timeout=5)["mu"], float(i))
    assert sum(eng.calls) == 6
    mb.close()
    assert not mb._thread.is_alive()


@pytest.fixture
def manual_service():
    _, _, model = _models()
    svc = tserver.StreamingSessionService(
        model, n_streams=2, stream_cfg=TSC, max_wait_ms=1.0, start=False,
        device="cpu")
    yield svc
    svc.close()


def test_same_session_pushes_keep_order_across_deferral(manual_service, rng):
    svc = manual_service
    sid, other = svc.start(), svc.start()
    c = [rng.normal(size=2048).astype(np.float32) for _ in range(3)]
    f1 = svc._enqueue(("push", sid, c[0], Future()))
    f2 = svc._enqueue(("push", sid, c[1], Future()))  # same sid: deferred
    f3 = svc._enqueue(("push", other, c[2], Future()))
    fe = svc._enqueue(("end", sid, None, Future()))
    assert svc._tick() == 1
    assert f1.result(timeout=1) and not f2.done()
    assert svc._tick() >= 1  # the carried c[1] first
    assert f2.done() and not fe.done()
    while not fe.done():
        svc._tick()
    assert f3.result(timeout=1) and fe.result(timeout=1) is True
    assert len(svc.sessions) == 1
    # The freed slot restarts from silence: a new session's first push
    # equals the first push of the slot's first session.
    sid2 = svc.start()
    g = svc._enqueue(("push", sid2, c[0], Future()))
    svc._tick()
    np.testing.assert_allclose(g.result(timeout=1)["mu"],
                               f1.result(timeout=1)["mu"], atol=1e-6)


def test_push_for_session_ended_while_queued_fails(manual_service, rng):
    svc = manual_service
    sid = svc.start()
    fe = svc._enqueue(("end", sid, None, Future()))
    fp = svc._enqueue(("push", sid, np.zeros(2048, np.float32), Future()))
    svc._tick()
    assert fe.result(timeout=1) is True
    svc._tick()
    with pytest.raises(ValueError, match="unknown session"):
        fp.result(timeout=1)
    with pytest.raises(ValueError, match="unknown session"):
        svc.set_context("nope", video=np.zeros(8))
    with pytest.raises(ValueError, match="samples"):
        svc.push(svc.start(), np.zeros(100, np.float32))


def test_conformal_loader(tmp_path):
    good = tmp_path / "conformal.json"
    good.write_text(json.dumps({"synthetic": {
        "alpha": 0.1, "normalized": False, "quantiles": [1.5, 2.0, 2.5]}}))
    spec = tserver.PredictionService.load_conformal(str(good))
    ref = jserver.PredictionService.load_conformal(str(good))
    assert spec["alpha"] == ref["alpha"] and not spec["normalized"]
    np.testing.assert_array_equal(spec["quantiles"], ref["quantiles"])
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"alpha": 0.01, "normalized": True,
                               "quantiles": [1.0, float("inf"), 1.0]}))
    with pytest.raises(ValueError, match="non-finite"):
        tserver.PredictionService.load_conformal(str(bad))
    # A single model's checkpoint is not a 2-member ensemble's.
    from tpu_deer_torch.train.checkpoint import CheckpointManager

    CheckpointManager(str(tmp_path / "ckpt")).save(
        {"model": CompleteDEERModel().state_dict()}, step=1, is_best=True)
    with pytest.raises(ValueError, match="member"):
        tserver.PredictionService.from_checkpoint(str(tmp_path / "ckpt"),
                                                  ensemble_members=2)


# ---------------------------------------------------------------------------
# Services from checkpoints, the channel fallback, the command line
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quantize", [False, True])
def test_from_checkpoint_with_streams_matches_jax(quantize, tmp_path, rng):
    """PredictionService.from_checkpoint with live sessions, float and int8,
    against the reference's on the same weights: /predict's JSON and two
    pushes of two sessions (default StreamingConfig: n_fft 1024, chunk
    4096; the int8 sessions stream the dequantized weights)."""
    from tpu_deer.train.checkpoint import CheckpointManager as JCheckpoints
    from tpu_deer_torch.train.checkpoint import CheckpointManager

    _, params, model = _models()
    meta = {"serving_channel": "calibrated"}
    JCheckpoints(str(tmp_path / "j")).save({"params": params, "step": 3}, 3,
                                           metrics=meta, is_best=True)
    CheckpointManager(str(tmp_path / "t")).save(
        {"model": model.state_dict(), "step": 3}, 3, metrics=meta,
        is_best=True)
    kw = dict(stream_slots=2, quantize_weights=quantize, batch_buckets=(1, 8))
    jsvc = jserver.PredictionService.from_checkpoint(
        str(tmp_path / "j"), config=JConfig(**NARROW), **kw)
    svc = tserver.PredictionService.from_checkpoint(
        str(tmp_path / "t"), config=DEERModelConfig(**NARROW), device="cpu",
        **kw)
    try:
        assert svc.engine.serving_channel == "calibrated"
        assert svc.engine.quantized == quantize
        a, v, t = _feats(rng, 3)
        payload = {"audio": a.tolist(), "video": v.tolist(), "text": t.tolist()}
        _assert_same(svc.predict_json(payload), jsvc.predict_json(payload))
        ctx = _feats(rng, 2)[1:]
        sids = [(s.streaming.start(video=ctx[0][i], text=ctx[1][i])
                 for s in (jsvc, svc)) for i in range(2)]
        sids = [tuple(pair) for pair in sids]
        audio = rng.normal(scale=0.1, size=(2, 2, 4096)).astype(np.float32)
        for k in range(2):
            for i, (jsid, tsid) in enumerate(sids):
                _assert_same(svc.streaming.push(tsid, audio[i, k]),
                             jsvc.streaming.push(jsid, audio[i, k]),
                             f"push {k} session {i}")
    finally:
        jsvc.streaming.close()
        svc.streaming.close()


class _ArtifactEngine:
    """An engine over an artifact whose outputs lack some channels."""

    output_dir = "/artifacts/old_export"

    def __init__(self, channel, outputs):
        self.serving_channel = channel
        self.outputs = outputs

    def predict(self, audio, video, text):
        return {k: np.full((len(audio), 3), i + 1.0, np.float32)
                for i, k in enumerate(self.outputs)}


@pytest.mark.parametrize("channel, outputs, served, jax_served", [
    # E|y - mu| comes before the raw variance when the selected channel is
    # missing (the reference tries calibrated, then the variance).
    ("calibrated", ("mu", "uncertainty", "expected_abs_error"), "eabs",
     "variance"),
    ("eabs", ("mu", "uncertainty", "calibrated_uncertainty"), "calibrated",
     "calibrated"),
    ("calibrated", ("mu", "uncertainty"), "variance", "variance"),
])
def test_predict_json_falls_back_to_the_artifacts_channels(
        channel, outputs, served, jax_served):
    payload = {"audio": np.zeros((2, 84)).tolist(),
               "video": np.zeros((2, 8)).tolist(),
               "text": np.zeros((2, 8)).tolist()}
    engine = _ArtifactEngine(channel, outputs)
    got = tserver.PredictionService(engine, DIMS).predict_json(payload)
    ref = jserver.PredictionService(engine, DIMS).predict_json(payload)
    assert (got["serving_channel"], ref["serving_channel"]) == (served,
                                                                 jax_served)
    key = {"calibrated": "calibrated_uncertainty", "eabs": "expected_abs_error",
           "variance": "uncertainty"}[served]
    assert got["deployable_uncertainty"] == got[key]


def test_predict_json_without_uncertainty_names_the_artifact():
    payload = {"audio": np.zeros((1, 84)).tolist(),
               "video": np.zeros((1, 8)).tolist(),
               "text": np.zeros((1, 8)).tolist()}
    engine = _ArtifactEngine("calibrated", ("mu",))
    with pytest.raises(ValueError, match="/artifacts/old_export"):
        tserver.PredictionService(engine, DIMS).predict_json(payload)
    with pytest.raises(KeyError):  # the reference raises a KeyError here
        jserver.PredictionService(engine, DIMS).predict_json(payload)


@pytest.mark.parametrize("argv, error", [
    ([], SystemExit),
    (["--checkpoint", "c", "--exported", "e"], SystemExit),
    (["--exported", "e", "--ood", "det.npz"], SystemExit),
    (["--exported", "e", "--stream_slots", "2"], SystemExit),
    (["--exported", "e", "--platform", "tpu"], SystemExit),
    (["--exported", "e", "--ensemble", "2"], SystemExit),
])
def test_main_argument_errors(argv, error):
    with pytest.raises(error):
        tserver.main(argv)
