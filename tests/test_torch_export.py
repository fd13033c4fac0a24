"""The port's export (tpu_deer_torch.export) against the JAX package's on the
CPU: the same weights (the port's init converted with state_dict_to_flax),
the same detector, the same inputs.

Tolerances: exported vs JAX's exported engine rtol 1e-4, atol 1e-5 (float32
model outputs, as tests/test_torch_model.py; ood_score, a sum of squares
over whitened features, rtol 1e-4 alone); is_ood and the manifest's fields
equal. Exported vs the port's live engine: the same float32 work in the
same order, so equal bits are expected; held at rtol 1e-6.
"""

import contextlib
import functools
import inspect
import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from tpu_deer import server as jserver
from tpu_deer.eval import ood as jood
from tpu_deer.export import export_inference as jexport
from tpu_deer.export import load_exported as jload
from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JConfig
from tpu_deer_torch import server as tserver
from tpu_deer_torch.convert import state_dict_to_flax
from tpu_deer_torch.eval import ood as tood
from tpu_deer_torch.export import (
    FORMAT,
    MANIFEST,
    ExportedEngine,
    export_inference,
    load_exported,
)
from tpu_deer_torch.models.deer_model import (
    DEERModelConfig,
    create_complete_deer_model,
)
from tpu_deer_torch.serve import InferenceEngine

torch.set_num_threads(1)

NARROW = dict(audio_dim=84, video_dim=8, text_dim=8, encoder_dim=16,
              fusion_dim=32, attention_heads=2, encoder_layers=1)
DIMS = (84, 8, 8)
BUCKETS = (1, 8)
FPR = 0.2
# (quantize, with an input_norm detector): float with OOD, int8 without.
VARIANTS = {"float_ood": (False, True), "int8": (True, False)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _models():
    """(the port's model, JAX's module, its converted params)."""
    model = create_complete_deer_model(DEERModelConfig(**NARROW), seed=0,
                                       device="cpu")
    return model.eval(), JModel(JConfig(**NARROW)), state_dict_to_flax(
        model.state_dict())


@functools.lru_cache(maxsize=None)
def _detectors():
    rng = np.random.default_rng(3)
    fit = [rng.normal(size=(128, d)).astype(np.float32) for d in DIMS]
    return (jood.MahalanobisOOD().fit_modalities(*fit),
            tood.MahalanobisOOD().fit_modalities(*fit))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{variant: (port artifact dir, JAX artifact dir, port manifest, JAX
    manifest)}."""
    model, jmodel, params = _models()
    jdet, tdet = _detectors()
    out = {}
    for name, (quantize, ood) in VARIANTS.items():
        tdir = str(tmp_path_factory.mktemp(f"torch_{name}"))
        jdir = str(tmp_path_factory.mktemp(f"jax_{name}"))
        tman = export_inference(model, tdir, BUCKETS, platforms=("cpu",),
                                quantize=quantize, ood_fpr=FPR,
                                ood_detector=tdet if ood else None,
                                serving_channel="calibrated")
        jman = jexport(jmodel, params, jdir, BUCKETS, quantize=quantize,
                       ood_fpr=FPR, ood_detector=jdet if ood else None,
                       serving_channel="calibrated")
        out[name] = (tdir, jdir, tman, jman)
    return out


@functools.lru_cache(maxsize=None)
def _loaded(tdir, jdir):
    """The port's and JAX's engines over one variant's artifacts, loaded
    once for the module (JAX compiles each bucket at its first call)."""
    return load_exported(tdir, device="cpu"), jload(jdir)


def _feats(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, d)).astype(np.float32) for d in DIMS]


def _assert_same(got, ref, rtol=1e-4, atol=1e-5):
    assert set(got) == set(ref)
    for key, r in ref.items():
        if np.asarray(r).dtype == bool or isinstance(r, (bool, str)):
            assert np.array_equal(got[key], r), key
        elif key == "ood_score":
            np.testing.assert_allclose(got[key], r, rtol=rtol, err_msg=key)
        else:
            np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                       np.asarray(r, np.float64), rtol=rtol,
                                       atol=atol, err_msg=key)


@pytest.mark.parametrize("n", [1, 19])  # 19: chunks of 8, 8 and 3 (pads to 8)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_exported_matches_jax(artifacts, variant, n):
    tdir, jdir, _, _ = artifacts[variant]
    feats = _feats(n, n)
    engine, jengine = _loaded(tdir, jdir)
    got = engine.predict(*feats)
    ref = {k: np.asarray(v) for k, v in jengine.predict(*feats).items()}
    assert all(len(v) == n for v in got.values())
    _assert_same(got, ref)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_exported_matches_live_engine(artifacts, variant):
    quantize, ood = VARIANTS[variant]
    model, _, _ = _models()
    feats = _feats(5, 19)
    live = InferenceEngine(model, BUCKETS, quantize_weights=quantize,
                           ood_detector=_detectors()[1] if ood else None,
                           ood_fpr=FPR, device="cpu").predict(*feats)
    engine = _loaded(*artifacts[variant][:2])[0]
    engine.warmup()  # eager on the CPU: one run of each bucket
    got = engine.predict(*feats)
    _assert_same(got, {k: live[k] for k in got}, rtol=1e-6, atol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_manifest_matches_jax(artifacts, variant):
    tdir, _, tman, jman = artifacts[variant]
    with open(os.path.join(tdir, MANIFEST)) as f:
        assert json.load(f) == tman
    for key in ("model", "config", "outputs", "buckets", "quantized",
                "serving_channel", "ensemble_members", "n_params", "ood"):
        assert tman.get(key) == jman.get(key), key
    assert tman["format"] == FORMAT and tman["platforms"] == ["cpu"]
    assert tman["artifacts"] == {str(b): f"forward_b{b}.pt2" for b in BUCKETS}
    with np.load(os.path.join(tdir, "params.npz"), allow_pickle=False) as z:
        keys = set(z.files)
    prefixes = {k.split("/")[0] for k in keys if "/" in k}
    assert prefixes == ({"q", "scale"} if tman["quantized"] else set()) | (
        {"ood"} if "ood" in tman else set())
    # The programs carry no weights: every tensor is an input. (The
    # programs as torch.export.load gave them to the module's engine.)
    loaded = _loaded(*artifacts[variant][:2])[0].exported
    assert sorted(loaded) == list(BUCKETS)
    for b, ep in loaded.items():
        assert not ep.state_dict and not ep.constants, b
        assert ep.example_inputs is None


def test_padding_and_chunking(artifacts):
    engine = _loaded(*artifacts["int8"][:2])[0]
    one = [engine.predict(*(f[i:i + 1] for f in _feats(7, 19)))
           for i in range(19)]
    whole = engine.predict(*_feats(7, 19))
    for key, v in whole.items():
        assert v.shape[0] == 19
        np.testing.assert_allclose(v, np.concatenate([o[key] for o in one]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_refusals(artifacts, tmp_path):
    model, _, _ = _models()
    jdir = artifacts["int8"][1]
    with pytest.raises(ValueError, match="StableHLO"):
        ExportedEngine(jdir, device="cpu")
    with open(os.path.join(artifacts["int8"][0], MANIFEST)) as f:
        manifest = json.load(f)
    (tmp_path / MANIFEST).write_text(json.dumps({**manifest, "format": "v0"}))
    with pytest.raises(ValueError, match="unrecognized export format"):
        ExportedEngine(str(tmp_path), device="cpu")
    rng = np.random.default_rng(0)
    fused = tood.MahalanobisOOD().fit(rng.normal(size=(64, 32)).astype(np.float32))
    with pytest.raises(ValueError, match="input_norm"):
        export_inference(model, str(tmp_path / "f"), BUCKETS, ("cpu",),
                         ood_detector=fused)
    with pytest.raises(ValueError, match="input_norm"):
        _, jmodel, params = _models()
        jexport(jmodel, params, str(tmp_path / "j"), BUCKETS,
                ood_detector=jood.MahalanobisOOD().fit(
                    rng.normal(size=(64, 32)).astype(np.float32)))
    with pytest.raises(ValueError, match="platforms"):
        export_inference(model, str(tmp_path / "t"), BUCKETS, ("tpu",))
    with pytest.raises(ValueError, match="stacked member params"):
        export_inference(model, str(tmp_path / "e"), BUCKETS, ("cpu",),
                         ensemble=True)


def test_entry_points_default_to_cuda(artifacts, tmp_path):
    """Without a card, the default device and platform raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    model, _, _ = _models()
    with pytest.raises(RuntimeError, match="CUDA"):
        export_inference(model, str(tmp_path), BUCKETS)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_exported(artifacts["int8"][0])
    with pytest.raises(RuntimeError, match="CUDA"):
        export_inference(model, str(tmp_path), BUCKETS, ("cpu", "cuda"))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_from_exported_predict_json_matches_jax(artifacts, variant,
                                                monkeypatch):
    tdir, jdir, _, _ = artifacts[variant]
    a, v, t = _feats(11, 3)
    payload = {"audio": a.tolist(), "video": v.tolist(), "text": t.tolist()}
    # from_exported's load_exported hands back the module's engine over the
    # same artifact, as load_exported loaded it (each program takes seconds
    # to deserialize; the server's subprocess below loads its own).
    from tpu_deer_torch import export as texport

    calls = []

    def loaded(path, device=None, graphs=True):
        calls.append((path, device))
        return _loaded(tdir, jdir)[0]

    monkeypatch.setattr(texport, "load_exported", loaded)
    svc = tserver.PredictionService.from_exported(tdir, device="cpu")
    assert calls == [(tdir, "cpu")]
    got = svc.predict_json(payload)
    # The reference's from_exported is its load_exported and this: the
    # module's JAX engine over the same artifact.
    jengine = _loaded(tdir, jdir)[1]
    c = jengine.manifest["config"]
    ref = jserver.PredictionService(
        jengine, (c["audio_dim"], c["video_dim"], c["text_dim"])).predict_json(payload)
    assert got["serving_channel"] == ref["serving_channel"] == "calibrated"
    _assert_same(got, ref)
    with pytest.raises(ValueError, match="checkpoint"):
        tserver.PredictionService.from_exported(tdir, device="cpu",
                                                stream_slots=2)


@contextlib.contextmanager
def _served(argv):
    """The server's main on the CPU in a fresh interpreter (`argv` after
    the interpreter's): yields call(path, payload=None) -> JSON; on exit,
    SIGINT, which must stop it with exit code 0."""
    proc = subprocess.Popen([sys.executable, *argv, "--platform", "cpu",
                             "--port", "0"],
                            cwd=ROOT, stderr=subprocess.PIPE, text=True)
    try:
        url = None
        for line in proc.stderr:
            if "listening on " in line:
                url = line.split("listening on ")[1].strip()
                break
        assert url, "the server did not start"

        def call(path, payload=None):
            data = None if payload is None else json.dumps(payload).encode()
            with urllib.request.urlopen(urllib.request.Request(
                    url + path, data=data), timeout=60) as r:
                return json.loads(r.read())

        yield call
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.stderr.close()


def test_server_main_serves_an_export_without_model_code(artifacts):
    """The server's main over an artifact, in a fresh interpreter that
    cannot import the port's model code, answers /healthz and /predict as
    this process's engine does (rtol 1e-6: another process may sum in
    another order, with its own thread count)."""
    tdir = artifacts["float_ood"][0]
    script = ("import sys\n"
              "sys.modules['tpu_deer_torch.models'] = None\n"
              "from tpu_deer_torch.server import main\n"
              "sys.exit(main(sys.argv[1:]))\n")
    with _served(["-c", script, "--exported", tdir]) as call:
        assert call("/healthz")["status"] == "ok"
        a, v, t = _feats(17, 2)
        got = call("/predict", {"audio": a.tolist(), "video": v.tolist(),
                                "text": t.tolist()})
        ref = _loaded(*artifacts["float_ood"][:2])[0].predict(a, v, t)
        _assert_same({k: got[k] for k in ref}, ref, rtol=1e-6, atol=0)
        assert call("/healthz")["requests_served"] == 1


def test_server_main_serves_a_checkpoint_with_streams(tmp_path):
    """`python -m tpu_deer_torch.server --checkpoint --stream_slots` at the
    flagship's default width: /predict as from_checkpoint's engine, and a
    live session's push as a direct StreamingSessionService's."""
    from tpu_deer_torch.train.checkpoint import CheckpointManager

    model = create_complete_deer_model(seed=2, device="cpu")
    CheckpointManager(str(tmp_path)).save(
        {"model": model.state_dict(), "step": 1}, 1, is_best=True,
        metrics={"serving_channel": "calibrated"})
    svc = tserver.PredictionService.from_checkpoint(
        str(tmp_path), stream_slots=2, device="cpu")
    a, v, t = (x.tolist() for x in
               [np.random.default_rng(23).normal(size=(3, d)).astype(
                   np.float32) for d in (84, 256, 768)])
    chunk = np.random.default_rng(29).normal(scale=0.1, size=4096)
    try:
        ref = svc.predict_json({"audio": a, "video": v, "text": t})
        pushed_ref = svc.streaming.push(svc.streaming.start(),
                                        chunk.astype(np.float32))
    finally:
        svc.streaming.close()
    with _served(["-m", "tpu_deer_torch.server", "--checkpoint",
                  str(tmp_path), "--stream_slots", "2"]) as call:
        health = call("/healthz")
        assert health["stream_slots"] == 2 and health["stream_sessions"] == 0
        got = call("/predict", {"audio": a, "video": v, "text": t})
        sid = call("/stream/start", {})["session_id"]
        pushed = call("/stream/push", {"session_id": sid,
                                       "audio": chunk.tolist()})
        assert call("/stream/end", {"session_id": sid}) == {"ended": True}
    # Another process may sum in another order (its own thread count).
    _assert_same(got, ref, rtol=1e-6, atol=0)
    _assert_same(pushed, pushed_ref, rtol=1e-6, atol=0)
    assert got["serving_channel"] == "calibrated"


def test_cli_export_writes_a_loadable_artifact(tmp_path, monkeypatch):
    """--mode export at the configured (narrow) width, int8, from a
    checkpoint: the artifact serves what the checkpoint's int8 engine
    serves, with the channel the checkpoint recorded. The CLI asks for the
    default buckets; the export traces the one the request below pads to
    (each `torch.export` program takes seconds to trace and to load)."""
    import yaml

    from tpu_deer_torch import cli
    from tpu_deer_torch import export as texport
    asked = []

    def served_bucket(*args, **kwargs):
        # The buckets the CLI asked for: positional (third) or by name.
        asked.append(args[2] if len(args) > 2 else
                     kwargs.get("batch_buckets", "default"))
        return export_inference(*args[:2], **{**kwargs, "batch_buckets": (8,)})

    monkeypatch.setattr(texport, "export_inference", served_bucket)
    from tpu_deer_torch.train.checkpoint import CheckpointManager
    from tpu_deer_torch.utils.config import default_config

    model, _, _ = _models()
    models = str(tmp_path / "models")
    CheckpointManager(models).save({"model": model.state_dict(), "step": 3},
                                   step=3, is_best=True,
                                   metrics={"serving_channel": "calibrated"})
    cfg = default_config()
    cfg["model"].update(NARROW)
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(cfg))
    assert cli.main(["--mode", "export", "--platform", "cpu", "--int8",
                     "--config", str(tmp_path / "c.yaml"), "--output_dir",
                     str(tmp_path), "--experiment_name", "x",
                     "--model_path", models]) == 0
    engine = load_exported(str(tmp_path / "exported_model"), device="cpu")
    assert engine.manifest["quantized"] and engine.serving_channel == "calibrated"
    assert asked == ["default"]
    assert inspect.signature(export_inference).parameters[
        "batch_buckets"].default == (1, 8, 64, 256)
    assert engine.buckets == [8]
    feats = _feats(19, 3)
    ref = InferenceEngine.from_checkpoint(
        models, config=DEERModelConfig(**NARROW), quantize_weights=True,
        device="cpu").predict(*feats)
    got = engine.predict(*feats)
    _assert_same(got, {k: ref[k] for k in got}, rtol=1e-6, atol=0)
