"""Serving buckets and the stream tick as CUDA graphs, on the card (needs a
CUDA device; marked `cuda`, skips without one). On the machine with the
card:

    TPU_DEER_TEST_TPU=1 python -m pytest tests/test_torch_serve_graph_cuda.py -q

Graphed against eager through the same entry points, at a narrow width and
every bucket, in float, int8 and with an OOD detector, for the live and the
exported engine; 8 graphed against 8 eager ticks at 64 streams. Both run
the same float32 device work in the same order, so equal bits are
expected; held at rtol/atol 1e-5 (a cuBLAS algorithm may differ between a
capture and an eager launch). A capture that syncs with the host raises.
"""

import threading

import numpy as np
import pytest
import torch

from tpu_deer_torch.eval.ood import MahalanobisOOD
from tpu_deer_torch.export import export_inference, load_exported
from tpu_deer_torch.graphs import GraphedCall
from tpu_deer_torch.kernels import mfcc_frames as k2
from tpu_deer_torch.models.deer_model import DEERModelConfig, create_complete_deer_model
from tpu_deer_torch.serve import InferenceEngine
from tpu_deer_torch.stream import StreamingConfig, StreamingRecognizer

pytestmark = pytest.mark.cuda

WIDTH = dict(encoder_dim=64, fusion_dim=128, encoder_layers=1)
DIMS = (84, 256, 768)
SIZES = (1, 8, 64, 256, 300)  # every bucket, and a chunked request
TOL = dict(rtol=1e-5, atol=1e-5)
VARIANTS = {"float": (False, False), "int8": (True, False),
            "ood": (False, True)}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _model(device):
    return create_complete_deer_model(DEERModelConfig(**WIDTH), seed=3,
                                      device=device)


def _detector():
    rng = np.random.default_rng(5)
    return MahalanobisOOD().fit_modalities(
        *(rng.normal(size=(512, d)).astype(np.float32) for d in DIMS))


def _feats(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, d)).astype(np.float32) for d in DIMS]


def _assert_close(got, ref):
    assert set(got) == set(ref)
    for key, r in ref.items():
        if r.dtype == bool:
            assert np.array_equal(got[key], r), key
        else:
            np.testing.assert_allclose(got[key], r, err_msg=key, **TOL)


def _engines(device, variant, tmp_path=None):
    """(graphed, eager) engines of one kind: live, or exported when
    tmp_path is given."""
    quantize, ood = VARIANTS[variant]
    kw = dict(ood_detector=_detector() if ood else None)
    if tmp_path is None:
        make = lambda graphs: InferenceEngine(
            _model(device), quantize_weights=quantize, device=device,
            graphs=graphs, **kw)
    else:
        export_inference(_model(device), str(tmp_path), platforms=("cuda",),
                         quantize=quantize, **kw)
        make = lambda graphs: load_exported(str(tmp_path), device=device,
                                            graphs=graphs)
    return make(True), make(False)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("kind", ["live", "exported"])
def test_graphed_buckets_match_eager(device, variant, kind, tmp_path):
    graphed, eager = _engines(device, variant,
                              tmp_path if kind == "exported" else None)
    assert graphed.graphs and not eager.graphs
    graphed.warmup()
    assert sorted(graphed.bucket_graphs.capture_s) == [1, 8, 64, 256]
    feats = _feats(max(SIZES))
    for n in SIZES:
        got = graphed.predict(*(f[:n] for f in feats))
        assert all(len(v) == n for v in got.values())
        _assert_close(got, eager.predict(*(f[:n] for f in feats)))
    replays = sum(g.replays for g in graphed.bucket_graphs._graphs.values())
    assert replays == len(SIZES) + 1  # 300 rows: 256 + 44 (→ 64)


def _drive(rec, audio, video, text, reset_at=5, idle_at=3):
    outs, states = [], []
    inactive = np.arange(rec.n_streams) % 5 == 4
    chunk = rec.cfg.chunk_samples
    for t in range(audio.shape[1] // chunk):
        if t == reset_at:
            rec.reset_streams([3, 7, 11])
        active = ~inactive if t == idle_at else None
        outs.append(rec.push(audio[:, t * chunk:(t + 1) * chunk], video,
                             text, active))
        states.append([f.cpu().numpy().copy() for f in rec.state])
    return outs, states


def test_buckets_called_from_threads_at_once(device):
    """Two threads predicting at once in different buckets of one engine
    (its graphs share a memory pool): every output equals the same request
    predicted alone. A later capture can place its outputs where an earlier
    graph's intermediates were, so without the pool's lock the other
    bucket's replay overwrote them before the copy out."""
    engine = InferenceEngine(_model(device), device=device)
    engine.warmup()
    feats = {n: _feats(n, seed=n) for n in (1, 3, 40, 200)}
    alone = {n: engine.predict(*f) for n, f in feats.items()}
    errors = []

    def client(sizes):
        try:
            for _ in range(25):
                for n in sizes:
                    _assert_close(engine.predict(*feats[n]), alone[n])
        except AssertionError as e:  # raised on the main thread below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(sizes,))
               for sizes in ((1, 40), (3, 200))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[0]


def test_graphed_ticks_match_eager(device):
    streams, ticks = 64, 8
    cfg = StreamingConfig()
    rng = np.random.default_rng(1)
    audio = (0.1 * rng.normal(size=(streams, ticks * cfg.chunk_samples))
             ).astype(np.float32)
    _, video, text = _feats(streams, seed=2)
    model, det = _model(device), _detector()
    graphed = StreamingRecognizer(model, streams, cfg, det, device=device)
    eager = StreamingRecognizer(model, streams, cfg, det, device=device,
                                graphs=False)
    graphed.warmup()
    launches = k2.mfcc_frames.launches
    state_ptrs = [f.data_ptr() for f in graphed.state]
    got, got_states = _drive(graphed, audio, video, text)
    ref, ref_states = _drive(eager, audio, video, text)
    assert [f.data_ptr() for f in graphed.state] == state_ptrs
    # The replays launch K2 from the graph, not through its wrapper.
    assert graphed._graph.replays == ticks
    assert k2.mfcc_frames.launches == launches + ticks  # the eager ticks
    for t in range(ticks):
        _assert_close(got[t], ref[t])
        for g, r in zip(got_states[t], ref_states[t]):
            np.testing.assert_allclose(g, r, **TOL)


def test_capture_while_another_thread_ticks(device):
    """A bucket captured at its first request (no warm-up, thread_local
    mode) while another thread replays the stream tick."""
    model = _model(device)
    rec = StreamingRecognizer(model, 16, device=device)
    rec.warmup()
    chunks = np.zeros((16, rec.cfg.chunk_samples), np.float32)
    stop, errors = threading.Event(), []

    def tick():
        try:
            while not stop.is_set():
                rec.push(chunks)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    thread = threading.Thread(target=tick)
    thread.start()
    try:
        graphed = InferenceEngine(model, device=device)
        feats = _feats(8)
        got = graphed.predict(*feats)
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not errors and not thread.is_alive()
    assert sorted(graphed.bucket_graphs.capture_s) == [8]
    _assert_close(got, InferenceEngine(model, device=device,
                                       graphs=False).predict(*feats))


def test_failed_capture_raises(device):
    with pytest.raises(RuntimeError):
        GraphedCall(lambda x: {"y": x * float(x.sum())},
                    [((4,), torch.float32)], device)
    engine = InferenceEngine(_model(device), device=device)
    forward = engine._forward
    engine._forward = lambda a, v, t: {
        "mu": forward(a, v, t)["mu"] * float(a.sum())}
    with pytest.raises(RuntimeError):
        engine.predict(*_feats(1))
    assert not engine.bucket_graphs.capture_s
