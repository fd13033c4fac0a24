"""The port's streaming path (tpu_deer_torch.stream, the frames front-end and
kernel K2's plain twin) against the JAX reference on the CPU.

K2's twin against the reference's `mfcc_frames` (XLA path and the Pallas
kernel in interpret mode) at the front-end tolerances of
tests/test_audio_frontend.py: power/logmel rtol 2e-4, atol 1e-3 and mfcc
rtol 2e-3, atol 5e-3 (float32 sums over n_fft samples in another order).
ZCR and RMS rtol 1e-4, atol 1e-5. Streaming features and every push output
rtol 1e-4, atol 1e-5: the 84-d vector is unit-variance, so entries near 0
carry the rounding of the unit scale; model outputs as in
tests/test_torch_model.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_reference import create_complete_deer_model as jax_create
from tpu_deer.eval import ood as jood
from tpu_deer.models.deer_model import DEERModelConfig as JConfig
from tpu_deer.ops import audio_frontend as jaf
from tpu_deer import stream as jstream
from tpu_deer_torch import stream as tstream
from tpu_deer_torch.convert import flax_to_state_dict
from tpu_deer_torch.eval import ood as tood
from tpu_deer_torch.kernels import mfcc_frames as k2
from tpu_deer_torch.models.deer_model import CompleteDEERModel, DEERModelConfig
from tpu_deer_torch.ops import audio_frontend as taf

torch.set_num_threads(1)

FRONT_TOL = ((2e-3, 5e-3), (2e-4, 1e-3), (2e-4, 1e-3))  # mfcc, logmel, power
TOL = dict(rtol=1e-4, atol=1e-5)
JFE = jaf.AudioFrontendConfig(n_fft=512, hop_length=128)
TFE = taf.AudioFrontendConfig(n_fft=512, hop_length=128)
JSC = jstream.StreamingConfig(frontend=JFE, chunk_samples=2048)
TSC = tstream.StreamingConfig(frontend=TFE, chunk_samples=2048)
NARROW = dict(audio_dim=84, video_dim=8, text_dim=8, encoder_dim=16,
              fusion_dim=32, attention_heads=2, encoder_layers=1)
S = 3


def _speech_like(rng, seconds=2.0, sr=16000):
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140.0 + 40.0 * np.sin(2 * np.pi * 0.7 * t)
    sig = np.zeros_like(t)
    for h in range(1, 5):
        sig += np.sin(2 * np.pi * h * np.cumsum(f0) / sr) / h
    sig *= 0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t) ** 2  # energy modulation
    return (sig + 0.05 * rng.normal(size=t.shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX model, its params, the port's model with the same weights)."""
    jmodel, params = jax_create(JConfig(**NARROW), seed=0)
    params = jax.tree_util.tree_map(np.asarray, params)
    model = CompleteDEERModel(DEERModelConfig(**NARROW))
    model.load_state_dict(flax_to_state_dict(params))
    return jmodel, params, model.eval()


# ---------------------------------------------------------------------------
# K2's plain twin and the frames front-end
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jax_path", ["xla", "pallas"])
@pytest.mark.parametrize("n_fft", [512, 1024])
def test_k2_plain_twin_matches_jax(n_fft, jax_path, rng):
    """37 rows: not a multiple of the kernel's 32-row block, nor of the
    Pallas kernel's 8-row tile."""
    jcfg = jaf.AudioFrontendConfig(n_fft=n_fft)
    tcfg = taf.AudioFrontendConfig(n_fft=n_fft)
    frames = rng.normal(size=(37, n_fft)).astype(np.float32)
    kw = (dict(use_pallas=True, interpret=True) if jax_path == "pallas"
          else dict(use_pallas=False))
    ref = jaf.mfcc_frames(jnp.asarray(frames), jcfg, **kw)
    bases = taf._device_bases(tcfg, torch.device("cpu"))
    got = k2.mfcc_frames_plain(torch.from_numpy(frames), bases, n_fft)
    for r, g, (rtol, atol) in zip(ref, got, FRONT_TOL):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol)


def test_k2_wrapper_on_cpu_is_the_plain_twin(rng):
    frames = torch.from_numpy(rng.normal(size=(5, 512)).astype(np.float32))
    bases = taf._device_bases(TFE, frames.device)
    before = k2.mfcc_frames.launches
    for a, b in zip(k2.mfcc_frames(frames, bases, 512),
                    k2.mfcc_frames_plain(frames, bases, 512)):
        assert torch.equal(a, b)
    assert k2.mfcc_frames.launches == before  # no kernel ran


@pytest.mark.parametrize("bad", ["n_fft_2048", "float64", "non_contiguous",
                                 "width", "rank3"])
def test_k2_wrapper_rejects_bad_input(bad):
    if bad == "n_fft_2048":
        cfg = taf.AudioFrontendConfig(n_fft=2048)
        with pytest.raises(ValueError, match="n_fft"):
            k2.mfcc_frames(torch.zeros(4, 2048),
                           taf._device_bases(cfg, torch.device("cpu")), 2048)
        return
    x = {"float64": torch.zeros(4, 512, dtype=torch.float64),
         "non_contiguous": torch.zeros(512, 4).t(),
         "width": torch.zeros(4, 500),
         "rank3": torch.zeros(1, 4, 512)}[bad]
    with pytest.raises((TypeError, ValueError)):
        k2.mfcc_frames(x, taf._device_bases(TFE, torch.device("cpu")), 512)


def test_frames_front_end_matches_jax(rng):
    """frame_signal, mfcc_frames over leading axes, RMS and ZCR."""
    sig = np.stack([_speech_like(rng, 0.3) for _ in range(2)])
    ref_frames = np.asarray(jaf.frame_signal(jnp.asarray(sig), JFE))
    frames = taf.frame_signal(torch.from_numpy(sig), TFE)
    np.testing.assert_array_equal(frames.numpy(), ref_frames)

    got = taf.mfcc_frames(frames, TFE)  # [2, N, ...] in one call
    for b in range(2):
        ref = jaf.mfcc_frames(jnp.asarray(ref_frames[b]), JFE)
        for r, g, (rtol, atol) in zip(ref, got, FRONT_TOL):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(r),
                                       rtol=rtol, atol=atol)
    np.testing.assert_allclose(
        taf.zero_crossing_rate(frames).numpy(),
        np.asarray(jaf.zero_crossing_rate(jnp.asarray(ref_frames))), **TOL)
    np.testing.assert_allclose(
        taf.rms_energy(frames).numpy(),
        np.asarray(jaf.rms_energy(jnp.asarray(ref_frames))), **TOL)


# ---------------------------------------------------------------------------
# streaming_update
# ---------------------------------------------------------------------------
def _port_run(sc, chunks):
    """chunks [S, n, chunk] → per-tick features [n, S, 84] (port)."""
    state = tstream.init_stream_state(sc, chunks.shape[0], device="cpu")
    feats = []
    for i in range(chunks.shape[1]):
        state, f = tstream.streaming_update(
            state, torch.from_numpy(chunks[:, i]), sc)
        feats.append(f.numpy())
    return np.stack(feats), state


def test_streaming_update_matches_jax(rng):
    """Two streams over five chunks: every tick's features, and the state
    the last tick leaves, equal the reference's per-stream updates. The
    state holds raw moments in MFCC units (means up to ~1e2, M2 up to
    ~1e5), so it is held at rtol 1e-4 with atol 1e-4 for entries near 0."""
    n = 5
    sig = np.stack([_speech_like(rng, 0.7), rng.normal(size=11200)])
    chunks = sig[:, : n * 2048].astype(np.float32).reshape(2, n, 2048)
    got, state = _port_run(TSC, chunks)
    for s in range(2):
        jstate = jstream.init_stream_state(JSC)
        for i in range(n):
            jstate, ref = jstream.streaming_update(jstate, chunks[s, i], JSC)
            np.testing.assert_allclose(got[i, s], np.asarray(ref), **TOL)
        for name in tstream.StreamState._fields:
            np.testing.assert_allclose(
                getattr(state, name)[s].numpy(),
                np.asarray(getattr(jstate, name)), rtol=1e-4, atol=1e-4,
                err_msg=name)


def test_streaming_converges_to_offline_extractor(rng):
    sig = _speech_like(rng, seconds=2.0)
    n = len(sig) // TSC.chunk_samples
    feats, _ = _port_run(TSC, sig[: n * 2048].reshape(1, n, 2048))
    offline = taf.extract_utterance_features(
        torch.from_numpy(sig[: n * 2048]), TFE).numpy()
    corr = np.corrcoef(feats[-1, 0], offline)[0, 1]
    assert corr > 0.99, corr
    assert np.abs(feats[-1, 0] - offline).mean() < 0.1


def test_streaming_chunking_invariance(rng):
    """Same audio split into different chunk counts → same final stats."""
    sig = _speech_like(rng, seconds=1.0)[: 4 * 2048]

    def run(chunk_samples):
        sc = tstream.StreamingConfig(frontend=TFE, chunk_samples=chunk_samples)
        n = len(sig) // chunk_samples
        return _port_run(sc, sig.reshape(1, n, chunk_samples))[0][-1, 0]

    np.testing.assert_allclose(run(2048), run(1024), atol=1e-4)


@pytest.mark.parametrize("chunk,fe,match", [
    (100, TFE, "multiple"),
    (128, TFE, "cover one FFT"),
    (1024, taf.AudioFrontendConfig(), "frames/chunk"),
])
def test_streaming_config_validation(chunk, fe, match):
    with pytest.raises(ValueError, match=match):
        tstream.StreamingConfig(frontend=fe, chunk_samples=chunk)


def test_welford_merge_survives_long_high_offset_streams():
    """Running (mean, M2) moments keep the variance where a naive f32
    sum-of-squares cancels: mean >> std over ~1e5 samples."""
    rng = np.random.default_rng(0)
    F, D, K = 64, 4, 2000
    true_mean, true_std = 1000.0, 0.1
    stats = torch.zeros(1, 2, D)
    naive = np.zeros((2, D), np.float32)
    n = torch.zeros(1)
    for _ in range(K):
        x = rng.normal(true_mean, true_std, size=(F, D)).astype(np.float32)
        stats = tstream._merge_moments(stats, n, torch.from_numpy(x)[None],
                                       1.0, torch.full((1,), float(F)))
        n = n + F
        naive[0] += x.sum(0)
        naive[1] += (x ** 2).sum(0)
    mean, std = tstream._mean_std(stats, n)
    np.testing.assert_allclose(mean[0].numpy(), true_mean, rtol=1e-5)
    np.testing.assert_allclose(std[0].numpy(), true_std, rtol=0.05)
    total = float(n)
    naive_std = np.sqrt(np.maximum(
        naive[1] / total - (naive[0] / total) ** 2, 0.0))
    assert np.all(np.abs(naive_std - true_std) / true_std > 0.5), naive_std


def test_empty_voiced_batch_keeps_stats():
    """One stream with no voiced frames keeps its moments; another in the
    same call merges."""
    stats = torch.tensor([[[5.0], [2.0]], [[5.0], [2.0]]])
    w = torch.tensor([[0.0] * 4, [1.0] * 4])[..., None]
    out = tstream._merge_moments(stats, torch.tensor([10.0, 10.0]),
                                 torch.ones(2, 4, 1), w,
                                 torch.tensor([0.0, 4.0]))
    np.testing.assert_allclose(out[0].numpy(), stats[0].numpy())
    assert not torch.equal(out[1], stats[1])


# ---------------------------------------------------------------------------
# StreamingRecognizer
# ---------------------------------------------------------------------------
def _detectors(rng):
    """The reference's and the port's detector, fitted on the same rows."""
    fit = (rng.normal(size=(256, 84)).astype(np.float32),
           rng.normal(size=(256, 8)).astype(np.float32),
           rng.normal(size=(256, 8)).astype(np.float32))
    return (jood.MahalanobisOOD().fit_modalities(*fit),
            tood.MahalanobisOOD().fit_modalities(*fit))


def test_recognizer_push_matches_jax(rng):
    """Four ticks with OOD, context vectors, one tick with inactive slots
    and a reset between ticks: every output key equals the reference's."""
    jmodel, params, model = _models()
    det, port_det = _detectors(rng)
    jrec = jstream.StreamingRecognizer(jmodel, params, n_streams=S, cfg=JSC,
                                       ood_detector=det, ood_fpr=0.05)
    rec = tstream.StreamingRecognizer(model, n_streams=S, cfg=TSC,
                                      ood_detector=port_det, ood_fpr=0.05,
                                      device="cpu")
    assert rec.ood_threshold == jrec.ood_threshold
    sig = np.stack([_speech_like(rng, 0.6) for _ in range(S)])
    video = rng.normal(size=(S, 8)).astype(np.float32)
    text = rng.normal(size=(S, 8)).astype(np.float32)
    for tick in range(4):
        chunks = sig[:, tick * 2048:(tick + 1) * 2048]
        active = np.array([True, tick != 1, tick != 2])
        if tick == 3:
            jrec.reset_streams([1])
            rec.reset_streams([1])
        ref = jrec.push(chunks, video, text, active)
        got = rec.push(chunks, video, text, active)
        assert set(got) == set(ref) == {
            "features", "mu", "uncertainty", "calibrated_uncertainty",
            "expected_abs_error", "ood_score"}
        for key in ref:
            assert got[key].shape == ref[key].shape, key
            np.testing.assert_allclose(got[key], ref[key], **TOL,
                                       err_msg=f"tick {tick} {key}")


def test_recognizer_streams_independent_and_reset(rng):
    _, _, model = _models()
    rec = tstream.StreamingRecognizer(model, n_streams=3, cfg=TSC,
                                      device="cpu")
    sig_a = _speech_like(rng, seconds=1.0)[: 2 * 2048]
    sig_b = rng.normal(size=2 * 2048).astype(np.float32)
    for i in range(2):
        s = slice(i * 2048, (i + 1) * 2048)
        out = rec.push(np.stack([sig_a[s], sig_b[s], sig_b[s]]))
    np.testing.assert_allclose(out["features"][1], out["features"][2],
                               atol=1e-6)
    assert np.abs(out["features"][0] - out["features"][1]).max() > 1e-3
    rec.reset_streams([1])
    fresh = tstream.StreamingRecognizer(model, n_streams=3, cfg=TSC,
                                        device="cpu")
    s0 = slice(0, 2048)
    out_fresh = fresh.push(np.stack([sig_a[s0]] * 3))
    out_replay = rec.push(np.stack([sig_b[s0], sig_a[s0], sig_b[s0]]))
    np.testing.assert_allclose(out_replay["features"][1],
                               out_fresh["features"][0], atol=1e-5)
    rec.reset_streams([])  # no-op


@pytest.mark.parametrize("case", ["bad_shape", "fused_detector", "no_key"])
def test_recognizer_edges(case, rng):
    _, _, model = _models()
    if case == "fused_detector":
        det = tood.MahalanobisOOD().fit(rng.normal(size=(64, 8)))
        with pytest.raises(ValueError, match="input_norm"):
            tstream.StreamingRecognizer(model, n_streams=2, cfg=TSC,
                                        ood_detector=det, device="cpu")
        return
    rec = tstream.StreamingRecognizer(model, n_streams=2, cfg=TSC,
                                      device="cpu")
    if case == "bad_shape":
        with pytest.raises(ValueError):
            rec.push(np.zeros((3, 2048), np.float32))
    else:
        assert "ood_score" not in rec.push(np.zeros((2, 2048), np.float32))


# ---------------------------------------------------------------------------
# eval/ood.py
# ---------------------------------------------------------------------------
def test_ood_detector_matches_jax(rng, tmp_path):
    """Same fit, scores, thresholds and calibration as the reference, and
    the .npz format is shared both ways."""
    feats = rng.normal(size=(40, 12)).astype(np.float32)
    held_out = rng.normal(size=(30, 12)).astype(np.float32)
    for jdet, tdet in ((jood.MahalanobisOOD(), tood.MahalanobisOOD()),
                       (jood.MahalanobisOOD(shrinkage=0.2, space="input_norm"),
                        tood.MahalanobisOOD(shrinkage=0.2, space="input_norm"))):
        jdet.fit(feats)
        tdet.fit(feats)
        for a, b in zip(tdet.device_arrays, jdet.device_arrays):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tdet.score(held_out),
                                      jdet.score(held_out))
        assert tdet.threshold(0.05) == jdet.threshold(0.05)
        jdet.calibrate(held_out)
        tdet.calibrate(held_out)
        assert tdet.threshold(0.1) == jdet.threshold(0.1)
        np.testing.assert_array_equal(tdet.is_ood(held_out),
                                      jdet.is_ood(held_out))
    jdet.save(str(tmp_path / "j.npz"))
    tdet.save(str(tmp_path / "t.npz"))
    for loaded, other in ((tood.MahalanobisOOD.load(str(tmp_path / "j.npz")),
                           jdet),
                          (jood.MahalanobisOOD.load(str(tmp_path / "t.npz")),
                           tdet)):
        assert loaded.space == other.space == "input_norm"
        assert loaded.threshold(0.1) == other.threshold(0.1)
    s_in, s_out = rng.normal(size=50), rng.normal(1.0, size=40)
    assert tood.ood_auroc(s_in, s_out) == jood.ood_auroc(s_in, s_out)
    with pytest.raises(ValueError, match="input_norm"):
        tood.MahalanobisOOD().fit(feats).score_modalities(feats)


def test_ood_device_twins_match_numpy(rng):
    a, v, t = (rng.normal(size=(6, d)).astype(np.float32) for d in (84, 8, 8))
    det = tood.MahalanobisOOD().fit_modalities(
        *(rng.normal(size=(64, d)).astype(np.float32) for d in (84, 8, 8)))
    feats = tood.input_norm_features_device(
        *(torch.from_numpy(x) for x in (a, v, t)))
    np.testing.assert_allclose(feats.numpy(),
                               jood.input_norm_features(a, v, t), **TOL)
    mean, whitener = (torch.from_numpy(x) for x in det.device_arrays)
    np.testing.assert_allclose(
        tood.mahalanobis_score_device(feats, mean, whitener).numpy(),
        det.score_modalities(a, v, t), rtol=1e-4, atol=1e-3)
