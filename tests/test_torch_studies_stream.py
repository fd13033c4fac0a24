"""The streaming study's twin (`tpu_deer_torch/experiments/streaming_demo.py`)
on the CPU: its signal generator is the reference's draw for draw; its
K-tick chain (the device-source capacity graph's function) equals K
sequential `streaming_update` calls and the reference's update on the
converted state (rtol 1e-4, atol 1e-5 for the features, as
tests/test_torch_stream.py holds them; the state's raw moments at rtol
1e-4, atol 1e-4); and its `--quick` run writes the reference's table."""

import functools
import os

import jax
import numpy as np
import torch

from experiments import streaming_demo as ref_stream
from tpu_deer import stream as jstream
from tpu_deer.ops import audio_frontend as jaf
from tpu_deer_torch import stream as tstream
from tpu_deer_torch.experiments import streaming_demo
from tpu_deer_torch.models.deer_model import create_complete_deer_model, DEERModelConfig
from tpu_deer_torch.ops import audio_frontend as taf

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
JSC = jstream.StreamingConfig(
    frontend=jaf.AudioFrontendConfig(n_fft=512, hop_length=128),
    chunk_samples=2048)
TSC = tstream.StreamingConfig(
    frontend=taf.AudioFrontendConfig(n_fft=512, hop_length=128),
    chunk_samples=2048)
NARROW = DEERModelConfig(audio_dim=84, video_dim=8, text_dim=8, encoder_dim=16,
                         fusion_dim=32, attention_heads=2, encoder_layers=1)
S, K = 3, 4


def test_speech_like_is_the_reference_generator():
    got = streaming_demo.speech_like(np.random.default_rng(7), 3, 0.3, 16000)
    want = ref_stream.speech_like(np.random.default_rng(7), 3, 0.3, 16000)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def _jax_update():
    """The reference's update of S streams at once, jitted (one compile)."""
    return jax.jit(jax.vmap(lambda s, c: jstream.streaming_update(s, c, JSC)))


def test_tick_chain_matches_sequential_updates_and_jax():
    """From a state one tick in (so the carries are not zero), K ticks of
    S streams: the chain's features, μ and final state equal K sequential
    `streaming_update` calls and forwards (the same ops: every bit), and
    the reference's updates from the converted state."""
    rng = np.random.default_rng(3)
    audio = streaming_demo.speech_like(rng, S, (K + 1) * 2048 / 16000, 16000)
    chunks = torch.from_numpy(audio.reshape(S, K + 1, 2048).transpose(1, 0, 2)
                              .copy())
    model = create_complete_deer_model(NARROW, seed=0, device="cpu")
    with torch.inference_mode():
        state, _ = tstream.streaming_update(
            tstream.init_stream_state(TSC, S, "cpu"), chunks[0], TSC)
        end, feats, mu = streaming_demo.tick_chain(
            model, state, lambda k: chunks[k + 1], K, TSC)
        assert feats.shape == (K, S, 84) and mu.shape == (K, S, 3)
        seq = state
        for k in range(K):
            seq, f = tstream.streaming_update(seq, chunks[k + 1], TSC)
            z = lambda d: torch.zeros(S, d)
            out = model(f, z(8), z(8))
            assert torch.equal(feats[k], f) and torch.equal(mu[k], out["mu_all"])
        for a, b in zip(end, seq):
            assert torch.equal(a, b)

    jstate = jstream.StreamState(*(np.asarray(x) for x in state))
    for k in range(K):
        jstate, ref = _jax_update()(jstate, chunks[k + 1].numpy())
        np.testing.assert_allclose(feats[k].numpy(), np.asarray(ref), **TOL)
    for name in tstream.StreamState._fields:
        np.testing.assert_allclose(getattr(end, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_streaming_demo_quick_writes_the_reference_table(tmp_path):
    """`--quick --platform cpu`: S 2 and 4 at full width, the K-tick chain
    at S 4; the table's columns are the reference's
    (`experiments/RESULTS_stream.md`), the streamed features track the
    offline extractor, the per-tick μ are finite."""
    out = str(tmp_path / "stream")
    assert streaming_demo.main(["--quick", "--platform", "cpu", "--out", out]) == 0
    with open(os.path.join(ROOT, "experiments", "RESULTS_stream.md")) as f:
        ref_lines = f.read().splitlines()
    with open(out + ".md") as f:
        lines = f.read().splitlines()
    header = next(l for l in ref_lines if l.startswith("| concurrent"))
    assert header == streaming_demo.TABLE_HEADER and header in lines
    rows = [l for l in lines if l.startswith("| 2 |") or l.startswith("| 4 |")]
    assert len(rows) == 2
    import json

    with open(out + ".json") as f:
        payload = json.load(f)
    assert [r["streams"] for r in payload["rows"]] == [2, 4]
    assert payload["feature_corr"] > 0.99
    dev = payload["device_source"]
    assert dev["streams"] == 4 and dev["ticks"] == 4
    assert len(dev["mu_mean"]) == 4 and np.isfinite(dev["mu_mean"]).all()
