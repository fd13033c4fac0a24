"""The port's enhanced 84-d utterance vector and the front-end's conv and
frames routes against the JAX package on the CPU, on the signals of
tests/test_audio_frontend.py's enhanced-feature and fused-from-signal
cases (tones at 220 Hz and 150 Hz, a 200/400/600 Hz harmonic stack, a
170 Hz tone in noise) and a noise burst.

Tolerance rtol 1e-4, atol 1e-5 (the port's standing one) for the vector
assembled from the same front-end products, for the conv and frames
routes, and end to end where the signal carries noise. A pure tone's
spectrum holds bins ~1e-7 of its peak, whose float32 DFT sums keep few
correct digits in any summation order, and the vector's spectral-contrast
and chroma entries read them: there the end-to-end bound is twice the
JAX package's own gap between its frames and conv routes on the same
signal (or the standing tolerance, where that is larger).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deer.ops import audio_frontend as jaf
from tpu_deer_torch.ops import audio_frontend as taf

torch.set_num_threads(1)

JCFG, TCFG = jaf.AudioFrontendConfig(), taf.AudioFrontendConfig()
TOL = dict(rtol=1e-4, atol=1e-5)


def _tone(freq, duration=1.0, sr=16000, amp=0.5):
    t = np.arange(int(duration * sr)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _signal(case):
    rng = np.random.default_rng(11)
    if case == "tone220":
        return _tone(220.0)
    if case == "tone150":
        return _tone(150.0, duration=0.5)
    if case == "harmonics":
        t = np.arange(16000) / 16000
        return sum(a * np.sin(2 * np.pi * f * t) for f, a in
                   ((200, 0.5), (400, 0.4), (600, 0.3))).astype(np.float32)
    if case == "tone_in_noise":
        return (0.4 * _tone(170.0, duration=0.75)[:12000]
                + 0.05 * rng.normal(size=12000)).astype(np.float32)
    return (0.1 * rng.normal(size=8000)).astype(np.float32)


CASES = ("tone220", "tone150", "harmonics", "tone_in_noise", "noise")
NOISY = ("tone_in_noise", "noise")
# The reference's vectors from its products (jitted: one compile a shape).
_j_vec = jax.jit(lambda *p: jaf._enhanced_vec(*p, JCFG))
_j_utterance = jax.jit(lambda m, p, t: jaf._utterance_vec(m, p, t, JCFG))


def _reference(sig, path="frames"):
    """The reference's enhanced vector through its `path` route; "frames"
    is extract_enhanced_utterance_features(use_pallas=False)."""
    return np.asarray(_j_vec(*jaf.mfcc_from_signal(jnp.asarray(sig), JCFG,
                                                   path=path)))


@pytest.mark.parametrize("case", CASES)
def test_enhanced_vector_matches_jax(case):
    sig = _signal(case)
    got = taf.extract_enhanced_utterance_features(torch.from_numpy(sig))
    assert got.shape == (84,) and torch.all(torch.isfinite(got))
    assert abs(float(got.mean())) < 1e-4
    # The assembly alone, from the same front-end products.
    products = taf.mfcc_from_signal(torch.from_numpy(sig))
    np.testing.assert_allclose(
        taf._enhanced_vec(*(p[None] for p in products), TCFG)[0].numpy(),
        np.asarray(_j_vec(*(jnp.asarray(p.numpy()) for p in products))),
        **TOL)
    want = _reference(sig)
    if case in NOISY:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        bound = np.maximum(2.0 * np.abs(want - _reference(sig, "conv")),
                           TOL["atol"] + TOL["rtol"] * np.abs(want))
        assert np.all(np.abs(got.numpy() - want) <= bound), np.flatnonzero(
            np.abs(got.numpy() - want) > bound)


def test_enhanced_batch_is_the_vmapped_reference():
    """[B, N] in, [B, 84] out from one front-end call: each row is the
    reference's function of that row (what its vmap computes)."""
    sigs = np.stack([_signal("tone_in_noise")[:8000], _signal("noise")])
    got = taf.extract_enhanced_utterance_features(torch.from_numpy(sigs))
    assert got.shape == (2, 84)
    for i in range(2):
        np.testing.assert_allclose(got[i].numpy(), _reference(sigs[i]), **TOL)
        single = taf.extract_enhanced_utterance_features(
            torch.from_numpy(sigs[i]))
        np.testing.assert_allclose(got[i].numpy(), single.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("path", ["conv", "frames"])
@pytest.mark.parametrize("case", NOISY)
def test_signal_routes_match_jax(path, case):
    sig = _signal(case)
    got = taf.mfcc_from_signal(torch.from_numpy(sig), path=path)
    want = jaf.mfcc_from_signal(jnp.asarray(sig), JCFG, path=path)
    for name, g, w in zip(("mfcc", "logmel", "power", "timefeats"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    # The feature extractors take the route: the 84-d vector through it.
    vec = taf.extract_utterance_features(torch.from_numpy(sig), path=path)
    ref = _j_utterance(want[0], want[2], want[3])
    np.testing.assert_allclose(vec.numpy(), np.asarray(ref), **TOL)


def test_paths_dispatch_and_refuse():
    sig = torch.from_numpy(_signal("noise"))
    k1 = taf.mfcc_from_signal(sig)
    for a, b in zip(k1, taf.mfcc_from_signal(sig, path="pallas")):
        assert torch.equal(a, b)  # "pallas" is K1 (its plain twin here)
    with pytest.raises(ValueError, match="unknown mfcc_from_signal path"):
        taf.mfcc_from_signal(sig, path="xla")
    frames = taf.audio_frame_features(sig, path="conv")
    assert frames.shape == taf.audio_frame_features(sig).shape


def test_spectral_peaks_find_harmonics():
    """A 200 Hz tone with strong harmonics → peaks near multiples of 200,
    ascending, as the reference's test finds them."""
    frames = taf.frame_signal(torch.from_numpy(_signal("harmonics")), TCFG)
    _, _, power = taf.mfcc_frames(frames, TCFG)
    freqs, mags = taf._spectral_peaks(power.mean(dim=0), TCFG, k=5)
    jfreqs, jmags = jaf._spectral_peaks(jnp.asarray(power.mean(dim=0).numpy()),
                                        JCFG, k=5)
    np.testing.assert_allclose(freqs.numpy(), np.asarray(jfreqs), **TOL)
    np.testing.assert_allclose(mags.numpy(), np.asarray(jmags), **TOL)
    found = freqs.numpy()[freqs.numpy() > 0]
    assert np.all(np.diff(found) > 0)
    for target in (200, 400, 600):
        assert np.min(np.abs(found - target)) < 40, (target, found)


def test_masked_stats_and_quantiles_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 40)).astype(np.float32) * 100
    mask = rng.random((3, 40)) > 0.5
    mask[2] = False  # no entry kept: min and max 0, quantile NaN
    got = taf._masked_stats(torch.from_numpy(x), torch.from_numpy(mask))
    for i in range(3):
        want = jaf._masked_stats(jnp.asarray(x[i]), jnp.asarray(mask[i]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), **TOL)
    nan = np.where(mask, x, np.nan)
    for q in (0.1, 0.25, 0.75, 0.9):
        np.testing.assert_allclose(
            taf._nanquantile(torch.from_numpy(nan), q).numpy(),
            np.asarray(jnp.nanquantile(jnp.asarray(nan), q, axis=-1)), **TOL)
