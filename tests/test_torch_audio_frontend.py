"""The port's audio front-end (tpu_deer_torch.ops.audio_frontend) against the
JAX reference on the CPU.

On the CPU the port runs K1's plain twin (unfold + matmuls); the reference
runs its `path="frames"` numerics and its Pallas kernel in interpret mode.
Tolerances are the ones tests/test_audio_frontend.py uses between the
reference's own paths: float32 sums over 1024 samples taken in another
order (power/logmel rtol 2e-4, atol 1e-3 — power reaches ~1e4 here; mfcc
rtol 2e-3, atol 5e-3 after the DCT mixes 40 log-mel bands; timefeats rtol
1e-4, atol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_deer.ops import audio_frontend as jaf
from tpu_deer_torch.kernels.mfcc_signal import mfcc_signal, mfcc_signal_plain
from tpu_deer_torch.ops import audio_frontend as taf

torch.set_num_threads(1)

JCFG = jaf.AudioFrontendConfig()
TCFG = taf.AudioFrontendConfig()
TOL = {  # output index → (rtol, atol)
    0: (2e-3, 5e-3),  # mfcc
    1: (2e-4, 1e-3),  # logmel
    2: (2e-4, 1e-3),  # power
    3: (1e-4, 1e-5),  # timefeats (RMS, ZCR)
}


def _mix(rng, n, f0=170.0):
    t = np.arange(n) / 16000.0
    sig = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.normal(size=n)
    return sig.astype(np.float32)


def _signals(case, rng):
    if case == "tone_noise":
        return _mix(rng, 12000)
    if case == "odd_length":
        return _mix(rng, 9001, f0=230.0)
    return np.stack([_mix(rng, 8000, f0) for f0 in (120.0, 200.0, 310.0)])


@pytest.mark.parametrize("jax_path", ["frames", "pallas"])
@pytest.mark.parametrize("case", ["tone_noise", "odd_length", "batch3"])
def test_plain_mfcc_matches_jax(case, jax_path, rng):
    sig = _signals(case, rng)
    kwargs = {"interpret": True} if jax_path == "pallas" else {}
    ref = jaf.mfcc_from_signal(jnp.asarray(sig), JCFG, path=jax_path, **kwargs)
    out = taf.mfcc_from_signal(torch.from_numpy(sig), TCFG)
    for i, (r, o) in enumerate(zip(ref, out)):
        assert o.shape == r.shape
        rtol, atol = TOL[i]
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=rtol, atol=atol)


def test_utterance_features_batch_matches_jax(rng):
    """[B, T] through one front-end call vs the reference per utterance.
    rtol 1e-4 as the reference's own batched-vs-single test; atol 1e-5
    because the vector is normalized to unit variance, so entries near zero
    carry float32 rounding of the unit scale, not of themselves."""
    sig = np.stack([_mix(rng, 24000, f0) for f0 in (110.0, 180.0, 260.0)])
    got = taf.extract_utterance_features_batch(torch.from_numpy(sig), TCFG)
    assert got.shape == (3, taf.FEATURE_DIM)
    for i in range(3):
        ref = jaf.extract_utterance_features(jnp.asarray(sig[i]), JCFG)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)


def test_single_utterance_matches_batch_row(rng):
    sig = _mix(rng, 16000)
    one = taf.extract_utterance_features(torch.from_numpy(sig), TCFG)
    batch = taf.extract_utterance_features_batch(
        torch.from_numpy(np.stack([sig, sig[::-1].copy()])), TCFG)
    np.testing.assert_allclose(one.numpy(), batch[0].numpy(), rtol=1e-6, atol=1e-6)


def test_derived_features_match_jax(rng):
    """deltas, spectral summaries and F0 (with median voicing) on the same
    power spectrum; rtol 1e-4 for float32 reductions in another order."""
    sig = _mix(rng, 16000, f0=200.0)
    _, _, power, _ = jaf.mfcc_from_signal(jnp.asarray(sig), JCFG, path="frames")
    tp = torch.from_numpy(np.array(power))[None]
    for ref, got in zip(jaf.spectral_summaries(power, JCFG),
                        taf.spectral_summaries(tp, TCFG)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-3)
    for median in (False, True):
        f0_ref, v_ref = jaf.f0_autocorrelation(power, JCFG, median_voicing=median)
        f0, v = taf.f0_autocorrelation(tp, TCFG, median_voicing=median)
        np.testing.assert_array_equal(v[0].numpy(), np.asarray(v_ref))
        np.testing.assert_allclose(f0[0].numpy(), np.asarray(f0_ref),
                                   rtol=1e-4, atol=1e-3)
    x = rng.normal(size=(20, 13)).astype(np.float32)
    np.testing.assert_allclose(
        taf.deltas(torch.from_numpy(x)[None], 9)[0].numpy(),
        np.asarray(jaf.deltas(jnp.asarray(x), 9)), rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_is_the_plain_twin(rng):
    x_pad, _ = taf._pad_for_frames(
        torch.from_numpy(np.stack([_mix(rng, 6000)] * 2)), TCFG)
    bases = taf._device_bases(TCFG, x_pad.device)
    before = mfcc_signal.launches
    for a, b in zip(mfcc_signal(x_pad, bases, 1024, 256),
                    mfcc_signal_plain(x_pad, bases, 1024, 256)):
        assert torch.equal(a, b)
    assert mfcc_signal.launches == before  # no kernel ran


def test_wrapper_rejects_n_fft_not_multiple_of_hop():
    cfg = taf.AudioFrontendConfig(hop_length=300)
    x_pad = torch.zeros(1, 4096)
    with pytest.raises(ValueError, match="n_fft % hop"):
        mfcc_signal(x_pad, taf._device_bases(cfg, x_pad.device), 1024, 300)


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "rank3"])
def test_wrapper_rejects_bad_input(bad):
    bases = taf._device_bases(TCFG, torch.device("cpu"))
    x = torch.zeros(2, 4096)
    x = {"float64": x.double(), "non_contiguous": torch.zeros(4096, 2).t(),
         "rank3": x[None]}[bad]
    with pytest.raises((TypeError, ValueError)):
        mfcc_signal(x, bases, 1024, 256)


@pytest.mark.parametrize("n_fft", [512, 1024])
def test_mel_band_table_covers_the_nonzeros(n_fft):
    """The kernels' band table: filter m's nonzero bins are exactly
    [lo_m, hi_m)."""
    bases = taf._device_bases(taf.AudioFrontendConfig(n_fft=n_fft),
                              torch.device("cpu"))
    mel, band = bases["mel"], bases["mel_band"]
    assert band.dtype == torch.int32 and tuple(band.shape) == (2, mel.shape[1])
    inside = torch.zeros(mel.shape, dtype=torch.bool)
    for m, (lo, hi) in enumerate(band.t().tolist()):
        assert lo < hi
        inside[lo:hi, m] = True
    assert torch.equal(inside, mel != 0)


@pytest.mark.parametrize("n_fft", [512, 1024])
def test_banded_mel_product_equals_dense(n_fft, rng):
    """Each filter summed over its band only, in ascending bin order (the
    kernels' mel product), equals the dense product taken in the same order
    over every bin bit for bit (a sequential float32 sum: the skipped terms
    are exact zeros), and power @ mel within float32 rounding."""
    bases = taf._device_bases(taf.AudioFrontendConfig(n_fft=n_fft),
                              torch.device("cpu"))
    mel, band = bases["mel"], bases["mel_band"]
    power = torch.from_numpy(
        (100.0 * rng.exponential(size=(64, mel.shape[0]))).astype(np.float32))
    dense = torch.zeros(64, mel.shape[1])
    for k in range(mel.shape[0]):
        dense = dense + power[:, k:k + 1] * mel[k]
    banded = torch.zeros(64, mel.shape[1])
    for m, (lo, hi) in enumerate(band.t().tolist()):
        acc = torch.zeros(64)
        for k in range(lo, hi):
            acc = acc + power[:, k] * mel[k, m]
        banded[:, m] = acc
    assert torch.equal(banded, dense)
    torch.testing.assert_close(banded, power @ mel, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["hole", "three_to_a_bin"])
def test_mel_bands_reject_a_table_the_kernels_cannot_stage(bad):
    mel = np.zeros((9, 3), dtype=np.float32)
    if bad == "hole":
        mel[[2, 4], 0] = 1.0  # bin 3 is zero inside filter 0's band
        match = "zero inside"
    else:
        mel[:, :] = 1.0  # every bin in all three filters
        match = "overlap"
    with pytest.raises(ValueError, match=match):
        taf.mel_bands(mel)


def test_short_signal_raises():
    """Reflect padding by n_fft // 2 needs more samples than that; the port
    raises where the reference would reflect repeatedly."""
    with pytest.raises(ValueError, match="reflect"):
        taf.mfcc_from_signal(torch.zeros(512), TCFG)
