"""The port's WAV loading (`data/native.py`, `data/audio_io.py`) against the
JAX package's on the CPU: the native decoder built from native/wavio.cpp
into build/native/, the port's `load_wav` equal to the reference's in every
sample where both decode natively (16, 44.1 and 48 kHz; mono and stereo;
16-bit PCM and float32), the fallback to scipy with one warning, and the
loaders recording their decoder.
"""

import logging
import os

import numpy as np
import pytest
from scipy.io import wavfile

from tpu_deer.data import audio_io as jaudio_io
from tpu_deer.data import native as jnative
from tpu_deer_torch.data import audio_io, native
from tpu_deer_torch.data.features import MultimodalFeatureExtractor
from tpu_deer_torch.data.raw_corpus import generate_raw_fixture_ravdess
from tpu_deer_torch.data.ravdess import load_ravdess


def _write(path, sr, channels, kind, seed):
    """One second of noise (std 3000 in int16 units) as a wav."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(sr, channels) if channels > 1 else sr) * 3000
    data = (np.clip(x, -32768, 32767).astype(np.int16) if kind == "pcm16"
            else (x / 32768).astype(np.float32))
    wavfile.write(path, sr, data)
    return path


@pytest.fixture
def no_native(monkeypatch):
    """Both packages without their native decoders (scipy decodes)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", True)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_failed", True)


@pytest.mark.parametrize("kind", ["pcm16", "float32"])
@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
@pytest.mark.parametrize("sr", [16000, 44100, 48000])
def test_load_wav_equals_reference(sr, channels, kind, tmp_path):
    path = _write(str(tmp_path / "a.wav"), sr, channels, kind, seed=sr + channels)
    assert jnative.get_lib() is not None  # the reference decodes natively too
    got, decoder = audio_io.load_wav_with_decoder(path)
    assert decoder == "native"
    want = jaudio_io.load_wav(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(audio_io.load_wav(path), got)
    assert got.shape == (16000,)


def test_build_is_keyed_and_stays_out_of_native(tmp_path, monkeypatch):
    """The library is built into its build directory under a name that
    hashes the source and flags, and nothing is written into native/."""
    before = sorted(os.listdir(native.SOURCE.parent))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    target = native.build()
    assert target.parent == tmp_path / "native" and target.exists()
    assert target.name.startswith("libwavio_") and target.suffix == ".so"
    assert native.build() == target  # built once
    assert sorted(os.listdir(native.SOURCE.parent)) == before
    assert native.library_path().name == target.name


def test_fallback_to_scipy_warns_and_matches_reference(no_native, tmp_path,
                                                      caplog, monkeypatch):
    path = _write(str(tmp_path / "b.wav"), 44100, 2, "pcm16", seed=1)
    got, decoder = audio_io.load_wav_with_decoder(path)
    assert decoder == "scipy"
    np.testing.assert_array_equal(got, jaudio_io.load_wav(path))
    stereo, _ = audio_io.load_wav_with_decoder(path, mono=False)
    assert stereo.shape[1] == 2
    # A decoder that fails to build warns once and records the fallback.
    monkeypatch.setattr(native, "_failed", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.get_lib() is None and native.get_lib() is None
    assert sum("decoding with scipy" in r.message for r in caplog.records) == 1
    assert audio_io.decoder_of(["native", "scipy"]) == "scipy"
    assert audio_io.decoder_of(["native", "native"]) == "native"


@pytest.mark.parametrize("decoder", ["native", "scipy"])
def test_loader_records_its_decoder(decoder, tmp_path, request):
    """A 48 kHz RAVDESS-layout corpus: the load records the decoder it used,
    and its wavs come out at 16 kHz."""
    if decoder == "scipy":
        request.getfixturevalue("no_native")
    root = generate_raw_fixture_ravdess(str(tmp_path / "rav"), n_per_actor=1,
                                        duration_s=0.3, sample_rate=48000)
    out = load_ravdess(root, extractor=MultimodalFeatureExtractor(device="cpu"),
                       cache_dir=str(tmp_path / "cache"))
    assert out["decoder"] == decoder
    first = out["train"].arrays["audio"][0]
    signal = audio_io.load_wav(sorted(
        p for p in (tmp_path / "rav").rglob("*.wav"))[0].as_posix())
    assert signal.shape == (4800,) and np.all(np.isfinite(first))
