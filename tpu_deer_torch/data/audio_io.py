"""WAV loading and resampling, as the reference's `tpu_deer/data/audio_io.py`.

`load_wav` decodes through the native decoder first (`data/native.py`: one
pass of decode, mix-down and resample that releases the GIL) and falls back
to scipy (`wavfile.read`, then `resample_poly`) where the decoder is
unavailable or cannot read the file. The two resample differently: at the
target rate they give the same float32 samples (16-bit PCM scaled by
1/32768 on both sides), at another rate they do not, so the decoder used is
part of the result. `load_wav_with_decoder` says which one decoded a file.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from tpu_deer_torch.data.native import load_wav_native


def load_wav_with_decoder(path: str, target_sr: int = 16000,
                          mono: bool = True) -> tuple[np.ndarray, str]:
    """(float32 samples in [-1, 1] at target_sr, "native" or "scipy"). The
    native decoder always mixes to mono, as the reference's."""
    native = load_wav_native(path, target_sr)
    if native is not None:
        return native, "native"
    return load_wav_scipy(path, target_sr, mono), "scipy"


def load_wav_scipy(path: str, target_sr: int = 16000,
                   mono: bool = True) -> np.ndarray:
    """The scipy decoder alone: `wavfile.read`, the mix-down, then
    `resample_poly` to target_sr."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if mono and audio.ndim > 1:
        audio = audio.mean(axis=1)
    if sr != target_sr:
        g = math.gcd(sr, target_sr)
        audio = resample_poly(audio, target_sr // g, sr // g).astype(np.float32)
    return audio


def load_wav(path: str, target_sr: int = 16000, mono: bool = True) -> np.ndarray:
    """Load a wav file → float32 in [-1, 1] at target_sr."""
    return load_wav_with_decoder(path, target_sr, mono)[0]


def decoder_of(decoders) -> str:
    """One name for the decoders of a load: "native" where every file went
    through the native decoder, else "scipy"."""
    return "native" if all(d == "native" for d in decoders) else "scipy"
