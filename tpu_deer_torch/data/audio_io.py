"""WAV loading and resampling on scipy (own copy of the scipy path of
`tpu_deer/data/audio_io.py`; the reference's native decoder is not ported).

16-bit PCM is scaled by 1/32768, as the native decoder scales it, so both
give the same float32 samples.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str, target_sr: int = 16000, mono: bool = True) -> np.ndarray:
    """Load a wav file → float32 in [-1, 1] at target_sr."""
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
