"""DSP basis matrices: window, real-DFT, mel filterbank, DCT-II, delta kernel.

The port's own copy of `tpu_deer/ops/dsp.py` (numpy only, unchanged
formulas), so that `tpu_deer_torch` imports nothing of the JAX package.
Everything the audio front-end needs is a dense matrix built once on the
host; the front-end turns it into device tensors and feeds it to the MFCC
kernel (`tpu_deer_torch.kernels.mfcc_signal`) or to plain matmuls.

Formulas follow the standard definitions (Slaney-style mel filterbank and
orthonormal DCT-II, matching librosa defaults).
"""

from __future__ import annotations

import numpy as np


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (matches np.hanning's symmetric variant is NOT
    used; librosa/scipy stft default is periodic)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def rdft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis: frames[N, n_fft] @ cos -> real part, @ sin -> -imag.

    Returns (cos[n_fft, n_bins], sin[n_fft, n_bins]) with n_bins = n_fft//2+1
    so that power = (f@cos)^2 + (f@sin)^2 equals |rfft(f)|^2.
    """
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = 2.0 * np.pi * t * k / n_fft
    return np.cos(angle), -np.sin(angle)


def hz_to_mel(f):
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    safe_f = np.maximum(f, 1e-10)
    return np.where(
        f >= min_log_hz, min_log_mel + np.log(safe_f / min_log_hz) / logstep, mel
    )


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    f = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f
    )


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank [n_bins, n_mels]."""
    fmax = fmax or sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))

    fb = np.zeros((n_bins, n_mels))
    for m in range(n_mels):
        lo, ctr, hi = mel_pts[m], mel_pts[m + 1], mel_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
        # Slaney area normalization
        fb[:, m] *= 2.0 / (hi - lo)
    return fb


def dct_matrix(n_mels: int, n_mfcc: int) -> np.ndarray:
    """Orthonormal DCT-II basis [n_mels, n_mfcc] (librosa norm='ortho')."""
    n = np.arange(n_mels)[:, None]
    k = np.arange(n_mfcc)[None, :]
    d = np.cos(np.pi * (2 * n + 1) * k / (2.0 * n_mels))
    d *= np.sqrt(2.0 / n_mels)
    d[:, 0] *= np.sqrt(0.5)
    return d


def delta_kernel(width: int = 9) -> np.ndarray:
    """Regression (Savitzky-Golay order-1) delta filter of odd width.

    delta[t] = sum_{d=1..W} d * (x[t+d] - x[t-d]) / (2 * sum d^2)
    — the formula behind librosa.feature.delta's default mode.
    """
    assert width % 2 == 1
    half = width // 2
    d = np.arange(-half, half + 1, dtype=np.float64)
    return d / np.sum(d * d)


def idft_lag_matrix(n_fft: int, max_lag: int) -> np.ndarray:
    """Inverse-DFT basis restricted to lags [0, max_lag): power[N, n_bins] @
    this -> autocorrelation[N, max_lag] (Wiener-Khinchin).

    For a real signal, autocorr(l) = (1/n) * sum_k power[k] * cos(2*pi*k*l/n)
    with the redundant upper half of the spectrum folded in (bins 1..n/2-1
    count twice, DC and Nyquist once).
    """
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[:, None]
    l = np.arange(max_lag)[None, :]
    basis = np.cos(2.0 * np.pi * k * l / n_fft)
    weights = np.full((n_bins, 1), 2.0)
    weights[0] = 1.0
    if n_fft % 2 == 0:
        weights[-1] = 1.0
    return (basis * weights) / n_fft
