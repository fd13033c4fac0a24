"""Audio feature front-end: signal → MFCC/power/RMS/ZCR → 84-d utterance vector.

Port of `tpu_deer/ops/audio_frontend.py` for the serving and streaming
paths. Two fused entry points, each through a kernel's wrapper: a CUDA
tensor launches the kernel, a CPU tensor takes its plain twin, and
`plain=True` forces the plain twin on the card, to check the kernel.

  * `mfcc_from_signal` — kernel K1 (`tpu_deer_torch.kernels.mfcc_signal`):
    from the signal, frames never reach device memory; the plain twin is
    unfold + matmuls (the reference's `path="frames"` numerics).
  * `mfcc_frames` — kernel K2 (`tpu_deer_torch.kernels.mfcc_frames`): from
    frames the caller holds (the streaming tick); all leading axes go into
    the kernel's rows, one launch, as the reference's custom_vmap collapses
    the stream axis.

Everything downstream (framing, deltas, F0 by autocorrelation, spectral
centroid, RMS, ZCR, the 84-d utterance vector and the [N, 84] frame-feature
matrix of the raw sequence model) is plain tensor code over a batch
dimension written out where the reference vmaps. The enhanced vector is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_deer_torch.kernels import mfcc_frames as k2
from tpu_deer_torch.kernels.mfcc_signal import mfcc_signal, mfcc_signal_plain
from tpu_deer_torch.ops import dsp

EPS = 1e-10
FEATURE_DIM = 84


@dataclasses.dataclass(frozen=True)
class AudioFrontendConfig:
    sample_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 40
    n_mfcc: int = 13
    fmin: float = 0.0
    fmax: Optional[float] = None
    f0_min: float = 65.0  # ~C2
    f0_max: float = 520.0  # ~C5
    delta_width: int = 9

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def max_lag(self) -> int:
        return int(self.sample_rate / self.f0_min) + 1

    @property
    def min_lag(self) -> int:
        return max(1, int(self.sample_rate / self.f0_max))


@functools.lru_cache(maxsize=8)
def _bases(cfg: AudioFrontendConfig) -> dict[str, np.ndarray]:
    """Host-built DSP bases for a config (numpy float32; the mel band
    table int32)."""
    window = dsp.hann_window(cfg.n_fft)
    cos, sin = dsp.rdft_matrices(cfg.n_fft)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    mel = f32(dsp.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                                 cfg.fmin, cfg.fmax))
    return {
        "window": f32(window),
        # Row 1 of cos/sin is the kernels' FFT twiddle table.
        "cos": f32(cos),
        "sin": f32(sin),
        "mel": mel,
        "mel_band": mel_bands(mel),
        "dct": f32(dsp.dct_matrix(cfg.n_mels, cfg.n_mfcc)),
        "lags": f32(dsp.idft_lag_matrix(cfg.n_fft, cfg.max_lag)),
        "freqs": f32(np.linspace(0.0, cfg.sample_rate / 2.0, cfg.n_bins)),
    }


def mel_bands(mel: np.ndarray) -> np.ndarray:
    """int32 [2, n_mels]: each filter's first nonzero bin and one past its
    last (lo = hi = 0 for an empty filter), for the kernels' banded mel
    product. Raises unless each filter's nonzeros are one run and the runs
    hold at most 2 * n_bins weights (a bin lies in at most two triangles),
    which is what the kernels stage."""
    nz = mel != 0
    band = np.zeros((2, mel.shape[1]), dtype=np.int32)
    for m in range(mel.shape[1]):
        idx = np.flatnonzero(nz[:, m])
        if idx.size:
            band[:, m] = idx[0], idx[-1] + 1
        if idx.size != band[1, m] - band[0, m]:
            raise ValueError(f"mel filter {m} has a zero inside its band")
    if (band[1] - band[0]).sum() > 2 * mel.shape[0]:
        raise ValueError("mel filters overlap more than two to a bin")
    return band


@functools.lru_cache(maxsize=8)
def _device_bases(cfg: AudioFrontendConfig,
                  device: torch.device) -> dict[str, torch.Tensor]:
    """The bases as tensors on `device`, uploaded once per (config, device)."""
    return {k: torch.from_numpy(v).to(device) for k, v in _bases(cfg).items()}


def _pad_for_frames(signals: torch.Tensor, cfg: AudioFrontendConfig):
    """[B, T] → (reflect-padded [B, Tp], n_frames), as frame_signal pads.

    Reflect padding needs T > n_fft // 2. The reference's jnp.pad reflects
    repeatedly for shorter signals; this port raises for them instead
    (every bucketed input is at least 2 s long).
    """
    pad = cfg.n_fft // 2
    if signals.shape[-1] <= pad:
        raise ValueError(
            f"signals need more than n_fft // 2 = {pad} samples for reflect "
            f"padding, got {signals.shape[-1]}"
        )
    x = F.pad(signals[:, None, :], (pad, pad), mode="reflect")[:, 0]
    n_frames = 1 + (x.shape[-1] - cfg.n_fft) // cfg.hop_length
    return x.contiguous(), n_frames


def mfcc_from_signal(signals: torch.Tensor,
                     cfg: AudioFrontendConfig = AudioFrontendConfig(),
                     plain: bool = False):
    """signals [T] or [B, T] float32 → (mfcc, logmel, power, timefeats).

    timefeats[..., 0] = RMS of the windowed frame, [..., 1] = ZCR.
    Goes through K1's wrapper, which launches the kernel for a CUDA tensor
    and runs the plain twin for a CPU one; plain=True takes the plain twin
    on any device (to check the kernel against it on the card).
    """
    squeeze = signals.dim() == 1
    if squeeze:
        signals = signals[None]
    x_pad, _ = _pad_for_frames(signals, cfg)
    bases = _device_bases(cfg, x_pad.device)
    fn = mfcc_signal_plain if plain else mfcc_signal
    out = fn(x_pad, bases, cfg.n_fft, cfg.hop_length)
    if squeeze:
        out = tuple(a[0] for a in out)
    return out


def frame_signal(signal: torch.Tensor, cfg: AudioFrontendConfig) -> torch.Tensor:
    """signal [..., T] → frames [..., N, n_fft] (centered, reflect-padded;
    a view of the padded signal, not a copy)."""
    lead = signal.shape[:-1]
    x_pad, _ = _pad_for_frames(signal.reshape(-1, signal.shape[-1]), cfg)
    frames = x_pad.unfold(-1, cfg.n_fft, cfg.hop_length)
    return frames.reshape(*lead, *frames.shape[1:])


def mfcc_frames(frames: torch.Tensor,
                cfg: AudioFrontendConfig = AudioFrontendConfig(),
                plain: bool = False):
    """frames [..., n_fft] → (mfcc [..., n_mfcc], logmel [..., n_mels],
    power [..., n_bins]), one K2 launch over all leading axes on the card."""
    lead = frames.shape[:-1]
    rows = frames.reshape(-1, cfg.n_fft).contiguous()
    bases = _device_bases(cfg, rows.device)
    fn = k2.mfcc_frames_plain if plain else k2.mfcc_frames
    return tuple(a.reshape(*lead, a.shape[-1])
                 for a in fn(rows, bases, cfg.n_fft))


def zero_crossing_rate(frames: torch.Tensor) -> torch.Tensor:
    """Per-frame ZCR (fraction of sign changes)."""
    changes = torch.diff(torch.sign(frames), dim=-1) != 0
    return changes.to(torch.float32).mean(dim=-1)


def rms_energy(frames: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(frames), dim=-1))


# ---------------------------------------------------------------------------
# Derived features, batched over a leading utterance axis: [B, N, ...]
# ---------------------------------------------------------------------------
def deltas(x: torch.Tensor, width: int = 9) -> torch.Tensor:
    """Regression delta along the frame axis (-2) with edge replication —
    librosa.feature.delta's behaviour. x [..., N, F]."""
    kernel = torch.as_tensor(dsp.delta_kernel(width), dtype=x.dtype,
                             device=x.device)
    half = width // 2
    n = x.shape[-2]
    first = x[..., :1, :].expand(*x.shape[:-2], half, x.shape[-1])
    last = x[..., -1:, :].expand(*x.shape[:-2], half, x.shape[-1])
    padded = torch.cat([first, x, last], dim=-2)
    # output[t] = sum_d k[d] * x[t + d]
    windows = torch.stack([padded[..., i:i + n, :] for i in range(width)])
    return torch.einsum("w,w...->...", kernel, windows)


def spectral_summaries(power: torch.Tensor, cfg: AudioFrontendConfig):
    """Per-frame spectral centroid / rolloff / bandwidth from power
    [..., N, n_bins] (librosa.feature.spectral_* definitions)."""
    freqs = _device_bases(cfg, power.device)["freqs"]
    mag = torch.sqrt(torch.clamp(power, min=0.0))
    norm = torch.clamp(mag.sum(dim=-1, keepdim=True), min=EPS)
    centroid = (mag * freqs).sum(dim=-1, keepdim=True) / norm

    cum = torch.cumsum(mag, dim=-1)
    thresh = 0.85 * cum[..., -1:]
    # argmax of a boolean: cast to integers, first maximum wins as in jnp.
    rolloff = freqs[torch.argmax((cum >= thresh).to(torch.int32), dim=-1)]

    bandwidth = torch.sqrt(
        ((freqs - centroid) ** 2 * mag).sum(dim=-1, keepdim=True) / norm
    )
    return centroid[..., 0], rolloff, bandwidth[..., 0]


def f0_autocorrelation(power: torch.Tensor, cfg: AudioFrontendConfig,
                       voiced_threshold: float = 0.5,
                       median_voicing: bool = False):
    """Frame-level F0 via normalized autocorrelation (Wiener-Khinchin), with
    parabolic refinement of the integer-lag peak. power [..., N, n_bins].

    median_voicing=True smooths voicing with a 3-frame majority vote.
    Returns (f0 [..., N], voiced [..., N] bool); unvoiced frames get f0 = 0.
    """
    autocorr = power @ _device_bases(cfg, power.device)["lags"]
    r0 = torch.clamp(autocorr[..., 0:1], min=EPS)
    norm_ac = autocorr / r0
    lag_idx = torch.arange(norm_ac.shape[-1], device=power.device)
    valid = (lag_idx >= cfg.min_lag) & (lag_idx <= cfg.max_lag - 1)
    masked = torch.where(valid, norm_ac, torch.full_like(norm_ac, -torch.inf))
    best_lag = torch.argmax(masked, dim=-1, keepdim=True)
    best_val = torch.gather(norm_ac, -1, best_lag)[..., 0]
    # Vertex of the parabola through (l-1, y-), (l, y0), (l+1, y+).
    last = norm_ac.shape[-1] - 1
    ym = torch.gather(norm_ac, -1, torch.clamp(best_lag - 1, 0, last))[..., 0]
    yp = torch.gather(norm_ac, -1, torch.clamp(best_lag + 1, 0, last))[..., 0]
    best_lag = best_lag[..., 0]
    denom = ym - 2.0 * best_val + yp
    safe = torch.abs(denom) > 1e-12
    delta = torch.where(safe, 0.5 * (ym - yp) / torch.where(safe, denom, 1.0),
                        0.0)
    delta = torch.clamp(delta, -0.5, 0.5)
    interior = (best_lag > 0) & (best_lag < last)
    refined_lag = best_lag.to(torch.float32) + torch.where(interior, delta, 0.0)
    voiced = best_val > voiced_threshold
    if median_voicing:
        v = voiced.to(torch.float32)
        padded = torch.cat([v[..., :1], v, v[..., -1:]], dim=-1)
        voiced = (padded[..., :-2] + padded[..., 1:-1] + padded[..., 2:]) >= 2.0
    f0 = torch.where(
        voiced, cfg.sample_rate / torch.clamp(refined_lag, min=1.0), 0.0
    )
    return f0, voiced


def _utterance_vec(mfcc, power, timefeats, cfg: AudioFrontendConfig):
    """[B, N, ...] fused products → [B, 84] utterance vectors.

    Layout (the reference's canonical one):
      [ 0:13] MFCC mean     [13:26] MFCC std     [26:39] ΔMFCC mean
      [39:52] ΔMFCC std     [52:65] ΔΔMFCC mean  [65:78] ΔΔMFCC std
      [78] F0 mean (voiced) [79] F0 std (voiced) [80] RMS mean
      [81] RMS std          [82] ZCR mean        [83] spectral-centroid mean
    normalized to zero mean / unit variance over the vector. Every std is the
    population std (correction=0), as jnp.std.
    """
    d1 = deltas(mfcc, cfg.delta_width)
    d2 = deltas(d1, cfg.delta_width)

    f0, voiced = f0_autocorrelation(power, cfg)
    v = voiced.to(torch.float32)
    n_voiced = torch.clamp(v.sum(dim=-1), min=1.0)
    f0_mean = (f0 * v).sum(dim=-1) / n_voiced
    f0_std = torch.sqrt(torch.clamp(
        (v * (f0 - f0_mean[:, None]) ** 2).sum(dim=-1) / n_voiced, min=0.0))

    rms, zcr = timefeats[..., 0], timefeats[..., 1]
    centroid, _, _ = spectral_summaries(power, cfg)

    std = lambda x, dim: torch.std(x, dim=dim, correction=0)
    vec = torch.cat(
        [
            mfcc.mean(dim=1), std(mfcc, 1),
            d1.mean(dim=1), std(d1, 1),
            d2.mean(dim=1), std(d2, 1),
            torch.stack([
                f0_mean, f0_std,
                rms.mean(dim=1), std(rms, 1),
                zcr.mean(dim=1), centroid.mean(dim=1),
            ], dim=-1),
        ],
        dim=-1,
    )
    mean = vec.mean(dim=-1, keepdim=True)
    return (vec - mean) / (std(vec, -1)[:, None] + 1e-8)


def extract_utterance_features_batch(
    signals: torch.Tensor,
    cfg: AudioFrontendConfig = AudioFrontendConfig(),
    plain: bool = False,
) -> torch.Tensor:
    """signals [B, T] → [B, 84], one fused front-end launch for the batch."""
    mfcc, _, power, timefeats = mfcc_from_signal(signals, cfg, plain=plain)
    return _utterance_vec(mfcc, power, timefeats, cfg)


def extract_utterance_features(
    signal: torch.Tensor,
    cfg: AudioFrontendConfig = AudioFrontendConfig(),
    plain: bool = False,
) -> torch.Tensor:
    """signal [T] → 84-d feature vector (see _utterance_vec for the layout)."""
    return extract_utterance_features_batch(signal[None], cfg, plain=plain)[0]


def _frame_feature_matrix(mfcc, logmel, power, timefeats,
                          cfg: AudioFrontendConfig) -> torch.Tensor:
    """[..., N, *] fused products → [..., N, 84] frame features: 13 MFCC,
    13 Δ, 13 ΔΔ, F0, voiced, RMS, ZCR, centroid, rolloff, bandwidth and the
    first 38 of the 40 log-mel bands."""
    d1 = deltas(mfcc, cfg.delta_width)
    d2 = deltas(d1, cfg.delta_width)
    f0, voiced = f0_autocorrelation(power, cfg)
    centroid, rolloff, bandwidth = spectral_summaries(power, cfg)
    scalars = torch.stack([f0, voiced.to(torch.float32), timefeats[..., 0],
                           timefeats[..., 1], centroid, rolloff, bandwidth],
                          dim=-1)
    return torch.cat([mfcc, d1, d2, scalars, logmel[..., :38]], dim=-1)


def audio_frame_features_batch(
    signals: torch.Tensor,
    cfg: AudioFrontendConfig = AudioFrontendConfig(),
) -> torch.Tensor:
    """signals [B, T] → [B, N, 84] frame features, one K1 launch for the
    batch. The front-end has no parameters, so nothing here needs a
    gradient."""
    with torch.no_grad():
        return _frame_feature_matrix(*mfcc_from_signal(signals, cfg), cfg)


def audio_frame_features(
    signal: torch.Tensor,
    cfg: AudioFrontendConfig = AudioFrontendConfig(),
) -> torch.Tensor:
    """signal [T] → frame-level features [N, 84] for the sequence encoder."""
    return audio_frame_features_batch(signal[None], cfg)[0]
