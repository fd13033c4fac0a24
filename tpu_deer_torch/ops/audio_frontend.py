"""Audio feature front-end: signal → MFCC/power/RMS/ZCR → 84-d utterance vector.

Port of `tpu_deer/ops/audio_frontend.py`. Two fused entry points, each
through a kernel's wrapper: a CUDA tensor launches the kernel, a CPU tensor
takes its plain twin, and `plain=True` forces the plain twin on the card,
to check the kernel.

  * `mfcc_from_signal` — kernel K1 (`tpu_deer_torch.kernels.mfcc_signal`):
    from the signal, frames never reach device memory; the plain twin is
    unfold + matmuls (the reference's `path="frames"` numerics). `path`
    takes the reference's three routes: "pallas" (or None) is K1,
    "frames" gathers frames and takes K2's plain twin, and "conv" frames,
    windows and transforms the signal by strided `conv1d`s (a plain torch
    route, as the reference's XLA one).
  * `mfcc_frames` — kernel K2 (`tpu_deer_torch.kernels.mfcc_frames`): from
    frames the caller holds (the streaming tick); all leading axes go into
    the kernel's rows, one launch, as the reference's custom_vmap collapses
    the stream axis.

Everything downstream (framing, deltas, F0 by autocorrelation, spectral
centroid, RMS, ZCR, the 84-d utterance vector, the enhanced 84-d vector and
the [N, 84] frame-feature matrix of the raw sequence model) is plain tensor
code over a batch dimension written out where the reference vmaps.
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
        # The conv route's window-folded bases, [2 * n_bins, 1, n_fft]
        # (cos then sin), and the squared window [1, 1, n_fft] for its RMS.
        "conv_dft": f32(np.concatenate([window[:, None] * cos,
                                        window[:, None] * sin], axis=1).T[:, None]),
        "conv_win_sq": f32(window * window)[None, None],
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


PATHS = ("pallas", "conv", "frames")


def _mfcc_signal_conv(x_pad: torch.Tensor, bases: dict,
                      cfg: AudioFrontendConfig):
    """x_pad [B, Tp] → the fused products, every framing a strided conv1d:
    the window-folded DFT, the windowed frame's mean square (x² against the
    squared window) and the sign changes' count (against ones)."""
    hop, n_fft, n_bins = cfg.hop_length, cfg.n_fft, cfg.n_bins
    x = x_pad[:, None, :]
    y = F.conv1d(x, bases["conv_dft"], stride=hop).transpose(1, 2)
    re, im = y[..., :n_bins], y[..., n_bins:]
    power = re * re + im * im
    logmel = torch.log(torch.clamp(power @ bases["mel"], min=EPS))
    mfcc = logmel @ bases["dct"]
    msq = F.conv1d(x * x, bases["conv_win_sq"], stride=hop)[:, 0] / n_fft
    rms = torch.sqrt(torch.clamp(msq, min=0.0))
    changes = (torch.diff(torch.sign(x_pad), dim=-1) != 0).to(torch.float32)
    ones = changes.new_ones((1, 1, n_fft - 1))
    zcr = F.conv1d(changes[:, None, :], ones, stride=hop)[:, 0] / (n_fft - 1)
    return mfcc, logmel, power, torch.stack([rms, zcr], dim=-1)


def _mfcc_signal_frames(x_pad: torch.Tensor, bases: dict,
                        cfg: AudioFrontendConfig):
    """x_pad [B, Tp] → the fused products from gathered frames: K2's plain
    twin, and RMS and ZCR of the frames."""
    frames = x_pad.unfold(-1, cfg.n_fft, cfg.hop_length)
    mfcc, logmel, power = k2.mfcc_frames_plain(frames, bases, cfg.n_fft)
    rms = rms_energy(frames * bases["window"])
    return mfcc, logmel, power, torch.stack([rms, zero_crossing_rate(frames)], -1)


def mfcc_from_signal(signals: torch.Tensor,
                     cfg: AudioFrontendConfig = AudioFrontendConfig(),
                     plain: bool = False, path: Optional[str] = None):
    """signals [T] or [B, T] float32 → (mfcc, logmel, power, timefeats).

    timefeats[..., 0] = RMS of the windowed frame, [..., 1] = ZCR.
    path None or "pallas" goes through K1's wrapper, which launches the
    kernel for a CUDA tensor and runs the plain twin for a CPU one;
    plain=True takes the plain twin on any device (to check the kernel
    against it on the card). path "conv" and "frames" are the plain torch
    routes of the reference's paths of those names. Another path raises.
    """
    if path is not None and path not in PATHS:
        raise ValueError(f"unknown mfcc_from_signal path: {path!r}")
    squeeze = signals.dim() == 1
    if squeeze:
        signals = signals[None]
    x_pad, _ = _pad_for_frames(signals, cfg)
    bases = _device_bases(cfg, x_pad.device)
    if path == "conv":
        out = _mfcc_signal_conv(x_pad, bases, cfg)
    elif path == "frames":
        out = _mfcc_signal_frames(x_pad, bases, cfg)
    else:
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
    path: Optional[str] = None,
) -> torch.Tensor:
    """signals [B, T] → [B, 84], one fused front-end launch for the batch."""
    mfcc, _, power, timefeats = mfcc_from_signal(signals, cfg, plain=plain,
                                                 path=path)
    return _utterance_vec(mfcc, power, timefeats, cfg)


def extract_utterance_features(
    signal: torch.Tensor,
    cfg: AudioFrontendConfig = AudioFrontendConfig(),
    plain: bool = False,
    path: Optional[str] = None,
) -> torch.Tensor:
    """signal [T] → 84-d feature vector (see _utterance_vec for the layout)."""
    return extract_utterance_features_batch(signal[None], cfg, plain=plain,
                                            path=path)[0]


# ---------------------------------------------------------------------------
# The enhanced 84-d vector, batched over a leading utterance axis
# ---------------------------------------------------------------------------
def _nanquantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation quantile over the last axis, NaNs left out (NaN
    where a row holds none), as jnp.nanquantile computes it: the sorted
    values at floor and ceil of q · (n - 1), weighted."""
    s = torch.sort(x, dim=-1).values  # NaNs sort last
    n = (~torch.isnan(x)).sum(dim=-1, keepdim=True).to(x.dtype)
    pos = q * (n - 1.0)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w = pos - lo
    last = x.shape[-1] - 1
    take = lambda i: torch.gather(s, -1, i.clamp(0, last).long())
    out = take(lo) * (1.0 - w) + take(hi) * w
    return torch.where(n > 0, out, torch.nan)[..., 0]


def _masked_stats(x: torch.Tensor, mask: torch.Tensor):
    """mean / std / min / max of x [..., N] over the entries `mask` keeps
    (0 for the min and max of a row with none)."""
    m = mask.to(torch.float32)
    n = torch.clamp(m.sum(dim=-1), min=1.0)
    mean = (x * m).sum(dim=-1) / n
    std = torch.sqrt(torch.clamp(
        (m * (x - mean[..., None]) ** 2).sum(dim=-1) / n, min=0.0))
    inf = torch.full_like(x, torch.inf)
    any_ = mask.any(dim=-1)
    mn = torch.where(any_, torch.where(mask, x, inf).amin(dim=-1), 0.0)
    mx = torch.where(any_, torch.where(mask, x, -inf).amax(dim=-1), 0.0)
    return mean, std, mn, mx


def _spectral_peaks(mean_power: torch.Tensor, cfg: AudioFrontendConfig,
                    k: int = 5):
    """Top-k local maxima of the mean power spectrum [..., n_bins] →
    (freqs, mags) [..., k], ascending in frequency; 0 where fewer than k
    peaks rise above a tenth of the maximum."""
    freqs = _device_bases(cfg, mean_power.device)["freqs"]
    p = mean_power
    left = torch.cat([p[..., :1], p[..., :-1]], dim=-1)
    right = torch.cat([p[..., 1:], p[..., -1:]], dim=-1)
    is_peak = (p > left) & (p >= right) & (p > 0.1 * p.amax(dim=-1, keepdim=True))
    masked = torch.where(is_peak, p, torch.full_like(p, -torch.inf))
    mags, idx = torch.topk(masked, k, dim=-1)
    found = torch.isfinite(mags)
    peak_freqs = torch.where(found, freqs[idx], 0.0)
    mags = torch.where(found, mags, 0.0)
    order = torch.argsort(torch.where(peak_freqs > 0, peak_freqs, torch.inf),
                          dim=-1, stable=True)
    return (torch.gather(peak_freqs, -1, order), torch.gather(mags, -1, order))


@functools.lru_cache(maxsize=8)
def _chroma_matrix(cfg: AudioFrontendConfig) -> np.ndarray:
    """[n_bins, 12] fold of FFT bins into pitch classes (simple chroma)."""
    freqs = np.linspace(0.0, cfg.sample_rate / 2.0, cfg.n_bins)
    out = np.zeros((cfg.n_bins, 12), dtype=np.float32)
    valid = freqs > 20.0
    midi = np.zeros_like(freqs)
    midi[valid] = 69.0 + 12.0 * np.log2(freqs[valid] / 440.0)
    pc = np.mod(np.round(midi), 12).astype(int)
    out[np.arange(cfg.n_bins)[valid], pc[valid]] = 1.0
    return out


def _enhanced_vec(mfcc, logmel, power, timefeats,
                  cfg: AudioFrontendConfig) -> torch.Tensor:
    """[B, N, ...] fused products → [B, 84] enhanced vectors:
      [ 0:39] mean MFCC, mean ΔMFCC, mean ΔΔMFCC (13 each)
      [39:64] prosodic: F0 {mean, std, min, max, p25, p75} over voiced
              frames, RMS {mean, std, min, max}, ZCR {mean, std}, rolloff
              {mean, std}, tempo (the onset envelope's autocorrelation
              peak), onset count, centroid {mean, std}, voiced fraction,
              F0 range, RMS range, onset strength {mean, std}, 0, 0
      [64:74] the 5 spectral peaks' frequencies (kHz) and log1p(power)
      [74:84] centroid, rolloff, bandwidth and contrast {mean, std}, and
              the mean chroma's mean and std
    normalized to zero mean / unit variance over the vector (population
    stds throughout, as jnp.std)."""
    std = lambda x, dim=-1: torch.std(x, dim=dim, correction=0)
    d1 = deltas(mfcc, cfg.delta_width)
    d2 = deltas(d1, cfg.delta_width)
    mfcc_block = torch.cat([mfcc.mean(1), d1.mean(1), d2.mean(1)], dim=-1)

    f0, voiced = f0_autocorrelation(power, cfg)
    f0_mean, f0_std, f0_min, f0_max = _masked_stats(f0, voiced)
    voiced_f = torch.where(voiced, f0, torch.nan)
    f0_p25 = torch.nan_to_num(_nanquantile(voiced_f, 0.25))
    f0_p75 = torch.nan_to_num(_nanquantile(voiced_f, 0.75))
    rms, zcr = timefeats[..., 0], timefeats[..., 1]
    r_mean, r_std, r_min, r_max = _masked_stats(rms, torch.ones_like(voiced))
    centroid, rolloff, bandwidth = spectral_summaries(power, cfg)
    # Onset strength: the positive log-mel flux between frames.
    flux = torch.clamp(torch.diff(logmel, dim=1), min=0.0).sum(dim=-1)
    flux_mean, flux_std = flux.mean(-1), std(flux)
    onsets = (flux > (flux_mean + flux_std)[:, None]).to(torch.float32)
    # Tempo: the autocorrelation peak of the centred onset envelope (lag 0
    # excluded), ac[k] = Σ_i f[i + k] · f[i].
    fc = flux - flux_mean[:, None]
    n_f = fc.shape[-1]
    windows = F.pad(fc, (0, n_f - 1)).unfold(-1, n_f, 1)  # [B, lag, i]
    ac = (windows * fc[:, None, :]).sum(-1)
    ac = torch.cat([torch.zeros_like(ac[:, :1]), ac[:, 1:]], dim=-1)
    lag = torch.argmax(ac, dim=-1)
    frame_rate = cfg.sample_rate / cfg.hop_length
    tempo = torch.where(lag > 0, 60.0 * frame_rate
                        / torch.clamp(lag, min=1).to(torch.float32), 0.0)
    zero = torch.zeros_like(f0_mean)
    prosodic = torch.stack([
        f0_mean, f0_std, f0_min, f0_max, f0_p25, f0_p75,
        r_mean, r_std, r_min, r_max,
        zcr.mean(-1), std(zcr),
        rolloff.mean(-1), std(rolloff),
        tempo, onsets.sum(-1),
        centroid.mean(-1), std(centroid),
        voiced.to(torch.float32).mean(-1),
        f0_max - f0_min, r_max - r_min,
        flux_mean, flux_std,
        zero, zero,
    ], dim=-1)

    peak_freqs, peak_mags = _spectral_peaks(power.mean(1), cfg, k=5)
    formants = torch.cat([peak_freqs / 1000.0, torch.log1p(peak_mags)], -1)

    mag = torch.sqrt(torch.clamp(power, min=0.0))
    contrast = torch.log((_nanquantile(mag, 0.9) + EPS)
                         / (_nanquantile(mag, 0.1) + EPS))
    chroma = mag @ torch.from_numpy(_chroma_matrix(cfg)).to(mag.device)
    chroma_mean = chroma.mean(1)
    spectral = torch.stack([
        centroid.mean(-1), std(centroid),
        rolloff.mean(-1), std(rolloff),
        bandwidth.mean(-1), std(bandwidth),
        contrast.mean(-1), std(contrast),
        chroma_mean.mean(-1), std(chroma_mean),
    ], dim=-1)

    vec = torch.cat([mfcc_block, prosodic, formants, spectral], dim=-1)
    return (vec - vec.mean(-1, keepdim=True)) / (std(vec)[:, None] + 1e-8)


def extract_enhanced_utterance_features(
    signals: torch.Tensor,
    cfg: AudioFrontendConfig = AudioFrontendConfig(),
    plain: bool = False,
    path: Optional[str] = None,
) -> torch.Tensor:
    """signal [T] → the enhanced 84-d vector, or signals [B, T] → [B, 84]
    from one front-end launch (see _enhanced_vec for the layout). The
    front-end takes K1 (its plain twin on the CPU, or with plain=True)
    unless `path` names another route."""
    squeeze = signals.dim() == 1
    batch = signals[None] if squeeze else signals
    with torch.no_grad():
        out = _enhanced_vec(*mfcc_from_signal(batch, cfg, plain=plain,
                                              path=path), cfg)
    return out[0] if squeeze else out


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
    path: Optional[str] = None,
) -> torch.Tensor:
    """signals [B, T] → [B, N, 84] frame features, one K1 launch for the
    batch (unless `path` names another route). The front-end has no
    parameters, so nothing here needs a gradient."""
    with torch.no_grad():
        return _frame_feature_matrix(*mfcc_from_signal(signals, cfg, path=path),
                                     cfg)


def audio_frame_features(
    signal: torch.Tensor,
    cfg: AudioFrontendConfig = AudioFrontendConfig(),
    path: Optional[str] = None,
) -> torch.Tensor:
    """signal [T] → frame-level features [N, 84] for the sequence encoder."""
    return audio_frame_features_batch(signal[None], cfg, path=path)[0]
