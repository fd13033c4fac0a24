"""Streaming real-time emotion recognition over live audio.

Port of `tpu_deer/stream.py`. Audio arrives in fixed-size chunks (a
multiple of the front-end hop) for S concurrent streams; every `push`
takes one [S, chunk] batch and returns S emotion estimates:

  * **One kernel launch per tick.** The chunk's frames of every stream go
    through kernel K2 together (`ops.audio_frontend.mfcc_frames`, S · F
    rows), where the reference vmaps the update and its custom_vmap rule
    collapses the stream axis into the kernel's rows.
  * **O(chunk) incremental features.** The 84-d utterance vector (the
    layout of `ops.audio_frontend._utterance_vec`) is a set of means/stds
    over frame-level features, so the state carries running moments (count,
    mean, M2; Chan/Welford-merged per chunk, which keeps the variance for
    unbounded session lengths where an f32 sum of squares cancels) plus
    small carry buffers: the last `n_fft - hop` raw samples (framing
    overlap) and the last `delta_width - 1` MFCC / Δ frames (delta context).
  * **A leading stream axis.** Every field of `StreamState` is a tensor
    [S, ...]; the update is written over that axis.
  * **One CUDA graph per tick** on the card, the counterpart of the
    reference's jit-compiled tick: the update, the per-slot select, the
    features, the model, E|y - mu| and the OOD score, K2 inside, replayed
    over static inputs (chunks, video, text, active) and a static state
    that the tick writes in place (`graphs.GraphedCall`).

Streaming semantics vs the offline extractor: a live stream has no future
samples, so it starts from silence (a zero carry) and does not emit the
final-edge frames until their audio arrives; delta statistics skip the
first `delta_width - 1` frame centers whose window touches pre-stream
silence. After a few chunks the running features converge to the offline
extractor's on the same audio (tests/test_torch_stream.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_deer_torch.core.nig import nig_expected_abs_error
from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.eval.ood import (
    input_norm_features_device,
    mahalanobis_score_device,
)
from tpu_deer_torch.graphs import GraphedCall
from tpu_deer_torch.ops import dsp
from tpu_deer_torch.ops.audio_frontend import (
    FEATURE_DIM,
    AudioFrontendConfig,
    _device_bases,
    f0_autocorrelation,
    mfcc_frames,
    rms_energy,
    spectral_summaries,
    zero_crossing_rate,
)


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Static configuration for a streaming session.

    `chunk_samples` must be a positive multiple of the front-end hop so
    every push yields a whole number of frames.
    """

    frontend: AudioFrontendConfig = AudioFrontendConfig()
    chunk_samples: int = 4096

    def __post_init__(self):
        hop = self.frontend.hop_length
        if self.chunk_samples <= 0 or self.chunk_samples % hop:
            raise ValueError(
                f"chunk_samples={self.chunk_samples} must be a positive "
                f"multiple of hop_length={hop}"
            )
        if self.chunk_samples < self.frontend.n_fft:
            raise ValueError(
                f"chunk_samples={self.chunk_samples} must cover one FFT "
                f"window (n_fft={self.frontend.n_fft})"
            )
        # The per-update delta context (mfcc_tail/d1_tail) is refilled from
        # this update's frames alone, so each chunk must produce at least
        # delta_width-1 frames or the carried tail shapes break.
        min_frames = self.frontend.delta_width - 1
        if self.chunk_samples // hop < min_frames:
            raise ValueError(
                f"chunk_samples={self.chunk_samples} yields "
                f"{self.chunk_samples // hop} frames/chunk; need >= "
                f"delta_width-1 = {min_frames} (raise chunk_samples or "
                f"lower delta_width)"
            )

    @property
    def frames_per_chunk(self) -> int:
        return self.chunk_samples // self.frontend.hop_length

    @property
    def sample_carry(self) -> int:
        return self.frontend.n_fft - self.frontend.hop_length


class StreamState(NamedTuple):
    """Per-stream carry: float32 tensors with a leading stream axis [S]."""

    sample_tail: torch.Tensor  # [S, n_fft - hop] raw-sample framing overlap
    mfcc_tail: torch.Tensor  # [S, delta_width - 1, n_mfcc] Δ context
    d1_tail: torch.Tensor  # [S, delta_width - 1, n_mfcc] ΔΔ context
    n_frames: torch.Tensor  # [S]: frames accumulated
    mfcc_stats: torch.Tensor  # [S, 2, n_mfcc]: running mean, M2 (Welford)
    d1_n: torch.Tensor  # [S]
    d1_stats: torch.Tensor  # [S, 2, n_mfcc]
    d2_n: torch.Tensor  # [S]
    d2_stats: torch.Tensor  # [S, 2, n_mfcc]
    f0_n: torch.Tensor  # [S] voiced-frame count
    f0_stats: torch.Tensor  # [S, 2]
    rms_stats: torch.Tensor  # [S, 2]
    zcr_mean: torch.Tensor  # [S]
    centroid_mean: torch.Tensor  # [S]


def init_stream_state(cfg: StreamingConfig, n_streams: int = 1,
                      device: DeviceLike = None) -> StreamState:
    """A fresh (silent) state for `n_streams` streams on `device`
    (None = the CUDA card)."""
    fe = cfg.frontend
    w = fe.delta_width - 1
    device = resolve_device(device)
    z = lambda *s: torch.zeros((n_streams, *s), dtype=torch.float32,
                               device=device)
    return StreamState(
        sample_tail=z(cfg.sample_carry),
        mfcc_tail=z(w, fe.n_mfcc),
        d1_tail=z(w, fe.n_mfcc),
        n_frames=z(),
        mfcc_stats=z(2, fe.n_mfcc),
        d1_n=z(),
        d1_stats=z(2, fe.n_mfcc),
        d2_n=z(),
        d2_stats=z(2, fe.n_mfcc),
        f0_n=z(),
        f0_stats=z(2),
        rms_stats=z(2),
        zcr_mean=z(),
        centroid_mean=z(),
    )


@functools.lru_cache(maxsize=8)
def _delta_kernel(width: int, device: torch.device) -> torch.Tensor:
    """The regression-delta weights on `device`, uploaded once (a copy from
    the host is not allowed while a CUDA graph is being captured)."""
    return torch.as_tensor(dsp.delta_kernel(width), dtype=torch.float32,
                           device=device)


def _valid_deltas(tail: torch.Tensor, new: torch.Tensor, width: int):
    """Un-padded regression deltas over [tail; new] along the frame axis.

    tail [S, width-1, D], new [S, F, D] → [S, F, D]: the interior
    (edge-effect-free) deltas, whose centers lag `width//2` frames behind
    the newest frame, identical to the offline `deltas()` away from signal
    edges.
    """
    x = torch.cat([tail, new], dim=-2)
    kernel = _delta_kernel(width, x.device).to(x.dtype)
    n_out = new.shape[-2]
    windows = torch.stack([x[..., i:i + n_out, :] for i in range(width)])
    return torch.einsum("w,w...->...", kernel, windows)


def streaming_update(state: StreamState, chunks: torch.Tensor,
                     cfg: StreamingConfig, plain: bool = False
                     ) -> tuple[StreamState, torch.Tensor]:
    """S streams, one chunk each: chunks [S, chunk_samples] float32 on the
    state's device → (new state, features [S, 84]).

    The frames of all S streams go through one K2 launch (its plain twin
    on the CPU, or anywhere with plain=True). The emitted vector follows
    the canonical layout of `_utterance_vec`, normalized to zero mean /
    unit variance.
    """
    fe = cfg.frontend
    half = fe.delta_width // 2
    F = cfg.frames_per_chunk
    S = chunks.shape[0]

    signal = torch.cat([state.sample_tail, chunks], dim=-1)
    # Framing without center padding: frame k covers [k*hop, k*hop + n_fft).
    frames = signal.unfold(-1, fe.n_fft, fe.hop_length)  # [S, F, n_fft] view
    mfcc, _, power = mfcc_frames(frames, fe, plain=plain)
    d1 = _valid_deltas(state.mfcc_tail, mfcc, fe.delta_width)
    d2 = _valid_deltas(state.d1_tail, d1, fe.delta_width)

    # Global frame indices of this update's outputs. Delta centers lag the
    # newest MFCC frame; centers whose window touches pre-stream silence
    # (index < width-1) are masked out of the running statistics.
    n0 = state.n_frames
    idx = torch.arange(F, dtype=torch.float32, device=chunks.device)
    d1_centers = n0[:, None] - half + idx
    d2_centers = n0[:, None] - 2 * half + idx
    d1_mask = (d1_centers >= fe.delta_width - 1).to(torch.float32)[..., None]
    d2_mask = (d2_centers >= 2 * (fe.delta_width - 1)).to(torch.float32)[..., None]

    f0, voiced = f0_autocorrelation(power, fe)
    v = voiced.to(torch.float32)
    rms = rms_energy(frames * _device_bases(fe, chunks.device)["window"])
    zcr = zero_crossing_rate(frames)
    centroid, _, _ = spectral_summaries(power, fe)

    n_new = torch.full((S,), float(F), device=chunks.device)
    d1_n, d2_n, f0_n = d1_mask.sum((1, 2)), d2_mask.sum((1, 2)), v.sum(1)
    step = F / (n0 + F)
    new_state = StreamState(
        sample_tail=signal[:, -cfg.sample_carry:],
        mfcc_tail=mfcc[:, -(fe.delta_width - 1):],
        d1_tail=d1[:, -(fe.delta_width - 1):],
        n_frames=n0 + F,
        mfcc_stats=_merge_moments(state.mfcc_stats, n0, mfcc, 1.0, n_new),
        d1_n=state.d1_n + d1_n,
        d1_stats=_merge_moments(state.d1_stats, state.d1_n, d1, d1_mask, d1_n),
        d2_n=state.d2_n + d2_n,
        d2_stats=_merge_moments(state.d2_stats, state.d2_n, d2, d2_mask, d2_n),
        f0_n=state.f0_n + f0_n,
        f0_stats=_merge_moments(state.f0_stats, state.f0_n, f0, v, f0_n),
        rms_stats=_merge_moments(state.rms_stats, n0, rms, 1.0, n_new),
        zcr_mean=state.zcr_mean + (zcr.mean(-1) - state.zcr_mean) * step,
        centroid_mean=state.centroid_mean
        + (centroid.mean(-1) - state.centroid_mean) * step,
    )
    return new_state, _features_from_state(new_state)


def _merge_moments(stats: torch.Tensor, n_old: torch.Tensor, x: torch.Tensor,
                   w, n_new: torch.Tensor) -> torch.Tensor:
    """Chan's parallel (mean, M2) merge of a weighted batch into running
    moments, per stream.

    stats [S, 2, ...] (mean, M2); x [S, F, ...] the batch values with 0/1
    weights `w` (broadcastable to x) summing to n_new [S] over the frame
    axis; n_old [S]. Plain sum / sum-of-squares would lose the variance of
    a long-lived stream to cancellation; these moments keep it."""
    per_stream = (-1,) + (1,) * (x.dim() - 2)
    n_old, n_new = n_old.reshape(per_stream), n_new.reshape(per_stream)
    nb = torch.clamp(n_new, min=1.0)
    bm = (x * w).sum(1) / nb
    bM2 = (((x - bm[:, None]) ** 2) * w).sum(1)
    n_tot = torch.clamp(n_old + n_new, min=1.0)
    delta = bm - stats[:, 0]
    mean = stats[:, 0] + delta * (n_new / n_tot)
    M2 = stats[:, 1] + bM2 + delta * delta * (n_old * n_new / n_tot)
    # An empty batch (n_new == 0, e.g. no voiced frames) changes nothing.
    keep = (n_new > 0).reshape((-1,) + (1,) * (stats.dim() - 1))
    return torch.where(keep, torch.stack([mean, M2], dim=1), stats)


def _mean_std(stats: torch.Tensor, n: torch.Tensor):
    """(mean, M2) running moments [S, 2, ...] → (mean, population std)."""
    n = torch.clamp(n, min=1.0).reshape((-1,) + (1,) * (stats.dim() - 2))
    return stats[:, 0], torch.sqrt(torch.clamp(stats[:, 1] / n, min=0.0))


def _features_from_state(s: StreamState) -> torch.Tensor:
    """StreamState → normalized 84-d feature vectors [S, 84]."""
    m_mean, m_std = _mean_std(s.mfcc_stats, s.n_frames)
    d1_mean, d1_std = _mean_std(s.d1_stats, s.d1_n)
    d2_mean, d2_std = _mean_std(s.d2_stats, s.d2_n)
    f0_mean, f0_std = _mean_std(s.f0_stats, s.f0_n)
    rms_mean, rms_std = _mean_std(s.rms_stats, s.n_frames)
    vec = torch.cat(
        [
            m_mean, m_std, d1_mean, d1_std, d2_mean, d2_std,
            torch.stack([f0_mean, f0_std, rms_mean, rms_std,
                         s.zcr_mean, s.centroid_mean], dim=-1),
        ],
        dim=-1,
    )
    if vec.shape[-1] != FEATURE_DIM:
        raise ValueError(f"feature vector has {vec.shape[-1]} entries, "
                         f"expected {FEATURE_DIM}")
    mean = vec.mean(dim=-1, keepdim=True)
    return (vec - mean) / (torch.std(vec, dim=-1, correction=0,
                                     keepdim=True) + 1e-8)


class StreamingRecognizer:
    """Multi-stream real-time emotion recognition service.

    Holds `n_streams` independent audio sessions. Every `push` processes
    one fixed-size chunk for all streams (one K2 launch) and runs the
    flagship model on the updated per-stream features.

    Video/text context features (for A+V+T prediction) are supplied per
    push and may update at any cadence; pass zeros for audio-only streams.

    The state lives in fixed device buffers that each tick writes in place
    (`self.state` is never rebound), so a CUDA graph of the tick stays
    valid.
    """

    def __init__(
        self,
        model,
        n_streams: int = 8,
        cfg: StreamingConfig = StreamingConfig(),
        ood_detector=None,
        ood_fpr: float = 0.01,
        device: DeviceLike = None,
        plain: bool = False,
        graphs: bool = True,
    ):
        """model: a CompleteDEERModel with its weights, moved to `device`
        (None = the CUDA card). ood_detector: a fitted MahalanobisOOD in
        "input_norm" space, scored on the same (features, video, text) the
        model sees; each push then gains "ood_score", and `ood_threshold`
        is its cutoff at the training false-positive rate `ood_fpr`.
        plain=True runs K2's plain twin in place of the kernel (to check
        the kernel on the card). graphs: a CUDA graph of the tick where the
        device is the card (captured at `warmup()` or the first push; the
        CPU is always eager); False runs eagerly on the card, to check the
        graph."""
        self.device = resolve_device(device)
        self.graphs = graphs and self.device.type == "cuda"
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.n_streams = n_streams
        self.plain = plain
        self._ood = None
        self.ood_threshold = None
        if ood_detector is not None:
            if ood_detector.space != "input_norm":
                raise ValueError(
                    "streaming OOD needs an 'input_norm'-space detector; "
                    f"got space={ood_detector.space!r}"
                )
            self._ood = tuple(torch.from_numpy(np.asarray(a)).to(self.device)
                              for a in ood_detector.device_arrays)
            self.ood_threshold = float(ood_detector.threshold(ood_fpr))
        self.state = init_stream_state(cfg, n_streams, self.device)
        mcfg = model.config
        self._specs = [((n_streams, cfg.chunk_samples), torch.float32),
                       ((n_streams, mcfg.video_dim), torch.float32),
                       ((n_streams, mcfg.text_dim), torch.float32),
                       ((n_streams,), torch.bool)]
        self._graph: Optional[GraphedCall] = None

    def _tick(self, chunks, video, text, active) -> dict[str, torch.Tensor]:
        """One tick over device tensors; writes the state in place. With
        every slot inactive the state is left as it was."""
        new_state, _ = streaming_update(self.state, chunks, self.cfg,
                                        self.plain)
        # Inactive slots pass through untouched (their chunk is ignored):
        # sessions advance independently though every tick carries all S.
        for field, new in zip(self.state, new_state):
            pick = active.reshape((-1,) + (1,) * (field.dim() - 1))
            field.copy_(torch.where(pick, new, field))
        feats = _features_from_state(self.state)
        out = self.model(feats, video, text)
        res = {
            "features": feats,
            "mu": out["mu_all"],
            "uncertainty": out["uncertainty_all"],
            "calibrated_uncertainty": out["calibrated_uncertainty"],
            "expected_abs_error": torch.cat(
                [nig_expected_abs_error(out[f"{n}_params"])
                 for n in self.model.config.dim_names], dim=-1),
        }
        if self._ood is not None:
            res["ood_score"] = mahalanobis_score_device(
                input_norm_features_device(feats, video, text), *self._ood)
        return res

    def warmup(self) -> None:
        """Ready the tick before serving, as the reference compiles its tick:
        capture the tick's graph (before other threads use the card), or,
        eager, run one all-inactive tick (that builds the kernel and loads
        the libraries). Either leaves every stream's state as it was."""
        if self.graphs:
            self._capture("global")
        else:
            S = self.n_streams
            self.push(np.zeros((S, self.cfg.chunk_samples), np.float32),
                      active=np.zeros(S, bool))

    def _capture(self, capture_error_mode: str) -> None:
        """Capture the tick's graph where it is not captured yet. The
        warm-up runs before the capture leave every stream's state as it
        was."""
        if self._graph is None:
            self._graph = GraphedCall(self._tick, self._specs, self.device,
                                      capture_error_mode=capture_error_mode)

    @property
    def capture_s(self) -> Optional[float]:
        return None if self._graph is None else self._graph.capture_s

    def reset_streams(self, stream_ids) -> None:
        """End the given sessions; their slots restart from silence (a
        fresh state is all zeros)."""
        ids = np.asarray(stream_ids, dtype=np.int64)
        if ids.size == 0:
            return
        idx = torch.from_numpy(ids).to(self.device)
        with torch.inference_mode():
            for field in self.state:
                field.index_fill_(0, idx, 0.0)

    def push(
        self,
        chunks: np.ndarray,
        video: Optional[np.ndarray] = None,
        text: Optional[np.ndarray] = None,
        active: Optional[np.ndarray] = None,
    ) -> dict[str, np.ndarray]:
        """chunks [n_streams, chunk_samples] → per-stream predictions.

        `active` ([S] bool, default all-true) selects which slots consume
        their chunk this tick; inactive slots keep their state (their
        outputs are still returned, computed from the unchanged state).
        Returns features [S, 84], mu [S, 3], raw + calibrated uncertainty,
        expected_abs_error [S, 3], and ood_score [S] with a detector.
        """
        S = self.n_streams
        mcfg = self.model.config
        if chunks.shape != (S, self.cfg.chunk_samples):
            raise ValueError(
                f"chunks must be [{S}, {self.cfg.chunk_samples}], "
                f"got {chunks.shape}"
            )
        if video is None:
            video = np.zeros((S, mcfg.video_dim), np.float32)
        if text is None:
            text = np.zeros((S, mcfg.text_dim), np.float32)
        if active is None:
            active = np.ones(S, bool)
        args = (chunks, video, text, active)
        if self.graphs:
            self._capture("thread_local")
            return self._graph(*args)
        with torch.inference_mode():
            out = self._tick(*(torch.as_tensor(np.asarray(a)).to(
                self.device, dtype) for a, (_, dtype) in zip(args, self._specs)))
            return {k: v.cpu().numpy() for k, v in out.items()}
