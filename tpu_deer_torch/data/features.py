"""Multimodal feature extraction for serving: audio, video, text → 84/256/768-d.

Port of `tpu_deer/data/features.py`:

  * audio — utterances are zero-padded to a few fixed length buckets and each
    bucket runs as one batch through the fused front-end: one launch of
    kernel K1 per bucket on the card.
  * video — 8x8 spatial-grid statistics of grayscale frames pooled over time
    into 256-d (numpy, from frames; decoding a video file is not ported).
  * text — the deterministic hashed word/bigram projection into 768-d. The
    BERT and MLM-encoder backends are not ported yet and raise.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Optional, Sequence

import numpy as np
import torch

from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.ops.audio_frontend import (
    FEATURE_DIM,
    AudioFrontendConfig,
    extract_utterance_features_batch,
)

AUDIO_DIM = FEATURE_DIM  # 84
VIDEO_DIM = 256
TEXT_DIM = 768

# Audio is zero-padded to these lengths (seconds) so a handful of shapes
# cover every utterance; longer signals are cut at the last bucket.
LENGTH_BUCKETS_S = (2.0, 4.0, 8.0, 16.0)


class AudioFeatureExtractor:
    def __init__(self, cfg: AudioFrontendConfig = AudioFrontendConfig(),
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _bucket_length(self, n: int) -> int:
        sr = self.cfg.sample_rate
        for sec in LENGTH_BUCKETS_S:
            if n <= int(sec * sr):
                return int(sec * sr)
        return int(LENGTH_BUCKETS_S[-1] * sr)

    def extract_batch(self, signals: Sequence[np.ndarray],
                      plain: bool = False) -> np.ndarray:
        """List of 1-D float32 signals → [N, 84] feature matrix.

        Groups signals by padded length bucket and runs each bucket as one
        batch (plain as in `mfcc_from_signal`).
        """
        out = np.zeros((len(signals), AUDIO_DIM), dtype=np.float32)
        buckets: dict[int, list[int]] = {}
        for i, s in enumerate(signals):
            buckets.setdefault(self._bucket_length(len(s)), []).append(i)
        for n, idxs in buckets.items():
            batch = np.zeros((len(idxs), n), dtype=np.float32)
            for row, i in enumerate(idxs):
                s = np.asarray(signals[i], dtype=np.float32)[:n]
                batch[row, : len(s)] = s
            x = torch.from_numpy(batch).to(self.device)
            with torch.inference_mode():
                feats = extract_utterance_features_batch(x, self.cfg, plain=plain)
            out[idxs] = feats.cpu().numpy()
        return out

    def extract(self, signal: np.ndarray) -> np.ndarray:
        return self.extract_batch([signal])[0]


class VideoFeatureExtractor:
    """256-d video features: 8x8 spatial grid statistics."""

    def __init__(self, grid: int = 8):
        self.grid = grid

    def extract_from_frames(self, frames: np.ndarray) -> np.ndarray:
        """frames [T, H, W] grayscale float → 256-d."""
        g = self.grid
        t, h, w = frames.shape
        hh, ww = h - h % g, w - w % g
        cells = frames[:, :hh, :ww].reshape(t, g, hh // g, g, ww // g)
        cell_means = cells.mean(axis=(2, 4))  # [T, g, g]
        diffs = np.abs(np.diff(cell_means, axis=0)) if t > 1 else np.zeros((1, g, g))
        feat = np.concatenate(
            [
                cell_means.mean(axis=0).ravel(),
                cell_means.std(axis=0).ravel(),
                diffs.mean(axis=0).ravel(),
                diffs.std(axis=0).ravel(),
            ]
        ).astype(np.float32)
        if feat.shape != (VIDEO_DIM,):
            raise ValueError(f"grid {g} gives {feat.shape[0]} features, "
                             f"expected {VIDEO_DIM}")
        std = feat.std()
        return (feat - feat.mean()) / (std + 1e-8)


_TOKEN_RE = re.compile(r"[a-z']+")


class TextFeatureExtractor:
    """768-d hashed text features: signed feature hashing of words + bigrams
    into 768 bins, l2-normalized. Deterministic and dependency-free.

    The reference also serves a local BERT (`bert_dir`,
    $TPU_DEER_BERT_DIR) or an MLM-pretrained encoder (`encoder_dir`,
    $TPU_DEER_TEXT_ENCODER_DIR). Those backends are not ported yet: asking
    for one, by argument or environment, raises rather than quietly
    serving hashed features.
    """

    def __init__(self, bert_dir: Optional[str] = None,
                 encoder_dir: Optional[str] = None):
        requested = {
            "bert_dir": bert_dir or os.environ.get("TPU_DEER_BERT_DIR"),
            "encoder_dir": encoder_dir
            or os.environ.get("TPU_DEER_TEXT_ENCODER_DIR"),
        }
        for name, value in requested.items():
            if value:
                raise NotImplementedError(
                    f"{name}={value!r}: only the hashed text backend is "
                    f"ported so far"
                )

    @staticmethod
    def _hash_token(token: str) -> tuple[int, float]:
        digest = hashlib.md5(token.encode()).digest()
        idx = int.from_bytes(digest[:4], "little") % TEXT_DIM
        sign = 1.0 if digest[4] % 2 == 0 else -1.0
        return idx, sign

    def _hashed(self, text: str) -> np.ndarray:
        vec = np.zeros(TEXT_DIM, dtype=np.float32)
        tokens = _TOKEN_RE.findall(text.lower())
        for tok in tokens:
            i, s = self._hash_token(tok)
            vec[i] += s
        for a, b in zip(tokens, tokens[1:]):
            i, s = self._hash_token(a + "_" + b)
            vec[i] += 0.5 * s
        norm = np.linalg.norm(vec)
        return vec / norm if norm > 0 else vec

    def extract(self, text: str) -> np.ndarray:
        if not text:
            return np.zeros(TEXT_DIM, dtype=np.float32)
        return self._hashed(text)

    def extract_batch(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.extract(t) for t in texts])


class MultimodalFeatureExtractor:
    """Bundles the three extractors behind one interface."""

    def __init__(
        self,
        audio_cfg: AudioFrontendConfig = AudioFrontendConfig(),
        bert_dir: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self.audio = AudioFeatureExtractor(audio_cfg, device=device)
        self.video = VideoFeatureExtractor()
        self.text = TextFeatureExtractor(bert_dir)
