"""Multimodal feature extraction: audio, video, text → 84/256/768-d.

Port of `tpu_deer/data/features.py`:

  * audio — utterances are zero-padded to a few fixed length buckets and each
    bucket runs as one batch through the fused front-end: one launch of
    kernel K1 per bucket on the card.
  * video — 8x8 spatial-grid statistics of grayscale frames pooled over time
    into 256-d (numpy); `extract(video_path)` decodes up to 32 evenly
    spaced frames with OpenCV, imported when called. Any decode failure
    (no `cv2`, an unreadable file) warns and gives zeros, as the
    reference's does.
  * text — a corpus-MLM-pretrained encoder (`train/text_pretrain.py`) saved
    by the port, from `encoder_dir` or $TPU_DEER_TEXT_ENCODER_DIR, else the
    deterministic hashed word/bigram projection into 768-d. A BERT
    directory (`bert_dir`, $TPU_DEER_BERT_DIR) is not ported and raises.
"""

from __future__ import annotations

import hashlib
import logging
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

logger = logging.getLogger(__name__)

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

    def __init__(self, max_frames: int = 32, grid: int = 8):
        self.max_frames = max_frames
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

    def extract(self, video_path: str) -> np.ndarray:
        """Up to `max_frames` evenly spaced frames of the file, grayscale,
        resized to 64x64 → 256-d; zeros with a warning when it cannot be
        decoded."""
        try:
            import cv2

            cap = cv2.VideoCapture(video_path)
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) or 0
            take = np.linspace(0, max(n - 1, 0), min(self.max_frames, max(n, 1)))
            frames = []
            for idx in take.astype(int):
                cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
                ok, frame = cap.read()
                if not ok:
                    break
                gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
                frames.append(cv2.resize(gray, (64, 64)).astype(np.float32) / 255.0)
            cap.release()
            if not frames:
                raise ValueError("no decodable frames")
            return self.extract_from_frames(np.stack(frames))
        except Exception as e:  # noqa: BLE001 — the reference's contract
            logger.warning(f"video feature extraction FAILED for {video_path}: "
                           f"{e} — emitting zeros")
            return np.zeros(VIDEO_DIM, dtype=np.float32)


_TOKEN_RE = re.compile(r"[a-z']+")


class TextFeatureExtractor:
    """768-d text features from the best backend at hand:

    1. a corpus-MLM-pretrained TextSequenceEncoder saved by
       `train/text_pretrain.py:TextEncoderFeaturizer` (`encoder_dir` or
       $TPU_DEER_TEXT_ENCODER_DIR), run on `device` (None = the CUDA card);
       its features are padded or cut to 768;
    2. signed feature hashing of words + bigrams into 768 bins,
       l2-normalized: deterministic and dependency-free.

    The reference serves a local BERT first (`bert_dir`,
    $TPU_DEER_BERT_DIR); that backend is not ported, and asking for it
    raises. `bert` is therefore always None, and `encoder` is set by the
    corpus loaders' MLM bootstrap.
    """

    def __init__(self, bert_dir: Optional[str] = None,
                 encoder_dir: Optional[str] = None,
                 device: DeviceLike = None):
        bert_dir = bert_dir or os.environ.get("TPU_DEER_BERT_DIR")
        if bert_dir:
            raise NotImplementedError(
                f"bert_dir={bert_dir!r}: the BERT text backend is not ported "
                f"(its weights are not in the repo)")
        self.bert = None
        self.encoder = None
        encoder_dir = encoder_dir or os.environ.get("TPU_DEER_TEXT_ENCODER_DIR")
        if encoder_dir and os.path.isdir(encoder_dir):
            from tpu_deer_torch.train.text_pretrain import TextEncoderFeaturizer

            device = resolve_device(device)
            try:
                self.encoder = TextEncoderFeaturizer.load(encoder_dir, device=device)
                logger.info(f"text features: MLM-pretrained encoder from "
                            f"{encoder_dir}")
            except Exception as e:  # noqa: BLE001 — the reference's fallback
                logger.warning(f"pretrained text encoder unavailable ({e}); "
                               "using hashed features")

    @property
    def backend(self) -> str:
        """The live backend: 'mlm' or 'hashed'."""
        return "mlm" if self.encoder is not None else "hashed"

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

    @staticmethod
    def _fit_dim(vec: np.ndarray) -> np.ndarray:
        """Pad or cut a backend's feature width to TEXT_DIM."""
        if vec.shape[-1] == TEXT_DIM:
            return vec
        out = np.zeros(TEXT_DIM, dtype=np.float32)
        n = min(TEXT_DIM, vec.shape[-1])
        out[:n] = vec[:n]
        return out

    def extract(self, text: str) -> np.ndarray:
        if not text:
            return np.zeros(TEXT_DIM, dtype=np.float32)
        if self.encoder is not None:
            return self._fit_dim(self.encoder.extract(text))
        return self._hashed(text)

    def extract_batch(self, texts: Sequence[str]) -> np.ndarray:
        if self.encoder is None:
            return np.stack([self.extract(t) for t in texts])
        feats = self.encoder.extract_batch(list(texts))
        if feats.shape[-1] != TEXT_DIM:
            feats = np.stack([self._fit_dim(v) for v in feats])
        for i, t in enumerate(texts):  # empty text stays zeros, as extract()
            if not t:
                feats[i] = 0.0
        return feats


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
        self.text = TextFeatureExtractor(bert_dir, device=device)
