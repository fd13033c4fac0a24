"""RAVDESS loader: filename-coded categorical emotions → VAD and features.

Port of `tpu_deer/data/ravdess.py`. Files are named
`MM-VC-EE-II-SS-RR-AA.(wav|mp4)` under Actor_XX/ (modality, vocal channel,
emotion, intensity, statement, repetition, actor). The emotion codes follow
the RAVDESS spec (01 neutral, 02 calm, 03 happy, 04 sad, 05 angry, 06
fearful, 07 disgust, 08 surprised), each mapped to a VAD target with a
dominance coordinate. The text is the statement the code names. Splits are
speaker-independent by actor: 1-18 train, 19-21 val, 22-24 test.

The audio goes through `extractor.audio.extract_batch` (K1 on the card);
video comes from the full-AV mp4 sibling where there is one
(`VideoFeatureExtractor.extract`). No MLM bootstrap: the corpus has two
fixed statements. The result also carries "text_backend", "decoder"
(the wav decoder, "native" or "scipy"; None on a cache hit), "load_s" and
"text_encoder".
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np

from tpu_deer_torch.data.cache import cache_dir_for, load_cached, save_cached
from tpu_deer_torch.data.iemocap import _split_arrays, decode_all
from tpu_deer_torch.device import DeviceLike

logger = logging.getLogger(__name__)

# code → (valence, arousal, dominance)
EMOTION_VAD = {
    1: (0.0, 0.0, 0.0),     # neutral
    2: (0.2, -0.5, 0.0),    # calm
    3: (0.8, 0.6, 0.4),     # happy
    4: (-0.6, -0.4, -0.4),  # sad
    5: (-0.7, 0.8, 0.6),    # angry
    6: (-0.5, 0.7, -0.5),   # fearful
    7: (-0.8, 0.2, 0.1),    # disgust
    8: (0.3, 0.8, 0.0),     # surprised
}

STATEMENTS = {
    1: "Kids are talking by the door",
    2: "Dogs are sitting by the door",
}


def parse_filename(stem: str) -> Optional[dict]:
    parts = stem.split("-")
    if len(parts) != 7:
        return None
    try:
        modality, channel, emotion, intensity, statement, repetition, actor = (
            int(p) for p in parts)
    except ValueError:
        return None
    if emotion not in EMOTION_VAD:
        return None
    return {
        "modality": modality,  # 01 full-AV, 02 video-only, 03 audio-only
        "channel": channel,
        "emotion": emotion,
        "intensity": intensity,
        "statement": statement,
        "repetition": repetition,
        "actor": actor,
    }


def _split_for_actor(actor: int) -> str:
    if actor <= 18:
        return "train"
    if actor <= 21:
        return "val"
    return "test"


def load_ravdess(root_path: str, quick: bool = False,
                 cache_dir: Optional[str] = None, extractor=None,
                 device: DeviceLike = None) -> dict:
    """Parse and featurize RAVDESS → {"train"/"val"/"test": ArrayDataset,
    "text_backend", "load_s", "text_encoder"}; a loader-built extractor
    runs on `device` (None = the CUDA card)."""
    from tpu_deer_torch.data.features import MultimodalFeatureExtractor

    t0 = time.perf_counter()
    root = Path(root_path)
    cdir = cache_dir_for(root_path, cache_dir)
    key = f"ravdess_{'quick' if quick else 'full'}_v1"
    cached = load_cached(cdir, key)
    if cached is not None:
        return _split_arrays(cached, {"cache_s": time.perf_counter() - t0},
                             "ravdess")

    records = []
    for wav in sorted(root.rglob("*.wav")):
        meta = parse_filename(wav.stem)
        if meta is None or meta["modality"] == 2:  # video-only codes
            continue
        mp4 = wav.with_suffix(".mp4")
        if not mp4.exists():  # the full-AV sibling: modality 01
            sib = wav.parent / ("01-" + "-".join(wav.stem.split("-")[1:]) + ".mp4")
            mp4 = sib if sib.exists() else None
        records.append({"wav": wav, "mp4": mp4, **meta})
    if not records:
        raise FileNotFoundError(f"no RAVDESS wav files under {root_path}")
    if quick:
        records = records[:200]

    extractor = extractor or MultimodalFeatureExtractor(device=device)
    times = {}
    t = time.perf_counter()
    signals, decoder = decode_all([r["wav"] for r in records])
    times["decode_s"] = time.perf_counter() - t
    t = time.perf_counter()
    audio_feats = extractor.audio.extract_batch(signals)
    times["audio_s"] = time.perf_counter() - t
    t = time.perf_counter()
    text_feats = extractor.text.extract_batch(
        [STATEMENTS.get(r["statement"], "") for r in records])
    times["text_s"] = time.perf_counter() - t
    t = time.perf_counter()
    video_feats = np.stack([
        extractor.video.extract(str(r["mp4"])) if r["mp4"] is not None
        else np.zeros(256, dtype=np.float32) for r in records])
    times["video_s"] = time.perf_counter() - t

    arrays = {
        "audio": audio_feats.astype(np.float32),
        "video": video_feats.astype(np.float32),
        "text": text_feats.astype(np.float32),
        "labels": np.asarray([EMOTION_VAD[r["emotion"]] for r in records],
                             dtype=np.float32),
        "split_code": np.asarray([
            {"train": 0, "val": 1, "test": 2}[_split_for_actor(r["actor"])]
            for r in records], dtype=np.int32),
        "text_backend": np.array(extractor.text.backend),
    }
    save_cached(cdir, key, arrays)
    times["total_s"] = time.perf_counter() - t0
    return _split_arrays(arrays, times, "ravdess", extractor.text.encoder,
                         decoder)
