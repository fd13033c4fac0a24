"""MELD loader: conversational utterances with categorical emotions → VAD.

Port of `tpu_deer/data/meld.py`. CSV files train_sent_emo.csv,
dev_sent_emo.csv and test_sent_emo.csv with at least `Utterance` and
`Emotion` columns give the splits; optional clips under `train_splits/`,
`dev_splits_complete/` and `output_repeated_splits_test/` named
`diaD_uttU.mp4` give video. Each emotion maps to a VAD target with a
dominance coordinate. The text is real; the audio is zeros (MELD's audio
lives in the clips, which this loader does not decode for sound, as the
reference's), so no signal reaches K1; video without clips is zeros, with
a warning.

AUTO (`pretrain_text=None`) MLM-pretrains the text featurizer on the train
CSV's utterances when the loader builds its own extractor, as
`data/iemocap.py` does, with the same resolved-backend cache key. The
result also carries "text_backend", "load_s" and "text_encoder".
"""

from __future__ import annotations

import csv
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np

from tpu_deer_torch.data.cache import cache_dir_for, load_cached, save_cached
from tpu_deer_torch.data.iemocap import bootstrap_text, wants_mlm
from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.device import DeviceLike

logger = logging.getLogger(__name__)

EMOTION_VAD = {
    "joy": (0.8, 0.6, 0.4),
    "sadness": (-0.8, -0.4, -0.4),
    "anger": (-0.6, 0.8, 0.6),
    "fear": (-0.5, 0.7, -0.5),
    "surprise": (0.3, 0.8, 0.0),
    "disgust": (-0.8, 0.2, 0.1),
    "neutral": (0.0, 0.0, 0.0),
}

SPLIT_FILES = {
    "train": ("train_sent_emo.csv", "train_splits"),
    "val": ("dev_sent_emo.csv", "dev_splits_complete"),
    "test": ("test_sent_emo.csv", "output_repeated_splits_test"),
}


def _read_csv(path: Path) -> list[dict]:
    with open(path, newline="", encoding="utf-8", errors="replace") as f:
        return list(csv.DictReader(f))


def load_meld(root_path: str, quick: bool = False,
              cache_dir: Optional[str] = None, extractor=None,
              pretrain_text: Optional[bool] = None,
              device: DeviceLike = None) -> dict:
    """Parse and featurize MELD → {"train"/"val"/"test": ArrayDataset,
    "text_backend", "load_s", "text_encoder"}; a loader-built extractor and
    the MLM featurizer run on `device` (None = the CUDA card)."""
    from tpu_deer_torch.data.features import MultimodalFeatureExtractor
    from tpu_deer_torch.data.tokenizer import HashTokenizer

    t0 = time.perf_counter()
    root = Path(root_path)
    cdir = cache_dir_for(root_path, cache_dir)
    caller_extractor = extractor is not None
    extractor = extractor or MultimodalFeatureExtractor(device=device)
    want_mlm = wants_mlm(pretrain_text, caller_extractor, extractor)
    base_key = f"meld_{'quick' if quick else 'full'}_v3"
    if not want_mlm:
        key = f"{base_key}_{extractor.text.backend}text"
        cached = load_cached(cdir, key)
        if cached is not None:
            return _unpack(cached, {"cache_s": time.perf_counter() - t0},
                           extractor.text.encoder)

    split_rows: dict[str, list[dict]] = {}
    for split, (csv_name, _) in SPLIT_FILES.items():
        csv_path = root / csv_name
        if not csv_path.exists():
            continue
        rows = [r for r in _read_csv(csv_path)
                if r.get("Emotion", "").lower() in EMOTION_VAD]
        split_rows[split] = rows[:100] if quick else rows
    if not split_rows:
        raise FileNotFoundError(f"no MELD CSVs under {root_path}")

    times = {}
    t = time.perf_counter()
    if want_mlm:
        bootstrap_text(extractor, [
            r.get("Utterance", "") for r in split_rows.get("train", [])
            if r.get("Utterance", "")], cdir, device, "the MELD train CSV")
        key = f"{base_key}_{extractor.text.backend}text"
        cached = load_cached(cdir, key)
        if cached is not None:
            return _unpack(cached, {"mlm_s": time.perf_counter() - t,
                                    "total_s": time.perf_counter() - t0},
                           extractor.text.encoder)
    times["mlm_s"] = time.perf_counter() - t

    packed: dict[str, np.ndarray] = {}
    times["text_s"] = times["video_s"] = 0.0
    for split, rows in split_rows.items():
        texts = [r.get("Utterance", "") for r in rows]
        t = time.perf_counter()
        text_feats = (extractor.text.extract_batch(texts) if rows
                      else np.zeros((0, 768), np.float32))
        times["text_s"] += time.perf_counter() - t
        if rows:
            token_ids, token_mask = HashTokenizer().encode_batch(texts)
        else:
            token_ids = np.zeros((0, 128), np.int32)
            token_mask = np.zeros((0, 128), np.int32)

        video_feats = np.zeros((len(rows), 256), dtype=np.float32)
        audio_feats = np.zeros((len(rows), 84), dtype=np.float32)
        clips_root = root / SPLIT_FILES[split][1]
        n_clips = 0
        t = time.perf_counter()
        if clips_root.is_dir():
            for i, r in enumerate(rows):
                clip = clips_root / (f"dia{r.get('Dialogue_ID', '')}"
                                     f"_utt{r.get('Utterance_ID', '')}.mp4")
                if clip.exists():
                    video_feats[i] = extractor.video.extract(str(clip))
                    n_clips += 1
        times["video_s"] += time.perf_counter() - t
        if n_clips == 0:
            logger.warning(f"MELD {split}: no video clips found under "
                           f"{clips_root} — audio/video features are zeros "
                           "(text-only training signal)")
        packed[f"{split}_audio"] = audio_feats
        packed[f"{split}_video"] = video_feats
        packed[f"{split}_text"] = text_feats.astype(np.float32)
        packed[f"{split}_token_ids"] = token_ids.astype(np.int32)
        packed[f"{split}_token_mask"] = token_mask.astype(np.int32)
        packed[f"{split}_labels"] = np.asarray(
            [EMOTION_VAD[r["Emotion"].lower()] for r in rows], dtype=np.float32)

    packed["text_backend"] = np.array(extractor.text.backend)
    save_cached(cdir, key, packed)
    times["total_s"] = time.perf_counter() - t0
    return _unpack(packed, times, extractor.text.encoder)


def _unpack(packed: dict, times: dict, text_encoder=None) -> dict:
    out: dict = {}
    for split in ("train", "val", "test"):
        if f"{split}_labels" in packed:
            arrays = {k: packed[f"{split}_{k}"]
                      for k in ("audio", "video", "text", "labels")}
            if f"{split}_token_ids" in packed:
                arrays["token_ids"] = packed[f"{split}_token_ids"]
                arrays["token_mask"] = packed[f"{split}_token_mask"]
            out[split] = ArrayDataset(arrays, name="meld")
    out["text_backend"] = str(packed.get("text_backend", "hashed"))
    out["load_s"] = times
    out["text_encoder"] = text_encoder
    return out
