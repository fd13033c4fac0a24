"""IEMOCAP loader: dimensional VAD labels and trimodal features.

Port of `tpu_deer/data/iemocap.py`. The layout:

  Session{1..5}/
    dialog/EmoEvaluation/<dialog>.txt
        [6.2901 - 8.2357]\tSes01F_impro01_F000\tneu\t[2.5000, 2.5000, 2.5000]
    dialog/transcriptions/<dialog>.txt
        Ses01F_impro01_F000 [6.2901-8.2357]: Excuse me.
    dialog/avi/DivX/<dialog>.avi                  (optional, dialog video)
    sentences/wav/<dialog>/<utterance>.wav

VAD on IEMOCAP's 1..5 scale are mapped to [-1, 1] by (v - 3) / 2. Splits
are speaker-independent: the speakers of sessions 1-4 split 80/20 into
train and val (the last fifth of the sorted speaker ids), session 5 is the
test set.

The audio of every utterance (a missing wav is 1,600 zeros) goes through
`extractor.audio.extract_batch`, one launch of K1 a length bucket on the
card. By default (AUTO, `pretrain_text=None`) a loader that builds its own
extractor MLM-pretrains the text featurizer on the corpus's own train-split
transcripts (`train/text_pretrain.py`, cached by corpus content); a caller's
extractor is used as it is. The feature cache is keyed on the text backend
that was actually resolved. The result also carries "text_backend",
"load_s", the wall seconds of the load's parts (decode, audio, mlm, text,
video, total), and "text_encoder", the MLM featurizer the load used (its
`history` set where this load trained it) or None.
"""

from __future__ import annotations

import logging
import re
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from tpu_deer_torch.data.cache import cache_dir_for, load_cached, save_cached
from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.device import DeviceLike

logger = logging.getLogger(__name__)

EMO_LINE = re.compile(
    r"\[(\d+\.\d+)\s*-\s*(\d+\.\d+)\]\t(\S+)\t(\S+)\t\[(-?\d+\.?\d*),\s*(-?\d+\.?\d*),\s*(-?\d+\.?\d*)\]"
)
TRANSCRIPT_LINE = re.compile(r"(\S+)\s+\[[\d.]+-[\d.]+\]:\s*(.*)")


def _speaker_id(utt_id: str, session: int) -> str:
    """Ses01F_impro01_F000 → speaker 'Ses01_F' (the F/M of the utterance)."""
    turn = utt_id.split("_")[-1]
    gender = turn[0] if turn and turn[0] in "FM" else "X"
    return f"Ses{session:02d}_{gender}"


def parse_annotations(root: Path) -> list[dict]:
    """Walk all sessions; returns one dict per annotated utterance with VAD
    mapped from 1..5 to [-1, 1] by (x - 3) / 2."""
    samples = []
    for session in range(1, 6):
        sdir = root / f"Session{session}"
        emo_dir = sdir / "dialog" / "EmoEvaluation"
        trans_dir = sdir / "dialog" / "transcriptions"
        if not emo_dir.is_dir():
            continue
        for emo_file in sorted(emo_dir.glob("*.txt")):
            dialog = emo_file.stem
            transcripts: dict[str, str] = {}
            tfile = trans_dir / f"{dialog}.txt"
            if tfile.exists():
                for line in tfile.read_text(errors="replace").splitlines():
                    m = TRANSCRIPT_LINE.match(line)
                    if m:
                        transcripts[m.group(1)] = m.group(2)
            for line in emo_file.read_text(errors="replace").splitlines():
                m = EMO_LINE.match(line)
                if not m:
                    continue
                utt_id = m.group(3)
                v, a, d = (float(m.group(i)) for i in (5, 6, 7))
                wav = sdir / "sentences" / "wav" / dialog / f"{utt_id}.wav"
                avi = sdir / "dialog" / "avi" / "DivX" / f"{dialog}.avi"
                samples.append({
                    "utt_id": utt_id,
                    "session": session,
                    "speaker": _speaker_id(utt_id, session),
                    "emotion": m.group(4),
                    "valence": (v - 3.0) / 2.0,
                    "arousal": (a - 3.0) / 2.0,
                    "dominance": (d - 3.0) / 2.0,
                    "wav": str(wav) if wav.exists() else None,
                    "avi": str(avi) if avi.exists() else None,
                    "t1": float(m.group(1)),
                    "t2": float(m.group(2)),
                    "text": transcripts.get(utt_id, ""),
                })
    return samples


def _assign_split(sample: dict, val_speakers: set[str]) -> str:
    if sample["session"] == 5:
        return "test"
    return "val" if sample["speaker"] in val_speakers else "train"


def _extract_video_segment(avi_path: str, t1: float, t2: float, extractor):
    """Dialog-level video: 8 frames inside [t1, t2], grayscale 64x64 →
    256-d; zeros with a warning when it cannot be decoded."""
    try:
        import cv2

        cap = cv2.VideoCapture(avi_path)
        fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
        frames = []
        for frac in np.linspace(0, 1, 8):
            t = t1 + frac * max(t2 - t1, 0.04)
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(t * fps))
            ok, frame = cap.read()
            if not ok:
                break
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            frames.append(cv2.resize(gray, (64, 64)).astype(np.float32) / 255.0)
        cap.release()
        if frames:
            return extractor.video.extract_from_frames(np.stack(frames))
    except Exception as e:  # noqa: BLE001 — the reference's contract
        logger.warning(f"video segment extraction failed ({avi_path}): {e}")
    return np.zeros(256, dtype=np.float32)


def wants_mlm(pretrain_text: Optional[bool], caller_extractor: bool,
              extractor) -> bool:
    """AUTO: pretrain when asked to, or when the loader built its own
    extractor and it has no semantic backend."""
    return pretrain_text is True or (
        pretrain_text is None and not caller_extractor
        and extractor.text.bert is None and extractor.text.encoder is None)


def bootstrap_text(extractor, train_texts, cache_dir, device, what: str) -> None:
    """Give `extractor` an MLM featurizer trained on `train_texts` (or warn
    and keep hashing when there are none)."""
    if extractor.text.bert is not None or extractor.text.encoder is not None:
        return
    if train_texts:
        from tpu_deer_torch.train.text_pretrain import corpus_text_featurizer

        extractor.text.encoder = corpus_text_featurizer(train_texts, cache_dir,
                                                        device=device)
    else:
        logger.warning(f"text bootstrap skipped: {what} has no train-split "
                       "transcripts — falling back to hashed text features")


def decode_all(paths, fill: int = 1600) -> list[np.ndarray]:
    """Each wav decoded (a pool of 8 threads); None gives `fill` zeros."""
    from tpu_deer_torch.data.audio_io import load_wav

    with ThreadPoolExecutor(max_workers=8) as pool:
        return list(pool.map(
            lambda p: load_wav(str(p)) if p else np.zeros(fill, np.float32),
            paths))


def load_iemocap(root_path: str, quick: bool = False,
                 cache_dir: Optional[str] = None, extractor=None,
                 pretrain_text: Optional[bool] = None,
                 device: DeviceLike = None) -> dict:
    """Parse and featurize IEMOCAP → {"train"/"val"/"test": ArrayDataset,
    "text_backend": str, "load_s": {part: seconds}, "text_encoder"}. An
    extractor the loader builds, and the MLM featurizer, run on `device`
    (None = the CUDA card)."""
    from tpu_deer_torch.data.features import MultimodalFeatureExtractor
    from tpu_deer_torch.data.tokenizer import HashTokenizer

    t0 = time.perf_counter()
    root = Path(root_path)
    cdir = cache_dir_for(root_path, cache_dir)
    caller_extractor = extractor is not None
    extractor = extractor or MultimodalFeatureExtractor(device=device)
    want_mlm = wants_mlm(pretrain_text, caller_extractor, extractor)
    base_key = f"iemocap_{'quick' if quick else 'full'}_v3"
    if not want_mlm:
        key = f"{base_key}_{extractor.text.backend}text"
        cached = load_cached(cdir, key)
        if cached is not None:
            return _split_arrays(cached, {"cache_s": time.perf_counter() - t0},
                                 text_encoder=extractor.text.encoder)

    samples = parse_annotations(root)
    if not samples:
        raise FileNotFoundError(f"no IEMOCAP annotations under {root_path}")
    if quick:
        samples = samples[:200]
    speakers_14 = sorted({s["speaker"] for s in samples if s["session"] < 5})
    n_val = max(1, int(0.2 * len(speakers_14)))
    val_speakers = set(speakers_14[-n_val:])

    times = {}
    t = time.perf_counter()
    if want_mlm:
        bootstrap_text(extractor, [
            s["text"] for s in samples
            if s["text"] and _assign_split(s, val_speakers) == "train"],
            cdir, device, "the corpus")
        key = f"{base_key}_{extractor.text.backend}text"
        cached = load_cached(cdir, key)
        if cached is not None:
            return _split_arrays(cached, {"mlm_s": time.perf_counter() - t,
                                          "total_s": time.perf_counter() - t0},
                                 text_encoder=extractor.text.encoder)
    times["mlm_s"] = time.perf_counter() - t

    t = time.perf_counter()
    signals = decode_all([s["wav"] for s in samples])
    times["decode_s"] = time.perf_counter() - t
    texts = [s["text"] for s in samples]
    t = time.perf_counter()
    audio_feats = extractor.audio.extract_batch(signals)
    times["audio_s"] = time.perf_counter() - t
    t = time.perf_counter()
    text_feats = extractor.text.extract_batch(texts)
    times["text_s"] = time.perf_counter() - t
    token_ids, token_mask = HashTokenizer().encode_batch(texts)
    t = time.perf_counter()
    video_feats = np.stack([
        _extract_video_segment(s["avi"], s["t1"], s["t2"], extractor)
        if s["avi"] else np.zeros(256, dtype=np.float32)
        for s in samples])
    times["video_s"] = time.perf_counter() - t

    arrays = {
        "audio": audio_feats.astype(np.float32),
        "video": video_feats.astype(np.float32),
        "text": text_feats.astype(np.float32),
        "token_ids": token_ids.astype(np.int32),
        "token_mask": token_mask.astype(np.int32),
        "labels": np.asarray([[s["valence"], s["arousal"], s["dominance"]]
                              for s in samples], dtype=np.float32),
        "split_code": np.asarray([
            {"train": 0, "val": 1, "test": 2}[_assign_split(s, val_speakers)]
            for s in samples], dtype=np.int32),
        "text_backend": np.array(extractor.text.backend),
    }
    save_cached(cdir, key, arrays)
    times["total_s"] = time.perf_counter() - t0
    return _split_arrays(arrays, times, text_encoder=extractor.text.encoder)


_META_KEYS = ("split_code", "text_backend")


def _split_arrays(arrays: dict, times: dict, name: str = "iemocap",
                  text_encoder=None) -> dict:
    code = arrays["split_code"]
    out: dict = {}
    for split, c in (("train", 0), ("val", 1), ("test", 2)):
        idx = np.where(code == c)[0]
        out[split] = ArrayDataset(
            {k: v[idx] for k, v in arrays.items() if k not in _META_KEYS},
            name=name)
    out["text_backend"] = str(arrays.get("text_backend", "hashed"))
    out["load_s"] = times
    out["text_encoder"] = text_encoder
    return out
