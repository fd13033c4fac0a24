"""Raw-media corpora in the IEMOCAP, RAVDESS and MELD layouts: seeded fixture
generators and the loaders that turn them into the padded arrays the raw
trainer consumes.

Port of `tpu_deer/data/raw_corpus.py`. The same seed and arguments give the
same files and bit-identical arrays as the reference. The layouts:

  * IEMOCAP: Session{1..5}/dialog/{EmoEvaluation,transcriptions}/<dialog>.txt
    (VAD on the 1..5 scale), sentences/wav/<dialog>/<utt>.wav (16-bit PCM)
    and sentences/video/<dialog>/<utt>.npy (frames [T, H, W, 3]); sessions
    1-3 train, 4 val, 5 test.
  * RAVDESS: Actor_01..24/ of filename-coded wavs (03-01-EE-II-SS-RR-AA.wav,
    audio-only) with a `<stem>.npy` decoded-frames sidecar standing in for
    the full-AV mp4; the text is the statement the code names; splits by
    actor, 1-18 / 19-21 / 22-24.
  * MELD: {train,dev,test}_sent_emo.csv (Sr No., Utterance, Emotion,
    Dialogue_ID, Utterance_ID) and per-split media dirs of diaD_uttU.wav and
    diaD_uttU.npy; splits by CSV; a missing wav is zeros, logged.

The fixtures' media encode the label (pitch and energy track arousal, the
second harmonic dominance, frame brightness valence, inter-frame motion
arousal; IEMOCAP and MELD transcripts carry emotion keywords), so training
to a nonzero CCC is a real check. A joint run loads every corpus under one
vocabulary (`merge_vocabs`) and concatenates the splits with a
`dataset_id` column (`combine_raw_splits`).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from tpu_deer_torch.data.audio_io import load_wav
from tpu_deer_torch.data.iemocap import parse_annotations
from tpu_deer_torch.data.vocab import CorpusVocab

logger = logging.getLogger(__name__)

# Emotion prototypes for the fixture generator: (valence, arousal, dominance).
_FIXTURE_CATEGORIES = {
    "joy": (0.7, 0.5, 0.3),
    "sad": (-0.6, -0.5, -0.4),
    "anger": (-0.5, 0.7, 0.5),
    "calm": (0.4, -0.6, 0.1),
}
_FIXTURE_WORDS = {
    "joy": ["wonderful", "delighted", "great", "cheerful"],
    "sad": ["terrible", "mournful", "awful", "gloomy"],
    "anger": ["furious", "outraged", "livid", "irate"],
    "calm": ["peaceful", "serene", "relaxed", "quiet"],
}

def _write_wav(path: Path, signal: np.ndarray, sr: int = 16000) -> None:
    from scipy.io import wavfile

    wavfile.write(str(path), sr,
                  (np.clip(signal, -1, 1) * 32767).astype(np.int16))


def _synth_media(v: float, a: float, d: float, rng, t: np.ndarray,
                 n_frames: int, image_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(signal, frames) whose structure encodes the VAD label."""
    v01, a01, d01 = (v + 1) / 2, (a + 1) / 2, (d + 1) / 2
    f0 = 140.0 + 220.0 * a01
    amp = 0.15 + 0.4 * a01
    sig = amp * np.sin(2 * np.pi * f0 * t)
    sig += (0.05 + 0.25 * d01) * np.sin(2 * np.pi * 2 * f0 * t)
    sig += 0.02 * rng.standard_normal(len(t))

    base = 0.2 + 0.6 * v01
    frames = np.empty((n_frames, image_size, image_size, 3), np.float32)
    phase = rng.random() * 2 * np.pi
    yy = np.linspace(0, 2 * np.pi, image_size)[:, None, None]
    for fidx in range(n_frames):
        motion = 0.15 * a01 * np.sin(yy + phase + fidx * (0.5 + 2.0 * a01))
        frames[fidx] = np.clip(
            base + motion + 0.03 * rng.standard_normal((image_size, image_size, 3)),
            0.0, 1.0,
        )
    return sig, frames


def generate_raw_fixture(root: str, n_train: int = 96, n_val: int = 32,
                         n_test: int = 32, duration_s: float = 0.8,
                         n_frames: int = 4, image_size: int = 16,
                         sample_rate: int = 16000, seed: int = 0) -> str:
    """Write a learnable raw-media corpus in the IEMOCAP layout. Returns root."""
    rng = np.random.default_rng(seed)
    root_path = Path(root)
    cats = list(_FIXTURE_CATEGORIES)
    session_plan = [(1, n_train // 2), (2, n_train - n_train // 2),
                    (4, n_val), (5, n_test)]
    t = np.arange(int(duration_s * sample_rate)) / sample_rate
    for session, count in session_plan:
        sdir = root_path / f"Session{session}"
        (sdir / "dialog" / "EmoEvaluation").mkdir(parents=True, exist_ok=True)
        (sdir / "dialog" / "transcriptions").mkdir(parents=True, exist_ok=True)
        dialog = f"Ses0{session}F_impro01"
        wav_dir = sdir / "sentences" / "wav" / dialog
        vid_dir = sdir / "sentences" / "video" / dialog
        wav_dir.mkdir(parents=True, exist_ok=True)
        vid_dir.mkdir(parents=True, exist_ok=True)
        emo_lines, trans_lines = [], []
        for i in range(count):
            utt = f"{dialog}_F{i:03d}"
            cat = cats[int(rng.integers(len(cats)))]
            v, a, d = (np.clip(x + rng.normal(0, 0.08), -1, 1)
                       for x in _FIXTURE_CATEGORIES[cat])
            sig, frames = _synth_media(v, a, d, rng, t, n_frames, image_size)
            _write_wav(wav_dir / f"{utt}.wav", sig, sample_rate)
            np.save(vid_dir / f"{utt}.npy", frames)
            w1, w2 = rng.choice(_FIXTURE_WORDS[cat], size=2, replace=False)
            text = f"that felt {w1} and {w2} to everyone"
            t1, t2 = float(i), float(i) + duration_s
            # Labels on IEMOCAP's 1..5 scale (the parser maps them to [-1, 1]).
            emo_lines.append(
                f"[{t1:.4f} - {t2:.4f}]\t{utt}\t{cat[:3]}\t"
                f"[{v * 2 + 3:.4f}, {a * 2 + 3:.4f}, {d * 2 + 3:.4f}]"
            )
            trans_lines.append(f"{utt} [{t1:.4f}-{t2:.4f}]: {text}")
        (sdir / "dialog" / "EmoEvaluation" / f"{dialog}.txt").write_text(
            "\n".join(emo_lines))
        (sdir / "dialog" / "transcriptions" / f"{dialog}.txt").write_text(
            "\n".join(trans_lines))
    return root


def generate_raw_fixture_ravdess(
    root: str,
    n_per_actor: int = 8,
    duration_s: float = 0.8,
    n_frames: int = 4,
    image_size: int = 16,
    sample_rate: int = 16000,
    seed: int = 0,
) -> str:
    """Write a learnable raw corpus in the RAVDESS layout: Actor_01..24/
    dirs of filename-coded wavs (03-01-EE-II-SS-RR-AA.wav, audio-only
    modality 03) with a
    `<stem>.npy` decoded-frames sidecar per utterance. Media is synthesized
    from the emotion-code VAD table (data.ravdess.EMOTION_VAD), so
    the loader's labels are recoverable from the media. Returns root."""
    from tpu_deer_torch.data.ravdess import EMOTION_VAD

    rng = np.random.default_rng(seed)
    root_path = Path(root)
    t = np.arange(int(duration_s * sample_rate)) / sample_rate
    emotions = sorted(EMOTION_VAD)
    for actor in range(1, 25):
        adir = root_path / f"Actor_{actor:02d}"
        adir.mkdir(parents=True, exist_ok=True)
        for i in range(n_per_actor):
            emotion = emotions[int(rng.integers(len(emotions)))]
            intensity = 1 + (i % 2)
            statement = 1 + ((i // 2) % 2)
            repetition = 1 + i // 4
            stem = (
                f"03-01-{emotion:02d}-{intensity:02d}-{statement:02d}-"
                f"{repetition:02d}-{actor:02d}"
            )
            v, a, d = EMOTION_VAD[emotion]
            sig, frames = _synth_media(v, a, d, rng, t, n_frames, image_size)
            _write_wav(adir / f"{stem}.wav", sig, sample_rate)
            np.save(adir / f"{stem}.npy", frames)
    return root


def generate_raw_fixture_meld(
    root: str,
    n_train: int = 96,
    n_val: int = 32,
    n_test: int = 32,
    duration_s: float = 0.8,
    n_frames: int = 4,
    image_size: int = 16,
    sample_rate: int = 16000,
    seed: int = 0,
) -> str:
    """Write a learnable raw corpus in the MELD layout: {train,dev,test}_
    sent_emo.csv (Sr No./Utterance/Emotion/Dialogue_ID/Utterance_ID) and
    per-split media dirs holding diaD_uttU.wav and diaD_uttU.npy frame
    sidecars. Returns root."""
    import csv

    from tpu_deer_torch.data.meld import EMOTION_VAD, SPLIT_FILES

    # Emotion-keyword templates so the TEXT channel carries label signal
    # (MELD is text-first; its utterances really do carry the emotion).
    words = {
        "joy": ["wonderful", "delighted", "great", "cheerful"],
        "sadness": ["terrible", "mournful", "awful", "gloomy"],
        "anger": ["furious", "outraged", "livid", "irate"],
        "fear": ["terrified", "scared", "panicked", "afraid"],
        "surprise": ["astonished", "stunned", "unexpected", "amazed"],
        "disgust": ["revolting", "gross", "nauseating", "vile"],
        "neutral": ["ordinary", "routine", "plain", "unremarkable"],
    }
    rng = np.random.default_rng(seed)
    root_path = Path(root)
    t = np.arange(int(duration_s * sample_rate)) / sample_rate
    emotions = sorted(EMOTION_VAD)
    counts = {"train": n_train, "val": n_val, "test": n_test}
    sr_no = 0
    for split, (csv_name, media_dir) in SPLIT_FILES.items():
        mdir = root_path / media_dir
        mdir.mkdir(parents=True, exist_ok=True)
        rows = []
        for i in range(counts[split]):
            sr_no += 1
            emotion = emotions[int(rng.integers(len(emotions)))]
            v, a, d = EMOTION_VAD[emotion]
            dia, utt = i // 4, i % 4
            sig, frames = _synth_media(v, a, d, rng, t, n_frames, image_size)
            _write_wav(mdir / f"dia{dia}_utt{utt}.wav", sig, sample_rate)
            np.save(mdir / f"dia{dia}_utt{utt}.npy", frames)
            w1, w2 = rng.choice(words[emotion], size=2, replace=False)
            rows.append(
                {
                    "Sr No.": sr_no,
                    "Utterance": f"honestly that was {w1} and {w2} to me",
                    "Emotion": emotion,
                    "Dialogue_ID": dia,
                    "Utterance_ID": utt,
                }
            )
        with open(root_path / csv_name, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
    return root


def _video_path_for(sample: dict) -> Optional[Path]:
    """.../sentences/wav/<dialog>/<utt>.wav → .../sentences/video/<dialog>/<utt>.npy"""
    if not sample["wav"]:
        return None
    wav = Path(sample["wav"])
    return wav.parent.parent.parent / "video" / wav.parent.name / (wav.stem + ".npy")


def _assemble_splits(records: dict[str, list], vocab: Optional[CorpusVocab],
                     max_audio_s: float, sample_rate: int,
                     max_video_frames: int, image_size: int,
                     max_tokens: int) -> tuple[dict, CorpusVocab]:
    """{split: [{wav, frames_path, text, label}]} → padded arrays per split:
    signal [N, L] float32, video_frames [N, T, H, W, 3] float32, token_ids
    and token_mask [N, max_tokens] int32, labels [N, 3] float32. The
    vocabulary is built from the train texts when not given."""
    if vocab is None:
        vocab = CorpusVocab.build((r["text"] for r in records.get("train", ())),
                                  max_length=max_tokens)
    n_audio = int(max_audio_s * sample_rate)

    def _load(r):
        return (load_wav(str(r["wav"]), target_sr=sample_rate) if r["wav"]
                else np.zeros(n_audio, np.float32))

    flat = [(split, r) for split, rs in records.items() for r in rs]
    with ThreadPoolExecutor(max_workers=8) as pool:
        signals = list(pool.map(lambda sr: _load(sr[1]), flat))

    splits: dict[str, dict[str, list]] = {}
    for (split, r), sig in zip(flat, signals):
        padded = np.zeros(n_audio, np.float32)
        padded[: min(len(sig), n_audio)] = sig[:n_audio]

        vpath = r.get("frames_path")
        if vpath is not None and Path(vpath).exists():
            frames = np.load(vpath).astype(np.float32)
        else:
            frames = np.zeros((max_video_frames, image_size, image_size, 3),
                              np.float32)
        vid = np.zeros((max_video_frames, image_size, image_size, 3), np.float32)
        tt = min(frames.shape[0], max_video_frames)
        vid[:tt] = frames[:tt, :image_size, :image_size, :3]

        ids, mask = vocab.encode(r["text"])
        bucket = splits.setdefault(split, {
            "signal": [], "video_frames": [], "token_ids": [], "token_mask": [],
            "labels": []})
        bucket["signal"].append(padded)
        bucket["video_frames"].append(vid)
        bucket["token_ids"].append(ids)
        bucket["token_mask"].append(mask)
        bucket["labels"].append(r["label"])

    out = {
        name: {
            "signal": np.stack(b["signal"]).astype(np.float32),
            "video_frames": np.stack(b["video_frames"]).astype(np.float32),
            "token_ids": np.stack(b["token_ids"]).astype(np.int32),
            "token_mask": np.stack(b["token_mask"]).astype(np.int32),
            "labels": np.asarray(b["labels"], np.float32),
        }
        for name, b in splits.items()
    }
    return out, vocab


def load_raw_corpus(root: str, vocab: Optional[CorpusVocab] = None,
                    max_audio_s: float = 1.0, sample_rate: int = 16000,
                    max_video_frames: int = 4, image_size: int = 16,
                    max_tokens: int = 16) -> tuple[dict, CorpusVocab]:
    """Parse an IEMOCAP-layout corpus into raw arrays for sequence training.
    Returns ({"train"/"val"/"test": arrays}, vocab)."""
    samples = parse_annotations(Path(root))
    if not samples:
        raise FileNotFoundError(f"no annotations under {root}")

    def split_of(s) -> str:
        return {5: "test", 4: "val"}.get(s["session"], "train")

    records: dict[str, list] = {}
    for s in samples:
        records.setdefault(split_of(s), []).append({
            "wav": s["wav"],
            "frames_path": _video_path_for(s),
            "text": s["text"],
            "label": [s["valence"], s["arousal"], s["dominance"]],
        })
    return _assemble_splits(records, vocab, max_audio_s, sample_rate,
                            max_video_frames, image_size, max_tokens)


def load_raw_ravdess(
    root: str,
    vocab: Optional[CorpusVocab] = None,
    max_audio_s: float = 1.0,
    sample_rate: int = 16000,
    max_video_frames: int = 4,
    image_size: int = 16,
    max_tokens: int = 16,
) -> tuple[dict[str, dict[str, np.ndarray]], CorpusVocab]:
    """Parse a RAVDESS-layout corpus (filename-coded wavs) into raw arrays.
    Labels come from the emotion-code table (data.ravdess.EMOTION_VAD);
    text is the statement
    sentence the code names; video comes from a `<stem>.npy` decoded-frames
    sidecar when present. Speaker-independent actor splits (1-18/19-21/
    22-24, data.ravdess._split_for_actor)."""
    from tpu_deer_torch.data.ravdess import (
        EMOTION_VAD, STATEMENTS, _split_for_actor, parse_filename,
    )

    records: dict[str, list] = {}
    for wav in sorted(Path(root).rglob("*.wav")):
        meta = parse_filename(wav.stem)
        if meta is None or meta["modality"] == 2:
            continue
        sidecar = wav.with_suffix(".npy")
        records.setdefault(_split_for_actor(meta["actor"]), []).append(
            {
                "wav": wav,
                "frames_path": sidecar if sidecar.exists() else None,
                "text": STATEMENTS.get(meta["statement"], ""),
                "label": list(EMOTION_VAD[meta["emotion"]]),
            }
        )
    if not records:
        raise FileNotFoundError(f"no RAVDESS-coded wav files under {root}")
    return _assemble_splits(
        records, vocab, max_audio_s, sample_rate, max_video_frames,
        image_size, max_tokens,
    )


def load_raw_meld(
    root: str,
    vocab: Optional[CorpusVocab] = None,
    max_audio_s: float = 1.0,
    sample_rate: int = 16000,
    max_video_frames: int = 4,
    image_size: int = 16,
    max_tokens: int = 16,
) -> tuple[dict[str, dict[str, np.ndarray]], CorpusVocab]:
    """Parse a MELD-layout corpus ({train,dev,test}_sent_emo.csv + per-split
    media dirs) into raw arrays. Utterance text is real (MELD is
    text-first); audio/video come from diaD_uttU.wav / diaD_uttU.npy in the
    split's media dir when present (missing media → zeros, logged). Splits
    follow MELD's own CSVs."""
    from tpu_deer_torch.data.meld import EMOTION_VAD, SPLIT_FILES, _read_csv

    root_path = Path(root)
    records: dict[str, list] = {}
    missing_media = 0
    for split, (csv_name, media_dir) in SPLIT_FILES.items():
        csv_path = root_path / csv_name
        if not csv_path.exists():
            continue
        mdir = root_path / media_dir
        for row in _read_csv(csv_path):
            emotion = (row.get("Emotion") or "").strip().lower()
            if emotion not in EMOTION_VAD:
                continue
            stem = (
                f"dia{(row.get('Dialogue_ID') or '').strip()}"
                f"_utt{(row.get('Utterance_ID') or '').strip()}"
            )
            wav = mdir / f"{stem}.wav"
            sidecar = mdir / f"{stem}.npy"
            if not wav.exists():
                missing_media += 1
                wav = None
            records.setdefault(split, []).append(
                {
                    "wav": wav,
                    "frames_path": sidecar if sidecar.exists() else None,
                    "text": row.get("Utterance") or "",
                    "label": list(EMOTION_VAD[emotion]),
                }
            )
    if not records:
        raise FileNotFoundError(f"no MELD CSV files under {root}")
    if missing_media:
        logger.warning(
            f"MELD raw: {missing_media} utterances have no wav in the media "
            "dirs — audio channel zero-filled for those (NOT random noise)"
        )
    return _assemble_splits(
        records, vocab, max_audio_s, sample_rate, max_video_frames,
        image_size, max_tokens,
    )


def merge_vocabs(vocabs, max_length: int = 16) -> CorpusVocab:
    """Union of the non-special tokens of several corpus vocabularies
    (deterministic sorted order) — the shared vocabulary joint multi-corpus
    raw runs load every corpus under."""
    from tpu_deer_torch.data.vocab import N_SPECIAL

    tokens = sorted({t for v in vocabs for t in v.itos[N_SPECIAL:]})
    return CorpusVocab(tokens, max_length=max_length)


def combine_raw_splits(
    corpora: dict[str, dict[str, dict[str, np.ndarray]]],
) -> dict[str, dict[str, np.ndarray]]:
    """Concatenate per-corpus split dicts (all loaded under ONE shared
    vocabulary and identical media geometry) into a joint corpus, adding a
    `dataset_id` column (order = sorted corpus names) so joint runs can
    report per-corpus metrics."""
    names = sorted(corpora)
    out: dict[str, dict[str, np.ndarray]] = {}
    for split in ("train", "val", "test"):
        present = [n for n in names if split in corpora[n]]
        if not present:
            continue
        keys = corpora[present[0]][split].keys()
        merged = {
            k: np.concatenate([corpora[n][split][k] for n in present])
            for k in keys
        }
        merged["dataset_id"] = np.concatenate(
            [
                np.full(
                    len(corpora[n][split]["labels"]), names.index(n), np.int32
                )
                for n in present
            ]
        )
        out[split] = merged
    return out
