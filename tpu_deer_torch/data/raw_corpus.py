"""Raw-media corpus in the IEMOCAP layout: a seeded fixture generator and the
loader that turns it into the padded arrays the raw trainer consumes.

Port of the IEMOCAP half of `tpu_deer/data/raw_corpus.py`, with its own
copy of the annotation parser (`tpu_deer/data/iemocap.py:parse_annotations`).
The same seed and arguments give the same files and bit-identical arrays as
the reference. The layout:

  Session{1..5}/dialog/EmoEvaluation/<dialog>.txt   VAD on IEMOCAP's 1..5 scale
  Session{1..5}/dialog/transcriptions/<dialog>.txt
  Session{1..5}/sentences/wav/<dialog>/<utt>.wav    16-bit PCM
  Session{1..5}/sentences/video/<dialog>/<utt>.npy  frames [T, H, W, 3]

Splits: sessions 1-3 train, 4 val, 5 test. The fixture's media encode the
label (pitch and energy track arousal, the second harmonic dominance, frame
brightness valence, inter-frame motion arousal; transcripts carry emotion
keywords), so training to a nonzero CCC is a real check. The RAVDESS and
MELD layouts are not ported yet.
"""

from __future__ import annotations

import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from tpu_deer_torch.data.audio_io import load_wav
from tpu_deer_torch.data.vocab import CorpusVocab

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
