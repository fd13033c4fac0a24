"""Corpus vocabulary for the text path (own copy of `tpu_deer/data/vocab.py`).

Frequency-sorted word types with the special tokens [PAD] [CLS] [SEP] [UNK]
[MASK]; the same ids as the reference for the same corpus, and the same
JSON file.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from typing import Iterable, Sequence

import numpy as np

_TOKEN_RE = re.compile(r"[a-z']+|[0-9]+|[^\sa-z0-9']")

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
UNK_ID = 3
MASK_ID = 4
SPECIAL_TOKENS = ("[PAD]", "[CLS]", "[SEP]", "[UNK]", "[MASK]")
N_SPECIAL = len(SPECIAL_TOKENS)


def tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


class CorpusVocab:
    """Frequency-sorted word vocabulary built from corpus text."""

    def __init__(self, tokens: Sequence[str], max_length: int = 128):
        """`tokens` is the ordered non-special vocabulary (ids start at
        N_SPECIAL); `CorpusVocab.build(texts)` makes one from a corpus."""
        self.itos = list(SPECIAL_TOKENS) + list(tokens)
        self.stoi = {t: i for i, t in enumerate(self.itos)}
        self.max_length = max_length

    @classmethod
    def build(cls, texts: Iterable[str], max_size: int = 30000,
              min_count: int = 1, max_length: int = 128) -> "CorpusVocab":
        counts = Counter()
        for text in texts:
            counts.update(tokenize(text))
        # (-count, token) gives a deterministic order.
        items = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        tokens = [t for t, c in items if c >= min_count][: max_size - N_SPECIAL]
        return cls(tokens, max_length=max_length)

    def __len__(self) -> int:
        return len(self.itos)

    @property
    def vocab_size(self) -> int:
        return len(self.itos)

    def token_id(self, token: str) -> int:
        return self.stoi.get(token, UNK_ID)

    def encode(self, text: str) -> tuple[np.ndarray, np.ndarray]:
        """text → (ids [max_length], mask [max_length]) with [CLS] ... [SEP]."""
        ids = [CLS_ID] + [self.token_id(t)
                          for t in tokenize(text)][: self.max_length - 2]
        ids.append(SEP_ID)
        mask = np.zeros(self.max_length, dtype=np.int32)
        mask[: len(ids)] = 1
        out = np.full(self.max_length, PAD_ID, dtype=np.int32)
        out[: len(ids)] = ids
        return out, mask

    def encode_batch(self, texts) -> tuple[np.ndarray, np.ndarray]:
        pairs = [self.encode(t) for t in texts]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"tokens": self.itos[N_SPECIAL:],
                       "max_length": self.max_length}, f)

    @classmethod
    def load(cls, path: str) -> "CorpusVocab":
        with open(path) as f:
            payload = json.load(f)
        return cls(payload["tokens"], max_length=payload["max_length"])
