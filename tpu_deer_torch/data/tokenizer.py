"""Deterministic hash tokenizer for the raw text path.

Own copy of `tpu_deer/data/tokenizer.py`: token → md5 → id in
[N_SPECIAL, vocab_size), the same ids in every process and as the
reference's, so cached datasets stay consistent.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

_TOKEN_RE = re.compile(r"[a-z']+|[0-9]+|[^\sa-z0-9']")

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
UNK_ID = 3
N_SPECIAL = 4


class HashTokenizer:
    def __init__(self, vocab_size: int = 30522, max_length: int = 128):
        self.vocab_size = vocab_size
        self.max_length = max_length

    def token_id(self, token: str) -> int:
        digest = hashlib.md5(token.encode()).digest()
        span = self.vocab_size - N_SPECIAL
        return N_SPECIAL + int.from_bytes(digest[:4], "little") % span

    def encode(self, text: str) -> tuple[np.ndarray, np.ndarray]:
        """text → (ids [max_length], mask [max_length]) with [CLS]...[SEP]."""
        tokens = _TOKEN_RE.findall(text.lower())
        ids = [CLS_ID] + [self.token_id(t) for t in tokens][: self.max_length - 2]
        ids.append(SEP_ID)
        mask = np.zeros(self.max_length, dtype=np.int32)
        mask[: len(ids)] = 1
        out = np.full(self.max_length, PAD_ID, dtype=np.int32)
        out[: len(ids)] = ids
        return out, mask

    def encode_batch(self, texts) -> tuple[np.ndarray, np.ndarray]:
        pairs = [self.encode(t) for t in texts]
        return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))
