"""On-disk feature cache: one compressed npz per (dataset, split, config key).

Own copy of `tpu_deer/data/cache.py`, with the same npz format and keys.
The cache directory next to a corpus is `tpu_deer_torch_cache`, not the
reference's `tpu_deer_cache`: neither package ever reads features or a text
encoder that the other one wrote.
"""

from __future__ import annotations

import hashlib
import logging
import os
import tempfile
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

CACHE_DIR_NAME = "tpu_deer_torch_cache"


def cache_dir_for(root_path: str, explicit: Optional[str] = None) -> str:
    """`explicit`, else `<root_path>/tpu_deer_torch_cache`, else (a read-only
    corpus) a per-corpus directory under the temporary directory."""
    if explicit:
        os.makedirs(explicit, exist_ok=True)
        return explicit
    candidate = os.path.join(root_path, CACHE_DIR_NAME)
    try:
        os.makedirs(candidate, exist_ok=True)
        probe = os.path.join(candidate, ".w")
        with open(probe, "w") as f:
            f.write("")
        os.remove(probe)
        return candidate
    except OSError:
        digest = hashlib.md5(os.path.abspath(root_path).encode()).hexdigest()[:12]
        fallback = os.path.join(tempfile.gettempdir(), CACHE_DIR_NAME, digest)
        os.makedirs(fallback, exist_ok=True)
        return fallback


def load_cached(cache_dir: str, key: str) -> Optional[dict[str, np.ndarray]]:
    path = os.path.join(cache_dir, f"{key}.npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception as e:  # noqa: BLE001 — a bad entry is a cache miss
        logger.warning(f"cache read failed for {path}: {e}")
        return None


def save_cached(cache_dir: str, key: str, arrays: dict[str, np.ndarray]) -> None:
    path = os.path.join(cache_dir, f"{key}.npz")
    try:
        np.savez_compressed(path, **arrays)
    except OSError as e:
        logger.warning(f"cache write failed for {path}: {e}")
