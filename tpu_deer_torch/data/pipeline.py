"""Host-side data pipeline: array datasets and seeded batch iteration.

Own copy of `tpu_deer/data/pipeline.py`: data lives as contiguous numpy
arrays on the host; batches are index vectors from a seeded permutation,
padded to a static batch size by wrapping around (with a mask marking the
real rows). The trainer stages the arrays on the device once and gathers
each batch there from its index vector. The same seed gives the same order
and masks as the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    """A dict of equal-length numpy arrays + a name (dataset identity)."""

    arrays: dict[str, np.ndarray]
    name: str = "dataset"

    def __post_init__(self):
        lengths = {k: len(v) for k, v in self.arrays.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"ragged arrays: {lengths}")

    def __len__(self) -> int:
        return len(next(iter(self.arrays.values())))

    def slice(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays.items()}


class BatchIterator:
    """Seeded, shuffled, statically-shaped batch iterator.

    The final partial batch is padded by wrapping around (with a `mask` array
    marking real rows) so every step sees the same shape. With
    `drop_last=True` (the trainer's default) partial batches are dropped
    instead.

    Multi-process: pass `process_index`/`process_count` and each process
    yields only its contiguous `batch_size/process_count` slice of every
    global batch (the same seeded permutation on every process keeps them in
    lockstep).
    """

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if batch_size % max(1, process_count) != 0:
            raise ValueError(
                f"global batch_size {batch_size} must be divisible by "
                f"process_count {process_count}"
            )
        if not 0 <= process_index < max(1, process_count):
            raise ValueError(
                f"process_index {process_index} out of range for "
                f"process_count {process_count}"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = max(1, process_count)
        self._epoch = 0
        self._seed = seed

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch_indices(
        self, epoch: Optional[int] = None
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield (index [B] int32, mask [B] float32) per batch — the host→
        device payload when the dataset itself is staged on device."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self._seed + epoch).permutation(n)

        n_batches = len(self)
        local = self.batch_size // self.process_count
        lo, hi = self.process_index * local, (self.process_index + 1) * local
        for b in range(n_batches):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            mask = np.ones(self.batch_size, dtype=np.float32)
            if len(idx) < self.batch_size:
                pad = self.batch_size - len(idx)
                mask[len(idx) :] = 0.0
                # Wrap around as many times as needed (pad may exceed n for
                # datasets smaller than one batch).
                filler = np.resize(order, pad)
                idx = np.concatenate([idx, filler])
            yield idx[lo:hi].astype(np.int32), mask[lo:hi]

    def epoch(self, epoch: Optional[int] = None) -> Iterator[dict[str, np.ndarray]]:
        for idx, mask in self.epoch_indices(epoch):
            batch = self.dataset.slice(idx)
            batch["mask"] = mask
            yield batch


def pad_to_multiple(arrays: dict[str, np.ndarray], multiple: int) -> dict:
    """Pad the leading axis to a multiple (for even sharding across devices)."""
    n = len(next(iter(arrays.values())))
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        out = dict(arrays)
        out["mask"] = np.ones(n, dtype=np.float32)
        return out
    pad = target - n
    out = {
        k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
        for k, v in arrays.items()
    }
    out["mask"] = np.concatenate(
        [np.ones(n, dtype=np.float32), np.zeros(pad, dtype=np.float32)]
    )
    return out
