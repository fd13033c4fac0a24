"""Loader factory: a corpus root → ArrayDatasets and seeded BatchIterators.

Port of `tpu_deer/data/loaders.py` (`create_enhanced_dataloaders`).
"""

from __future__ import annotations

from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
from tpu_deer_torch.device import DeviceLike


def create_enhanced_dataloaders(
    root_path: str,
    batch_size: int = 32,
    dataset: str = "iemocap",
    quick: bool = False,
    seed: int = 0,
    extractor=None,
    device: DeviceLike = None,
) -> tuple[dict[str, ArrayDataset], dict[str, BatchIterator]]:
    """Parse and featurize a corpus root → ({split: dataset}, {split:
    iterator}); train shuffles and drops its partial batch."""
    from tpu_deer_torch.data import iemocap, meld, ravdess

    loaders = {
        "iemocap": iemocap.load_iemocap,
        "ravdess": ravdess.load_ravdess,
        "meld": meld.load_meld,
    }
    if dataset.lower() not in loaders:
        raise ValueError(f"unknown dataset {dataset!r}; expected {list(loaders)}")
    loaded = loaders[dataset.lower()](root_path, quick=quick, extractor=extractor,
                                      device=device)
    datasets = {split: ds for split, ds in loaded.items()
                if isinstance(ds, ArrayDataset)}
    iterators = {
        split: BatchIterator(ds, batch_size, shuffle=(split == "train"),
                             drop_last=(split == "train"), seed=seed)
        for split, ds in datasets.items()
    }
    return datasets, iterators
