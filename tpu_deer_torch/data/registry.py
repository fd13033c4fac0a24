"""Dataset registry: config dataset names and paths → loaded ArrayDatasets.

Port of `tpu_deer/data/registry.py`: bridges the YAML config
(`datasets.names` / `datasets.paths` / `datasets.pretrain_text`) to the
loaders of `data/{iemocap,ravdess,meld}.py`. Returns None when no
configured path exists on disk, which is the caller's cue for its loud
synthetic fallback.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from tpu_deer_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


def load_configured_datasets(config: dict, quick: bool = False,
                             device: DeviceLike = None) -> Optional[dict]:
    """Load every configured dataset that exists on disk, featurized on
    `device` (None = the CUDA card).

    Returns {"train": {name: ArrayDataset}, "val": {...}, "test": {...},
    "meta": {"text_backend": {name: backend}, "load_s": {name: {part:
    seconds}}, "text_encoder": {name: the MLM featurizer its loader
    used}}} or None when nothing is available. `datasets.pretrain_text`
    absent or None is AUTO (IEMOCAP and MELD MLM-pretrain their text
    featurizer on their own train transcripts); false forces the hashed
    features, true forces pretraining. A loader that fails is skipped with a
    warning, as in the reference.
    """
    from tpu_deer_torch.data import iemocap, meld, ravdess

    loaders = {
        "IEMOCAP": iemocap.load_iemocap,
        "RAVDESS": ravdess.load_ravdess,
        "MELD": meld.load_meld,
    }
    ds_config = config.get("datasets", {})
    names = ds_config.get("names", [])
    paths = ds_config.get("paths", {})
    pretrain_text = ds_config.get("pretrain_text", None)
    if pretrain_text is not None:
        pretrain_text = bool(pretrain_text)
    out: dict = {"train": {}, "val": {}, "test": {}}
    text_backends: dict[str, str] = {}
    load_s: dict[str, dict] = {}
    encoders: dict = {}
    for name in names:
        path = paths.get(name)
        if not path or not os.path.isdir(path):
            continue
        loader = loaders.get(name.upper())
        if loader is None:
            logger.warning(f"unknown dataset {name!r} — skipping")
            continue
        device = resolve_device(device)  # raises here, not inside the skip
        try:
            kwargs = {"quick": quick, "device": device}
            if name.upper() in ("IEMOCAP", "MELD"):
                kwargs["pretrain_text"] = pretrain_text
            splits = loader(path, **kwargs)
        except Exception as e:  # noqa: BLE001 — the reference skips it
            logger.warning(f"failed to load {name} from {path}: {e}")
            continue
        for split in ("train", "val", "test"):
            if split in splits and len(splits[split]) > 0:
                out[split][name.lower()] = splits[split]
        text_backends[name.lower()] = str(splits.get("text_backend", "hashed"))
        load_s[name.lower()] = splits.get("load_s", {})
        if splits.get("text_encoder") is not None:
            encoders[name.lower()] = splits["text_encoder"]
    if not text_backends:
        return None
    out["meta"] = {"text_backend": text_backends, "load_s": load_s,
                   "text_encoder": encoders}
    logger.info(f"text feature backends: {text_backends}")
    return out
