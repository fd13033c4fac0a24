"""YAML config handling with the reference's schema (`datasets`, `model`,
`training`, `hardware`).

Port of `tpu_deer/utils/config.py`: the same defaults, merged under a YAML
file where one is given. PyYAML is imported only where a file is read or
written. `hardware.device` takes "auto" (the CUDA card), "cuda" or "cpu".
"""

from __future__ import annotations

import copy
import os
from typing import Any, Optional

DEFAULT_CONFIG: dict[str, Any] = {
    "datasets": {
        "names": ["IEMOCAP", "RAVDESS", "MELD"],
        "paths": {
            "IEMOCAP": "/path/to/IEMOCAP_full_release",
            "RAVDESS": "/path/to/RAVDESS",
            "MELD": "/path/to/MELD",
        },
        "weights": {"IEMOCAP": 1.0, "RAVDESS": 0.8, "MELD": 0.6},
        "synthetic_fallback": True,
    },
    "model": {
        "audio_dim": 84,
        "video_dim": 256,
        "text_dim": 768,
        "encoder_dim": 256,
        "fusion_dim": 512,
        "emotion_dims": 3,
        "attention_heads": 8,
        "encoder_layers": 3,
        "dropout": 0.3,
    },
    "training": {
        "learning_rate": 1.0e-4,
        "weight_decay": 1.0e-5,
        "gradient_clip": 1.0,
        "batch_size": 32,
        "num_epochs": 100,
        "evidence_weight": 1.0,
        "kl_weight": 0.1,
        "aleatoric_moment_weight": 0.0,
        "scheduler": "cosine",
        "warmup_epochs": 5,
        "early_stopping_patience": 10,
        "val_frequency": 1,
        "save_frequency": 10,
        "curriculum_learning": True,
        "grad_accum_steps": 1,
        "param_sharding": "tp",
        "spike_backoff": True,
        "ema_decay": 0.0,
        "ema_eval": False,
        "seed": 42,
    },
    "hardware": {
        "device": "auto",
        "num_workers": 4,
        "mesh": {"data": -1, "model": 1},
        "compute_dtype": "float32",
    },
}


def default_config() -> dict[str, Any]:
    return copy.deepcopy(DEFAULT_CONFIG)


def _deep_update(base: dict, override: dict) -> dict:
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_yaml_config(path: Optional[str] = None) -> dict[str, Any]:
    """The defaults, with the YAML file at `path` merged over them when it
    exists."""
    config = default_config()
    if path and os.path.exists(path):
        import yaml

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        _deep_update(config, loaded)
    return config


def save_yaml_config(config: dict, path: str) -> None:
    import yaml

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
