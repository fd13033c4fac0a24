"""Modality ablation study: train and evaluate on every modality subset.

Port of `tpu_deer/eval/ablation.py`. For each subset the excluded
modalities are zeroed at train and at eval time, a flagship initialised
from `seed` trains on them with the port's DEERTrainer, and
DEERModelEvaluator reports the full metric bundle on the test split with
the post-hoc uncertainty scale fitted on the masked validation split.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.eval.evaluator import DEERModelEvaluator
from tpu_deer_torch.models.deer_model import DEERModelConfig, create_complete_deer_model
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

logger = logging.getLogger(__name__)

DEFAULT_SUBSETS: tuple[tuple[str, ...], ...] = (
    ("audio",),
    ("video",),
    ("text",),
    ("audio", "video"),
    ("audio", "text"),
    ("audio", "video", "text"),
)


def _mask_modalities(ds: ArrayDataset, keep: Sequence[str]) -> ArrayDataset:
    """The dataset with every modality outside `keep` zeroed."""
    arrays = dict(ds.arrays)
    for mod in ("audio", "video", "text"):
        if mod not in keep and mod in arrays:
            arrays[mod] = np.zeros_like(arrays[mod])
    return ArrayDataset(arrays, ds.name)


class AblationStudy:
    def __init__(self, model_config: DEERModelConfig,
                 training_config: TrainingConfig,
                 subsets: Sequence[Sequence[str]] = DEFAULT_SUBSETS,
                 seed: int = 0, device: DeviceLike = None):
        self.model_config = model_config
        self.training_config = training_config
        self.subsets = [tuple(s) for s in subsets]
        self.seed = seed
        self.device = resolve_device(device)

    def run(self, train_ds: ArrayDataset, val_ds: ArrayDataset,
            test_ds: Optional[ArrayDataset] = None,
            num_epochs: Optional[int] = None) -> dict[str, dict]:
        """{"A", "V", "T", "A+V", ...: the subset's evaluation as a dict with
        its "modalities"}."""
        test_ds = test_ds or val_ds
        evaluator = DEERModelEvaluator(n_bootstrap=0)
        results: dict[str, dict] = {}
        for subset in self.subsets:
            key = "+".join(m[0].upper() for m in subset)
            model = create_complete_deer_model(self.model_config, seed=self.seed,
                                               device=self.device)
            steps = max(1, len(train_ds) // self.training_config.batch_size)
            trainer = DEERTrainer(model, self.training_config,
                                  steps_per_epoch=steps, device=self.device)
            masked_val = _mask_modalities(val_ds, subset)
            trainer.train({train_ds.name: _mask_modalities(train_ds, subset)},
                          {val_ds.name: masked_val}, num_epochs=num_epochs)
            res = evaluator.evaluate_model(
                trainer, _mask_modalities(test_ds, subset),
                calibration_dataset=masked_val)
            results[key] = res.to_dict()
            results[key]["modalities"] = list(subset)
            logger.info(f"[ablation {key}] CCC {res.ccc_average:.4f} "
                        f"ECE {res.ece:.4f}")
        return results
