"""K-fold cross-validation with real per-fold training.

Port of `tpu_deer/eval/cross_validation.py`. The folds come from one seeded
numpy permutation (the same indices as the reference's for the same seed
and size); each fold trains a freshly initialised flagship (init seed
`seed + fold`) with the port's DEERTrainer and evaluates it with
DEERModelEvaluator. A tenth of the fold's training rows, drawn by a
fold-seeded shuffle, stays out of the loss and fits the post-hoc
uncertainty scale, so the reported ECE is the deployable calibrated one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.eval.evaluator import DEERModelEvaluator
from tpu_deer_torch.models.deer_model import DEERModelConfig, create_complete_deer_model
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig


class CrossValidationEvaluator:
    def __init__(self, model_config: DEERModelConfig,
                 training_config: TrainingConfig, n_folds: int = 5,
                 seed: int = 0, device: DeviceLike = None):
        self.model_config = model_config
        self.training_config = training_config
        self.n_folds = n_folds
        self.seed = seed
        self.device = resolve_device(device)

    def _folds(self, n: int):
        """(train indices, validation indices) per fold: contiguous slices
        of one seeded permutation, the first n % n_folds folds one row
        larger."""
        order = np.random.default_rng(self.seed).permutation(n)
        sizes = np.full(self.n_folds, n // self.n_folds)
        sizes[: n % self.n_folds] += 1
        start = 0
        for size in sizes:
            val_idx = order[start: start + size]
            train_idx = np.concatenate([order[:start], order[start + size:]])
            start += size
            yield train_idx, val_idx

    def run(self, dataset: ArrayDataset,
            epochs_per_fold: Optional[int] = None) -> dict:
        fold_results = []
        for fold, (train_idx, val_idx) in enumerate(self._folds(len(dataset))):
            shuffled = np.random.default_rng(self.seed * 7919 + fold).permutation(
                train_idx)
            n_cal = max(1, len(shuffled) // 10)
            cal_ds = ArrayDataset(dataset.slice(shuffled[:n_cal]), dataset.name)
            train_ds = ArrayDataset(dataset.slice(shuffled[n_cal:]), dataset.name)
            val_ds = ArrayDataset(dataset.slice(val_idx), dataset.name)

            model = create_complete_deer_model(self.model_config,
                                               seed=self.seed + fold,
                                               device=self.device)
            steps = max(1, len(train_ds) // self.training_config.batch_size)
            trainer = DEERTrainer(model, self.training_config,
                                  steps_per_epoch=steps, device=self.device)
            trainer.train({dataset.name: train_ds}, {dataset.name: val_ds},
                          num_epochs=epochs_per_fold)
            fold_results.append(DEERModelEvaluator(n_bootstrap=0).evaluate_model(
                trainer, val_ds, calibration_dataset=cal_ds))

        cccs = np.array([r.ccc_average for r in fold_results])
        maes = np.array([r.mae_average for r in fold_results])
        half = 1.96 * cccs.std() / np.sqrt(len(cccs))
        return {
            "folds": [r.to_dict() for r in fold_results],
            "ccc_mean": float(cccs.mean()),
            "ccc_std": float(cccs.std()),
            "ccc_ci": (float(cccs.mean() - half), float(cccs.mean() + half)),
            "mae_mean": float(maes.mean()),
            "mae_std": float(maes.std()),
        }
