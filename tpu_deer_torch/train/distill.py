"""Uncertainty-aware knowledge distillation for serving-size students.

Port of `tpu_deer/train/distill.py`. Stamp the training set once with a
teacher's outputs (`add_teacher_targets`), then train the student with
`DEERTrainer` as usual: its loss picks up the `teacher_mu` / `teacher_unc`
arrays (TrainingConfig `distill_mu_weight` / `distill_unc_weight`), on the
per-step and the fused path. The student still sees the true labels, so
distillation is a regularizer toward the teacher, not a replacement for the
data.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_deer_torch.core.nig import combine_members
from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.models.deer_model import member_forward, uncertainty_outputs

__all__ = ["add_teacher_targets"]


def add_teacher_targets(model, dataset: ArrayDataset, batch_size: int = 512,
                        ensemble: bool = False, params=None) -> ArrayDataset:
    """A copy of `dataset` with `teacher_mu` / `teacher_unc` arrays from the
    teacher's deterministic forward over fixed-size batches (the last one
    wrap-padded, its padding dropped); `teacher_unc` is the raw total
    uncertainty (`uncertainty_all`), which the student matches in log
    space. The teacher runs where its weights lie.

    `model`: a CompleteDEERModel with its weights; or, with
    `ensemble=True`, the ensemble's structure with `params` its stacked
    members (`train/ensemble.py:create_deer_ensemble`, or an
    EnsembleTrainer's `model` and `_params`): the targets are then the
    moment-matched combination (`core/nig.py:combine_members`), whose
    uncertainty gains the cross-member disagreement."""
    if ensemble and params is None:
        raise ValueError("ensemble=True needs the stacked member params")
    device = (next(iter(params.values())) if ensemble
              else next(model.parameters())).device
    n = len(dataset)
    arrays = [np.asarray(dataset.arrays[k]) for k in ("audio", "video", "text")]
    was_training = model.training
    model.eval()
    mus, uncs = [], []
    try:
        with torch.no_grad():
            for start in range(0, n, batch_size):
                idx = np.arange(start, min(start + batch_size, n))
                pad = batch_size - len(idx)
                if pad:  # one batch shape; the padded rows are dropped
                    idx = np.concatenate([idx, idx[:pad] % n])
                a, v, t = (torch.from_numpy(np.ascontiguousarray(x[idx])).to(device)
                           for x in arrays)
                if ensemble:
                    out = combine_members(member_forward(
                        model, params, a, v, t,
                        lambda o: uncertainty_outputs(o, model.config.dim_names)))
                    mu, unc = out["mu"], out["uncertainty"]
                else:
                    out = model(a, v, t)
                    mu, unc = out["mu_all"], out["uncertainty_all"]
                keep = batch_size - pad
                mus.append(mu[:keep].float().cpu().numpy())
                uncs.append(unc[:keep].float().cpu().numpy())
    finally:
        model.train(was_training)
    stamped = dict(dataset.arrays)
    stamped["teacher_mu"] = np.concatenate(mus).astype(np.float32)
    stamped["teacher_unc"] = np.concatenate(uncs).astype(np.float32)
    return ArrayDataset(stamped, dataset.name)

