"""Serving-compression study: distill the flagship into a small student,
through the port.

    python -m tpu_deer_torch.experiments.distill_study
    python -m tpu_deer_torch.experiments.distill_study --quick --platform cpu

Twin of `experiments/distill_study.py`, with its flags, defaults, seeds and
rows: labels are scarce (8,192 labeled rows) and unlabeled media abundant
(57,344 rows) of the default synthetic fixture, 30 epochs a model, batch
512, lr 2e-3 cosine with 2 warm-up epochs, validation every epochs // 6
epochs and no early stop. The flagship teacher (init seed 0) and a ~9×
smaller student from scratch (encoder 96, fusion 128, one layer, 4 heads;
init seed 1) train on the labeled rows; the distilled student (init seed 1)
trains on every row, the unlabeled rows' labels replaced by the teacher's
mu, with the teacher's mu and uncertainty as distillation targets (weights
1.0 / 0.5). Each row reports CCC, the uncertainty-error correlation, the
calibrated ECE (a post-hoc scale fitted on validation) and the parameter
count.

Differences from the reference: float32 with TF32 off, fused epochs (a
CUDA graph of the train step) on the card, and `--platform` (`cuda`, the
default, raising without a card; or `cpu`). Results go to
`results_torch/RESULTS_distill_h100.{json,md}` (`--quick`: `..._quick`),
the Markdown table beside the reference's run
(`experiments/RESULTS_distill.json`).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

DEFAULT_OUT = "results_torch/RESULTS_distill_h100"
REFERENCE = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                         "experiments", "RESULTS_distill.json")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--n_labeled", type=int, default=8192)
    p.add_argument("--n_unlabeled", type=int, default=57344)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--distill_mu_weight", type=float, default=1.0)
    p.add_argument("--distill_unc_weight", type=float, default=0.5)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    from tpu_deer_torch.core import metrics as M
    from tpu_deer_torch.data.pipeline import ArrayDataset
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.device import resolve_device
    from tpu_deer_torch.eval.calibration import fit_uncertainty_scale
    from tpu_deer_torch.experiments.synthetic_headline import card_name
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        count_parameters,
        create_complete_deer_model,
    )
    from tpu_deer_torch.train.distill import add_teacher_targets
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

    if args.quick:
        args.n_labeled, args.n_unlabeled = 1024, 3072
        args.epochs, args.batch_size = 10, 256
        if args.out == DEFAULT_OUT:
            args.out += "_quick"
    device = resolve_device(args.platform)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    platform = card_name(device)

    teacher_cfg = DEERModelConfig()
    student_cfg = DEERModelConfig(encoder_dim=96, fusion_dim=128,
                                  encoder_layers=1, attention_heads=4)
    n_total = args.n_labeled + args.n_unlabeled
    splits = make_synthetic_splits(SyntheticConfig(
        n_train=n_total, n_val=max(2048, n_total // 16),
        n_test=max(2048, n_total // 16)))
    full = splits["train"]
    labeled = ArrayDataset({k: v[: args.n_labeled] for k, v in full.items()},
                           "labeled")
    val = ArrayDataset(splits["val"], "synthetic")
    test = splits["test"]
    test_ds = ArrayDataset(test, "synthetic")

    def make_trainer(model_cfg, init_seed, train_len, seed, **overrides):
        cfg = TrainingConfig(
            learning_rate=2e-3, batch_size=args.batch_size,
            num_epochs=args.epochs, warmup_epochs=2, scheduler="cosine",
            val_frequency=max(1, args.epochs // 6),
            early_stopping_patience=10**9, seed=seed, fused_epochs=True,
            **overrides)
        model = create_complete_deer_model(model_cfg, seed=init_seed,
                                           device=device)
        return DEERTrainer(model, cfg,
                           steps_per_epoch=max(1, train_len // args.batch_size),
                           device=device)

    def evaluate(trainer, name, train_s):
        out = trainer.predict(test_ds)
        y = test["labels"]
        ccc = float(np.mean([M.ccc_np(y[:, d], out["mu"][:, d]) for d in range(3)]))
        err = np.abs(out["mu"] - y).mean(axis=1)
        r = float(np.corrcoef(out["uncertainty"].mean(axis=1), err)[0, 1])
        val_out = trainer.predict(val)
        scale = fit_uncertainty_scale(val_out["mu"], val.arrays["labels"],
                                      val_out["calibrated_uncertainty"])
        return {"name": name, "ccc_avg": ccc, "unc_err_corr": r,
                "ece_calibrated": float(M.ece_np(
                    out["mu"], y, scale * out["calibrated_uncertainty"])),
                "params": count_parameters(trainer.model),
                "train_s": train_s}

    def train(trainer, datasets):
        t = time.time()
        trainer.train(datasets, {"synthetic": val})
        return time.time() - t

    t0 = time.time()
    rows = []
    t_tr = make_trainer(teacher_cfg, 0, len(labeled), seed=0)
    rows.append(evaluate(t_tr, "teacher (flagship)",
                         train(t_tr, {"labeled": labeled})))
    s_tr = make_trainer(student_cfg, 1, len(labeled), seed=1)
    rows.append(evaluate(s_tr, "student from scratch",
                         train(s_tr, {"labeled": labeled})))

    # The unlabeled rows' true labels are replaced by the teacher's mu (they
    # would be unavailable); the teacher arrays ride along on every row.
    stamped = add_teacher_targets(t_tr.model, ArrayDataset(dict(full), "distill"),
                                  batch_size=args.batch_size)
    pseudo = dict(stamped.arrays)
    pseudo["labels"] = np.concatenate([
        pseudo["labels"][: args.n_labeled],
        pseudo["teacher_mu"][args.n_labeled:]]).astype(np.float32)
    stamped = ArrayDataset(pseudo, "distill")
    d_tr = make_trainer(student_cfg, 1, len(stamped), seed=1,
                        distill_mu_weight=args.distill_mu_weight,
                        distill_unc_weight=args.distill_unc_weight)
    rows.append(evaluate(d_tr, "student distilled (+unlabeled)",
                         train(d_tr, {"distill": stamped})))
    elapsed = time.time() - t0

    ratio = rows[0]["params"] / rows[2]["params"]
    gap = rows[0]["ccc_avg"] - rows[1]["ccc_avg"]
    recovered = (rows[2]["ccc_avg"] - rows[1]["ccc_avg"]) / gap if gap > 1e-9 else 0.0
    reference = None
    if os.path.exists(REFERENCE):
        with open(REFERENCE) as f:
            reference = json.load(f)
    md = [
        "# Uncertainty-aware distillation — the port on the card",
        "",
        f"- platform: **{platform}**, float32 (TF32 off), fused epochs; "
        f"{args.n_labeled} labeled + {args.n_unlabeled} unlabeled train "
        f"samples, {args.epochs} epochs per model, batch {args.batch_size}, "
        f"{elapsed:.0f}s total (training: "
        + ", ".join(f"{r['train_s']:.0f}s" for r in rows) + ")",
        f"- teacher {rows[0]['params']:,} params -> student "
        f"{rows[2]['params']:,} params ({ratio:.1f}x smaller); distillation "
        f"recovers {recovered:.0%} of the teacher-vs-scratch-student CCC gap",
        "- ECE uses the deployable calibrated uncertainty with a post-hoc "
        "scale fit on the validation split",
        "",
        "| model | run | params | CCC avg | unc-err corr | ECE (calibrated) |",
        "|---|---|---|---|---|---|",
    ]
    for i, r in enumerate(rows):
        others = [("this run", r)]
        if reference is not None and i < len(reference["rows"]):
            others.append(("reference", reference["rows"][i]))
        for label, row in others:
            md.append(f"| {r['name']} | {label} | {row['params']:,} | "
                      f"{row['ccc_avg']:.3f} | {row['unc_err_corr']:.3f} | "
                      f"{row['ece_calibrated']:.3f} |")
    md += ["", "Reproduce: `python -m tpu_deer_torch.experiments.distill_study` "
               "on the card (`--quick --platform cpu` for a CPU smoke)."]
    text = "\n".join(md) + "\n"
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out + ".md", "w") as f:
        f.write(text)
    with open(args.out + ".json", "w") as f:
        json.dump({"rows": rows, "platform": platform, "elapsed_s": elapsed,
                   "recovered": recovered, "args": vars(args)}, f, indent=1)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
