"""Seed replication: cross-seed intervals and a computed effect size,
through the port.

    python -m tpu_deer_torch.experiments.seed_study
    python -m tpu_deer_torch.experiments.seed_study --quick --platform cpu

Twin of `experiments/seed_study.py`, with its flags, recipe and payload
keys: `--n_seeds` (5) replications, each with a fresh data draw (synthetic
seed 1000 + seed) and a fresh init (seed), the quick-headline recipe
(65,536 rows × 30 epochs, batch 4,096, lr 1.2e-3 cosine with 5 warm-up
epochs, dropout 0.05, KL 0.01, calibration 0.15, validation every 10
epochs, no early stop). Per seed two models train through `DEERTrainer`
(fused epochs, a CUDA graph of the step, on the card): the full trimodal
flagship and the text-only one, the other modalities zeroed at train and
eval time (`eval/ablation.py:_mask_modalities`). Reported: per seed and
mean ± std with 95% t-intervals (`ci95`) of CCC, MAE, calibrated ECE, raw
E|y − μ| ECE, the shipped channel's ECE and the uncertainty-error r, and
the paired `core/metrics.py:statistical_significance_test` of full
against text-only (Cohen's d and p).

Differences from the reference: the model computes in bfloat16 on the card
and float32 on the CPU (as the reference's on its TPU and CPU), TF32 off;
`--platform` picks the card (`cuda`, the default; it raises without one)
or the CPU; results go to `results_torch/RESULTS_seeds_h100.{json,md}`
(`--quick`: 2 seeds of 2,048 rows × 4 epochs at batch 256,
`..._quick`), beside the reference's intervals
(`experiments/RESULTS_seeds.json`), a CCC gap beyond 0.02 flagged.
"""

from __future__ import annotations

import time

import numpy as np

from tpu_deer_torch.experiments import twin

AGGREGATED = ("full_ccc", "text_only_ccc", "full_mae", "ece_calibrated",
              "ece_eabs", "ece_shipped", "unc_err_r", "cohens_d")
LABELS = (
    ("full_ccc", "CCC avg (full model)"),
    ("text_only_ccc", "CCC avg (text-only baseline)"),
    ("full_mae", "MAE (full)"),
    ("ece_calibrated", "ECE (calibrated channel)"),
    ("ece_eabs", "ECE (raw NIG E|err| channel)"),
    ("ece_shipped", "ECE (shipped serving channel)"),
    ("unc_err_r", "uncertainty-error r"),
    ("cohens_d", "Cohen's d (full vs text-only)"),
)


def ci95(vals: np.ndarray) -> tuple[float, float]:
    """95% interval of the mean by the t distribution (the reference's
    `_ci95`)."""
    from scipy import stats as sp_stats

    n = len(vals)
    if n < 2:
        return float(vals[0]), float(vals[0])
    half = sp_stats.t.ppf(0.975, n - 1) * vals.std(ddof=1) / np.sqrt(n)
    m = vals.mean()
    return float(m - half), float(m + half)


def aggregate(rows: list[dict], keys=AGGREGATED) -> dict:
    """{key: {"mean", "std" (ddof 1; 0 for one row), "ci95"}} over rows."""
    agg = {}
    for key in keys:
        vals = np.array([r[key] for r in rows])
        lo, hi = ci95(vals)
        agg[key] = {"mean": float(vals.mean()),
                    "std": float(vals.std(ddof=1)) if len(vals) > 1 else 0.0,
                    "ci95": [lo, hi]}
    return agg


def seed_row(seed: int, labels: np.ndarray, preds: dict,
             serving_channel: str) -> dict:
    """One seed's metrics from the full and text-only test predictions."""
    from tpu_deer_torch.core.metrics import (
        ccc_np,
        ece_np,
        pearson_np,
        statistical_significance_test,
    )

    row = {"seed": seed, "serving_channel": serving_channel}
    for variant in ("full", "text_only"):
        mu = preds[variant]["mu"]
        row[f"{variant}_ccc"] = float(np.mean(
            [ccc_np(labels[:, d], mu[:, d]) for d in range(3)]))
        row[f"{variant}_mae"] = float(np.mean(np.abs(mu - labels)))
    pred = preds["full"]
    row["ece_calibrated"] = float(ece_np(pred["mu"], labels,
                                         pred["calibrated_uncertainty"]))
    row["ece_eabs"] = float(ece_np(pred["mu"], labels, pred["eabs"]))
    row["ece_shipped"] = row[f"ece_{serving_channel}"]
    row["unc_err_r"] = float(pearson_np(np.abs(pred["mu"] - labels).mean(axis=1),
                                        pred["uncertainty"].mean(axis=1)))
    sig = statistical_significance_test(preds["text_only"]["mu"], labels,
                                        pred["mu"])
    row["cohens_d"] = sig["cohens_d"]
    row["p_value"] = sig["p_value"]
    return row


def main(argv=None) -> int:
    p = twin.parser(__doc__, "seeds")
    p.add_argument("--n_seeds", type=int, default=5)
    p.add_argument("--n_train", type=int, default=65536)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--lr", type=float, default=1.2e-3)
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "seeds")
    if args.quick:
        args.n_seeds = min(args.n_seeds, 2)
        args.n_train, args.epochs, args.batch_size = 2048, 4, 256

    import torch

    from tpu_deer_torch.data.pipeline import ArrayDataset
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.eval.ablation import _mask_modalities
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        create_complete_deer_model,
    )
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    mcfg = DEERModelConfig(dropout=0.05, compute_dtype=dtype)
    tcfg = TrainingConfig(
        learning_rate=args.lr, batch_size=args.batch_size,
        num_epochs=args.epochs, warmup_epochs=min(5, args.epochs // 2),
        scheduler="cosine", early_stopping_patience=10**6, val_frequency=10,
        kl_weight=0.01, calibration_alignment_weight=0.15,
        fused_epochs=device.type == "cuda")

    t0 = time.time()
    rows = []
    for seed in range(args.n_seeds):
        splits = make_synthetic_splits(SyntheticConfig(
            n_train=args.n_train, n_val=args.n_train // 8,
            n_test=args.n_train // 8, seed=1000 + seed))
        train_ds, val_ds, test_ds = (ArrayDataset(splits[s], "synthetic")
                                     for s in ("train", "val", "test"))
        preds, channel = {}, None
        for variant, keep in (("full", ("audio", "video", "text")),
                              ("text_only", ("text",))):
            model = create_complete_deer_model(mcfg, seed=seed, device=device)
            trainer = DEERTrainer(model, tcfg, device=device,
                                  steps_per_epoch=max(1, args.n_train
                                                      // args.batch_size))
            res = trainer.train({"synthetic": _mask_modalities(train_ds, keep)},
                                {"synthetic": _mask_modalities(val_ds, keep)})
            preds[variant] = trainer.predict(_mask_modalities(test_ds, keep),
                                             return_nig=True)
            if variant == "full":
                channel = res["serving_channel"]
            del trainer, model
        row = seed_row(seed, test_ds.arrays["labels"], preds, channel)
        rows.append(row)
        print(row, flush=True)

    wall = time.time() - t0
    agg = aggregate(rows)
    max_p = max(r["p_value"] for r in rows)
    payload = {
        "platform": platform, "compute_dtype": dtype, "n_seeds": args.n_seeds,
        "recipe": {"n_train": args.n_train, "epochs": args.epochs,
                   "batch_size": args.batch_size, "lr": args.lr},
        "wall_s": wall, "seeds": rows, "aggregate": agg, "max_p_value": max_p,
    }
    ref = (twin.reference("seeds") or {}).get("aggregate", {})
    md = [
        "# Seed-replication study — the port on the card",
        "",
        f"- platform: **{platform}**, {dtype} compute, {args.n_seeds} seeds x "
        f"(full + text-only) trainings, {args.n_train} train samples, "
        f"{args.epochs} epochs each{', fused' if tcfg.fused_epochs else ''}, "
        f"{wall:.0f}s total",
        "- each seed draws fresh data and a fresh init; text-only zeroes the "
        "other modalities as `eval/ablation.py` does; Cohen's d and p from "
        "`core/metrics.py:statistical_significance_test`",
        f"- the reference's five TPU seeds (`experiments/RESULTS_seeds.json`) "
        f"beside each row; a mean gap beyond {twin.CCC_GAP} is marked "
        "**(gap)**",
        "",
        "| metric | mean ± std | 95% CI | reference mean ± std | reference "
        "95% CI | gap |",
        "|---|---|---|---|---|---|",
    ]
    for key, label in LABELS:
        a, r = agg[key], ref.get(key)
        refs = (f"{r['mean']:.3f} ± {r['std']:.3f} | [{r['ci95'][0]:.3f}, "
                f"{r['ci95'][1]:.3f}]" if r else "— | —")
        md.append(f"| {label} | {a['mean']:.3f} ± {a['std']:.3f} | "
                  f"[{a['ci95'][0]:.3f}, {a['ci95'][1]:.3f}] | {refs} | "
                  f"{twin.gap(a['mean'], r and r['mean'])} |")
    md += [
        f"| max p-value over seeds | {max_p:.2e} | — | — | — | |",
        "",
        f"Serving-channel selection per seed: "
        f"{[r['serving_channel'] for r in rows]}.",
        "",
        "Per-seed rows in `RESULTS_seeds_h100.json`.",
        "",
        "Reproduce: `python -m tpu_deer_torch.experiments.seed_study` on the "
        "card (`--quick --platform cpu` for a CPU smoke).",
    ]
    twin.write(args.out, md, payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
