"""K-fold cross-validation with every fold trained, through the port.

    python -m tpu_deer_torch.experiments.cross_validation_study
    python -m tpu_deer_torch.experiments.cross_validation_study --quick --platform cpu

Twin of `experiments/cross_validation_study.py`, with its defaults: 5
folds of 8,000 synthetic rows (`SyntheticConfig`, seed 42), the flagship
trained 10 epochs a fold at batch 512, lr 2e-3 cosine with one warm-up
epoch, validation every 5 epochs (`eval/cross_validation.py`: a tenth of
each fold's train rows held out to fit the calibration scale), then CCC
mean, std and 95% interval, MAE and the calibrated ECE over the folds.
Differences: float32 with TF32 off where the reference ran bf16 on its
TPU, fused epochs on the card. Results:
results_torch/RESULTS_cv_h100.{json,md}, beside the reference's
experiments/RESULTS_cv.json.
"""

from __future__ import annotations

import time

from tpu_deer_torch.experiments import twin


def main(argv=None) -> int:
    p = twin.parser(__doc__, "cv")
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--n_samples", type=int, default=8000)
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "cv")
    if args.quick:
        args.folds, args.epochs, args.n_samples = 2, 1, 1024

    from tpu_deer_torch.data.pipeline import ArrayDataset
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.eval.cross_validation import CrossValidationEvaluator
    from tpu_deer_torch.models.deer_model import DEERModelConfig
    from tpu_deer_torch.train.trainer import TrainingConfig

    splits = make_synthetic_splits(SyntheticConfig(n_train=args.n_samples,
                                                   n_val=10, n_test=10))
    cv = CrossValidationEvaluator(
        DEERModelConfig(),
        TrainingConfig(learning_rate=2e-3, batch_size=512,
                       num_epochs=args.epochs, warmup_epochs=1,
                       scheduler="cosine", val_frequency=5,
                       early_stopping_patience=50,
                       fused_epochs=device.type == "cuda"),
        n_folds=args.folds, device=device)
    t0 = time.time()
    res = cv.run(ArrayDataset(splits["train"], "synthetic"),
                 epochs_per_fold=args.epochs)
    elapsed = time.time() - t0

    ref = twin.reference("cv")
    ece = sum(f["ece"] for f in res["folds"]) / len(res["folds"])

    def stats(r):
        return (f"{r['ccc_mean']:.3f} ± {r['ccc_std']:.3f}",
                f"[{r['ccc_ci'][0]:.3f}, {r['ccc_ci'][1]:.3f}]",
                f"{r['mae_mean']:.3f} ± {r['mae_std']:.3f}",
                f"{sum(f['ece'] for f in r['folds']) / len(r['folds']):.3f}")

    md = [
        "# K-fold cross-validation — the port on the card",
        "",
        f"- platform: **{platform}**, float32 (TF32 off)"
        f"{', fused epochs' if device.type == 'cuda' else ''}; {args.folds} "
        f"folds × {args.epochs} epochs on {args.n_samples} samples, "
        f"{elapsed:.0f}s total",
        "- every fold trains (`eval/cross_validation.py`); the reference's "
        "run (`experiments/RESULTS_cv.json`, bf16 on its TPU) beside it; a "
        f"CCC-mean gap beyond {twin.CCC_GAP} is marked **(gap)**",
        "",
        "| statistic | this run | reference |",
        "|---|---|---|",
    ]
    ours, theirs = stats(res), stats(ref) if ref else ("n/a",) * 4
    for name, a, b in zip(("CCC mean ± std", "CCC 95% CI", "MAE mean ± std",
                           "calibrated ECE mean"), ours, theirs):
        md.append(f"| {name} | {a} | {b} |")
    md += ["", f"CCC-mean gap: {twin.gap(res['ccc_mean'], ref and ref['ccc_mean'])}",
           "", "Per-fold CCC: " + ", ".join(f"{f['ccc_average']:.3f}"
                                            for f in res["folds"]),
           "Per-fold ECE (calibrated on a held-out train slice): "
           + ", ".join(f"{f['ece']:.3f}" for f in res["folds"]),
           "", "Reproduce: `python -m tpu_deer_torch.experiments."
               "cross_validation_study` on the card (`--quick --platform cpu` "
               "for a CPU smoke)."]
    twin.write(args.out, md, {"results": res, "calibrated_ece_mean": ece,
                              "platform": platform, "elapsed_s": elapsed,
                              "args": vars(args)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
