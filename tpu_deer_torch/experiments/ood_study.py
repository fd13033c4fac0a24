"""The OOD guardrail: Mahalanobis detectors in three spaces against the
epistemic channel, through the port.

    python -m tpu_deer_torch.experiments.ood_study
    python -m tpu_deer_torch.experiments.ood_study --quick --platform cpu

Twin of `experiments/ood_study.py`, with its flags, data, training and
payload keys: latent-structured synthetic data (`--latent_dim` 16;
`--n_train` 16,384, `--n_eval` 4,096), the flagship trained through
`DEERTrainer` (12 epochs, batch 512, lr 2e-3 cosine with 2 warm-up epochs,
validation every 3 epochs, seed 0). Detectors, all
`eval/ood.py:MahalanobisOOD` fitted on up to 8,192 training rows (a fifth
held out for threshold calibration): on the per-modality L2-normalized
inputs ("input_norm", the shipped guardrail), on the model's fused
representation (`predict(return_fused=True)`) and on the raw concatenated
inputs; plus the epistemic channel. Probes: the four families of
`ensemble_study.make_probes` on the test split (rng 123). Reported: AUROC
of clean test against each probe, and for the shipped detector the TPR at
its 1% training-FPR threshold and the clean test's FPR there.

Differences from the reference: the model computes in bfloat16 on the card
and float32 on the CPU (as the reference's on its TPU and CPU), with TF32
off and fused epochs (a CUDA graph of the step) on the card; `--platform`
picks the card (`cuda`, the default; it raises without one) or the CPU;
results go to `results_torch/RESULTS_ood_h100.{json,md}` (`--quick`: 2,048
train, 1,024 eval rows, 4 epochs, `..._quick`), beside the reference's run
(`experiments/RESULTS_ood.json`), an AUROC gap beyond 0.02 flagged.
"""

from __future__ import annotations

import time

import numpy as np

from tpu_deer_torch.experiments import twin

SHIPPED = "mahalanobis (input_norm, shipped)"


def modalities(a: dict):
    return a["audio"], a["video"], a["text"]


def raw_inputs(a: dict) -> np.ndarray:
    return np.concatenate(modalities(a), axis=1)


def fit_detectors(fit_arrays: dict, fused_fit: np.ndarray):
    """(input_norm, fused, raw-input) detectors fitted as the reference fits
    them: the first fifth of the rows held out for the threshold's
    calibration (the raw-input detector on every row, uncalibrated)."""
    from tpu_deer_torch.eval import ood

    n_cal = len(fused_fit) // 5
    det_fused = ood.MahalanobisOOD().fit(fused_fit[n_cal:]).calibrate(
        fused_fit[:n_cal])
    norm_fit = ood.input_norm_features(*modalities(fit_arrays))
    det_norm = ood.MahalanobisOOD(space="input_norm").fit(
        norm_fit[n_cal:]).calibrate(norm_fit[:n_cal])
    det_raw = ood.MahalanobisOOD().fit(raw_inputs(fit_arrays))
    return det_norm, det_fused, det_raw


def scores(detectors, arrays: dict, pred: dict) -> dict:
    """Every detector's score of `arrays`, with the model's predictions
    (`epistemic` and `fused`) on them."""
    det_norm, det_fused, det_raw = detectors
    return {
        "epistemic": pred["epistemic"].mean(axis=1),
        SHIPPED: det_norm.score_modalities(*modalities(arrays)),
        "mahalanobis (fused)": det_fused.score(pred["fused"]),
        "mahalanobis (raw input)": det_raw.score(raw_inputs(arrays)),
    }


def score_table(s_test: dict, s_probe: dict, threshold: float) -> list[dict]:
    """The reference's rows: each detector's AUROC of clean test against
    each probe; for the shipped detector the TPR of each probe above
    `threshold` (its 1% training-FPR cutoff) and the clean test's FPR."""
    from tpu_deer_torch.eval.ood import ood_auroc as auroc

    rows = []
    for det in s_test:
        row = {"detector": det, "auroc": {}, "tpr_at_1pct_fpr": {}}
        for name in s_probe:
            row["auroc"][name] = auroc(s_test[det], s_probe[name][det])
        if det == SHIPPED:
            row["tpr_at_1pct_fpr"] = {
                name: float(np.mean(s_probe[name][det] > threshold))
                for name in s_probe}
            row["test_fpr_at_threshold"] = float(np.mean(s_test[det] > threshold))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = twin.parser(__doc__, "ood")
    p.add_argument("--n_train", type=int, default=16384)
    p.add_argument("--n_eval", type=int, default=4096)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--latent_dim", type=int, default=16,
                   help="shared cross-modal latent dimension; 0 reproduces "
                        "the i.i.d. generator")
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "ood")
    if args.quick:
        args.n_train, args.n_eval, args.epochs = 2048, 1024, 4

    from tpu_deer_torch.data.pipeline import ArrayDataset
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.experiments.ensemble_study import make_probes
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        create_complete_deer_model,
    )
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

    dtype = twin.compute_dtype(device)
    splits = make_synthetic_splits(SyntheticConfig(
        n_train=args.n_train, n_val=args.n_eval, n_test=args.n_eval,
        latent_dim=args.latent_dim or None))
    train_ds = ArrayDataset(splits["train"], "synthetic")
    val = {"synthetic": ArrayDataset(splits["val"], "synthetic")}
    test = splits["test"]
    probes = {name: ArrayDataset(arrays, f"ood_{name.split()[0]}")
              for name, arrays in make_probes(
                  test, np.random.default_rng(123)).items()}
    test_ds = ArrayDataset(test, "synthetic")

    t0 = time.time()
    model = create_complete_deer_model(DEERModelConfig(compute_dtype=dtype),
                                       seed=0, device=device)
    trainer = DEERTrainer(
        model,
        TrainingConfig(learning_rate=2e-3, batch_size=args.batch_size,
                       num_epochs=args.epochs, warmup_epochs=2,
                       scheduler="cosine",
                       val_frequency=max(1, args.epochs // 4),
                       early_stopping_patience=10**9, seed=0,
                       fused_epochs=device.type == "cuda"),
        steps_per_epoch=max(1, args.n_train // args.batch_size), device=device)
    trainer.train({"synthetic": train_ds}, val)

    fit_rows = min(len(train_ds), 8192)
    fit_slice = train_ds.slice(np.arange(fit_rows))
    fused_fit = trainer.predict(ArrayDataset(fit_slice, "fit"),
                                return_fused=True)["fused"]
    detectors = fit_detectors(fit_slice, fused_fit)
    run = lambda arrays, ds: scores(detectors, arrays,
                                    trainer.predict(ds, return_fused=True))
    s_test = run(test, test_ds)
    s_probe = {name: run(probes[name].arrays, probes[name]) for name in probes}
    rows = score_table(s_test, s_probe, detectors[0].threshold(0.01))
    elapsed = time.time() - t0

    ref = {r["detector"]: r for r in (twin.reference("ood") or {}).get("rows", [])}
    names = list(probes)
    md = [
        "# OOD guardrail study — the port on the card",
        "",
        f"- platform: **{platform}**, {dtype} compute, {args.n_train} train "
        f"samples, {args.epochs} epochs, {elapsed:.0f}s total; probes of "
        f"`ensemble_study.make_probes` on latent-structured inputs "
        f"(latent_dim={args.latent_dim})",
        f"- detectors fitted on {fit_rows - fit_rows // 5} train rows + "
        f"{fit_rows // 5} held out for the threshold: input_norm (the "
        "shipped guardrail), the fused representation, the raw 84+256+768-d "
        "inputs",
        f"- the reference's run (`experiments/RESULTS_ood.json`) beside each "
        f"row; an AUROC gap beyond {twin.CCC_GAP} is marked **(gap)**",
        "",
        "| detector | run | " + " | ".join(f"AUROC {n}" for n in names) + " |",
        "|---|---|" + "---|" * len(names),
    ]
    for row in rows:
        r = ref.get(row["detector"])
        md.append(f"| {row['detector']} | this run | " + " | ".join(
            f"{row['auroc'][n]:.3f}"
            + (f" ({twin.gap(row['auroc'][n], r['auroc'][n])})" if r else "")
            for n in names) + " |")
        if r:
            md.append(f"| {row['detector']} | reference | " + " | ".join(
                f"{r['auroc'][n]:.3f}" for n in names) + " |")
    shipped = next(r for r in rows if r["detector"] == SHIPPED)
    ref_shipped = ref.get(SHIPPED, {}).get("tpr_at_1pct_fpr", {})
    md += [
        "",
        "Operating point (the shipped input_norm detector, threshold at 1% "
        "training FPR):",
        "",
        "| probe | TPR @ 1% FPR | reference |",
        "|---|---|---|",
    ] + [f"| {n} | {shipped['tpr_at_1pct_fpr'][n]:.3f} | "
         + (f"{ref_shipped[n]:.3f}" if n in ref_shipped else "—") + " |"
         for n in names] + [
        f"| clean test (FPR) | {shipped['test_fpr_at_threshold']:.3f} | "
        + (f"{ref[SHIPPED]['test_fpr_at_threshold']:.3f}" if SHIPPED in ref
           else "—") + " |",
        "",
        "Reproduce: `python -m tpu_deer_torch.experiments.ood_study` on the "
        "card (`--quick --platform cpu` for a CPU smoke).",
    ]
    twin.write(args.out, md, {"rows": rows, "elapsed_s": elapsed,
                              "args": vars(args), "platform": platform})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
