"""Fusion-zoo ablation: the flagship trained with every fusion strategy,
through the port.

    python -m tpu_deer_torch.experiments.fusion_ablation
    python -m tpu_deer_torch.experiments.fusion_ablation --quick --platform cpu

Twin of `experiments/fusion_ablation.py`, with its defaults: benchmark v2
(32,768 train rows), for each `DEERModelConfig.fusion_type` in
FUSION_TYPES the flagship (init seed 0, dropout 0.1) trained 20 epochs at
batch 512, lr 1e-3 cosine with one warm-up epoch, validation every 4
epochs, then CCC, MAE, the calibrated ECE (a post-hoc scale fitted on
validation), the uncertainty-error correlation and the parameter count on
the test split. Differences: float32 with TF32 off where the reference ran
bf16 on its TPU, fused epochs (a CUDA graph of the train step) on the card.
Results: results_torch/RESULTS_fusion_h100.{json,md}, beside the
reference's experiments/RESULTS_fusion.json.
"""

from __future__ import annotations

import time

from tpu_deer_torch.experiments import twin

FUSION_TYPES = ("hierarchical", "attention", "bilinear", "concat",
                "adaptive", "moe")


def main(argv=None) -> int:
    p = twin.parser(__doc__, "fusion")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--n_train", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--dropout", type=float, default=0.1)
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "fusion")
    epochs = args.epochs or (2 if args.quick else 20)
    n_train = args.n_train or (512 if args.quick else 32768)

    from tpu_deer_torch.data.pipeline import ArrayDataset
    from tpu_deer_torch.data.synthetic import benchmark_v2, make_synthetic_splits
    from tpu_deer_torch.eval.evaluator import DEERModelEvaluator
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        count_parameters,
        create_complete_deer_model,
    )
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

    splits = make_synthetic_splits(benchmark_v2(n_train=n_train))
    train_ds, val_ds, test_ds = (ArrayDataset(splits[s], "synthetic")
                                 for s in ("train", "val", "test"))
    results = {}
    t0 = time.time()
    for fusion in FUSION_TYPES:
        model = create_complete_deer_model(
            DEERModelConfig(fusion_type=fusion, dropout=args.dropout), seed=0,
            device=device)
        n_params = count_parameters(model)
        trainer = DEERTrainer(
            model, TrainingConfig(
                learning_rate=1e-3, batch_size=args.batch_size,
                num_epochs=epochs, warmup_epochs=1, scheduler="cosine",
                val_frequency=4, early_stopping_patience=50,
                fused_epochs=device.type == "cuda"),
            steps_per_epoch=max(n_train // args.batch_size, 1), device=device)
        t = time.time()
        trainer.train({"s": train_ds}, {"s": val_ds})
        train_s = time.time() - t
        res = DEERModelEvaluator(n_bootstrap=0, seed=0).evaluate_model(
            trainer, test_ds, n_parameters=n_params, calibration_dataset=val_ds)
        results[fusion] = {
            "ccc_average": float(res.ccc_average),
            "mae_average": float(res.mae_average),
            "ece": float(res.ece),
            "unc_err_corr": float(res.uncertainty_error_correlation),
            "n_params": int(n_params),
            "train_s": train_s,
        }
        print(f"{fusion:>12}: CCC {res.ccc_average:.3f} MAE "
              f"{res.mae_average:.3f} ECE {res.ece:.3f} corr "
              f"{res.uncertainty_error_correlation:.3f} ({n_params:,} params, "
              f"{train_s:.1f} s)", flush=True)
    elapsed = time.time() - t0

    ref = twin.reference("fusion") or {}
    md = [
        "# Fusion-zoo ablation — the port on the card",
        "",
        f"- platform: **{platform}**, float32 (TF32 off)"
        f"{', fused epochs' if device.type == 'cuda' else ''}; "
        f"{n_train} train samples of benchmark v2, {epochs} epochs per "
        f"strategy, batch {args.batch_size}, dropout {args.dropout}, "
        f"{elapsed:.0f}s total",
        "- the reference's run (`experiments/RESULTS_fusion.json`, bf16 on "
        "its TPU) beside each row; a CCC gap beyond "
        f"{twin.CCC_GAP} is marked **(gap)**",
        "- ECE uses the deployable calibrated uncertainty with a post-hoc "
        "scale fit on the validation split",
        "",
        "| fusion | run | CCC avg | MAE avg | ECE (calibrated) | unc-err corr "
        "| params | train s | CCC gap |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key, r in results.items():
        rr = ref.get(key)
        md.append(f"| {key} | this run | {r['ccc_average']:.3f} | "
                  f"{r['mae_average']:.3f} | {r['ece']:.3f} | "
                  f"{r['unc_err_corr']:.3f} | {r['n_params']:,} | "
                  f"{r['train_s']:.1f} | "
                  f"{twin.gap(r['ccc_average'], rr and rr['ccc_average'])} |")
        if rr:
            md.append(f"| {key} | reference | {rr['ccc_average']:.3f} | "
                      f"{rr['mae_average']:.3f} | {rr['ece']:.3f} | "
                      f"{rr['unc_err_corr']:.3f} | {rr['n_params']:,} | | |")
    md += ["", "Reproduce: `python -m tpu_deer_torch.experiments.fusion_ablation` "
               "on the card (`--quick --platform cpu` for a CPU smoke)."]
    twin.write(args.out, md, {"results": results, "platform": platform,
                              "elapsed_s": elapsed, "args": vars(args)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
