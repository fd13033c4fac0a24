"""Modality ablation: the flagship trained on every modality subset,
through the port.

    python -m tpu_deer_torch.experiments.ablation_study
    python -m tpu_deer_torch.experiments.ablation_study --quick --platform cpu

Twin of `experiments/ablation_study.py`, with its defaults: benchmark v2
(16,384 train rows), the flagship (dropout 0.1) trained 20 epochs a subset
at batch 512, lr 1e-3 cosine with one warm-up epoch, validation every 4
epochs, the modalities outside the subset zeroed in every split
(`eval/ablation.py`), then CCC, MAE, the calibrated ECE (a post-hoc scale
fitted on validation) and the uncertainty-error correlation on the test
split. Differences: float32 with TF32 off where the reference ran bf16 on
its TPU, fused epochs on the card. Results:
results_torch/RESULTS_ablation_h100.{json,md}, beside the reference's
experiments/RESULTS_ablation.json.
"""

from __future__ import annotations

import time

from tpu_deer_torch.experiments import twin


def main(argv=None) -> int:
    p = twin.parser(__doc__, "ablation")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--n_train", type=int, default=16384)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--dropout", type=float, default=0.1)
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "ablation")
    if args.quick:
        args.epochs, args.n_train = 1, 1024

    from tpu_deer_torch.data.pipeline import ArrayDataset
    from tpu_deer_torch.data.synthetic import benchmark_v2, make_synthetic_splits
    from tpu_deer_torch.eval.ablation import AblationStudy
    from tpu_deer_torch.models.deer_model import DEERModelConfig
    from tpu_deer_torch.train.trainer import TrainingConfig

    splits = make_synthetic_splits(benchmark_v2(n_train=args.n_train))
    study = AblationStudy(
        DEERModelConfig(dropout=args.dropout),
        TrainingConfig(learning_rate=1e-3, batch_size=args.batch_size,
                       num_epochs=args.epochs, warmup_epochs=1,
                       scheduler="cosine", val_frequency=4,
                       early_stopping_patience=50,
                       fused_epochs=device.type == "cuda"),
        device=device)
    t0 = time.time()
    results = study.run(*(ArrayDataset(splits[s], "synthetic")
                          for s in ("train", "val", "test")),
                        num_epochs=args.epochs)
    elapsed = time.time() - t0

    ref = twin.reference("ablation") or {}
    md = [
        "# Modality ablation — the port on the card",
        "",
        f"- platform: **{platform}**, float32 (TF32 off)"
        f"{', fused epochs' if device.type == 'cuda' else ''}; "
        f"{args.n_train} train samples of benchmark v2, {args.epochs} epochs "
        f"a subset, batch {args.batch_size}, dropout {args.dropout}, "
        f"{elapsed:.0f}s total",
        "- the reference's run (`experiments/RESULTS_ablation.json`, bf16 on "
        f"its TPU) beside each row; a CCC gap beyond {twin.CCC_GAP} is marked "
        "**(gap)**",
        "- ECE uses the deployable calibrated uncertainty with a post-hoc "
        "scale fit on the validation split",
        "",
        "| modalities | run | CCC avg | MAE avg | ECE (calibrated) | "
        "unc-err corr | CCC gap |",
        "|---|---|---|---|---|---|---|",
    ]
    for key, r in results.items():
        rr = ref.get(key)
        md.append(f"| {key} | this run | {r['ccc_average']:.3f} | "
                  f"{r['mae_average']:.3f} | {r['ece']:.3f} | "
                  f"{r['uncertainty_error_correlation']:.3f} | "
                  f"{twin.gap(r['ccc_average'], rr and rr['ccc_average'])} |")
        if rr:
            md.append(f"| {key} | reference | {rr['ccc_average']:.3f} | "
                      f"{rr['mae_average']:.3f} | {rr['ece']:.3f} | "
                      f"{rr['uncertainty_error_correlation']:.3f} | |")
    md += ["", "Reproduce: `python -m tpu_deer_torch.experiments.ablation_study` "
               "on the card (`--quick --platform cpu` for a CPU smoke)."]
    twin.write(args.out, md, {"results": results, "platform": platform,
                              "elapsed_s": elapsed, "args": vars(args)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
