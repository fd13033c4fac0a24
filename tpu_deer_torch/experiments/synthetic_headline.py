"""The headline run through the port: the flagship at full width on the
synthetic benchmark, trained with the headline recipe on the card.

    python -m tpu_deer_torch.experiments.synthetic_headline
    python -m tpu_deer_torch.experiments.synthetic_headline --platform cpu \\
        --n_train 2048 --epochs 2 --batch_size 256 --out /tmp/headline

Twin of `experiments/synthetic_headline.py`, with its flags, defaults,
payload keys and Markdown table: `CompleteDEERModel` (3,918,324 params) on
1,048,576 synthetic training rows (n/8 validation and test rows, data seed
42 + seed, init seed `--seed`), batch 4,096, lr 1.2e-3 cosine with 5
warmup epochs, dropout 0.05, KL weight 0.01, calibration weight 0.15, 100
fused epochs (a CUDA graph of the train step on the card), validation every
10 epochs and no early stop; then the metric bundle on the test split (CCC,
MAE, RMSE, ECE of each uncertainty channel, a post-hoc scale fit on
validation, the uncertainty-error correlation and AUSE, bootstrap CIs).

The model computes in bfloat16 on the card, as the reference's does on its
TPU, and in float32 on the CPU (parameters, NIG math and calibration stay
float32), with TF32 and cuBLAS's bf16 reduced-precision reductions off.

Differences from the reference: `--platform` picks the card (`cuda`, the
default; it raises without one) or the CPU; results go to
`results_torch/RESULTS_synthetic_h100` (`_seed<k>` added for a non-zero
seed), the payload's `platform` names the card and its power limit, and
`--figures_from` without `--figures` renders into
`results_torch/figures_headline`. `--figures DIR` renders the plots
(`viz/report.py`; where matplotlib is not installed, the interactive
dashboard and the JSON data export only), as the reference does.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

DEFAULT_OUT = "results_torch/RESULTS_synthetic_h100"
DEFAULT_FIGURES = "results_torch/figures_headline"


def _render_figures(pred, labels, history, figures_dir, title_suffix=""):
    """The plot set, the summary figure and the interactive dashboard from
    a run's predictions, as the reference renders them: the reliability and
    scatter plots read the deployable calibrated uncertainty, the
    decomposition the raw aleatoric and epistemic components."""
    from tpu_deer_torch.viz.html_report import create_interactive_report
    from tpu_deer_torch.viz.report import (
        create_comprehensive_report,
        plot_summary_figure,
    )

    deployable = pred["calibrated_uncertainty"]
    paths = create_comprehensive_report(
        pred["mu"], labels, deployable, history=history,
        aleatoric=pred["aleatoric"], epistemic=pred["epistemic"],
        output_dir=figures_dir)
    if "static" not in paths:
        paths["summary"] = plot_summary_figure(
            pred["mu"], labels, deployable, history=history,
            save_path=os.path.join(figures_dir, "summary.png"))
    paths["interactive"] = create_interactive_report(
        pred["mu"], labels, deployable, history=history,
        output_path=os.path.join(figures_dir, "interactive_report.html"),
        title=f"Multimodal DEER — headline run {title_suffix}")
    print("figures:", ", ".join(sorted(paths)))
    return paths


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class _Heartbeat:
    """A MetricWriter stand-in: one stderr line an epoch and a validation."""

    def __init__(self, t0: float):
        self.t0 = t0

    def scalar(self, key, value, step):
        if key == "train/lr":
            print(f"[epoch {step}] lr={value:.2e} t={time.time() - self.t0:.0f}s",
                  file=sys.stderr, flush=True)

    def scalars(self, metrics, step, prefix=""):
        if prefix == "val/":
            print(f"[epoch {step}] val_ccc={metrics['ccc_average']:.4f} "
                  f"t={time.time() - self.t0:.0f}s", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--n_train", type=int, default=1048576)
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--lr", type=float, default=1.2e-3)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--dropout", type=float, default=0.05)
    p.add_argument("--kl_weight", type=float, default=0.01)
    p.add_argument("--calibration_weight", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--figures", default=None, metavar="DIR")
    p.add_argument("--figures_from", default=None, metavar="NPZ")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.figures_from:
        saved = np.load(args.figures_from)
        history = ({"train_loss": list(saved["history_train_loss"]),
                    "val_ccc": list(saved["history_val_ccc"])}
                   if "history_train_loss" in saved.files else None)
        _render_figures(
            {k: saved[k] for k in saved.files if k != "labels"},
            saved["labels"], history, args.figures or DEFAULT_FIGURES,
            title_suffix="(from saved predictions)")
        return 0

    from tpu_deer_torch.core.metrics import ece_np
    from tpu_deer_torch.data.pipeline import ArrayDataset
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.device import resolve_device
    from tpu_deer_torch.eval.calibration import fit_uncertainty_scale
    from tpu_deer_torch.eval.comprehensive import ComprehensiveEvaluator
    from tpu_deer_torch.eval.evaluator import DEERModelEvaluator
    from tpu_deer_torch.eval.uncertainty import UncertaintyAnalyzer
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        count_parameters,
        create_complete_deer_model,
    )
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

    if args.seed and args.out == DEFAULT_OUT:
        args.out += f"_seed{args.seed}"
    device = resolve_device(args.platform)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    platform = card_name(device)

    splits = make_synthetic_splits(SyntheticConfig(
        n_train=args.n_train, n_val=args.n_train // 8, n_test=args.n_train // 8,
        seed=42 + args.seed))
    train_ds, val_ds, test_ds = (ArrayDataset(splits[s], "synthetic")
                                 for s in ("train", "val", "test"))
    compute_dtype = "bfloat16" if device.type == "cuda" else "float32"
    model = create_complete_deer_model(
        DEERModelConfig(dropout=args.dropout, compute_dtype=compute_dtype),
        seed=args.seed, device=device)
    n_params = count_parameters(model)
    trainer = DEERTrainer(
        model,
        TrainingConfig(
            learning_rate=args.lr, batch_size=args.batch_size,
            num_epochs=args.epochs, warmup_epochs=args.warmup_epochs,
            scheduler="cosine",
            # No early stop: patience counts validations, and the cosine
            # schedule needs its whole horizon.
            early_stopping_patience=10**6, val_frequency=10,
            kl_weight=args.kl_weight,
            calibration_alignment_weight=args.calibration_weight,
            fused_epochs=True),
        steps_per_epoch=len(train_ds) // args.batch_size, device=device)

    t0 = time.time()
    results = trainer.train({"synthetic": train_ds}, {"synthetic": val_ds},
                            logger=_Heartbeat(t0))
    train_time = time.time() - t0

    labels = test_ds.arrays["labels"]
    pred = trainer.predict(test_ds, return_nig=True)
    ev = DEERModelEvaluator(n_bootstrap=500).evaluate_arrays(
        pred["mu"], labels, pred["uncertainty"], n_params)
    ece_calibrated = ece_np(pred["mu"], labels, pred["calibrated_uncertainty"])
    ece_raw_eabs = ece_np(pred["mu"], labels, pred["eabs"])
    val_pred = trainer.predict(val_ds)
    best_scale = fit_uncertainty_scale(val_pred["mu"], val_ds.arrays["labels"],
                                       val_pred["calibrated_uncertainty"])
    ece_posthoc = ece_np(pred["mu"], labels,
                         best_scale * pred["calibrated_uncertainty"])
    ua = UncertaintyAnalyzer().analyze(pred["mu"], labels, pred["uncertainty"],
                                       aleatoric=pred["aleatoric"],
                                       epistemic=pred["epistemic"])
    ua_alea = UncertaintyAnalyzer().analyze(pred["mu"], labels, pred["aleatoric"])
    report = ComprehensiveEvaluator().generate_report(
        pred["mu"], labels, pred["uncertainty"],
        model_name=f"CompleteDEERModel ({platform})")

    payload = {
        "platform": platform,
        "seed": args.seed,
        "n_params": n_params,
        "epochs_run": results["epochs_run"],
        "train_time_s": train_time,
        "best_val_ccc": results["best_val_ccc"],
        "test": ev.to_dict(),
        "ece_calibrated": float(ece_calibrated),
        "ece_raw_eabs": float(ece_raw_eabs),
        "ece_posthoc": float(ece_posthoc),
        "posthoc_scale": best_scale,
        "uncertainty": {
            "uncertainty_error_correlation": ua["uncertainty_error_correlation"],
            "ause": ua["ause"],
            "aleatoric_error_correlation": ua_alea["uncertainty_error_correlation"],
            "aleatoric_ause": ua_alea["ause"],
            "decomposition": ua.get("decomposition"),
        },
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out + ".json", "w") as f:
        json.dump(payload, f, indent=2, default=float)

    ci = ev.confidence_intervals["valence"]
    md = [
        "# Synthetic headline run — computed results",
        "",
        f"- platform: **{platform}**, compute dtype {compute_dtype}, params: "
        f"{n_params:,} (reference model: 3,918,324)",
        f"- train: {args.n_train} samples, {results['epochs_run']} epochs, "
        f"{train_time:.1f}s wall",
        "",
        "| metric | value |",
        "|---|---|",
        f"| CCC valence / arousal / dominance | {ev.ccc['valence']:.3f} / "
        f"{ev.ccc['arousal']:.3f} / {ev.ccc['dominance']:.3f} |",
        f"| CCC average | {ev.ccc_average:.3f} |",
        f"| MAE average | {ev.mae_average:.3f} |",
        f"| RMSE average | {ev.rmse_average:.3f} |",
        f"| ECE (raw NIG, moment channel, variance units) | {ev.ece:.3f} |",
        f"| ECE (raw NIG, closed-form E\\|err\\| channel) | {ece_raw_eabs:.3f} |",
        f"| ECE (calibrated uncertainty) | {ece_calibrated:.3f} |",
        f"| ECE (+ post-hoc scale fit on val) | {ece_posthoc:.3f} |",
        f"| uncertainty-error correlation (total) | "
        f"{ua['uncertainty_error_correlation']:.3f} |",
        f"| uncertainty-error correlation (aleatoric) | "
        f"{ua_alea['uncertainty_error_correlation']:.3f} |",
        f"| AUSE (total / aleatoric) | {ua['ause']:.4f} / {ua_alea['ause']:.4f} |",
        f"| CCC 95% CI (valence) | [{ci[0]:.3f}, {ci[1]:.3f}] |",
        "",
        "```",
        report,
        "```",
    ]
    with open(args.out + ".md", "w") as f:
        f.write("\n".join(md) + "\n")
    np.savez(args.out + "_predictions.npz", labels=labels,
             history_train_loss=np.asarray(results["history"]["train_loss"],
                                           dtype=np.float64),
             history_val_ccc=np.asarray(results["history"]["val_ccc"],
                                        dtype=np.float64),
             **pred)
    if args.figures:
        _render_figures(pred, labels, results["history"], args.figures,
                        title_suffix=f"({platform}, CCC {ev.ccc_average:.3f})")
    print(json.dumps(payload["test"]["ccc"], indent=2))
    print("uncertainty-error r:", payload["uncertainty"])
    print("written:", args.out + ".md")
    return 0


if __name__ == "__main__":
    sys.exit(main())
