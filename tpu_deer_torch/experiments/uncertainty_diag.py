"""Diagnose the uncertainty-ranking gap on the heteroscedastic benchmark,
through the port.

    python -m tpu_deer_torch.experiments.uncertainty_diag
    python -m tpu_deer_torch.experiments.uncertainty_diag --quick --platform cpu

Twin of `experiments/uncertainty_diag.py`, with its flags, its one probe
and its payload keys: the flagship trained with the v2 loss at evidence
weight 1.0 and KL weight 0.1, lr 1.2e-3 cosine with 5 warm-up epochs,
calibration weight 0.05, no aleatoric moment matching, dropout 0.05, batch
4,096, on 64 × `--n_train` = 1,048,576 synthetic rows (n/16 validation
and test rows) for 100 fused epochs (a CUDA graph of the step on the card).
On the test split it separates the two causes of a low
uncertainty-error correlation: the model-conditional ceiling
r(true noise scale, |error|), and for the total, aleatoric and epistemic
channels r(channel, |error|), r(channel, true noise scale), the channel's
mean on hard and easy rows and its AUSE.

The model computes in bfloat16 on the card, as the reference's does on its
TPU, and in float32 on the CPU (`synthetic_headline.py`'s rule), with TF32
and cuBLAS's bf16 reduced-precision reductions off. The reference's record
of this probe is `experiments/diag_history/batch7.json` (batch 7 of
`diag_history/INDEX.md`; `RESULTS_uncertainty_diag.json` holds batch 1's
older probes).

Differences from the reference: `--platform` picks the card (`cuda`, the
default; it raises without one) or the CPU; results go to
`results_torch/RESULTS_uncertainty_diag_h100.{json,md}` (`--quick`: 4,096
rows × 2 epochs at batch 256, `..._quick`), the payload's `platform`
names the card and its power limit, and the Markdown table sets each
number beside batch 7's, a CCC gap beyond 0.02 flagged.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from tpu_deer_torch.experiments import twin

CHANNELS = ("uncertainty", "aleatoric", "epistemic")
REFERENCE = os.path.join(twin.ROOT, "experiments", "diag_history", "batch7.json")


def run_one(splits, model_config, args, epochs, evidence_w, kl_w, lr,
            moment_w=0.1, warmup=2, device=None):
    """One probe: train on `splits`, then the diagnosis on the test split
    (the reference's `run_one`, on `device`: None is the card)."""
    from tpu_deer_torch.core.metrics import ccc_np, pearson_np
    from tpu_deer_torch.data.pipeline import ArrayDataset
    from tpu_deer_torch.device import resolve_device
    from tpu_deer_torch.eval.uncertainty import UncertaintyAnalyzer
    from tpu_deer_torch.models.deer_model import create_complete_deer_model
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

    train_ds, val_ds, test_ds = (ArrayDataset(splits[s], "synthetic")
                                 for s in ("train", "val", "test"))
    device = resolve_device(device)
    model = create_complete_deer_model(model_config, seed=0, device=device)
    trainer = DEERTrainer(
        model,
        TrainingConfig(
            learning_rate=lr, batch_size=args.batch_size,
            num_epochs=epochs, warmup_epochs=warmup, scheduler="cosine",
            early_stopping_patience=1000, val_frequency=10,
            evidence_weight=evidence_w, kl_weight=kl_w,
            calibration_alignment_weight=0.05, loss_variant="v2",
            aleatoric_moment_weight=moment_w, fused_epochs=True),
        steps_per_epoch=len(train_ds) // args.batch_size, device=device)
    trainer.train({"synthetic": train_ds}, {"synthetic": val_ds})
    pred = trainer.predict(test_ds)
    y = test_ds.arrays["labels"]
    mu = np.asarray(pred["mu"])
    err = np.abs(mu - y).mean(axis=1)
    is_hard = splits["test"]["is_hard"].astype(bool)
    noise_scale = np.where(is_hard, 0.4, 0.1)

    analyzer = UncertaintyAnalyzer()
    out = {
        "epochs": epochs, "evidence_weight": evidence_w, "kl_weight": kl_w,
        "lr": lr,
        "r_oracle_vs_model_err": pearson_np(noise_scale, err),
        "err_hard_mean": float(err[is_hard].mean()),
        "err_easy_mean": float(err[~is_hard].mean()),
        "ccc_average": float(np.mean([ccc_np(y[:, i], mu[:, i])
                                      for i in range(y.shape[1])])),
    }
    for kind in CHANNELS:
        u = np.asarray(pred[kind]).mean(axis=1)
        ua = analyzer.analyze(mu, y, np.asarray(pred[kind]))
        out[kind] = {
            "r_vs_err": pearson_np(err, u),
            "r_vs_noise_scale": pearson_np(noise_scale, u),
            "mean_hard": float(u[is_hard].mean()),
            "mean_easy": float(u[~is_hard].mean()),
            "ause": ua["ause"],
        }
    return out


def reference() -> dict:
    """Batch 7's record of the probe."""
    with open(REFERENCE) as f:
        return json.load(f)


def table(payload: dict, ref: dict) -> list[str]:
    """The Markdown rows of each run beside the reference's first run."""
    (rr,) = ref["runs"]
    md = []
    for r in payload["runs"]:
        md += [
            f"### {r['n_train']:,} rows × {r['epochs']} epochs, batch "
            f"{r['batch']}, dropout {r['dropout']}, moment_w {r['moment_w']}",
            "",
            "| quantity | port | reference (batch 7) | gap |",
            "|---|---|---|---|",
            f"| CCC average | {r['ccc_average']:.4f} | {rr['ccc_average']:.4f} | "
            f"{twin.gap(r['ccc_average'], rr['ccc_average'])} |",
            f"| r(true noise scale, \\|error\\|) | {r['r_oracle_vs_model_err']:.4f} "
            f"| {rr['r_oracle_vs_model_err']:.4f} | |",
            f"| mean \\|error\\| hard / easy | {r['err_hard_mean']:.4f} / "
            f"{r['err_easy_mean']:.4f} | {rr['err_hard_mean']:.4f} / "
            f"{rr['err_easy_mean']:.4f} | |",
        ]
        for kind in CHANNELS:
            a, b = r[kind], rr[kind]
            md += [
                f"| {kind}: r vs \\|error\\| | {a['r_vs_err']:.4f} | "
                f"{b['r_vs_err']:.4f} | |",
                f"| {kind}: r vs noise scale | {a['r_vs_noise_scale']:.4f} | "
                f"{b['r_vs_noise_scale']:.4f} | |",
                f"| {kind}: mean hard / easy | {a['mean_hard']:.4f} / "
                f"{a['mean_easy']:.4f} | {b['mean_hard']:.4f} / "
                f"{b['mean_easy']:.4f} | |",
                f"| {kind}: AUSE | {a['ause']:.4f} | {b['ause']:.4f} | |",
            ]
        md.append("")
    return md


def main(argv=None) -> int:
    p = twin.parser(__doc__, "uncertainty_diag")
    p.add_argument("--n_train", type=int, default=16384)
    p.add_argument("--batch_size", type=int, default=512)
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "uncertainty_diag")

    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.models.deer_model import DEERModelConfig

    dtype = twin.compute_dtype(device)
    # (epochs, evidence_w, kl_w, lr, n_train, dropout, batch, moment_w,
    # warmup): batch 7, the reference's one probe.
    probes = [(100, 1.0, 0.1, 1.2e-3, 64 * args.n_train, 0.05, 4096, 0.0, 5)]
    if args.quick:
        probes = [(2, 1.0, 0.1, 1.2e-3, 4096, 0.05, 256, 0.0, 1)]
    results = []
    t0 = time.time()
    for epochs, ew, kw, lr, n_train, dropout, batch, moment_w, warmup in probes:
        splits = make_synthetic_splits(SyntheticConfig(
            n_train=n_train, n_val=max(2048, n_train // 16),
            n_test=max(2048, n_train // 16)))
        args.batch_size = batch
        res = run_one(splits, DEERModelConfig(dropout=dropout, compute_dtype=dtype),
                      args, epochs, ew, kw, lr, moment_w=moment_w, warmup=warmup,
                      device=device)
        res.update(n_train=n_train, dropout=dropout, batch=batch,
                   moment_w=moment_w, warmup=warmup)
        results.append(res)
        print(json.dumps(res, default=float), file=sys.stderr, flush=True)

    payload = {"platform": platform, "elapsed_s": time.time() - t0,
               "runs": results}
    ref = reference()
    md = [
        "# Uncertainty-ranking diagnosis — the port on the card",
        "",
        f"- platform: **{platform}**, {dtype} compute, fused epochs, "
        f"{payload['elapsed_s']:.0f}s total",
        "- beside `experiments/diag_history/batch7.json` (the reference's "
        f"{ref['platform']} run of the same probe); a CCC gap beyond "
        f"{twin.CCC_GAP} is marked **(gap)**",
        "- r(true noise scale, |error|) is the ceiling any uncertainty could "
        "reach on this model's errors; each channel's r vs noise scale says "
        "whether its head learned the hardness feature",
        "",
        *table(payload, ref),
        "Reproduce: `python -m tpu_deer_torch.experiments.uncertainty_diag` "
        "on the card (`--quick --platform cpu` for a CPU smoke).",
    ]
    twin.write(args.out, md, payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
