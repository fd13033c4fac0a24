"""Diagnose the raw-NIG miscalibration, through the port: which of the
NIG head's point summaries is calibrated with no learned correction.

    python -m tpu_deer_torch.experiments.nig_calibration_study
    python -m tpu_deer_torch.experiments.nig_calibration_study --quick --platform cpu

Twin of `experiments/nig_calibration_study.py`, with its flags, defaults,
probes and payload keys: five trainings of the flagship (dropout 0.1,
seed 0) on `--n_train` synthetic rows (n/8 validation and test rows, at
least 2,048) for `--epochs` at batch `--batch_size`, lr `--lr` cosine with
2 warm-up epochs, calibration weight 0.05, validation every 10 epochs and
no early stop: the headline defaults, then KL weight 0.01, KL weight 0,
the v1 loss at evidence weight 0.1, and aleatoric moment matching at 0.1.
Each reports CCC, MAE, the mean α, ν and β, the ECE of the moment channel
β(1+ν)/(ν(α−1)) (variance units), of the closed-form Student-t E|y − μ|
channel (`core/nig.py:nig_expected_abs_error`) and of the learned
calibrated channel, the scale ratios mean(eabs)/mean|err| and
mean(moment)/mean(err²), and r(eabs, |err|), from `predict(return_nig=True)`
and `core/metrics.py`'s `ece_np` and `pearson_np`. Fused epochs (a CUDA
graph of the step) on the card, per step on the CPU, as the reference on
its TPU and CPU.

The model computes in bfloat16 on the card, as the reference's does on its
TPU, and in float32 on the CPU, with TF32 and cuBLAS's bf16
reduced-precision reductions off.

Differences from the reference: `--platform` picks the card (`cuda`, the
default; it raises without one) or the CPU, and `--quick` (4,096 rows ×
6 epochs at batch 256, the first two probes) runs where `--platform` says;
results go to `results_torch/RESULTS_nig_calibration_h100.{json,md}`
(`--quick`: `..._quick`), the payload's `platform` names the card and its
power limit, the table sets the reference's CCC and eabs ECE beside each
probe's (a CCC gap beyond 0.02 flagged), and the reading of the full
default run is computed from this run's numbers, not pinned.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from tpu_deer_torch.experiments import twin

PROBES = (
    ("headline-default", {}),
    ("kl-0.01", {"kl_weight": 0.01}),
    ("kl-0", {"kl_weight": 0.0}),
    ("loss-v1", {"loss_variant": "v1", "evidence_weight": 0.1}),
    ("moment-match-0.1", {"aleatoric_moment_weight": 0.1}),
)


def run_probe(name, splits, args, device, **overrides):
    """One probe: train with the headline defaults and `overrides`, then
    the channels' calibration on the test split (the reference's
    `run_probe`, on `device`: None is the card)."""
    from tpu_deer_torch.core.metrics import ccc_np, ece_np, pearson_np
    from tpu_deer_torch.data.pipeline import ArrayDataset
    from tpu_deer_torch.device import resolve_device
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        create_complete_deer_model,
    )
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

    device = resolve_device(device)
    train_ds, val_ds, test_ds = (ArrayDataset(splits[s], "synthetic")
                                 for s in ("train", "val", "test"))
    config = DEERModelConfig(dropout=0.1, compute_dtype=twin.compute_dtype(device))
    model = create_complete_deer_model(config, seed=0, device=device)
    tc = dict(
        learning_rate=args.lr, batch_size=args.batch_size,
        num_epochs=args.epochs, warmup_epochs=2, scheduler="cosine",
        early_stopping_patience=10**6, val_frequency=10,
        calibration_alignment_weight=0.05, fused_epochs=device.type == "cuda")
    tc.update(overrides)
    trainer = DEERTrainer(model, TrainingConfig(**tc),
                          steps_per_epoch=len(train_ds) // args.batch_size,
                          device=device)
    t0 = time.time()
    trainer.train({"synthetic": train_ds}, {"synthetic": val_ds})
    pred = trainer.predict(test_ds, return_nig=True)
    y = test_ds.arrays["labels"]
    mu = np.asarray(pred["mu"])
    err = np.abs(mu - y)
    return {
        "probe": name,
        "overrides": dict(overrides),
        "train_s": time.time() - t0,
        "ccc_avg": float(np.mean([ccc_np(y[:, i], mu[:, i])
                                  for i in range(y.shape[1])])),
        "mae": float(err.mean()),
        "mean_alpha": float(np.asarray(pred["alpha"]).mean()),
        "mean_nu": float(np.asarray(pred["nu"]).mean()),
        "mean_beta": float(np.asarray(pred["beta"]).mean()),
        "ece_moment": ece_np(mu, y, pred["uncertainty"]),
        "ece_eabs": ece_np(mu, y, pred["eabs"]),
        "ece_calibrated": ece_np(mu, y, pred["calibrated_uncertainty"]),
        "eabs_over_err": float(np.asarray(pred["eabs"]).mean() / err.mean()),
        "moment_over_var": float(np.asarray(pred["uncertainty"]).mean()
                                 / np.square(err).mean()),
        "r_eabs_err": pearson_np(np.asarray(pred["eabs"]).mean(axis=1),
                                 err.mean(axis=1)),
    }


def reading(results: list[dict]) -> list[str]:
    """What the full default run says, computed from its numbers."""
    r = {x["probe"]: x for x in results}
    head = r["headline-default"]
    best = min(results, key=lambda x: x["ece_eabs"])
    return [
        "",
        "## Reading the table (computed from this run)",
        "",
        f"- At the headline defaults the closed-form eabs channel's ECE is "
        f"{head['ece_eabs']:.3f} against {head['ece_moment']:.3f} for the "
        f"moment channel (scale ratio eabs/|err| {head['eabs_over_err']:.2f}, "
        f"moment/err² {head['moment_over_var']:.2f}).",
        f"- The lowest eabs ECE is the {best['probe']} probe's "
        f"({best['ece_eabs']:.3f}, CCC {best['ccc_avg']:.3f}); KL 0.01 reads "
        f"{r['kl-0.01']['ece_eabs']:.3f} and KL 0 "
        f"{r['kl-0']['ece_eabs']:.3f}.",
        f"- loss-v1 (evidence weight 0.1): mean α {r['loss-v1']['mean_alpha']:.2f}, "
        f"CCC {r['loss-v1']['ccc_avg']:.3f}.",
        f"- Moment matching 0.1: moment ECE {r['moment-match-0.1']['ece_moment']:.3f}, "
        f"mean ν {r['moment-match-0.1']['mean_nu']:.2f}, eabs ECE "
        f"{r['moment-match-0.1']['ece_eabs']:.3f}.",
    ]


def main(argv=None) -> int:
    p = twin.parser(__doc__, "nig_calibration")
    p.add_argument("--n_train", type=int, default=65536)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--lr", type=float, default=2e-3)
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "nig_calibration")
    probes = list(PROBES)
    if args.quick:
        args.n_train, args.epochs, args.batch_size = 4096, 6, 256
        probes = probes[:2]

    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits

    splits = make_synthetic_splits(SyntheticConfig(
        n_train=args.n_train, n_val=max(2048, args.n_train // 8),
        n_test=max(2048, args.n_train // 8)))
    results = []
    t0 = time.time()
    for name, overrides in probes:
        res = run_probe(name, splits, args, device, **overrides)
        results.append(res)
        print(json.dumps(res, default=float), file=sys.stderr, flush=True)

    payload = {"platform": platform, "n_train": args.n_train,
               "epochs": args.epochs, "elapsed_s": time.time() - t0,
               "runs": results}
    ref = {r["probe"]: r for r in
           (twin.reference("nig_calibration") or {}).get("runs", [])}
    dtype = twin.compute_dtype(device)
    lines = [
        "# Raw-NIG calibration study — the port on the card",
        "",
        f"- platform: **{platform}**, {dtype} compute, n_train {args.n_train}, "
        f"epochs {args.epochs} ({payload['elapsed_s']:.0f}s total)",
        "- Channels: *moment* = shipped total uncertainty "
        "beta(1+nu)/(nu(alpha-1)) (variance units); *eabs* = closed-form "
        "Student-t E|y-mu| (no learned correction); *calibrated* = learned "
        "calibration layer.",
        "- ref = the reference's committed run (`experiments/"
        f"RESULTS_nig_calibration.json`, its TPU); a CCC gap beyond "
        f"{twin.CCC_GAP} is marked **(gap)**",
        "",
        "| probe | CCC | ref CCC | gap | ECE moment | ECE eabs | ref ECE eabs "
        "| ECE calib | mean α | mean ν | eabs/|err| | r(eabs,err) |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    cell = lambda v: "—" if v is None else f"{v:.3f}"
    for r in results:
        rr = ref.get(r["probe"], {})
        lines.append(
            f"| {r['probe']} | {r['ccc_avg']:.3f} | {cell(rr.get('ccc_avg'))} "
            f"| {twin.gap(r['ccc_avg'], rr.get('ccc_avg'))} "
            f"| {r['ece_moment']:.3f} | {r['ece_eabs']:.3f} "
            f"| {cell(rr.get('ece_eabs'))} | {r['ece_calibrated']:.3f} "
            f"| {r['mean_alpha']:.2f} | {r['mean_nu']:.2f} "
            f"| {r['eabs_over_err']:.2f} | {r['r_eabs_err']:.2f} |")
    # The reading is written for the full default configuration only, as
    # the reference's; any other run gets the computed table alone.
    if (not args.quick and args.n_train == 65536 and args.epochs == 30
            and len(results) == len(PROBES)):
        lines += reading(results)
    else:
        lines += ["", "(Non-default configuration — computed table only.)"]
    lines += ["", "Reproduce: `python -m tpu_deer_torch.experiments."
              "nig_calibration_study` on the card (`--quick --platform cpu` "
              "for a CPU smoke)."]
    twin.write(args.out, lines, payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
