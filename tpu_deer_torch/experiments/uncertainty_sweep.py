"""Uncertainty-quality sweep on the heteroscedastic synthetic benchmark,
through the port.

    python -m tpu_deer_torch.experiments.uncertainty_sweep \\
        --n_train 16384 --epochs 40
    python -m tpu_deer_torch.experiments.uncertainty_sweep --quick --platform cpu

Twin of `experiments/uncertainty_sweep.py`, with its flags, defaults,
grid and payload keys: for each (evidence weight, KL weight) of the full
grid, {0.5, 1, 3, 10} × {0.1, 1} at calibration weight 0.05 and the v2 loss
(`--grid small`: (1.0, 0.1) alone), the flagship trained from seed 0 on
`--n_train` synthetic rows (n/8 validation and test rows) at lr `--lr`
cosine with 2 warm-up epochs, validation every 5 epochs and patience 100;
then, on the test split, CCC and for the total, aleatoric, epistemic and
calibrated channels r(mean |error|, mean uncertainty) and AUSE. The
reference's committed run (`experiments/RESULTS_uncertainty_sweep.md`) used
16,384 rows × 40 epochs, not the defaults of 16,000 × 25: the first command
above is that run.

The model computes in bfloat16 on the card, as the reference's does on its
TPU, and in float32 on the CPU, with TF32 and cuBLAS's bf16
reduced-precision reductions off.

Differences from the reference: on the card the epochs are fused (a CUDA
graph of the step; the reference trains per step, and the port's fused
epochs equal its per-step ones, `tests/test_torch_fused.py`), per step on
the CPU as the reference; `--platform` picks the card (`cuda`, the
default; it raises without one) or the CPU; results go to
`results_torch/RESULTS_uncertainty_sweep_h100.{json,md}` (`--quick`: 2,048
rows × 2 epochs at batch 256 on the small grid, `..._quick`), the payload's
`platform` names the card and its power limit, and the table sets each
run's CCC and r beside the reference's, a CCC gap beyond 0.02 flagged.
"""

from __future__ import annotations

import itertools
import json
import sys
import time

import numpy as np

from tpu_deer_torch.experiments import twin

CHANNELS = ("uncertainty", "aleatoric", "epistemic", "calibrated_uncertainty")


def run_one(splits, model_config, args, evidence_w, kl_w, cal_w, variant,
            device=None):
    """One grid point: train on `splits`, then CCC and each channel's r and
    AUSE on the test split (the reference's `run_one`, on `device`: None
    is the card)."""
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
            learning_rate=args.lr, batch_size=args.batch_size,
            num_epochs=args.epochs, warmup_epochs=2, scheduler="cosine",
            early_stopping_patience=100, val_frequency=5,
            evidence_weight=evidence_w, kl_weight=kl_w,
            calibration_alignment_weight=cal_w, loss_variant=variant,
            # Off (None) on the CPU, as the reference leaves it.
            fused_epochs=True if device.type == "cuda" else None),
        steps_per_epoch=len(train_ds) // args.batch_size, device=device)
    trainer.train({"synthetic": train_ds}, {"synthetic": val_ds})
    pred = trainer.predict(test_ds)
    y = test_ds.arrays["labels"]
    mu = np.asarray(pred["mu"])
    err = np.abs(mu - y).mean(axis=1)

    out = {}
    analyzer = UncertaintyAnalyzer()
    for kind in CHANNELS:
        u = np.asarray(pred[kind]).mean(axis=1)
        ua = analyzer.analyze(mu, y, np.asarray(pred[kind]))
        out[kind] = {"r": pearson_np(err, u), "ause": ua["ause"]}
    out["ccc_average"] = float(np.mean([ccc_np(y[:, i], mu[:, i])
                                        for i in range(y.shape[1])]))
    return out


def grid(name: str) -> list[tuple]:
    """(evidence weight, KL weight, calibration weight, loss variant) of
    each run: under v2 the first two scale reg_weight (0.1×) and
    kl_weight_v2 (0.1×)."""
    if name == "small":
        return [(1.0, 0.1, 0.05, "v2")]
    return list(itertools.product((0.5, 1.0, 3.0, 10.0), (0.1, 1.0), (0.05,),
                                  ("v2",)))


def main(argv=None) -> int:
    p = twin.parser(__doc__, "uncertainty_sweep")
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--n_train", type=int, default=16000)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--grid", default="full", choices=["full", "small"])
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "uncertainty_sweep")
    if args.quick:
        args.n_train, args.epochs, args.batch_size, args.grid = 2048, 2, 256, "small"

    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.models.deer_model import DEERModelConfig

    dtype = twin.compute_dtype(device)
    splits = make_synthetic_splits(SyntheticConfig(
        n_train=args.n_train, n_val=args.n_train // 8, n_test=args.n_train // 8))
    model_config = DEERModelConfig(compute_dtype=dtype)

    results = []
    t0 = time.time()
    for ew, kw, cw, variant in grid(args.grid):
        res = run_one(splits, model_config, args, ew, kw, cw, variant,
                      device=device)
        res["config"] = {"evidence_weight": ew, "kl_weight": kw,
                         "calibration_alignment_weight": cw, "variant": variant}
        results.append(res)
        print(json.dumps({"config": res["config"],
                          "ccc": round(res["ccc_average"], 3),
                          "total_r": round(res["uncertainty"]["r"], 3),
                          "aleatoric_r": round(res["aleatoric"]["r"], 3)}),
              file=sys.stderr, flush=True)

    payload = {"platform": platform, "elapsed_s": time.time() - t0,
               "runs": results}
    ref = {(r["config"]["evidence_weight"], r["config"]["kl_weight"]): r
           for r in (twin.reference("uncertainty_sweep") or {}).get("runs", [])}
    md = [
        "# Uncertainty-quality sweep — the port on the card",
        "",
        f"- platform: **{platform}**, {dtype} compute, {args.n_train} train "
        f"samples, {args.epochs} epochs per run"
        f"{', fused' if device.type == 'cuda' else ''}, "
        f"{payload['elapsed_s']:.0f}s total",
        "- r = Pearson(per-sample mean |error|, mean uncertainty); AUSE on "
        "the same pairs. 'aleatoric' ranks by β/(α−1) only.",
        "- ref = the reference's committed run (`experiments/"
        "RESULTS_uncertainty_sweep.json`: 16,384 rows × 40 epochs on its "
        f"TPU); a CCC gap beyond {twin.CCC_GAP} is marked **(gap)**",
        "",
        "| evidence_w | kl_w | CCC | ref CCC | gap | r(total) | ref r(total) "
        "| r(aleatoric) | ref r(aleatoric) | AUSE(total) | AUSE(aleatoric) |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        c = r["config"]
        rr = ref.get((c["evidence_weight"], c["kl_weight"]))
        cell = lambda v: "—" if v is None else f"{v:.3f}"
        md.append(
            f"| {c['evidence_weight']} | {c['kl_weight']} "
            f"| {r['ccc_average']:.3f} | {cell(rr and rr['ccc_average'])} "
            f"| {twin.gap(r['ccc_average'], rr and rr['ccc_average'])} "
            f"| {r['uncertainty']['r']:.3f} "
            f"| {cell(rr and rr['uncertainty']['r'])} "
            f"| {r['aleatoric']['r']:.3f} | {cell(rr and rr['aleatoric']['r'])} "
            f"| {r['uncertainty']['ause']:.3f} | {r['aleatoric']['ause']:.3f} |")
    md += ["", "Reproduce: `python -m tpu_deer_torch.experiments.uncertainty_sweep "
           "--n_train 16384 --epochs 40` on the card (`--quick --platform cpu` "
           "for a CPU smoke)."]
    twin.write(args.out, md, payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
