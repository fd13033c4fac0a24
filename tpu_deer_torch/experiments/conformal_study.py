"""Split-conformal intervals on the headline run's saved predictions,
through the port.

    python -m tpu_deer_torch.experiments.conformal_study
    python -m tpu_deer_torch.experiments.conformal_study --platform cpu \\
        --predictions experiments/RESULTS_synthetic_predictions.npz

Twin of `experiments/conformal_study.py`, with its split, levels, variants
and rows: the test-set predictions saved by the headline twin
(`--predictions`, default `results_torch/RESULTS_synthetic_h100_predictions.npz`,
git-ignored: the headline twin writes it), split 50/50 into calibration
and evaluation halves by `default_rng(0)`; per α in 0.32, 0.10, 0.05 and
0.01, `eval/conformal.py:ConformalCalibrator` with absolute scores and with
scores normalized by the raw, the calibrated and the E|y − μ| uncertainty;
coverage and mean width per dimension. The same table is written for the
reference's committed predictions (`experiments/RESULTS_synthetic_predictions.npz`,
its TPU run), which reproduces `experiments/RESULTS_conformal.json`.

Host work (numpy), run as the other twins are: `--platform cuda` (the
default) raises without a card; results go to
`results_torch/RESULTS_conformal_h100.{json,md}`.
"""

from __future__ import annotations

import os

import numpy as np

from tpu_deer_torch.experiments import twin

ALPHAS = (0.32, 0.10, 0.05, 0.01)
REFERENCE_NPZ = os.path.join(twin.ROOT, "experiments",
                             "RESULTS_synthetic_predictions.npz")


def conformal_rows(npz_path: str) -> list[dict]:
    """The reference's rows for one predictions file: per α, the absolute
    variant and one normalized variant a scale (raw, calibrated, eabs where
    saved)."""
    from tpu_deer_torch.eval.conformal import ConformalCalibrator

    d = np.load(npz_path)
    mu, labels = d["mu"].astype(np.float64), d["labels"].astype(np.float64)
    sigmas = {
        "raw": np.sqrt(np.maximum(d["uncertainty"].astype(np.float64), 1e-12)),
        "calibrated": np.sqrt(np.maximum(
            d["calibrated_uncertainty"].astype(np.float64), 1e-12)),
    }
    if "eabs" in d.files:
        # E|y - mu| is already in |error| units: the score's normalizer as is.
        sigmas["eabs"] = np.maximum(d["eabs"].astype(np.float64), 1e-12)

    perm = np.random.default_rng(0).permutation(mu.shape[0])
    cal, tst = perm[: mu.shape[0] // 2], perm[mu.shape[0] // 2:]
    rows = []
    for alpha in ALPHAS:
        for name, sig in [("absolute", None)] + [
                (f"normalized/{n}", s) for n, s in sigmas.items()]:
            c = ConformalCalibrator(alpha=alpha, normalized=sig is not None)
            c.fit(mu[cal], None if sig is None else sig[cal], labels[cal])
            rows.append({"variant": name, **c.report(
                mu[tst], None if sig is None else sig[tst], labels[tst])})
    return rows


def table(rows: list[dict]) -> list[str]:
    md = ["| nominal | variant | coverage (V/A/D) | mean width (V/A/D) |",
          "|---|---|---|---|"]
    for r in rows:
        cov = "/".join(f"{c:.3f}" for c in r["empirical_coverage"])
        wid = "/".join(f"{w:.3f}" for w in r["mean_width"])
        md.append(f"| {r['nominal_coverage']:.2f} | {r['variant']} | {cov} | "
                  f"{wid} |")
    return md


def saving_at_90(rows: list[dict]) -> float:
    """How much shorter normalized/raw intervals are than absolute ones at
    0.90 nominal, on average over the dimensions."""
    pick = lambda v: next(r for r in rows if r["nominal_coverage"] == 0.90
                          and r["variant"] == v)
    return 1.0 - (float(np.mean(pick("normalized/raw")["mean_width"]))
                  / float(np.mean(pick("absolute")["mean_width"])))


def main(argv=None) -> int:
    p = twin.parser(__doc__, "conformal")
    p.add_argument("--predictions", default=os.path.join(
        twin.ROOT, "results_torch", "RESULTS_synthetic_h100_predictions.npz"))
    args = p.parse_args(argv)
    _, platform = twin.setup(args, "conformal")
    if not os.path.exists(args.predictions):
        print(f"{args.predictions} missing — regenerate it with `python -m "
              "tpu_deer_torch.experiments.synthetic_headline` on the card")
        return 1
    rows = conformal_rows(args.predictions)
    ref_rows = conformal_rows(REFERENCE_NPZ)
    n = len(np.load(args.predictions)["mu"])
    cover = lambda rs: min(min(r["empirical_coverage"]) - r["nominal_coverage"]
                           for r in rs)
    md = [
        "# Conformal prediction intervals — the port's headline predictions",
        "",
        f"- split conformal on the headline twin's test predictions "
        f"(`{os.path.basename(args.predictions)}`, {n:,} samples), 50/50 "
        "calibration/evaluation, seed 0; coverage per dimension [valence, "
        "arousal, dominance], width the mean interval length; normalized "
        "variants scale the scores by the NIG total-uncertainty sigma (raw "
        "or calibrated) or by E|y − μ|",
        f"- host: {platform}",
        "",
        "## The port's predictions",
        "",
        *table(rows),
        "",
        f"At 0.90 nominal, normalized/raw intervals are "
        f"{saving_at_90(rows):.0%} shorter than constant-width ones; the "
        f"lowest coverage minus its nominal level is {cover(rows):+.4f}.",
        "",
        "## The reference's committed predictions "
        "(`experiments/RESULTS_synthetic_predictions.npz`, its TPU run)",
        "",
        *table(ref_rows),
        "",
        f"At 0.90 nominal: {saving_at_90(ref_rows):.0%} shorter; lowest "
        f"coverage minus nominal {cover(ref_rows):+.4f}. These rows are "
        "`experiments/RESULTS_conformal.json`'s.",
        "",
        "Reproduce: `python -m tpu_deer_torch.experiments.conformal_study` "
        "after the headline twin's run (host only, seconds).",
    ]
    twin.write(args.out, md, {"platform": platform,
                              "predictions": os.path.basename(args.predictions),
                              "rows": rows, "reference_rows": ref_rows})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
