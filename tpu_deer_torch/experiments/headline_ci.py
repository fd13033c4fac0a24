"""Headline replications aggregated into intervals, through the port.

    python -m tpu_deer_torch.experiments.headline_ci
    python -m tpu_deer_torch.experiments.headline_ci --dir experiments \\
        --pattern 'RESULTS_synthetic*.json' --out /tmp/headline_ci

Twin of `experiments/headline_ci.py`, with its runs, keys and table: it
reads the headline twin's runs (`--dir` results_torch, `--pattern`
RESULTS_synthetic_h100*.json: seed 0 and each `--seed K` run of
`python -m tpu_deer_torch.experiments.synthetic_headline --seed K`), and
writes mean ± std and 95% t-intervals of CCC, MAE, calibrated ECE, raw
E|y − μ| ECE and the uncertainty-error r over them, beside the
reference's intervals (`experiments/RESULTS_headline_ci.json`), a gap of
a mean beyond 0.02 flagged. Pointed at the reference's own files
(`--dir experiments --pattern 'RESULTS_synthetic*.json'`) it reproduces
the reference's aggregate.

Host work only, but run as the other twins are: `--platform cuda` (the
default) raises without a card; results go to
`results_torch/RESULTS_headline_ci_h100.{json,md}`.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from tpu_deer_torch.experiments import twin
from tpu_deer_torch.experiments.seed_study import aggregate

KEYS = ("ccc_avg", "mae_avg", "ece_calibrated", "ece_raw_eabs", "unc_err_r")
LABELS = (
    ("ccc_avg", "CCC average"),
    ("mae_avg", "MAE average"),
    ("ece_calibrated", "ECE (calibrated channel)"),
    ("ece_raw_eabs", "ECE (raw closed-form E|err| channel)"),
    ("unc_err_r", "uncertainty-error r"),
)


def load_runs(paths: list[str]) -> list[dict]:
    """The reference's per-run summary of each headline result file."""
    runs = []
    for p in sorted(paths):
        with open(p) as f:
            d = json.load(f)
        runs.append({
            "seed": d.get("seed", 0),
            "source": os.path.basename(p),
            "ccc_avg": float(np.mean(list(d["test"]["ccc"].values()))),
            "mae_avg": float(np.mean(list(d["test"]["mae"].values()))),
            "ece_calibrated": d["ece_calibrated"],
            "ece_raw_eabs": d["ece_raw_eabs"],
            "unc_err_r": d["uncertainty"]["uncertainty_error_correlation"],
            "train_time_s": d["train_time_s"],
            "platform": d.get("platform"),
        })
    return runs


def main(argv=None) -> int:
    p = twin.parser(__doc__, "headline_ci")
    p.add_argument("--dir", default=os.path.join(twin.ROOT, "results_torch"))
    p.add_argument("--pattern", default="RESULTS_synthetic_h100*.json")
    args = p.parse_args(argv)
    twin.setup(args, "headline_ci")
    paths = [q for q in glob.glob(os.path.join(args.dir, args.pattern))
             if not q.endswith("_quick.json")]
    runs = load_runs(paths)
    if len(runs) < 2:
        print(f"only {len(runs)} run(s) found in {args.dir} — run "
              "synthetic_headline --seed 1..K first")
        return 1
    agg = aggregate(runs, KEYS)
    payload = {"n_seeds": len(runs), "runs": runs, "aggregate": agg}

    ref = (twin.reference("headline_ci") or {}).get("aggregate", {})
    platforms = sorted({r["platform"] for r in runs if r["platform"]})
    md = [
        "# Headline-claim replication CI — the port",
        "",
        f"- {len(runs)} replications of the full headline recipe (1M "
        "samples, 100 fused epochs, kl 0.01 — "
        "`tpu_deer_torch/experiments/synthetic_headline.py`), a fresh data "
        "draw and init a seed (`--seed K`); runs on "
        + (", ".join(f"**{p}**" for p in platforms) or "no named platform"),
        "- the reference's three TPU seeds "
        "(`experiments/RESULTS_headline_ci.json`) beside each row; a mean "
        f"gap beyond {twin.CCC_GAP} is marked **(gap)**",
        "",
        "| metric | per-seed | mean ± std | 95% CI | reference 95% CI | "
        "inside the reference's CI | gap |",
        "|---|---|---|---|---|---|---|",
    ]
    for key, label in LABELS:
        a, r = agg[key], ref.get(key)
        per = " / ".join(f"{run[key]:.3f}" for run in runs)
        inside = ("—" if not r else
                  "yes" if r["ci95"][0] <= a["mean"] <= r["ci95"][1] else "no")
        md.append(
            f"| {label} | {per} | {a['mean']:.3f} ± {a['std']:.3f} | "
            f"[{a['ci95'][0]:.3f}, {a['ci95'][1]:.3f}] | "
            + (f"[{r['ci95'][0]:.3f}, {r['ci95'][1]:.3f}]" if r else "—")
            + f" | {inside} | {twin.gap(a['mean'], r and r['mean'])} |")
    md += [
        "",
        "Per-run JSONs: " + ", ".join(f"`{r['source']}`" for r in runs) + ".",
        "",
        "Reproduce: `python -m tpu_deer_torch.experiments.synthetic_headline "
        "--seed K` per seed on the card, then `python -m "
        "tpu_deer_torch.experiments.headline_ci` (host only).",
    ]
    twin.write(args.out, md, payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
