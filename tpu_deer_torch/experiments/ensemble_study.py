"""Deep ensemble vs MC dropout vs one evidential model, through the port.

    python -m tpu_deer_torch.experiments.ensemble_study
    python -m tpu_deer_torch.experiments.ensemble_study --quick --platform cpu

Twin of `experiments/ensemble_study.py`, with its flags, defaults, seeds
and rows: the flagship (3,918,324 params) on `benchmark_v2` (131,072 train
and 8,192 validation and test rows), 30 epochs, batch 2,048, dropout 0.1,
lr 2e-3 cosine with 2 warm-up epochs, validation every 6 epochs and no
early stop. Rows: the single model (init seed 0, trainer seed 0); the same
model with MC dropout (S = 8); a K = 4 deep ensemble (`train/ensemble.py`,
init seed 1, trainer seed 1) with each member's CCC; for each, CCC,
uncertainty-error correlation, AUSE, calibrated ECE (a post-hoc scale fit
on validation) and the AUROC of the mean epistemic uncertainty on four
distribution shifts of the test set (`make_probes`); the ensemble's AUROC
without the cross-member disagreement; and the data ceiling, a Monte-Carlo
oracle from the generative model.

Differences from the reference: the model computes in float32 with TF32
off (the reference ran bfloat16 on its TPU), trains with fused epochs (a
CUDA graph of the train step) on the card, and `--platform` picks the card
(`cuda`, the default; it raises without one) or the CPU. Results go to
`results_torch/RESULTS_ensemble_h100.{json,md}` (`--quick`:
`..._quick`), the Markdown table beside the reference's
(`experiments/RESULTS_ensemble.json`, one TPU run with no interval).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

DEFAULT_OUT = "results_torch/RESULTS_ensemble_h100"
REFERENCE = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                         "experiments", "RESULTS_ensemble.json")


def auroc(neg: np.ndarray, pos: np.ndarray) -> float:
    """Rank-based AUROC (Mann-Whitney U) with midranks for ties:
    P(score(pos) > score(neg))."""
    scores = np.concatenate([neg, pos])
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    n_pos, n_neg = len(pos), len(neg)
    r_pos = ranks[n_neg:].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def make_probes(test: dict, rng: np.random.Generator) -> dict:
    """The reference's four shifts of the test features: every feature
    column permuted on its own ("shuffled"), +2.0 ("shifted"), video and
    text from other rows ("misaligned"), and ×2.5, a negative control that
    the encoders' Dense → ReLU → LayerNorm input stack normalizes away
    ("scaled (control)")."""
    shuffled = dict(test)
    for k in ("audio", "video", "text"):
        cols = test[k].copy()
        for c in range(cols.shape[1]):
            cols[:, c] = cols[rng.permutation(len(cols)), c]
        shuffled[k] = cols
    scaled, shifted = dict(test), dict(test)
    for k in ("audio", "video", "text"):
        scaled[k] = (test[k] * 2.5).astype(np.float32)
        shifted[k] = (test[k] + 2.0).astype(np.float32)
    misaligned = dict(test)
    misaligned["video"] = test["video"][rng.permutation(len(test["video"]))]
    misaligned["text"] = test["text"][rng.permutation(len(test["text"]))]
    return {"shuffled": shuffled, "shifted": shifted, "misaligned": misaligned,
            "scaled (control)": scaled}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--n_train", type=int, default=131072)
    p.add_argument("--n_eval", type=int, default=8192)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--members", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    from tpu_deer_torch.core import metrics as M
    from tpu_deer_torch.data.pipeline import ArrayDataset
    from tpu_deer_torch.data.synthetic import benchmark_v2, make_synthetic_splits
    from tpu_deer_torch.device import resolve_device
    from tpu_deer_torch.eval.calibration import fit_uncertainty_scale
    from tpu_deer_torch.eval.uncertainty import sparsification_curve
    from tpu_deer_torch.experiments.synthetic_headline import card_name
    from tpu_deer_torch.models.deer_model import (
        CompleteDEERModel,
        DEERModelConfig,
        create_complete_deer_model,
    )
    from tpu_deer_torch.train.ensemble import EnsembleTrainer, create_deer_ensemble
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

    if args.quick:
        args.n_train, args.n_eval = 2048, 1024
        args.epochs, args.members = 6, 3
        args.batch_size = min(args.batch_size, 512)
        if args.out == DEFAULT_OUT:
            args.out += "_quick"
    device = resolve_device(args.platform)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    platform = card_name(device)
    mcfg = DEERModelConfig(dropout=args.dropout)

    splits = make_synthetic_splits(benchmark_v2(
        n_train=args.n_train, n_val=args.n_eval, n_test=args.n_eval))
    train = {"synthetic": ArrayDataset(splits["train"], "synthetic")}
    val_ds = ArrayDataset(splits["val"], "synthetic")
    val = {"synthetic": val_ds}
    test = splits["test"]
    test_ds = ArrayDataset(test, "synthetic")

    # The data ceiling: mu* = E[y|x] and unc* = E[|y - mu*| | x], Monte
    # Carlo'd from the known signal and noise scale.
    o_rng = np.random.default_rng(7)
    sig, ns = test["signal"], test["noise_scale"][:, None]
    draws = np.tanh(sig[None] + ns[None] * o_rng.standard_normal(
        (256, *sig.shape))).astype(np.float32)
    mu_star = draws.mean(axis=0)
    unc_star = np.abs(draws - mu_star[None]).mean(axis=0).mean(axis=1)
    err_star = np.abs(test["labels"] - mu_star).mean(axis=1)
    ceiling = {
        "ccc": float(np.mean([M.ccc_np(test["labels"][:, d], mu_star[:, d])
                              for d in range(3)])),
        "r": float(np.corrcoef(unc_star, err_star)[0, 1]),
        "ause": float(sparsification_curve(err_star, unc_star)["ause"]),
    }
    del draws

    rng = np.random.default_rng(123)
    ood_sets = {name: ArrayDataset(arrays, f"ood_{name.split()[0]}")
                for name, arrays in make_probes(test, rng).items()}

    def tcfg(seed):
        return TrainingConfig(
            learning_rate=2e-3, batch_size=args.batch_size,
            num_epochs=args.epochs, warmup_epochs=2, scheduler="cosine",
            val_frequency=max(1, args.epochs // 5),
            early_stopping_patience=10**9, seed=seed, fused_epochs=True)

    steps = max(1, args.n_train // args.batch_size)

    def id_metrics(predict, name):
        out = predict(test_ds)
        y = test["labels"]
        ccc = float(np.mean([M.ccc_np(y[:, d], out["mu"][:, d]) for d in range(3)]))
        err = np.abs(out["mu"] - y).mean(axis=1)
        unc = out["uncertainty"].mean(axis=1)
        val_out = predict(val_ds)
        scale = fit_uncertainty_scale(val_out["mu"], val_ds.arrays["labels"],
                                      val_out["calibrated_uncertainty"])
        return out, {
            "name": name, "ccc_avg": ccc,
            "unc_err_corr": float(np.corrcoef(unc, err)[0, 1]),
            "ause": float(sparsification_curve(err, unc)["ause"]),
            "ece_calibrated": float(M.ece_np(
                out["mu"], y, scale * out["calibrated_uncertainty"])),
        }

    def ood_auroc(predict, test_out):
        clean = test_out["epistemic"].mean(axis=1)
        return {o: auroc(clean, predict(ds)["epistemic"].mean(axis=1))
                for o, ds in ood_sets.items()}

    t0 = time.time()
    # --- the single flagship ------------------------------------------------
    s_tr = DEERTrainer(create_complete_deer_model(mcfg, seed=0, device=device),
                       tcfg(0), steps_per_epoch=steps, device=device)
    t_train = time.time()
    s_tr.train(train, val)
    single_train_s = time.time() - t_train
    s_out, s_row = id_metrics(s_tr.predict, "single evidential model")
    s_row["ood_auroc"] = ood_auroc(s_tr.predict, s_out)

    # --- the same trained model with MC dropout -------------------------------
    mc_samples = 8
    mc_predict = lambda ds: s_tr.predict_mc_dropout(ds, n_samples=mc_samples)
    m_out, m_row = id_metrics(mc_predict, f"single + MC dropout (S={mc_samples})")
    m_row["ood_auroc"] = ood_auroc(mc_predict, m_out)

    # --- the K-member deep ensemble --------------------------------------------
    emodel, stacked = create_deer_ensemble(mcfg, n_members=args.members, seed=1,
                                           device=device)
    e_tr = EnsembleTrainer(emodel, stacked, tcfg(1), steps_per_epoch=steps,
                           device=device)
    t_train = time.time()
    e_tr.train(train, val)
    ensemble_train_s = time.time() - t_train
    _, e_row = id_metrics(e_tr.predict, f"deep ensemble (K={args.members})")

    # Per member: CCC spread and the disagreement isolation, through one
    # single-model trainer whose weights are swapped per member.
    member_ccc, member_epi, member_mu = [], {}, {}
    m_tr = DEERTrainer(CompleteDEERModel(mcfg), tcfg(1), steps_per_epoch=steps,
                       device=device)
    for k in range(args.members):
        m_tr.model.load_state_dict(e_tr.member_params(k))
        for split, ds in (("test", test_ds), *ood_sets.items()):
            out = m_tr.predict(ds)
            member_epi.setdefault(split, []).append(out["epistemic"])
            member_mu.setdefault(split, []).append(out["mu"])
        member_ccc.append(float(np.mean([
            M.ccc_np(test["labels"][:, d], member_mu["test"][-1][:, d])
            for d in range(3)])))

    def combined_epi(split, with_disagreement):
        epi = np.mean(member_epi[split], axis=0)
        if with_disagreement:
            epi = epi + np.var(member_mu[split], axis=0)
        return epi.mean(axis=1)

    e_row["member_ccc"] = member_ccc
    e_row["ood_auroc"] = {o: auroc(combined_epi("test", True), combined_epi(o, True))
                          for o in ood_sets}
    e_row["ood_auroc_no_disagreement"] = {
        o: auroc(combined_epi("test", False), combined_epi(o, False))
        for o in ood_sets}
    elapsed = time.time() - t0

    rows = [s_row, m_row, e_row]
    reference = None
    if os.path.exists(REFERENCE):
        with open(REFERENCE) as f:
            reference = json.load(f)
    md = [
        "# Deep ensemble vs MC dropout vs single evidential model — the "
        "port on the card",
        "",
        f"- platform: **{platform}**, float32 (TF32 off), {args.n_train} "
        f"train samples, {args.epochs} epochs, batch {args.batch_size}, "
        f"dropout {args.dropout}, K={args.members} members (one vmapped "
        f"step, fused epochs), {elapsed:.0f}s total (training: single "
        f"{single_train_s:.0f}s, ensemble {ensemble_train_s:.0f}s)",
        "- benchmark v2 (`data/synthetic.py:benchmark_v2`); OOD AUROC scores "
        "the mean epistemic uncertainty against the clean test set; "
        "'scaled (control)' is a negative control (~0.5 expected)",
        f"- **data ceiling** (MC oracle from the generative model): CCC "
        f"{ceiling['ccc']:.3f}, unc-err corr {ceiling['r']:.3f}, AUSE "
        f"{ceiling['ause']:.3f}",
        f"- member CCCs: {', '.join(f'{c:.3f}' for c in member_ccc)} -> "
        f"ensemble {e_row['ccc_avg']:.3f} (moment-matched combination)",
        "",
        "| model | run | CCC avg | unc-err corr | AUSE | ECE (cal.) | "
        + " | ".join(f"OOD {o}" for o in ood_sets) + " |",
        "|---|---|---|---|---|---|" + "---|" * len(ood_sets),
    ]
    for i, r in enumerate(rows):
        others = [("this run", r)]
        if reference is not None and i < len(reference["rows"]):
            others.append(("reference (TPU, bf16)", reference["rows"][i]))
        for label, row in others:
            md.append(
                f"| {r['name']} | {label} | {row['ccc_avg']:.3f} | "
                f"{row['unc_err_corr']:.3f} | {row['ause']:.3f} | "
                f"{row['ece_calibrated']:.3f} | "
                + " | ".join(f"{row['ood_auroc'][o]:.3f}" for o in ood_sets)
                + " |")
    nd = e_row["ood_auroc_no_disagreement"]
    md += [
        "",
        "Disagreement isolation (ensemble epistemic WITHOUT the cross-member "
        "disagreement term): " + ", ".join(f"{o} {nd[o]:.3f}" for o in ood_sets),
        "",
        "Reproduce: `python -m tpu_deer_torch.experiments.ensemble_study` on "
        "the card (`--quick --platform cpu` for a CPU smoke).",
    ]
    text = "\n".join(md) + "\n"
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out + ".md", "w") as f:
        f.write(text)
    with open(args.out + ".json", "w") as f:
        json.dump({"rows": rows, "ceiling": ceiling, "platform": platform,
                   "elapsed_s": elapsed, "single_train_s": single_train_s,
                   "ensemble_train_s": ensemble_train_s, "args": vars(args)},
                  f, indent=1)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
