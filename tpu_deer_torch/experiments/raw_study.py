"""Raw-media study: the three corpus layouts end to end, alone and jointly,
through the port.

    python -m tpu_deer_torch.experiments.raw_study
    python -m tpu_deer_torch.experiments.raw_study --quick --platform cpu

Twin of `experiments/raw_study.py`, with its fixtures, seeds and sizes:
generated corpora in the IEMOCAP (768/96/96 utterances, seed 11), RAVDESS
(42 utterances an actor, seed 12) and MELD (768/96/96, seed 13) layouts,
each loaded on its own vocabulary and trained with RawSequenceDEERModel
(encoder 128, fusion 256, 4 heads, dropout 0.1, init seed 0) for 60 epochs
at batch 64, lr 2e-3, the audio front-end (kernel K1) inside every step;
then the three loaded under one merged vocabulary and trained jointly, with
the joint model's test CCC per corpus. Each row reports the best val CCC,
the test CCC per dimension and the MAE, and K1's launches. Differences:
float32 with TF32 off on the card where the reference ran on its TPU.
Results: results_torch/RESULTS_raw_h100.{json,md}, beside the reference's
experiments/RESULTS_raw.json.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from tpu_deer_torch.experiments import twin


def main(argv=None) -> int:
    p = twin.parser(__doc__, "raw")
    p.add_argument("--epochs", type=int, default=None)
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "raw")
    epochs = args.epochs or (8 if args.quick else 60)

    from tpu_deer_torch.core import metrics as M
    from tpu_deer_torch.data import raw_corpus as rc
    from tpu_deer_torch.kernels import mfcc_signal as k1
    from tpu_deer_torch.models.hierarchical_deer import create_raw_sequence_model
    from tpu_deer_torch.ops.audio_frontend import AudioFrontendConfig
    from tpu_deer_torch.train.raw_trainer import RawSequenceTrainer, RawTrainingConfig

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tdir:
        if args.quick:
            sizes = {"iemocap": (48, 16, 16), "meld": (48, 16, 16)}
            per_actor = 3
        else:
            sizes = {"iemocap": (768, 96, 96), "meld": (768, 96, 96)}
            per_actor = 42
        roots = {
            "iemocap": rc.generate_raw_fixture(
                os.path.join(tdir, "iem"), *sizes["iemocap"], seed=11),
            "ravdess": rc.generate_raw_fixture_ravdess(
                os.path.join(tdir, "rav"), n_per_actor=per_actor, seed=12),
            "meld": rc.generate_raw_fixture_meld(
                os.path.join(tdir, "meld"), *sizes["meld"], seed=13),
        }
        loaders = {"iemocap": rc.load_raw_corpus,
                   "ravdess": rc.load_raw_ravdess, "meld": rc.load_raw_meld}
        fcfg = AudioFrontendConfig()

        def train_and_eval(splits, vocab_size, tag):
            tr, te = splits["train"], splits.get("test") or splits["val"]
            model = create_raw_sequence_model(
                seed=0, device=device,
                encoder_dim=64 if args.quick else 128,
                fusion_dim=128 if args.quick else 256,
                vocab_size=vocab_size, num_heads=4, dropout=0.1)
            trainer = RawSequenceTrainer(
                model, RawTrainingConfig(learning_rate=2e-3,
                                         batch_size=32 if args.quick else 64,
                                         num_epochs=epochs),
                frontend_config=fcfg, device=device)
            before = k1.mfcc_signal.launches
            t = time.time()
            res = trainer.train(tr, splits.get("val"))
            pred = trainer.predict(te)
            y = te["labels"]
            ccc = [float(M.ccc_np(y[:, d], pred["mu"][:, d])) for d in range(3)]
            row = {"corpus": tag, "n_train": int(len(tr["labels"])),
                   "best_val_ccc": float(res["best_val_ccc"]),
                   "test_ccc": ccc, "test_ccc_avg": float(np.mean(ccc)),
                   "test_mae": float(np.abs(pred["mu"] - y).mean()),
                   "k1_launches": k1.mfcc_signal.launches - before,
                   "train_s": time.time() - t}
            print(f"{tag:>24}: test CCC {row['test_ccc_avg']:.3f} (V/A/D "
                  f"{ccc[0]:.3f}/{ccc[1]:.3f}/{ccc[2]:.3f}) MAE "
                  f"{row['test_mae']:.3f} [{row['n_train']} train, K1 "
                  f"launches {row['k1_launches']}, {row['train_s']:.1f} s]",
                  flush=True)
            return pred, row

        rows = []
        for tag, loader in loaders.items():
            splits, vocab = loader(roots[tag])
            rows.append(train_and_eval(splits, vocab.vocab_size, tag)[1])
        shared = rc.merge_vocabs([loaders[t](roots[t])[1] for t in sorted(loaders)])
        corpora = {t: loaders[t](roots[t], vocab=shared)[0] for t in loaders}
        joint = rc.combine_raw_splits(corpora)
        pred, row = train_and_eval(joint, shared.vocab_size, "joint (all three)")
        te = joint["test"]
        row["joint_per_corpus_ccc"] = {
            nm: float(np.mean([M.ccc_np(te["labels"][te["dataset_id"] == i][:, d],
                                        pred["mu"][te["dataset_id"] == i][:, d])
                               for d in range(3)]))
            for i, nm in enumerate(sorted(corpora))}
        rows.append(row)
    elapsed = time.time() - t0

    ref = {r["corpus"]: r for r in (twin.reference("raw") or {}).get("rows", [])}
    md = [
        "# Raw-media runs, all three corpus layouts — the port on the card",
        "",
        f"- platform: **{platform}**, float32 (TF32 off), {epochs} epochs a "
        f"run, K1 (the audio front-end) inside every step, {elapsed:.0f}s "
        "total",
        "- the reference's run (`experiments/RESULTS_raw.json`, on its TPU) "
        f"beside each row; a test-CCC gap beyond {twin.CCC_GAP} is marked "
        "**(gap)**",
        "",
        "| corpus | run | n train | best val CCC | test CCC avg | V / A / D | "
        "test MAE | K1 launches | train s | CCC gap |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        rr = ref.get(r["corpus"])
        v, a, d = r["test_ccc"]
        md.append(f"| {r['corpus']} | this run | {r['n_train']} | "
                  f"{r['best_val_ccc']:.3f} | **{r['test_ccc_avg']:.3f}** | "
                  f"{v:.3f} / {a:.3f} / {d:.3f} | {r['test_mae']:.3f} | "
                  f"{r['k1_launches']} | {r['train_s']:.1f} | "
                  f"{twin.gap(r['test_ccc_avg'], rr and rr['test_ccc_avg'])} |")
        if rr:
            v, a, d = rr["test_ccc"]
            md.append(f"| {r['corpus']} | reference | {rr['n_train']} | "
                      f"{rr['best_val_ccc']:.3f} | {rr['test_ccc_avg']:.3f} | "
                      f"{v:.3f} / {a:.3f} / {d:.3f} | {rr['test_mae']:.3f} | | | |")
    joint_ref = ref.get("joint (all three)", {}).get("joint_per_corpus_ccc", {})
    md += ["", "Joint model's test CCC per corpus: " + ", ".join(
        f"{k} {v:.3f}" + (f" (reference {joint_ref[k]:.3f})" if k in joint_ref else "")
        for k, v in rows[-1]["joint_per_corpus_ccc"].items()),
        "", "Reproduce: `python -m tpu_deer_torch.experiments.raw_study` on the "
            "card (`--quick --platform cpu` for a CPU smoke)."]
    twin.write(args.out, md, {"rows": rows, "platform": platform,
                              "elapsed_s": elapsed, "args": vars(args)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
