"""Command-line pipeline on the card: full / train / evaluate / test modes.

Port of `tpu_deer/cli.py`:

    python -m tpu_deer_torch.cli --mode full --quick
    python -m tpu_deer_torch.cli --mode train --config configs/config.yaml
    python -m tpu_deer_torch.cli --mode evaluate --model_path <models dir>
    python -m tpu_deer_torch.cli --mode export --model_path <models dir> [--int8]
    python -m tpu_deer_torch.cli --mode visualize --model_path <models dir>
    python -m tpu_deer_torch.cli --mode full --quick --ensemble 4
    python -m tpu_deer_torch.cli --mode full --quick --platform cpu

`--platform auto` (the default) and `cuda` run on the CUDA card and raise
without one; `cpu` runs on the CPU. Width comes from the config, as in the
reference: `--mode full --quick` trains the flagship (3,918,324 params) on
the 512/128/128-row synthetic fixture, batch 32, 8 epochs. `--recipe
uncertainty` is the headline recipe (batch 4,096, 100 epochs), trained with
fused epochs, a CUDA graph of the train step on the card; `--quick` turns
them off, as in the reference.

`--mode export` writes `<output_dir>/exported_model`
(`tpu_deer_torch.export`): the model of `--model_path`'s best checkpoint
(its latest where there is no best) with the serving channel it recorded,
in int8 with `--int8`, with an OOD score with `--ood_detector` (the
evaluate stage's `results/ood_detector.npz`) at `--ood_fpr`, for the
platform of `--platform`.

`--ensemble K` (or `training.ensemble_members`) trains a K-member deep
ensemble (`train/ensemble.py`) in every mode: one vmapped step, the
evaluation, conformal intervals and plots on the moment-matched combined
outputs, and `--mode export --ensemble K` an artifact of all K members.
`--mode visualize` and the last stage of `--mode full` write the plots
(`viz/report.py`) into `<experiment>/plots`: the static figures where
matplotlib is installed, else only the interactive HTML dashboard and the
JSON data export (the summary's `plots` records why).

Data: the corpora configured under `datasets.names`/`datasets.paths` that
exist on disk load through `data/registry.py` (IEMOCAP, RAVDESS and MELD,
every utterance's audio through K1 on the card, the MLM text bootstrap by
default); the backend that made each corpus's text features is recorded in
the artifacts. Where no configured path exists (the config's
`/path/to/...`), the pipeline takes the synthetic fixture with a warning,
as the reference does.

`--raw` (`run_raw_pipeline`) trains `RawSequenceDEERModel` end to end from
waveforms, frame arrays and transcripts, with K1 in the step, in the
layout of `--raw_dataset` (iemocap, ravdess or meld): the corpus at
`datasets.raw_root`, or a generated fixture in that layout, and writes
`results/raw_results.json`. The unused `--results_dir` is not taken.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from tpu_deer_torch.device import DeviceLike, resolve_device

logger = logging.getLogger("tpu_deer_torch.cli")

# Named training recipes applied over the base YAML (the reference's; a
# sibling file configs/uncertainty.yaml carries the same values). Order:
# YAML -> recipe -> --quick -> explicit flags.
RECIPES = {
    "uncertainty": {
        "model": {"dropout": 0.05},
        "training": {
            "learning_rate": 1.2e-3,
            "batch_size": 4096,
            "num_epochs": 100,
            "warmup_epochs": 5,
            "scheduler": "cosine",
            "kl_weight": 0.01,
            "calibration_alignment_weight": 0.15,
            "val_frequency": 10,
            "early_stopping_patience": 10**6,
            "fused_epochs": True,
        },
    },
}

PLATFORMS = {"auto": None, "cuda": "cuda", "cpu": "cpu"}


class MultimodalDEERPipeline:
    """Experiment orchestration: model, data, trainer, training, evaluation
    and the report, in one experiment directory."""

    def __init__(self, config_path: Optional[str] = None,
                 output_dir: str = "experiments",
                 experiment_name: Optional[str] = None,
                 overrides: Optional[dict] = None, quick: bool = False,
                 resume: bool = False, recipe: Optional[str] = None,
                 device: DeviceLike = None):
        from tpu_deer_torch.utils.config import load_yaml_config, save_yaml_config

        self.device = resolve_device(device)
        self.quick = quick
        self.resume = resume
        self.config = load_yaml_config(config_path)
        if recipe is not None:
            if recipe not in RECIPES:
                raise ValueError(
                    f"unknown recipe {recipe!r}; available: {sorted(RECIPES)}")
            for section, values in RECIPES[recipe].items():
                self.config.setdefault(section, {}).update(values)
            self.config["recipe"] = recipe
        if quick:
            # Small but learnable; undo a recipe's fused epochs and sparse
            # validation.
            self.config["training"].update(
                num_epochs=8, batch_size=32, learning_rate=3e-3,
                warmup_epochs=1, scheduler="constant", fused_epochs=False,
                val_frequency=1)
        for key, value in (overrides or {}).items():
            section, _, name = key.partition(".")
            if name:
                self.config[section][name] = value

        if experiment_name is None:
            experiment_name = time.strftime("experiment_%Y%m%d_%H%M%S")
        self.experiment_dir = os.path.join(output_dir, experiment_name)
        for sub in ("models", "plots", "logs", "results", "configs", "data"):
            os.makedirs(os.path.join(self.experiment_dir, sub), exist_ok=True)
        save_yaml_config(self.config,
                         os.path.join(self.experiment_dir, "configs", "config.yaml"))

        self.seed = int(self.config["training"].get("seed", 42))
        self.ensemble_members = int(
            self.config["training"].get("ensemble_members", 1))
        self.model = self.params = None
        self.trainer = None
        self.datasets = None

    def path(self, *parts) -> str:
        return os.path.join(self.experiment_dir, *parts)

    # -- components ------------------------------------------------------
    def create_model(self):
        from tpu_deer_torch.models.deer_model import (
            DEERModelConfig,
            count_parameters,
            create_complete_deer_model,
        )

        m = self.config["model"]
        self.model_config = DEERModelConfig(
            audio_dim=int(m["audio_dim"]),
            video_dim=int(m["video_dim"]),
            text_dim=int(m["text_dim"]),
            encoder_dim=int(m.get("encoder_dim", 256)),
            fusion_dim=int(m["fusion_dim"]),
            emotion_dims=int(m["emotion_dims"]),
            attention_heads=int(m["attention_heads"]),
            encoder_layers=int(m.get("encoder_layers", 3)),
            dropout=float(m["dropout"]),
            compute_dtype=self.config["hardware"].get("compute_dtype", "float32"),
            fusion_type=str(m.get("fusion_type", "hierarchical")),
            moe_experts=int(m.get("moe_experts", 4)),
            stacked_compute=bool(m.get("stacked_compute", False)),
        )
        if self.ensemble_members > 1:
            from tpu_deer_torch.train.ensemble import create_deer_ensemble

            self.model, self.params = create_deer_ensemble(
                self.model_config, n_members=self.ensemble_members,
                seed=self.seed, device=self.device)
            n_params = sum(v.numel() for v in self.params.values())
            logger.info(f"deep ensemble created: {self.ensemble_members} "
                        f"members, {n_params:,} total parameters "
                        f"({n_params // self.ensemble_members:,} per member)")
            return self.model
        self.model = create_complete_deer_model(self.model_config, seed=self.seed,
                                                device=self.device)
        logger.info(f"model created: {count_parameters(self.model):,} parameters")
        return self.model

    def create_datasets(self):
        """The configured corpora that exist on disk, through the registry;
        the synthetic fixture, with a warning, where none does."""
        from tpu_deer_torch.data.pipeline import ArrayDataset
        from tpu_deer_torch.data.registry import load_configured_datasets
        from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits

        loaded = load_configured_datasets(self.config, quick=self.quick,
                                          device=self.device)
        if loaded:
            self.text_backends = loaded.pop("meta", {}).get("text_backend", {})
            self.datasets = loaded
            logger.info(f"loaded real datasets: {list(loaded['train'])}")
            return self.datasets
        logger.warning("no real dataset paths found — using the synthetic "
                       "fixture (set datasets.paths in the config to train on "
                       "real data)")
        m = self.config["model"]
        n_train, n_val, n_test = (512, 128, 128) if self.quick else (1000, 200, 200)
        splits = make_synthetic_splits(SyntheticConfig(
            n_train=n_train, n_val=n_val, n_test=n_test,
            audio_dim=int(m["audio_dim"]), video_dim=int(m["video_dim"]),
            text_dim=int(m["text_dim"]), seed=self.seed))
        self.text_backends = {"synthetic": "precomputed-synthetic"}
        self.datasets = {split: {"synthetic": ArrayDataset(splits[split], "synthetic")}
                         for split in ("train", "val", "test")}
        return self.datasets

    def create_trainer(self):
        from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

        t = self.config["training"]
        weights = {k.lower(): float(v)
                   for k, v in self.config["datasets"].get("weights", {}).items()}
        self.training_config = TrainingConfig(
            learning_rate=float(t["learning_rate"]),
            weight_decay=float(t.get("weight_decay", 1e-5)),
            gradient_clip=float(t.get("gradient_clip", 1.0)),
            batch_size=int(t["batch_size"]),
            num_epochs=int(t["num_epochs"]),
            scheduler=t.get("scheduler", "cosine"),
            warmup_epochs=int(t.get("warmup_epochs", 5)),
            early_stopping_patience=int(t.get("early_stopping_patience", 10)),
            dataset_weights=weights or {"synthetic": 1.0},
            curriculum_learning=bool(t.get("curriculum_learning", True)),
            val_frequency=int(t.get("val_frequency", 1)),
            save_frequency=int(t.get("save_frequency", 10)),
            evidence_weight=float(t.get("evidence_weight", 1.0)),
            kl_weight=float(t.get("kl_weight", 0.1)),
            loss_variant=str(t.get("loss_variant", "v2")),
            calibration_alignment_weight=float(
                t.get("calibration_alignment_weight", 0.05)),
            fused_epochs=bool(t.get("fused_epochs", False)),
            aleatoric_moment_weight=float(t.get("aleatoric_moment_weight", 0.0)),
            grad_accum_steps=int(t.get("grad_accum_steps", 1)),
            param_sharding=t.get("param_sharding", "tp"),
            spike_backoff=bool(t.get("spike_backoff", True)),
            spike_rollback=bool(t.get("spike_rollback", True)),
            ema_decay=float(t.get("ema_decay", 0.0)),
            ema_eval=bool(t.get("ema_eval", False)),
            seed=self.seed,
        )
        steps = sum(len(d) // self.training_config.batch_size
                    for d in self.datasets["train"].values())
        if self.ensemble_members > 1:
            from tpu_deer_torch.train.ensemble import EnsembleTrainer

            self.trainer = EnsembleTrainer(
                self.model, self.params, self.training_config,
                steps_per_epoch=max(1, steps), device=self.device)
        else:
            self.trainer = DEERTrainer(self.model, self.training_config,
                                       steps_per_epoch=max(1, steps),
                                       device=self.device)
        return self.trainer

    # -- stages ----------------------------------------------------------
    def run_training(self) -> dict:
        from tpu_deer_torch.train.checkpoint import CheckpointManager
        from tpu_deer_torch.utils.logging import MetricWriter

        writer = MetricWriter(self.path("logs"))
        try:
            results = self.trainer.train(
                self.datasets["train"], self.datasets["val"], logger=writer,
                checkpoints=CheckpointManager(self.path("models")),
                resume=self.resume)
        finally:
            writer.close()
        history = {k: v for k, v in results.items() if k != "trainer"}
        with open(self.path("results", "training_history.json"), "w") as f:
            json.dump(history, f, indent=2, default=float)
        return results

    def run_evaluation(self) -> dict:
        from tpu_deer_torch.eval.evaluator import DEERModelEvaluator

        test_sets = self.datasets.get("test") or self.datasets["val"]
        evaluator = DEERModelEvaluator(n_bootstrap=200, seed=self.seed)
        all_results = {}
        for name, ds in test_sets.items():
            res = evaluator.evaluate_model(
                self.trainer, ds, n_parameters=self.trainer.n_parameters)
            all_results[name] = res.to_dict()
            logger.info(f"[{name}] CCC avg {res.ccc_average:.4f} "
                        f"MAE avg {res.mae_average:.4f} ECE {res.ece:.4f}")
        with open(self.path("results", "evaluation.json"), "w") as f:
            json.dump(all_results, f, indent=2)
        self._write_conformal_report(test_sets)
        self._write_ood_detector()
        return all_results

    def _write_ood_detector(self, max_fit_rows: int = 16384) -> None:
        """Fit the input_norm Mahalanobis OOD detector on the train split
        (20% held out for its threshold when there are >= 256 rows) and
        save it as results/ood_detector.npz."""
        from tpu_deer_torch.eval.ood import MahalanobisOOD, input_norm_features

        train_sets = self.datasets.get("train") or {}
        if not train_sets:
            return
        feats = []
        for ds in train_sets.values():
            arrays = ds.arrays
            if len(ds) > max_fit_rows:
                idx = np.sort(np.random.default_rng(0).choice(
                    len(ds), max_fit_rows, replace=False))
                arrays = ds.slice(idx)
            feats.append(input_norm_features(arrays["audio"], arrays["video"],
                                             arrays["text"]))
        x = np.concatenate(feats)
        det = MahalanobisOOD(space="input_norm")
        if len(x) >= 256:
            perm = np.random.default_rng(1).permutation(len(x))
            n_cal = len(x) // 5
            det.fit(x[perm[n_cal:]]).calibrate(x[perm[:n_cal]])
        else:
            det.fit(x)
        det.save(self.path("results", "ood_detector.npz"))
        logger.info("OOD detector fitted on %d input_norm rows (threshold@1%%fpr "
                    "%.1f) -> results/ood_detector.npz", len(x), det.threshold(0.01))

    def _write_conformal_report(self, test_sets) -> None:
        """Split-conformal 90% intervals: quantiles fitted on the val split,
        coverage and width on the test split (results/conformal.json)."""
        from tpu_deer_torch.eval.conformal import ConformalCalibrator

        val_sets = self.datasets.get("val") or {}
        report = {}
        for name, test_ds in test_sets.items():
            cal_ds = val_sets.get(name) or next(iter(val_sets.values()), None)
            if cal_ds is None or cal_ds is test_ds:
                continue
            pc = self.trainer.predict(cal_ds)
            pt = self.trainer.predict(test_ds)
            cal = ConformalCalibrator(alpha=0.1, normalized=True).fit(
                pc["mu"], np.sqrt(np.maximum(pc["uncertainty"], 1e-12)),
                cal_ds.arrays["labels"])
            report[name] = cal.report(
                pt["mu"], np.sqrt(np.maximum(pt["uncertainty"], 1e-12)),
                test_ds.arrays["labels"])
            cov = report[name]["empirical_coverage"]
            logger.info(f"[{name}] conformal 90% intervals: coverage "
                        + "/".join(f"{c:.3f}" for c in cov))
        if report:
            with open(self.path("results", "conformal.json"), "w") as f:
                json.dump(report, f, indent=2)

    def run_visualization(self) -> dict:
        """The plots of the first test set (`viz/report.py`), with the
        attention weights of a forward over its first 256 rows (the member
        mean for an ensemble), into <experiment>/plots."""
        from tpu_deer_torch.models.deer_model import member_forward
        from tpu_deer_torch.viz.report import create_comprehensive_report

        test_sets = self.datasets.get("test") or self.datasets["val"]
        _, ds = next(iter(test_sets.items()))
        pred = self.trainer.predict(ds)
        model = self.trainer.model.eval()
        a, v, t = (torch.from_numpy(np.ascontiguousarray(ds.arrays[k][:256]))
                   .to(self.device) for k in ("audio", "video", "text"))
        with torch.no_grad():
            if self.trainer.n_members > 1:
                attention = member_forward(
                    model, self.trainer.params, a, v, t,
                    lambda out: out["attention_weights"].float()).mean(0)
            else:
                attention = model(a, v, t)["attention_weights"].float()
        return create_comprehensive_report(
            predictions=pred["mu"], targets=ds.arrays["labels"],
            uncertainties=pred["uncertainty"],
            attention_weights=attention.cpu().numpy(),
            history=self.trainer.history, aleatoric=pred["aleatoric"],
            epistemic=pred["epistemic"], output_dir=self.path("plots"))

    def generate_final_report(self, train_results, eval_results) -> str:
        lines = [
            "# Multimodal DEER — Experiment Report",
            "",
            f"- experiment dir: `{self.experiment_dir}`",
            f"- device: {self.device}",
            f"- quick mode: {self.quick}",
            f"- epochs run: {train_results.get('epochs_run')}",
            f"- training time: {train_results.get('training_time_s', 0):.1f}s",
            f"- best val CCC: {train_results.get('best_val_ccc', float('nan')):.4f}",
            "- serving channel (selected by validation ECE): "
            f"{train_results.get('serving_channel', 'eabs')}",
            "- text backend: " + (", ".join(
                f"{k}={v}" for k, v in getattr(self, "text_backends", {}).items())
                or "unknown"),
            "",
            "## Test results",
            "",
            "| dataset | CCC avg | CCC V | CCC A | CCC D | MAE avg | ECE |",
            "|---|---|---|---|---|---|---|",
        ]
        for name, res in eval_results.items():
            ccc = res["ccc"]
            lines.append(
                f"| {name} | {res['ccc_average']:.4f} | {ccc.get('valence', 0):.4f} "
                f"| {ccc.get('arousal', 0):.4f} | {ccc.get('dominance', 0):.4f} "
                f"| {res['mae_average']:.4f} | {res['ece']:.4f} |")
        path = self.path("results", "final_report.md")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path

    def run_full_pipeline(self) -> dict:
        t0 = time.time()
        try:
            self.create_model()
            self.create_datasets()
            self.create_trainer()
            train_results = self.run_training()
            eval_results = self.run_evaluation()
            plots = self.run_visualization()
            report = self.generate_final_report(train_results, eval_results)
        except Exception as e:
            # Write the crash report, then re-raise.
            import traceback

            with open(self.path("results", "error_report.json"), "w") as f:
                json.dump({"error": str(e), "type": type(e).__name__,
                           "traceback": traceback.format_exc(),
                           "elapsed_s": time.time() - t0}, f, indent=2)
            raise
        summary = {
            "experiment_dir": self.experiment_dir,
            "best_val_ccc": train_results["best_val_ccc"],
            "serving_channel": train_results.get("serving_channel", "eabs"),
            "test_results": eval_results,
            "text_backend": getattr(self, "text_backends", {}),
            "plots": plots,
            "report": report,
            "total_time_s": time.time() - t0,
        }
        with open(self.path("results", "pipeline_summary.json"), "w") as f:
            json.dump(summary, f, indent=2, default=float)
        return summary

    def load_checkpoint(self, model_path: str) -> None:
        from tpu_deer_torch.train.checkpoint import CheckpointManager

        ckpt = CheckpointManager(model_path)
        step = "best" if os.path.isdir(os.path.join(model_path, "best")) else None
        self.trainer.load_state_dict(ckpt.restore(step, map_location=self.device))
        logger.info(f"restored checkpoint from {model_path}")


RAW_LAYOUTS = ("iemocap", "ravdess", "meld")


def _raw_layout(layout: str):
    """(fixture generator taking (root, n_train, n_val, n_test, seed),
    loader) of a raw corpus layout."""
    from tpu_deer_torch.data import raw_corpus as rc

    return {
        "iemocap": (rc.generate_raw_fixture, rc.load_raw_corpus),
        # 24 actors, 18/3/3 train/val/test by actor.
        "ravdess": (lambda root, n_train, n_val, n_test, seed:
                    rc.generate_raw_fixture_ravdess(
                        root, n_per_actor=max(1, round(n_train / 18)), seed=seed),
                    rc.load_raw_ravdess),
        "meld": (lambda root, n_train, n_val, n_test, seed:
                 rc.generate_raw_fixture_meld(root, n_train=n_train, n_val=n_val,
                                              n_test=n_test, seed=seed),
                 rc.load_raw_meld),
    }[layout]


def run_raw_pipeline(args, device: DeviceLike = None) -> dict:
    """--raw: raw-media training end to end on `device` (None = the CUDA
    card). The corpus at `datasets.raw_root` in the config, or a fixture
    in the `--raw_dataset` layout generated under the experiment (seed 42;
    96/24/24 utterances with --quick, else 768/96/96), loads into padded
    arrays; RawSequenceDEERModel (encoder 64 and fusion 128 with --quick,
    else 128 and 256; seeded init 42) trains with RawSequenceTrainer (K1 in
    the step on the card; lr 2e-3, batch 32 or 64, 12 or 60 epochs unless
    given), predicts the test split and is evaluated; the summary goes to
    results/raw_results.json."""
    from tpu_deer_torch.eval.evaluator import DEERModelEvaluator
    from tpu_deer_torch.models.hierarchical_deer import create_raw_sequence_model
    from tpu_deer_torch.ops.audio_frontend import AudioFrontendConfig
    from tpu_deer_torch.train.raw_trainer import RawSequenceTrainer, RawTrainingConfig
    from tpu_deer_torch.utils.config import load_yaml_config

    device = resolve_device(device)
    config = load_yaml_config(args.config)
    name = args.experiment_name or time.strftime("raw_experiment_%Y%m%d_%H%M%S")
    exp_dir = os.path.join(args.output_dir, name)
    for sub in ("results", "data", "logs"):
        os.makedirs(os.path.join(exp_dir, sub), exist_ok=True)

    layout = args.raw_dataset
    generate_fixture, load_corpus = _raw_layout(layout)
    raw_root = config["datasets"].get("raw_root")
    if not (raw_root and os.path.isdir(raw_root)):
        raw_root = os.path.join(exp_dir, "data", f"raw_fixture_{layout}")
        logger.warning(
            "no datasets.raw_root configured — generating a raw-media fixture "
            f"corpus in the {layout} layout under {raw_root} (real-format wavs "
            "+ frame arrays + transcripts with learnable labels)")
        n = (96, 24, 24) if args.quick else (768, 96, 96)
        generate_fixture(raw_root, *n, seed=42)

    splits, vocab = load_corpus(raw_root)
    logger.info("raw corpus: " + ", ".join(f"{k}={len(v['labels'])}"
                                           for k, v in splits.items())
                + f" | vocab {vocab.vocab_size}")
    model = create_raw_sequence_model(
        seed=42, device=device, encoder_dim=64 if args.quick else 128,
        fusion_dim=128 if args.quick else 256, vocab_size=vocab.vocab_size,
        num_heads=4, dropout=0.1)
    trainer = RawSequenceTrainer(
        model, RawTrainingConfig(
            learning_rate=args.learning_rate or 2e-3,
            batch_size=args.batch_size or (32 if args.quick else 64),
            num_epochs=args.epochs or (12 if args.quick else 60)),
        frontend_config=AudioFrontendConfig(), device=device)
    tr = splits["train"]
    results = trainer.train(tr, splits.get("val"))
    test = splits.get("test") or splits["val"]
    pred = trainer.predict(test)
    ev = DEERModelEvaluator(n_bootstrap=0).evaluate_arrays(
        pred["mu"], test["labels"], pred["uncertainty"])
    summary = {
        "experiment_dir": exp_dir,
        "raw_layout": layout,
        "raw_root": raw_root,
        "vocab_size": vocab.vocab_size,
        "best_val_ccc": results["best_val_ccc"],
        "test": ev.to_dict(),
        "history": results["history"],
        "training_time_s": results["training_time_s"],
    }
    with open(os.path.join(exp_dir, "results", "raw_results.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)
    logger.info(f"raw e2e: best val CCC {results['best_val_ccc']:.4f} | "
                f"test CCC {ev.ccc_average:.4f} MAE {ev.mae_average:.4f}")
    return summary


def run_component_tests(device: DeviceLike = None) -> bool:
    """--mode test: model forward, DEER loss and NIG math on `device`, and a
    training-curve plot (skipped where matplotlib is not installed)."""
    from tpu_deer_torch.core import losses, nig
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        create_complete_deer_model,
    )

    ok = True
    try:
        device = resolve_device(device)
        model = create_complete_deer_model(
            DEERModelConfig(encoder_dim=64, fusion_dim=128, encoder_layers=1),
            seed=0, device=device)
        zeros = lambda d: torch.zeros((2, d), device=device)
        with torch.no_grad():
            out = model(zeros(84), zeros(256), zeros(768))
        assert out["mu_all"].shape == (2, 3)
        print("model forward: OK")

        ps = [out[f"{n}_params"] for n in ("valence", "arousal", "dominance")]
        loss = losses.multi_task_deer_loss(ps, torch.zeros((2, 3), device=device))
        assert bool(torch.isfinite(loss["total_loss"]))
        print("DEER loss: OK")

        p = nig.nig_params_from_evidence(torch.zeros((2, 3, 4), device=device))
        u = nig.nig_uncertainties(p)
        assert bool(torch.all(u["total"] > 0))
        print("NIG math: OK")

        import tempfile

        from tpu_deer_torch.viz.report import NO_MATPLOTLIB, PerformanceVisualizer

        try:
            with tempfile.TemporaryDirectory() as td:
                path = PerformanceVisualizer().plot_training_curves(
                    {"train_loss": [3, 2, 1], "val_ccc": [0.1, 0.2],
                     "learning_rate": [1e-4] * 3},
                    save_path=f"{td}/curves.png")
                assert os.path.exists(path)
            print("visualization: OK")
        except ImportError:
            print(f"visualization: skipped ({NO_MATPLOTLIB})")
    except Exception as e:  # noqa: BLE001 — reported as the mode's failure
        print(f"component test FAILED: {e!r}")
        ok = False
    return ok


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Multimodal DEER pipeline on a "
                                            "CUDA card (PyTorch port)")
    p.add_argument("--mode", choices=["full", "train", "evaluate", "visualize",
                                      "test", "export"], default="full")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="experiments")
    p.add_argument("--experiment_name", type=str, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in the experiment's "
                        "models/ dir (same --output_dir and --experiment_name)")
    p.add_argument("--quick", action="store_true",
                   help="8 epochs, batch size 32, lr 3e-3, small learnable "
                        "synthetic data")
    p.add_argument("--recipe", choices=sorted(RECIPES), default=None,
                   help="named config preset applied over the base config "
                        "(explicit flags still win); same values as "
                        "configs/uncertainty.yaml")
    p.add_argument("--raw", action="store_true",
                   help="raw-media end-to-end training: waveforms + frame "
                        "arrays + transcripts through RawSequenceDEERModel "
                        "with K1 in the step (datasets.raw_root in the "
                        "config, or a generated fixture)")
    p.add_argument("--raw_dataset", choices=RAW_LAYOUTS, default="iemocap",
                   help="corpus layout for --raw: IEMOCAP session dirs, "
                        "RAVDESS filename-coded Actor_XX wavs, or MELD CSV + "
                        "media dirs")
    p.add_argument("--ensemble", type=int, default=None, metavar="K",
                   help="train a K-member deep ensemble (all members in one "
                        "vmapped step; predictions moment-matched, the "
                        "cross-member disagreement added to the epistemic "
                        "channel). Equivalent to training.ensemble_members "
                        "in the config")
    p.add_argument("--platform", choices=sorted(PLATFORMS), default="auto",
                   help="'auto' and 'cuda': the CUDA card, raising without "
                        "one; 'cpu': the CPU")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="--mode export: int8 Dense kernels in the artifact, "
                        "dequantized inside its programs")
    p.add_argument("--ood_detector", metavar="NPZ",
                   help="--mode export: an input_norm Mahalanobis detector "
                        "(the evaluate stage's results/ood_detector.npz); "
                        "the programs gain an ood_score output and the "
                        "manifest the is_ood threshold")
    p.add_argument("--ood_fpr", type=float, default=0.01,
                   help="--mode export: training-quantile false-positive "
                        "rate for the is_ood threshold")
    return p


def export_model(args, pipeline: "MultimodalDEERPipeline",
                 device: torch.device) -> dict:
    """--mode export: the configured model, with `--model_path`'s weights
    and serving channel, exported to <output_dir>/exported_model."""
    from tpu_deer_torch.export import export_inference
    from tpu_deer_torch.models.deer_model import LAYOUT_FIELDS

    ckpt = step = None
    if args.model_path:
        from tpu_deer_torch.train.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.model_path)
        step = ("best" if os.path.isdir(os.path.join(args.model_path, "best"))
                else None)
        # The model the checkpoint was trained as (fusion type, layout).
        meta = ckpt.metadata(step)
        layout = meta.get("model", {})
        pipeline.config["model"].update(
            {f: layout[f] for f in LAYOUT_FIELDS if f in layout})
    pipeline.create_model()
    ensemble = pipeline.ensemble_members > 1
    params = pipeline.params
    serving_channel = "eabs"
    if ckpt is not None:
        params = ckpt.restore_params(step)
        if not ensemble:
            pipeline.model.load_state_dict(params)
        serving_channel = meta["metrics"].get("serving_channel", "eabs")
    ood_det = None
    if args.ood_detector:
        from tpu_deer_torch.eval.ood import MahalanobisOOD

        ood_det = MahalanobisOOD.load(args.ood_detector)
    out_dir = os.path.join(args.output_dir, "exported_model")
    manifest = export_inference(
        pipeline.model, out_dir, platforms=(device.type,), quantize=args.int8,
        ood_detector=ood_det, ood_fpr=args.ood_fpr,
        serving_channel=serving_channel, ensemble=ensemble,
        params=params if ensemble else None)
    return {"export_dir": out_dir,
            **{k: manifest[k] for k in ("buckets", "platforms", "n_params",
                                        "quantized", "ensemble_members",
                                        "serving_channel")}}


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(PLATFORMS[args.platform])
    logger.info("device: %s", device)

    if args.mode == "test":
        return 0 if run_component_tests(device) else 1
    if args.raw:
        summary = run_raw_pipeline(args, device)
        print(json.dumps({"best_val_ccc": summary["best_val_ccc"],
                          "test_ccc": summary["test"]["ccc_average"],
                          "experiment_dir": summary["experiment_dir"]}, indent=2))
        return 0

    overrides = {}
    if args.epochs is not None:
        overrides["training.num_epochs"] = args.epochs
    if args.batch_size is not None:
        overrides["training.batch_size"] = args.batch_size
    if args.learning_rate is not None:
        overrides["training.learning_rate"] = args.learning_rate
    if args.ensemble is not None:
        overrides["training.ensemble_members"] = args.ensemble

    pipeline = MultimodalDEERPipeline(
        config_path=args.config, output_dir=args.output_dir,
        experiment_name=args.experiment_name, overrides=overrides,
        quick=args.quick, resume=args.resume, recipe=args.recipe, device=device)

    if args.mode == "export":
        print(json.dumps(export_model(args, pipeline, device), indent=2))
        return 0
    if args.mode == "full":
        summary = pipeline.run_full_pipeline()
        print(json.dumps({"best_val_ccc": summary["best_val_ccc"],
                          "experiment_dir": summary["experiment_dir"]}, indent=2))
        return 0
    pipeline.create_model()
    pipeline.create_datasets()
    pipeline.create_trainer()
    if args.mode == "train":
        results = pipeline.run_training()
        print(f"best val CCC: {results['best_val_ccc']:.4f}")
        return 0
    if args.model_path:
        pipeline.load_checkpoint(args.model_path)
    if args.mode == "visualize":
        print(json.dumps(pipeline.run_visualization(), indent=2))
    else:  # evaluate
        print(json.dumps(pipeline.run_evaluation(), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
