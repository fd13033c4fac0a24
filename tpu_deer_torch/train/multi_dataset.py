"""Joint training over several corpora and the real cross-dataset transfer
matrix.

Port of `tpu_deer/train/multi_dataset.py`:

  * `run_multi_dataset_training` trains one flagship on every dataset's
    train split at once (the trainer's curriculum and dataset weights; one
    epoch's steps are the sum over the datasets) and evaluates it on each
    dataset's test split, the uncertainty scale fitted on its val split;
  * `evaluate_cross_dataset` trains a model on each source alone and
    evaluates it on every other dataset's test split, calibrated with the
    scale fitted on the source's val split (the target's labels are unseen
    in a transfer setting); transfer effectiveness is
    `core.metrics.cross_dataset_transfer_effectiveness(source CCC, target
    CCC)`.

    python -m tpu_deer_torch.train.multi_dataset
    python -m tpu_deer_torch.train.multi_dataset --n 4000 --epochs 15 \\
        --batch_size 256 --lr 2e-3
    python -m tpu_deer_torch.train.multi_dataset --quick --platform cpu

`main` loads the configured corpora through `data/registry.py`, or, where
no configured path exists, three synthetic stand-in corpora that share a
label function (seeds 100-102, label seed 7), as the reference does. It
writes the JSON report (`--report`, by default
`results_torch/RESULTS_multidataset_h100.json`; `--quick`: `..._quick`)
and, beside it, a Markdown table of the joint CCCs and the transfer
matrix. Beyond the reference's flags, `--platform`
(`auto` and `cuda`: the card, raising without one; `cpu`), float32 with
TF32 off, and fused epochs (one CUDA graph of the train step) on the card.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Mapping, Optional

import numpy as np

from tpu_deer_torch.core.metrics import cross_dataset_transfer_effectiveness
from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.eval.evaluator import DEERModelEvaluator
from tpu_deer_torch.models.deer_model import DEERModelConfig, create_complete_deer_model
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

logger = logging.getLogger(__name__)

PLATFORMS = {"auto": None, "cuda": "cuda", "cpu": "cpu"}
DEFAULT_REPORT = "results_torch/RESULTS_multidataset_h100.json"


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    path: str = ""
    weight: float = 1.0


@dataclasses.dataclass
class MultiDatasetResults:
    joint: dict
    per_dataset: dict[str, dict]
    transfer: dict[str, dict]
    training_time_s: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class MultiDatasetFramework:
    """Joint training over several datasets and the transfer matrix, on
    `device` (None = the CUDA card)."""

    def __init__(self, model_config: DEERModelConfig,
                 training_config: TrainingConfig,
                 datasets: Mapping[str, Mapping[str, ArrayDataset]],
                 mesh=None, seed: int = 0, device: DeviceLike = None):
        """datasets: {name: {"train": ds, "val": ds, "test": ds}}"""
        self.model_config = model_config
        self.training_config = training_config
        self.datasets = dict(datasets)
        self.mesh = mesh
        self.seed = seed
        self.device = resolve_device(device)
        self.joint_trainer: Optional[DEERTrainer] = None
        # Per-dataset provenance for the report (e.g. the registry's text
        # backends).
        self.meta: dict = {}

    def _make_trainer(self, train_sets: Mapping[str, ArrayDataset]) -> DEERTrainer:
        model = create_complete_deer_model(self.model_config, seed=self.seed,
                                           device=self.device)
        steps = sum(max(1, len(d) // self.training_config.batch_size)
                    for d in train_sets.values())
        return DEERTrainer(model, self.training_config, steps_per_epoch=steps,
                           mesh=self.mesh, device=self.device)

    def run_multi_dataset_training(self, num_epochs: Optional[int] = None
                                   ) -> MultiDatasetResults:
        t0 = time.time()
        train_sets = {n: d["train"] for n, d in self.datasets.items()}
        val_sets = {n: d["val"] for n, d in self.datasets.items()}
        self.joint_trainer = self._make_trainer(train_sets)
        joint = dict(self.joint_trainer.train(train_sets, val_sets,
                                              num_epochs=num_epochs))
        evaluator = DEERModelEvaluator(n_bootstrap=0)
        per_dataset = {}
        for name, d in self.datasets.items():
            res = evaluator.evaluate_model(
                self.joint_trainer, d.get("test") or d["val"],
                calibration_dataset=d["val"])
            per_dataset[name] = res.to_dict()
            logger.info(f"[joint → {name}] CCC {res.ccc_average:.4f} "
                        f"ECE {res.ece:.4f}")
        return MultiDatasetResults(joint=joint, per_dataset=per_dataset,
                                   transfer={}, training_time_s=time.time() - t0)

    def evaluate_cross_dataset(self, num_epochs: Optional[int] = None
                               ) -> dict[str, dict]:
        """{"src->tgt": source and target CCC, target MAE, effectiveness}
        for each ordered pair."""
        evaluator = DEERModelEvaluator(n_bootstrap=0)
        results: dict[str, dict] = {}
        for src, d_src in self.datasets.items():
            trainer = self._make_trainer({src: d_src["train"]})
            trainer.train({src: d_src["train"]}, {src: d_src["val"]},
                          num_epochs=num_epochs)
            src_res = evaluator.evaluate_model(
                trainer, d_src.get("test") or d_src["val"],
                calibration_dataset=d_src["val"])
            src_ccc = src_res.ccc_average
            for tgt, d_tgt in self.datasets.items():
                if tgt == src:
                    continue
                tgt_res = evaluator.evaluate_model(
                    trainer, d_tgt.get("test") or d_tgt["val"],
                    calibration_scale=src_res.posthoc_scale)
                eff = cross_dataset_transfer_effectiveness(
                    src_ccc, tgt_res.ccc_average)
                results[f"{src}->{tgt}"] = {
                    "source_ccc": float(src_ccc),
                    "target_ccc": float(tgt_res.ccc_average),
                    "target_mae": float(tgt_res.mae_average),
                    "transfer_effectiveness": float(eff),
                }
                logger.info(f"[{src}→{tgt}] src CCC {src_ccc:.4f} tgt CCC "
                            f"{tgt_res.ccc_average:.4f} eff {eff:.2%}")
        return results

    def run_full_experiment(self, num_epochs: Optional[int] = None,
                            transfer_epochs: Optional[int] = None,
                            report_path: Optional[str] = None
                            ) -> MultiDatasetResults:
        results = self.run_multi_dataset_training(num_epochs)
        results.transfer = self.evaluate_cross_dataset(transfer_epochs or num_epochs)
        if report_path:
            self.generate_report(results, report_path)
        return results

    def generate_report(self, results: MultiDatasetResults, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = results.to_dict()
        payload["datasets"] = {n: {split: len(ds) for split, ds in d.items()}
                               for n, d in self.datasets.items()}
        if self.meta:
            payload["meta"] = self.meta
        if results.transfer:
            payload["transfer_effectiveness_avg"] = float(np.mean(
                [v["transfer_effectiveness"] for v in results.transfer.values()]))
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=float)
        return path


def markdown_report(payload: dict, platform: str, args: dict) -> str:
    """The joint CCCs and the transfer matrix of a report as Markdown."""
    lines = [
        "# Multi-dataset framework — computed results (PyTorch port)",
        "",
        f"- platform: **{platform}**; {args['n']} rows a dataset, "
        f"{args['epochs']} epochs, batch {args['batch_size']}, lr {args['lr']}; "
        f"joint training {payload['training_time_s']:.1f} s, "
        f"the whole run {payload['elapsed_s']:.1f} s",
        "",
        "| dataset | joint CCC | calibrated ECE |",
        "|---|---|---|",
    ]
    for name, r in payload["per_dataset"].items():
        lines.append(f"| {name} | {r['ccc_average']:.3f} | {r['ece']:.4f} |")
    lines += ["", "| transfer | source CCC | target CCC | effectiveness |",
              "|---|---|---|---|"]
    for pair, r in payload["transfer"].items():
        lines.append(f"| {pair} | {r['source_ccc']:.3f} | {r['target_ccc']:.3f} "
                     f"| {100 * r['transfer_effectiveness']:.1f}% |")
    if "transfer_effectiveness_avg" in payload:
        lines += ["", "Average transfer effectiveness: "
                  f"**{100 * payload['transfer_effectiveness_avg']:.1f}%**"]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    """The joint experiment, the transfer matrix and the report."""
    import argparse

    import torch

    from tpu_deer_torch.data.registry import load_configured_datasets
    from tpu_deer_torch.utils.config import load_yaml_config

    p = argparse.ArgumentParser(description="multi-dataset DEER experiment")
    p.add_argument("--config", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--transfer_epochs", type=int, default=None)
    p.add_argument("--report", default=DEFAULT_REPORT)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--n", type=int, default=None,
                   help="synthetic-fallback samples per dataset")
    p.add_argument("--platform", choices=sorted(PLATFORMS), default="auto",
                   help="'auto' and 'cuda': the CUDA card, raising without "
                        "one; 'cpu': the CPU")
    args = p.parse_args(argv)
    if args.quick and args.report == DEFAULT_REPORT:
        args.report = DEFAULT_REPORT.replace(".json", "_quick.json")

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    device = resolve_device(PLATFORMS[args.platform])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = load_yaml_config(args.config)
    t0 = time.time()

    loaded = load_configured_datasets(config, quick=args.quick, device=device)
    meta = loaded.pop("meta", {}) if loaded else {}
    meta.pop("text_encoder", None)  # featurizer objects, not for the report
    n = args.n if args.n is not None else (200 if args.quick else 1000)
    if loaded:
        datasets = {name: {split: loaded[split][name]
                           for split in ("train", "val", "test")
                           if name in loaded.get(split, {})}
                    for name in loaded["train"]}
        m = config["model"]
        model_cfg = DEERModelConfig(
            audio_dim=int(m["audio_dim"]), video_dim=int(m["video_dim"]),
            text_dim=int(m["text_dim"]), fusion_dim=int(m["fusion_dim"]))
    else:
        logger.warning("no real datasets configured — synthetic 3-dataset run")
        from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits

        datasets = {}
        for i, name in enumerate(("iemocap", "ravdess", "meld")):
            splits = make_synthetic_splits(SyntheticConfig(
                n_train=n, n_val=n // 4, n_test=n // 4, seed=100 + i,
                label_seed=7, audio_dim=84, video_dim=256, text_dim=768))
            datasets[name] = {s: ArrayDataset(splits[s], name) for s in splits}
        model_cfg = DEERModelConfig()

    t = config["training"]
    weights = {k.lower(): float(v)
               for k, v in config["datasets"].get("weights", {}).items()}
    train_cfg = TrainingConfig(
        learning_rate=args.lr if args.lr is not None else float(t["learning_rate"]),
        batch_size=(args.batch_size if args.batch_size is not None
                    else int(t["batch_size"])),
        num_epochs=args.epochs or (3 if args.quick else int(t["num_epochs"])),
        warmup_epochs=min(int(t.get("warmup_epochs", 5)), 1 if args.quick else 5),
        dataset_weights=weights or {name: 1.0 for name in datasets},
        fused_epochs=device.type == "cuda",
        seed=int(t.get("seed", 42)))

    fw = MultiDatasetFramework(model_cfg, train_cfg, datasets, device=device)
    fw.meta = meta or {"text_backend": {name: "precomputed-synthetic"
                                        for name in datasets}}
    results = fw.run_full_experiment(
        num_epochs=train_cfg.num_epochs,
        transfer_epochs=args.transfer_epochs or train_cfg.num_epochs,
        report_path=args.report)
    with open(args.report) as f:
        payload = json.load(f)
    payload["elapsed_s"] = time.time() - t0
    from tpu_deer_torch.experiments.synthetic_headline import card_name

    payload["platform"] = card_name(device)
    with open(args.report, "w") as f:
        json.dump(payload, f, indent=2, default=float)
    md_path = os.path.splitext(args.report)[0] + ".md"
    with open(md_path, "w") as f:
        f.write(markdown_report(payload, payload["platform"], {
            "n": n if not loaded else "corpus", "epochs": train_cfg.num_epochs,
            "batch_size": train_cfg.batch_size, "lr": train_cfg.learning_rate}))
    print(json.dumps({
        "per_dataset_ccc": {name: r["ccc_average"]
                            for name, r in results.per_dataset.items()},
        "transfer": {k: v["transfer_effectiveness"]
                     for k, v in results.transfer.items()},
        "report": args.report,
    }, indent=2))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
