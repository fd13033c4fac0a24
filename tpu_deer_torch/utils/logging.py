"""Experiment logging: scalar metrics as JSON lines, experiment directories.

Port of `tpu_deer/utils/logging.py`. `MetricWriter` appends one JSON object
per scalar to `<log_dir>/metrics.jsonl` (the reference's TensorBoard event
files are not written). `ExperimentLogger` makes the experiment's
directories, a log file and a MetricWriter.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional


class MetricWriter:
    """Scalars to `<log_dir>/metrics.jsonl`: {"tag", "value", "step",
    "time"} per line."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "time": time.time()}) + "\n")
        self._jsonl.flush()

    def scalars(self, metrics: dict, step: int, prefix: str = "") -> None:
        """Every value that converts to float; others (strings) are skipped."""
        for k, v in metrics.items():
            try:
                value = float(v)
            except (TypeError, ValueError):
                continue
            self.scalar(f"{prefix}{k}", value, step)

    def close(self) -> None:
        self._jsonl.close()


class ExperimentLogger:
    """Per-experiment directory with config.json, results.json, a log file
    and a MetricWriter."""

    def __init__(self, base_dir: str, experiment_name: Optional[str] = None):
        if experiment_name is None:
            experiment_name = time.strftime("experiment_%Y%m%d_%H%M%S")
        self.experiment_dir = os.path.join(base_dir, experiment_name)
        for sub in ("models", "plots", "logs", "results", "configs", "data"):
            os.makedirs(os.path.join(self.experiment_dir, sub), exist_ok=True)

        self.logger = logging.getLogger(f"tpu_deer_torch.{experiment_name}")
        self.logger.setLevel(logging.INFO)
        if not self.logger.handlers:
            fh = logging.FileHandler(
                os.path.join(self.experiment_dir, "logs", "experiment.log"))
            fh.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
            self.logger.addHandler(fh)
            sh = logging.StreamHandler()
            sh.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
            self.logger.addHandler(sh)

        self.metrics = MetricWriter(os.path.join(self.experiment_dir, "logs"))

    def path(self, *parts: str) -> str:
        return os.path.join(self.experiment_dir, *parts)

    def save_config(self, config: dict) -> None:
        with open(self.path("configs", "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)

    def save_results(self, results: dict) -> None:
        with open(self.path("results", "results.json"), "w") as f:
            json.dump(results, f, indent=2, default=str)

    def info(self, msg: str) -> None:
        self.logger.info(msg)
