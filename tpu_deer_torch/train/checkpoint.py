"""Checkpoint manager: the full training state plus metadata on disk.

Port of `tpu_deer/train/checkpoint.py`, same layout and policies:

    <dir>/step_XXXXXXXX/state.pt   the state (model, optimizer and dropout
                                   generator state, step), written with
                                   torch.save and read back with
                                   torch.load(weights_only=True)
    <dir>/step_XXXXXXXX/meta.json  {"step", "metrics", "format"[, "model"]}
    <dir>/best/                    a copy of the best step's directory

A step is written into `step_XXXXXXXX.partial/` and renamed into place, so
a failed write leaves no step behind (the reference writes in place).
`keep_last` prunes the oldest step directories. With `async_save=True` the
state is copied to host memory on the caller's thread (so the checkpoint is
the state of the step that asked for it), and writing, the best copy and
pruning run on one background worker; `wait()` and every read drain the
queue first, and a worker's failure is raised at the next save or wait,
after the whole queue has drained.

The reference's sharded and multi-process formats (`manifest.json`) are not
ported, and the port does not read the reference's msgpack checkpoints:
restoring either raises NotImplementedError.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _to_host(obj: Any) -> Any:
    """A copy of a nested state with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _to_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        # One worker: writes land in request order, so the best copy and
        # pruning cannot race a write still in flight.
        self._pool = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: list = []

    @staticmethod
    def _raise_first(futures) -> None:
        """Read every future's result; raise the first failure, log the
        others."""
        first_exc = None
        for fut in futures:
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 — re-raised below
                if first_exc is None:
                    first_exc = e
                else:
                    logger.error("additional async checkpoint write failed: %r", e)
        if first_exc is not None:
            raise first_exc

    def wait(self) -> None:
        """Block until every queued write is on disk; re-raise the first
        worker failure once the whole queue has drained."""
        pending, self._pending = self._pending, []
        self._raise_first(pending)

    # -- paths -----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    @property
    def best_dir(self) -> str:
        return os.path.join(self.directory, "best")

    def _path(self, step) -> str:
        if step == "best":
            return self.best_dir
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return self._step_dir(step)

    # -- save ------------------------------------------------------------
    def save(self, state: dict, step: int, metrics: Optional[dict] = None,
             is_best: bool = False, model: Optional[dict] = None) -> str:
        """Write `state` (nested dicts of tensors and numbers) and its
        metadata as step `step`; copy it to best/ when `is_best`. `model`,
        the model's layout (`models/deer_model.py:layout_meta`), goes into
        the metadata beside the metrics. Returns the step's directory."""
        path = self._step_dir(step)
        host_state = _to_host(state)  # caller thread: the state of this step
        meta = {"step": step, "metrics": _to_jsonable(metrics or {}),
                "format": "torch"}
        if model:
            meta["model"] = _to_jsonable(model)

        def commit():
            # Written beside the step's directory and renamed into place, so
            # a failed or cut write leaves no step that resume would read.
            tmp = path + ".partial"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            try:
                torch.save(host_state, os.path.join(tmp, STATE_FILE))
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f, indent=2)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
            if is_best:
                if os.path.isdir(self.best_dir):
                    shutil.rmtree(self.best_dir)
                shutil.copytree(path, self.best_dir)
            self._prune()

        if self._pool is None:
            commit()
            return path
        # Report earlier worker failures at this save: completed futures
        # leave the queue before they are read, so each failure is raised
        # once.
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        self._pending.append(self._pool.submit(commit))
        self._raise_first(done)
        return path

    def _prune(self) -> None:
        # Runs on the worker: must not drain the queue (all_steps would).
        steps = self._list_steps()
        for step in steps[: -self.keep_last] if self.keep_last > 0 else []:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def _list_steps(self) -> list[int]:
        return sorted(int(name[5:]) for name in os.listdir(self.directory)
                      if name.startswith("step_") and name[5:].isdigit())

    # -- restore ---------------------------------------------------------
    def all_steps(self) -> list[int]:
        self.wait()
        return self._list_steps()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step=None, map_location=None) -> dict:
        """The saved state: step=None the latest, "best" the best copy, or
        a step number."""
        self.wait()
        path = self._path(step)
        if os.path.exists(os.path.join(path, "manifest.json")):
            raise NotImplementedError(
                "sharded checkpoints are not ported yet (ROADMAP queue 1, "
                "item 13)")
        if os.path.exists(os.path.join(path, "state.msgpack")):
            raise NotImplementedError(
                "this is a checkpoint of the JAX package (msgpack); the port "
                "reads only its own (ROADMAP queue 3)")
        return torch.load(os.path.join(path, STATE_FILE),
                          map_location=map_location, weights_only=True)

    def restore_params(self, step=None, map_location=None) -> dict:
        """Just the model's state_dict (for serving)."""
        return self.restore(step, map_location)["model"]

    def metadata(self, step=None) -> dict:
        self.wait()
        with open(os.path.join(self._path(step), "meta.json")) as f:
            return json.load(f)
