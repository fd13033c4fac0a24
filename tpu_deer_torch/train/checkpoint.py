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

The sharded format, as the reference's: when the state holds DTensors
(a trainer under a mesh: `state_dict()` places its parameters and optimizer
tensors; a DTensor on a mesh of one device counts too) or the world has more
than one process, `save` writes `manifest.json` (every leaf's global shape,
dtype and the [start, stop) ranges of its pieces, or its value) and
`arrays/<key>__<ranges>.npy` pieces: each distinct piece once, by the
process at coordinate 0 on the mesh axes the leaf is replicated over; a
leaf that is not a DTensor by process 0. Across processes the save is
synchronous, between barriers, and the directory must be on a filesystem
every process shares. `restore` reassembles each leaf from the pieces that
cover it (read through mmap): onto a template leaf's placement where the
template holds a DTensor (each process reads its own region), else whole,
so a state saved under one layout restores under another, or without a
mesh; a template leaf the manifest lacks raises.

The reference's own checkpoints are read too, and turned into the port's
state through `convert.py`: its `state.msgpack` (decoded by
`train/flax_msgpack.py`) and its sharded format (keys "params/...",
"opt_state/...", "step"). `restore` gives the model's state_dict, the
optimizer's moments, count, EMA and accumulation state, and the step, so a
run resumes (the dropout generator is the trainer's own); `restore_params`
the state_dict.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_deer_torch.convert import flax_to_state_dict
from tpu_deer_torch.parallel.mesh import (
    AXES,
    all_regions,
    coordinate,
    mesh_shape,
    region,
    to_dtensor,
    world_size,
)
from tpu_deer_torch.train.flax_msgpack import msgpack_restore

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"
MANIFEST = "manifest.json"
MSGPACK = "state.msgpack"


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


# -- the sharded format -------------------------------------------------------

def _dtensor_type():
    """DTensor, where torch.distributed.tensor is loaded (else no state
    holds one)."""
    return getattr(sys.modules.get("torch.distributed.tensor"), "DTensor", None)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def _flatten(tree: Any, prefix: str = "") -> dict:
    """Nested dicts → {"a/b/c": leaf}; an empty dict below the top is a
    leaf of its own."""
    if isinstance(tree, dict) and (tree or not prefix):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


def _chunk_name(key: str, spec) -> str:
    safe = key.replace("/", ".")
    if not spec:
        return f"{safe}__full.npy"
    return f"{safe}__" + ".".join(f"{a}_{b}" for a, b in spec) + ".npy"


def _spec(dtensor) -> list:
    """The mesh axis splitting each dim of a DTensor (None: not split)."""
    names = dtensor.device_mesh.mesh_dim_names or AXES
    spec = [None] * dtensor.dim()
    for name, placement in zip(names, dtensor.placements):
        if placement.is_shard():
            spec[placement.dim] = name
    return spec


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor as numpy (bfloat16 as its uint16 bits)."""
    t = t.detach().to("cpu", copy=True).contiguous()
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":  # uint16 bits, or the reference's |V2
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype)))


def _snapshot_chunks(flat: dict) -> tuple[dict, list]:
    """(manifest, [(file name, array)] this process writes), taken on the
    caller's thread so that the pieces are the state of the step that
    asked. Each distinct piece of a DTensor is written by the process at
    coordinate 0 of the axes it is replicated over; other tensors by
    process 0."""
    DTensor = _dtensor_type()
    proc0 = _rank() == 0
    leaves: dict = {}
    chunks: list = []
    for key, v in flat.items():
        if DTensor is not None and isinstance(v, DTensor):
            spec, shape = _spec(v), tuple(v.shape)
            sizes, coords = mesh_shape(v.device_mesh), coordinate(v.device_mesh)
            leaves[key] = {"shape": list(shape), "dtype": _dtype_name(v.dtype),
                           "chunks": all_regions(shape, spec, sizes)}
            if all(coords[a] == 0 for a in AXES if a not in spec):
                chunks.append((_chunk_name(key, region(shape, spec, sizes, coords)),
                               _host(v.to_local())))
        elif isinstance(v, (torch.Tensor, np.ndarray, np.generic)):
            arr = _host(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            full = [[0, d] for d in arr.shape]
            leaves[key] = {"shape": list(arr.shape), "chunks": [full],
                           "dtype": (_dtype_name(v.dtype) if isinstance(v, torch.Tensor)
                                     else str(arr.dtype))}
            if proc0:
                chunks.append((_chunk_name(key, full), arr))
        elif isinstance(v, dict):  # an empty dict
            leaves[key] = {"empty_dict": True}
        else:
            leaves[key] = {"value": _to_jsonable(v)}
    return {"format": 1, "leaves": leaves}, chunks


def _read_region(arrays_dir: str, key: str, meta: dict, spec, cache: dict
                 ) -> np.ndarray:
    """The [start, stop) region `spec` of leaf `key`, assembled from the
    saved pieces that cover it (mmap'd: only the needed slices are read).
    The saved pieces and the region are independent (any two layouts)."""
    out = None
    filled = 0
    for cspec in meta["chunks"]:
        inter = [(max(s, cs), min(e, ce)) for (s, e), (cs, ce) in zip(spec, cspec)]
        if any(a >= b for a, b in inter):
            continue
        fname = _chunk_name(key, cspec)
        if fname not in cache:
            cache[fname] = np.load(os.path.join(arrays_dir, fname), mmap_mode="r")
        chunk = cache[fname]
        if out is None:
            out = np.empty([e - s for s, e in spec], chunk.dtype)
        src = tuple(slice(a - cs, b - cs) for (a, b), (cs, _) in zip(inter, cspec))
        dst = tuple(slice(a - s, b - s) for (a, b), (s, _) in zip(inter, spec))
        out[dst] = chunk[src]
        filled += int(np.prod([b - a for a, b in inter]))
    size = int(np.prod([e - s for s, e in spec]))
    if filled < size or (out is None and size):
        raise ValueError(f"checkpoint chunks for {key!r} cover {filled}/{size} "
                         f"elements of region {spec}: corrupt or incomplete save")
    if out is None:  # an empty region
        out = np.empty([e - s for s, e in spec], np.uint8)
    return out


def _read_leaf(path: str, key: str, meta: dict, target=None, map_location=None):
    """Leaf `key` of the sharded checkpoint at `path`: a value, {} (an empty
    dict), a DTensor placed as `target` where that is a DTensor (this
    process reads its region), else the whole tensor."""
    if meta.get("empty_dict"):
        return {}
    if "value" in meta:
        return meta["value"]
    arrays_dir = os.path.join(path, "arrays")
    shape = tuple(meta["shape"])
    cache: dict = {}
    DTensor = _dtensor_type()
    if DTensor is not None and isinstance(target, DTensor):
        spec = _spec(target)
        mesh = target.device_mesh
        local = _tensor(_read_region(
            arrays_dir, key, meta,
            region(shape, spec, mesh_shape(mesh), coordinate(mesh)), cache),
            meta["dtype"]).to(target.device)
        return to_dtensor(local, mesh, spec, shape)
    out = _tensor(_read_region(arrays_dir, key, meta, [[0, d] for d in shape],
                               cache), meta["dtype"])
    return out.to(map_location) if map_location is not None else out


# -- the reference's checkpoints ------------------------------------------------

def _subtree(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def _arrays(flat: dict) -> dict:
    """The array leaves (masked and empty states are empty dicts)."""
    return {k: np.asarray(v) for k, v in flat.items()
            if isinstance(v, (np.ndarray, np.generic))}


def _state_dict(flat: dict) -> dict:
    """A flattened flax subtree ("a/b/kernel": array) → a state_dict."""
    return flax_to_state_dict(_unflatten(_arrays(flat)))


def from_reference(flat: dict) -> dict:
    """A reference TrainState, flattened ("params/...", "opt_state/...",
    "step", numpy leaves), as the port's state: {"model": state_dict,
    "optimizer": AdamW state, "step"}. The optimizer chain is the
    reference trainer's: clip → multi_transform(adamw per group) [→ EMA],
    under optax.MultiSteps when gradients accumulate."""
    opt = _subtree(flat, "opt_state/")
    optimizer: dict = {}
    if "mini_step" in opt:  # optax.MultiSteps
        optimizer["mini_step"] = int(opt["mini_step"])
        optimizer["acc"] = _state_dict(_subtree(opt, "acc_grads/"))
        opt = _subtree(opt, "inner_opt_state/")
    groups = _subtree(opt, "1/inner_states/")
    # The adamw states of the groups as one "mu/...", "nu/..." tree: each
    # group holds its own parameters' moments and masks the others'.
    adam = {}
    for key, v in _arrays(groups).items():
        _, _, rest = key.partition("/inner_state/0/")
        if rest == "count":
            optimizer["count"] = int(v)
        elif rest:
            adam[rest] = v
    optimizer["mu"] = _state_dict(_subtree(adam, "mu/"))
    optimizer["nu"] = _state_dict(_subtree(adam, "nu/"))
    if any(k.startswith("2/ema/") for k in opt):
        optimizer["ema"] = _state_dict(_subtree(opt, "2/ema/"))
    optimizer.setdefault("count", 0)
    return {"model": _state_dict(_subtree(flat, "params/")),
            "optimizer": optimizer, "step": int(flat["step"])}


def _is_reference(manifest: dict) -> bool:
    return any(k.startswith("params/") for k in manifest["leaves"])


def _place(state: Any, map_location) -> Any:
    if isinstance(state, torch.Tensor):
        return state.to(map_location) if map_location is not None else state
    if isinstance(state, dict):
        return {k: _place(v, map_location) for k, v in state.items()}
    return state


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
        meta = {"step": step, "metrics": _to_jsonable(metrics or {}),
                "format": "torch"}
        if model:
            meta["model"] = _to_jsonable(model)
        flat = _flatten(state)
        DTensor = _dtensor_type()
        if world_size() > 1 or (DTensor is not None and any(
                isinstance(v, DTensor) for v in flat.values())):
            return self._save_sharded(path, flat, meta, is_best)
        host_state = _to_host(state)  # caller thread: the state of this step

        def write(tmp):
            torch.save(host_state, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f, indent=2)

        return self._dispatch(lambda: self._commit(path, write, is_best), path)

    def _commit(self, path: str, write, is_best: bool) -> None:
        """`write(tmp)` into the step's directory beside it, renamed into
        place (a failed or cut write leaves no step that resume would read),
        then the best copy and pruning."""
        tmp = path + ".partial"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            write(tmp)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._finish(path, is_best)

    def _finish(self, path: str, is_best: bool) -> None:
        shutil.rmtree(path, ignore_errors=True)
        os.replace(path + ".partial", path)
        if is_best:
            if os.path.isdir(self.best_dir):
                shutil.rmtree(self.best_dir)
            shutil.copytree(path, self.best_dir)
        self._prune()

    def _save_sharded(self, path: str, flat: dict, meta: dict,
                      is_best: bool) -> str:
        manifest, chunks = _snapshot_chunks(flat)  # caller thread
        meta = {**meta, "format": "sharded", "process_count": world_size()}

        def write_chunks(tmp):
            arrays = os.path.join(tmp, "arrays")
            os.makedirs(arrays, exist_ok=True)
            for name, arr in chunks:
                np.save(os.path.join(arrays, name), arr)

        def write_meta(tmp):
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f, indent=2)

        if world_size() == 1:
            return self._dispatch(lambda: self._commit(
                path, lambda tmp: (write_chunks(tmp), write_meta(tmp)), is_best),
                path)
        # Across processes the barriers order the writes: synchronous, on
        # the caller's thread (earlier asynchronous writes drained first).
        self.wait()
        tmp = path + ".partial"
        if _rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(os.path.join(tmp, "arrays"))
        _barrier()
        write_chunks(tmp)
        _barrier()  # every piece on disk
        if _rank() == 0:
            write_meta(tmp)
            self._finish(path, is_best)
        _barrier()
        return path

    def _dispatch(self, commit, path: str) -> str:
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

    def restore(self, step=None, map_location=None, template=None) -> dict:
        """The saved state: step=None the latest, "best" the best copy, or
        a step number. A sharded checkpoint is placed as `template` (a state
        whose DTensor leaves give the placements to read into; every leaf
        of it must be saved), else read whole; the reference's checkpoints
        come back converted (module docstring)."""
        self.wait()
        path = self._path(step)
        if os.path.exists(os.path.join(path, MANIFEST)):
            return self._restore_sharded(path, template, map_location)
        if os.path.exists(os.path.join(path, MSGPACK)):
            with open(os.path.join(path, MSGPACK), "rb") as f:
                tree = msgpack_restore(f.read())
            return _place(from_reference(_flatten(tree)), map_location)
        return torch.load(os.path.join(path, STATE_FILE),
                          map_location=map_location, weights_only=True)

    def _restore_sharded(self, path: str, template, map_location) -> dict:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        leaves = manifest["leaves"]
        if _is_reference(manifest):
            flat = {k: _read_leaf(path, k, meta) for k, meta in leaves.items()}
            flat = {k: v.numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in flat.items()}
            return _place(from_reference(flat), map_location)
        targets = _flatten(template) if template is not None else {}
        missing = [k for k in targets if k not in leaves]
        if missing:
            raise ValueError(
                f"sharded checkpoint at {path} lacks template leaves "
                f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
        return _unflatten({k: _read_leaf(path, k, meta, targets.get(k),
                                         map_location)
                           for k, meta in leaves.items()
                           if template is None or k in targets})

    def restore_params(self, step=None, map_location=None) -> dict:
        """Just the model's state_dict (for serving), whole tensors."""
        self.wait()
        path = self._path(step)
        if os.path.exists(os.path.join(path, MANIFEST)):
            with open(os.path.join(path, MANIFEST)) as f:
                leaves = json.load(f)["leaves"]
            if not any(k.startswith("params/") for k in leaves):
                return {k[len("model/"):]: _read_leaf(path, k, meta,
                                                      map_location=map_location)
                        for k, meta in leaves.items() if k.startswith("model/")}
        return self.restore(step, map_location)["model"]

    def metadata(self, step=None) -> dict:
        self.wait()
        with open(os.path.join(self._path(step), "meta.json")) as f:
            return json.load(f)
