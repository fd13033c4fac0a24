"""Carry weights between the reference's flax parameter tree and the port.

The flax tree comes in as a nested mapping of numpy arrays (e.g. the params
of `tpu_deer.models.deer_model.create_complete_deer_model` passed through
`np.asarray`); nothing here imports JAX. Names map segment by segment:

  flax                                  torch state_dict
  .../block_{i}/...                     .../blocks.{i}/...
  deer_head_{name}/...                  heads.{name}/...
  block_{i}/Dense_0, block_{i}/LayerNorm_0   blocks.{i}.dense, blocks.{i}.norm
  Dense_{i} (estimator, weight network,
             evidence network)          layers.{i}
  */kernel [in, out]                    */weight [out, in]
  */scale (LayerNorm)                   */weight
  calibration/cal{1,2,3}_{kernel,bias}, calibration/temperature
                                        unchanged (same names and layout;
                                        temperature stays pre-softplus)

Every other segment (input_proj, q_proj, av_fusion_in, ...) is the same on
both sides.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Iterator

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: tuple = ()) -> Iterator[tuple[tuple, np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _torch_key(path: tuple[str, ...]) -> tuple[str, bool]:
    """flax path → (state_dict key, whether the leaf is transposed)."""
    out = []
    for i, seg in enumerate(path[:-1]):
        parent = path[i - 1] if i else ""
        if m := re.fullmatch(r"block_(\d+)", seg):
            out += ["blocks", m.group(1)]
        elif m := re.fullmatch(r"deer_head_(.+)", seg):
            out += ["heads", m.group(1)]
        elif m := re.fullmatch(r"Dense_(\d+)", seg):
            out += ["dense"] if parent.startswith("block_") else ["layers", m.group(1)]
        elif seg == "LayerNorm_0" and parent.startswith("block_"):
            out.append("norm")
        else:
            out.append(seg)
    leaf = path[-1]
    transposed = leaf == "kernel"
    out.append({"kernel": "weight", "scale": "weight"}.get(leaf, leaf))
    return ".".join(out), transposed


def _flax_path(key: str, ndim: int) -> tuple[tuple[str, ...], bool]:
    """state_dict key → (flax path, whether the leaf is transposed)."""
    toks = key.split(".")
    out, i = [], 0
    while i < len(toks) - 1:
        tok = toks[i]
        if tok in ("blocks", "heads", "layers"):
            nxt = toks[i + 1]
            out.append({"blocks": f"block_{nxt}", "heads": f"deer_head_{nxt}",
                        "layers": f"Dense_{nxt}"}[tok])
            i += 2
            continue
        out.append({"dense": "Dense_0", "norm": "LayerNorm_0"}.get(tok, tok))
        i += 1
    leaf = toks[-1]
    transposed = leaf == "weight" and ndim == 2
    if leaf == "weight":
        leaf = "kernel" if ndim == 2 else "scale"
    return tuple(out) + (leaf,), transposed


def flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) → the port's state_dict."""
    out = {}
    for path, leaf in _flatten(params):
        key, transposed = _torch_key(tuple(path))
        arr = np.ascontiguousarray(leaf.T if transposed else leaf)
        out[key] = torch.from_numpy(arr.copy())
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's state_dict → nested flax params (numpy leaves)."""
    tree: dict = {}
    for key, tensor in state_dict.items():
        arr = tensor.detach().cpu().numpy()
        path, transposed = _flax_path(key, arr.ndim)
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = np.ascontiguousarray(arr.T if transposed else arr)
    return tree
