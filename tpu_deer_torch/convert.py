"""Carry weights between the reference's flax parameter tree and the port.

The flax tree comes in as a nested mapping of numpy arrays (e.g. a model's
params passed through `np.asarray`); nothing here imports JAX. Both
directions are exact (transposes and copies only) for the flagship
`CompleteDEERModel` and for `RawSequenceDEERModel`. Names map segment by
segment:

  flax                                  torch state_dict
  block_{i}                             blocks.{i}
  deer_head_{name}                      heads.{name}
  conv_{i}                              convs.{i}
  block_{i}/Dense_0, block_{i}/LayerNorm_0   blocks.{i}.dense, blocks.{i}.norm
                                        (ResidualBlock)
  LayerNorm_0, LayerNorm_1, MultiHeadAttention_0, MLP_0
                                        norm1, norm2, attn, mlp
                                        (TransformerBlock)
  Conv_0, Conv_1, GroupNorm_0           conv1, conv2, group_norm (ConvBlock)
  any other Dense_{i}                   layers.{i}
  */kernel [in, out]                    */weight [out, in]
  */kernel [k, in, out] (Conv over time)    */weight [out, in, k]
  */kernel [kh, kw, in, out] (HWIO)     */weight [out, in, kh, kw] (OIHW)
  */scale (LayerNorm, GroupNorm)        */weight
  embed/embedding                       embed.weight
  {fwd,bwd}_{l}/{ii,if,ig,io}/kernel    lstm.weight_ih_l{l}[_reverse] rows
                                        i, f, g, o (each [H, in])
  {fwd,bwd}_{l}/{hi,hf,hg,ho}/kernel    lstm.weight_hh_l{l}[_reverse]
  {fwd,bwd}_{l}/{hi,hf,hg,ho}/bias      lstm.bias_hh_l{l}[_reverse]
  (no leaf: flax's input kernels        lstm.bias_ih_l{l}[_reverse] = 0
   carry no bias)
  calibration/cal{1,2,3}_{kernel,bias}, calibration/temperature
                                        unchanged

Every other segment (input_proj, q_proj, av_fusion_in, head_valence, ...)
is the same on both sides; BilinearFusion's `bilinear_kernel` [in_a, in_b,
out] keeps flax's layout.

Member-stacked subtrees (flax's `nn.vmap` with a leading member axis on
every leaf: the stacked layout's `stacked_encoders/trunk` and
`stacked_heads/evidence_network`, MoEFusion's `experts`) convert member by
member, each member as its unstacked counterpart would, and stack again:
a Dense kernel [E, in, out] becomes a weight [E, out, in].
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_GATES = ("i", "f", "g", "o")  # torch's LSTM row order, as flax's cell
_LSTM_CELL = {f"{w}{g}" for w in "ih" for g in _GATES}
_LSTM_KEY = re.compile(r"(?:(.*)\.)?lstm\.(weight_ih|weight_hh|bias_ih|bias_hh)"
                       r"_l(\d+)(_reverse)?")
_TRANSFORMER = {"LayerNorm_0": "norm1", "LayerNorm_1": "norm2",
                "MultiHeadAttention_0": "attn", "MLP_0": "mlp"}
_CONV_BLOCK = {"Conv_0": "conv1", "Conv_1": "conv2", "GroupNorm_0": "group_norm"}
_TO_FLAX = {v: k for k, v in {**_TRANSFORMER, **_CONV_BLOCK}.items()}
_TO_FLAX["dense"] = "Dense_0"
# Kernel layouts: flax → torch axes, by rank.
_KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def _torch_segment(seg: str, parent: str, siblings) -> list[str]:
    if m := re.fullmatch(r"block_(\d+)", seg):
        return ["blocks", m.group(1)]
    if m := re.fullmatch(r"deer_head_(.+)", seg):
        return ["heads", m.group(1)]
    if m := re.fullmatch(r"conv_(\d+)", seg):
        return ["convs", m.group(1)]
    if m := re.fullmatch(r"Dense_(\d+)", seg):
        return ["dense"] if parent.startswith("block_") else ["layers", m.group(1)]
    if "LayerNorm_1" in siblings and seg in _TRANSFORMER:
        return [_TRANSFORMER[seg]]
    if seg == "LayerNorm_0" and parent.startswith("block_"):
        return ["norm"]
    return [_CONV_BLOCK.get(seg, seg)]


def _torch_leaf(name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        return "weight", arr.transpose(_KERNEL_AXES[arr.ndim])
    return {"scale": "weight", "embedding": "weight"}.get(name, name), arr


def _lstm_cell(cell: Mapping, prefix: list[str], layer: str, reverse: bool,
               out: dict) -> None:
    """One flax OptimizedLSTMCell → nn.LSTM's four tensors of one layer and
    direction."""
    sfx = f"_l{layer}" + ("_reverse" if reverse else "")
    gates = lambda w, leaf: [np.asarray(cell[f"{w}{g}"][leaf]) for g in _GATES]
    w_ih = np.concatenate([k.T for k in gates("i", "kernel")])
    base = ".".join(prefix + ["lstm"])
    out[f"{base}.weight_ih{sfx}"] = w_ih
    out[f"{base}.weight_hh{sfx}"] = np.concatenate(
        [k.T for k in gates("h", "kernel")])
    out[f"{base}.bias_ih{sfx}"] = np.zeros(w_ih.shape[0], w_ih.dtype)
    out[f"{base}.bias_hh{sfx}"] = np.concatenate(gates("h", "bias"))


# (parent, segment) of a member-stacked subtree; None matches any parent.
_MEMBER_STACKED = (("stacked_encoders", "trunk"),
                   ("stacked_heads", "evidence_network"), (None, "experts"))


def _is_member_stacked(parent: str, seg: str) -> bool:
    return any(seg == s and p in (None, parent) for p, s in _MEMBER_STACKED)


def member_axes(key: str) -> int:
    """1 if state_dict entry `key` lies in a member-stacked subtree (its
    tensors carry a leading member axis), else 0."""
    toks = key.split(".")
    return int(any(_is_member_stacked(toks[i - 1] if i else "", tok)
                   for i, tok in enumerate(toks[:-1])))


def _flax_to_arrays(params: Mapping, parent: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}

    def walk(node: Mapping, parent: str, prefix: list[str]) -> None:
        for key, value in node.items():
            if not isinstance(value, Mapping):
                name, arr = _torch_leaf(key, np.asarray(value))
                out[".".join(prefix + [name])] = arr
            elif (m := re.fullmatch(r"(fwd|bwd)_(\d+)", key)) and set(value) == _LSTM_CELL:
                _lstm_cell(value, prefix, m.group(2), m.group(1) == "bwd", out)
            elif _is_member_stacked(parent, key):
                here = ".".join(prefix + _torch_segment(key, parent, node))
                members = [_flax_to_arrays(_unstack(value, k), key)
                           for k in range(_members(value) or 1)]
                for name, arr in members[0].items():
                    out[f"{here}.{name}"] = (arr if arr.size == 0 else
                                             np.stack([m[name] for m in members]))
            else:
                walk(value, key, prefix + _torch_segment(key, parent, node))

    walk(params, parent, [])
    return out


def flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) → the port's state_dict."""
    return {k: torch.from_numpy(np.ascontiguousarray(v).copy())
            for k, v in _flax_to_arrays(params).items()}


def _flax_path(key: str) -> tuple[str, ...]:
    """A state_dict key (not an LSTM tensor) → its flax path."""
    toks = key.split(".")
    out, i = [], 0
    while i < len(toks) - 1:
        tok = toks[i]
        if tok in ("blocks", "heads", "layers", "convs"):
            nxt = toks[i + 1]
            out.append({"blocks": f"block_{nxt}", "heads": f"deer_head_{nxt}",
                        "layers": f"Dense_{nxt}", "convs": f"conv_{nxt}"}[tok])
            i += 2
            continue
        in_block = i >= 2 and toks[i - 2] in ("blocks", "convs")
        if tok == "norm" and i >= 2 and toks[i - 2] == "blocks":
            out.append("LayerNorm_0")  # ResidualBlock
        elif in_block:  # a transformer block's, ResidualBlock's or ConvBlock's
            out.append(_TO_FLAX.get(tok, tok))
        else:
            out.append(tok)
        i += 1
    return tuple(out) + (toks[-1],)


def flax_leaf(key: str, ndim: int) -> str:
    """The flax leaf name of state_dict entry `key` of rank `ndim` (not an
    LSTM tensor): "kernel" for a Linear or conv weight, "embedding",
    "scale" for a norm's weight; other names are unchanged. The member axis
    of a member-stacked subtree does not count in `ndim`'s reading."""
    path = _flax_path(key)
    if path[-1] != "weight":
        return path[-1]
    if len(path) >= 2 and path[-2] == "embed":
        return "embedding"
    return "scale" if ndim - member_axes(key) == 1 else "kernel"


def flax_quantized_to_state_dict(q_tree: Mapping, scale_tree: Mapping
                                 ) -> tuple[dict, dict]:
    """The reference's `quantize_tree` output (q_tree, scale_tree) → the
    port's (q state_dict, scale state_dict): int8 kernels transposed to the
    state_dict's layout, per-output-channel scales [out], the empty scale
    of a leaf that is not quantized unchanged. Flagship leaves (no LSTM)."""
    def as_row(node: Mapping) -> dict:
        # A "kernel" scale [out] as [1, out], so the kernel transpose makes
        # it [out, 1]; an empty scale [0] as [1, 0].
        return {k: as_row(v) if isinstance(v, Mapping)
                else np.asarray(v).reshape(1, -1) if k == "kernel"
                else np.asarray(v) for k, v in node.items()}

    scales = flax_to_state_dict(as_row(scale_tree))
    return (flax_to_state_dict(q_tree),
            {k: v.reshape(-1) for k, v in scales.items()})


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's state_dict → nested flax params (numpy leaves). Raises if
    an LSTM input bias is not zero (flax's cell has no such parameter)."""
    tree: dict = {}

    def put(path: tuple[str, ...], arr: np.ndarray) -> None:
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = np.ascontiguousarray(arr)

    stacked: dict[str, dict] = {}  # member-stacked subtree → its entries
    for key, tensor in state_dict.items():
        toks = key.split(".")
        cut = next((i for i, tok in enumerate(toks[:-1])
                    if _is_member_stacked(toks[i - 1] if i else "", tok)), None)
        if cut is not None:
            head, rest = ".".join(toks[:cut + 1]), ".".join(toks[cut + 1:])
            stacked.setdefault(head, {})[rest] = tensor
            continue
        arr = tensor.detach().cpu().numpy()
        if m := _LSTM_KEY.fullmatch(key):
            prefix, kind, layer, reverse = m.groups()
            if kind == "bias_ih":
                if np.any(arr):
                    raise ValueError(f"{key} is not zero: flax's LSTM cell "
                                     f"has no input bias")
                continue
            parent = _flax_path(prefix + ".x")[:-1] if prefix else ()
            cell = parent + (f"{'bwd' if reverse else 'fwd'}_{layer}",)
            w = "i" if kind == "weight_ih" else "h"
            for g, part in zip(_GATES, np.split(arr, 4)):
                if kind == "bias_hh":
                    put(cell + (f"h{g}", "bias"), part)
                else:
                    put(cell + (f"{w}{g}", "kernel"), part.T)
            continue
        path = _flax_path(key)
        leaf = flax_leaf(key, arr.ndim)
        if leaf == "kernel":
            arr = arr.transpose(np.argsort(_KERNEL_AXES[arr.ndim]))
        put(path[:-1] + (leaf,), arr)
    for head, entries in stacked.items():
        node = tree
        for seg in _flax_path(head + ".x")[:-1]:
            node = node.setdefault(seg, {})
        node.update(state_dict_to_stacked_flax(entries))
    return tree


# -- member-stacked trees (deep ensembles) ------------------------------------

def _unstack(tree: Mapping, k: int) -> dict:
    """Member `k` of a tree whose leaves carry a leading member axis; an
    empty leaf (the quantizer's scale of a leaf it passes through, which is
    not stacked) is the same for every member."""
    return {key: _unstack(v, k) if isinstance(v, Mapping)
            else (np.asarray(v) if np.size(v) == 0 else np.asarray(v)[k])
            for key, v in tree.items()}


def _members(tree: Mapping) -> int:
    """The member count of a stacked tree (None where every leaf is empty)."""
    for v in tree.values():
        n = _members(v) if isinstance(v, Mapping) else (
            None if np.size(v) == 0 else np.shape(v)[0])
        if n is not None:
            return n
    return None


def _stack_state(dicts: list) -> dict[str, torch.Tensor]:
    return {k: (dicts[0][k] if dicts[0][k].numel() == 0
                else torch.stack([d[k] for d in dicts]))
            for k in dicts[0]}


def stacked_flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """A member-stacked flax tree (every leaf [K, ...], as the reference's
    `create_deer_ensemble` builds it) → a state_dict of [K, ...] tensors in
    the port's layout (a Linear weight [K, out, in])."""
    return _stack_state([flax_to_state_dict(_unstack(params, k))
                         for k in range(_members(params))])


def state_dict_to_stacked_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of `stacked_flax_to_state_dict` (empty entries, which carry
    no member axis, stay as they are)."""
    n = next((v.shape[0] for v in state_dict.values() if v.numel()), 1)
    trees = [state_dict_to_flax({k: v if v.numel() == 0 else v[i]
                                 for k, v in state_dict.items()})
             for i in range(n)]

    def stack(nodes):
        first = nodes[0]
        return {key: stack([n[key] for n in nodes]) if isinstance(first[key], Mapping)
                else first[key] if np.size(first[key]) == 0
                else np.stack([n[key] for n in nodes]) for key in first}

    return stack(trees)


def stacked_flax_quantized_to_state_dict(q_tree: Mapping, scale_tree: Mapping
                                         ) -> tuple[dict, dict]:
    """The reference's `quantize_tree(..., member_stacked=True)` output →
    the port's: int8 kernels [K, in, out] → [K, out, in], scales [K, out],
    the empty scale of a leaf that is not quantized unchanged."""
    pairs = [flax_quantized_to_state_dict(_unstack(q_tree, k),
                                          _unstack(scale_tree, k))
             for k in range(_members(q_tree))]
    return (_stack_state([q for q, _ in pairs]),
            _stack_state([s for _, s in pairs]))
