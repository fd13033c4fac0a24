"""The port's parameter layouts (`tpu_deer_torch/parallel/mesh.py`) against
the reference's rules (`tpu_deer/parallel/mesh.py`) on the same trees, with
no process group: for every state_dict tensor, the mesh axis of each dim
equals the flax leaf's PartitionSpec carried through `convert.py`'s
transposes, and the pieces a layout cuts a tensor into are the shards JAX
places on the 8 virtual CPU devices (`tests/conftest.py`).

The torch dim that each flax dim becomes is found without the port's rule
code: every flax leaf is filled with distinct integers (its flat indices
plus an offset of its own), converted with `flax_to_state_dict`, and each
torch dim's step between neighbours is a flax dim's stride.
"""

import functools

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding

from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JConfig
from tpu_deer.parallel import mesh as jmesh
from tpu_deer_torch.convert import (
    flax_to_state_dict,
    stacked_flax_to_state_dict,
    state_dict_to_flax,
)
from tpu_deer_torch.models.deer_model import (
    DEERModelConfig,
    create_complete_deer_model,
)
from tpu_deer_torch.parallel import mesh as tmesh

# __graft_entry__.py's dryrun configuration, the flagship's stacked layout
# and its MoE fusion (member-stacked subtrees) at the same width.
DRYRUN = dict(audio_dim=16, video_dim=16, text_dim=16, encoder_dim=32,
              fusion_dim=64, attention_heads=4, encoder_layers=1, dropout=0.1)
MODELS = {"dryrun": DRYRUN, "stacked": {**DRYRUN, "stacked_compute": True},
          "moe": {**DRYRUN, "fusion_type": "moe"}}
LAYOUTS = [("tp", 1, 2), ("fsdp", 2, 1), ("fsdp", 4, 2), ("fsdp", 8, 1),
           ("replicated", 4, 2)]


@functools.lru_cache(maxsize=None)
def _params(name):
    """The model's flax tree: the port's seeded init converted, its paths
    and shapes checked against the reference's init traced with
    jax.eval_shape (no compile)."""
    cfg = MODELS[name]
    model = create_complete_deer_model(DEERModelConfig(**cfg), seed=0,
                                       device="cpu")
    params = state_dict_to_flax(model.state_dict())
    x = tuple(np.zeros((2, cfg[f"{m}_dim"]), np.float32)
              for m in ("audio", "video", "text"))
    shapes = jax.eval_shape(lambda: JModel(JConfig(**cfg)).init(
        jax.random.PRNGKey(0), *x))["params"]
    ref = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in got] == [p for p, _ in ref]
    assert all(a.shape == b.shape for (_, a), (_, b) in zip(ref, got))
    return params


def _indexed(params, stacked=False):
    """(flax leaves by path, the state_dict of their index arrays, each
    leaf's offset)."""
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    offsets, tree = [], {}
    total = 0
    for path, leaf in leaves:
        node = tree
        keys = [k.key for k in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.arange(total, total + leaf.size).reshape(leaf.shape)
        offsets.append(total)
        total += leaf.size
    sd = (stacked_flax_to_state_dict if stacked else flax_to_state_dict)(tree)
    return leaves, {k: v.numpy() for k, v in sd.items()}, offsets


def _expected(leaves, offsets, name, arr, mode, data, model, member=False):
    """The flax leaf's spec on the torch dims of `arr` (the converted index
    array of state_dict entry `name`)."""
    i = int(np.searchsorted(offsets, arr.min(), side="right")) - 1
    path, leaf = leaves[i]
    spec = tuple(jmesh.param_spec(path, leaf, mode, data, model))
    spec = spec + (None,) * (leaf.ndim - len(spec))
    strides = [int(np.prod(leaf.shape[k + 1:])) for k in range(leaf.ndim)]
    flat = arr - offsets[i]
    if member:  # one member of a stacked tensor holds a member's indices
        flat = flat - flat.min()
    out, used = [None] * arr.ndim, set()
    for j in range(arr.ndim):
        if arr.shape[j] > 1:
            step = int(np.take(flat, 1, axis=j).ravel()[0]
                       - np.take(flat, 0, axis=j).ravel()[0])
            k = next(k for k in range(leaf.ndim)
                     if strides[k] == step and leaf.shape[k] == arr.shape[j]
                     and k not in used)
            used.add(k)
            out[j] = k
    for j in range(arr.ndim):  # size-1 dims: the flax dims left, in order
        if out[j] is None:
            out[j] = next(k for k in range(leaf.ndim)
                          if k not in used and leaf.shape[k] == 1)
            used.add(out[j])
    return path, leaf, tuple(spec[k] for k in out), out


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("mode,data,model_size", LAYOUTS)
def test_specs_match_reference(model, mode, data, model_size):
    leaves, sd, offsets = _indexed(_params(model))
    assert len(sd) == len(leaves)
    for name, arr in sd.items():
        _, _, want, _ = _expected(leaves, offsets, name, arr, mode, data,
                                  model_size)
        got = tmesh.param_spec(name, arr.shape, mode, data, model_size)
        assert got == want, (name, got, want)


def test_ensemble_specs_match_reference():
    """The ensemble layout on a member-stacked state_dict (K = 4 over a
    "model" axis of 2, and of 3, which does not divide it)."""
    one = _params("dryrun")
    stacked = jax.tree_util.tree_map(lambda x: np.stack([x] * 4), one)
    leaves, sd, offsets = _indexed(stacked, stacked=True)
    for model_size in (2, 3):
        for name, arr in sd.items():
            _, leaf, _, _ = _expected(leaves, offsets, name, arr[0], "tp", 1,
                                      1, member=True)
            want = tuple(jmesh.ensemble_sharding_rules(None, leaf, model_size))
            want = want + (None,) * (arr.ndim - len(want))
            assert tmesh.param_spec(name, arr.shape, "ensemble", 1,
                                    model_size) == want, name


@pytest.mark.parametrize("mode,data,model_size", [("tp", 1, 2), ("fsdp", 2, 1),
                                                  ("fsdp", 4, 2)])
def test_stacked_specs_match_reference(mode, data, model_size):
    """The other layouts on a member-stacked state_dict (an ensemble's
    under a mesh, `member_dims=1`): the reference's rules read a stacked
    tree's leaves [K, ...] as they are (the member axis is a leaf axis, so
    fsdp may split it), carried to the torch dims."""
    one = _params("dryrun")
    stacked = jax.tree_util.tree_map(lambda x: np.stack([x] * 4), one)
    leaves, sd, offsets = _indexed(stacked, stacked=True)
    split = 0
    for name, arr in sd.items():
        path, leaf, _, axes = _expected(leaves, offsets, name, arr[0], "tp", 1,
                                        1, member=True)
        spec = tuple(jmesh.param_spec(path, leaf, mode, data, model_size))
        spec = spec + (None,) * (leaf.ndim - len(spec))
        assert 0 not in axes  # the member's dims are the stacked leaf's 1..
        want = (spec[0],) + tuple(spec[a] for a in axes)
        got = tmesh.param_spec(name, arr.shape, mode, data, model_size,
                               member_dims=1)
        assert got == want, (name, got, want)
        split += any(got)
    assert split > 0


def test_fsdp_at_data_4_shards_39_leaves():
    """On the dryrun's 4 × 2 the rules shard 39 of the 95 leaves over
    "data", on both sides. (MULTICHIP_r05.json's fsdp_sharded_leaves=41
    counts the parameters the reference's jitted step returned: XLA gives
    two more of its outputs a "data" sharding; the parameters it placed
    were 39.)"""
    leaves, sd, _ = _indexed(_params("dryrun"))
    specs = [tmesh.param_spec(n, a.shape, "fsdp", 4, 2) for n, a in sd.items()]
    assert sum("data" in s for s in specs) == 39 == sum(
        "data" in tuple(jmesh.param_spec(p, lf, "fsdp", 4, 2))
        for p, lf in leaves)
    assert sum("model" in s for s in specs) == sum(
        "model" in tmesh.param_sharding_rules(n, a.shape) for n, a in sd.items())


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown param_sharding mode"):
        tmesh.param_spec("fusion.av_fusion_in.weight", (64, 32), "zero3", 2)
    with pytest.raises(ValueError, match="unknown param_sharding mode"):
        jmesh.param_spec((), np.zeros((2, 2)), "zero3", 2)


@pytest.mark.parametrize("mode,data,model_size", [("fsdp", 4, 2), ("tp", 2, 2),
                                                  ("fsdp", 8, 1)])
def test_pieces_are_jax_shards(mode, data, model_size):
    """Every tensor's pieces (`all_regions`, the checkpoint's chunks) are
    the index ranges of JAX's shards of the flax leaf on a data × model
    mesh, carried to the torch dims."""
    leaves, sd, offsets = _indexed(_params("dryrun"))
    mesh = jmesh.create_mesh(jmesh.MeshConfig(data=data, model=model_size),
                             devices=jax.devices()[:data * model_size])
    sizes = {"data": data, "model": model_size}
    for name, arr in sd.items():
        path, leaf, spec, axes = _expected(leaves, offsets, name, arr, mode,
                                           data, model_size)
        jspec = jmesh.param_spec(path, leaf, mode, data, model_size)
        shards = NamedSharding(mesh, jspec).devices_indices_map(leaf.shape)
        want = sorted({tuple(tuple(_range(shards_idx[k], leaf.shape[k]))
                             for k in axes) for shards_idx in shards.values()})
        got = sorted(tuple(map(tuple, r)) for r in
                     tmesh.all_regions(arr.shape, spec, sizes))
        assert got == want, name


def _range(sl, n):
    return (0 if sl.start is None else sl.start, n if sl.stop is None else sl.stop)


@pytest.mark.parametrize("device,env,local_ids,want", [
    (None, {"LOCAL_RANK": "3"}, None, 3),
    ("cuda", {"LOCAL_RANK": "3"}, None, 3),
    ("cuda", {}, None, 6 % 4),
    ("cuda", {"LOCAL_RANK": "3"}, (1,), 1),
    ("cuda:2", {"LOCAL_RANK": "3"}, None, 2),
])
def test_runtime_picks_each_rank_its_card(monkeypatch, device, env, local_ids,
                                          want):
    """`initialize_runtime` on NCCL binds rank 6 of 8 (four cards a host)
    to its own card, whether the device is left to it or given as "cuda"
    without an index (as `cli --platform cuda` gives it): the config's
    local_device_ids, else LOCAL_RANK, else the rank modulo the card count;
    an explicit index stands. No group is started: the calls are
    recorded."""
    import torch

    from tpu_deer_torch.parallel import runtime as truntime

    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.setdefault("set_device", d))
    monkeypatch.setattr(truntime.dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend, **kw))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rt = truntime.initialize_runtime(truntime.RuntimeConfig(
        coordinator_address="127.0.0.1:1", num_processes=8, process_id=6,
        local_device_ids=local_ids), device=device)
    assert rt.device == torch.device("cuda", want)
    assert calls["set_device"] == torch.device("cuda", want)
    assert calls["backend"] == "nccl" and calls["device_id"] == rt.device
    assert calls["rank"] == 6 and calls["world_size"] == 8
