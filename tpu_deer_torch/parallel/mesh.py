"""Device mesh and parameter layouts on torch.distributed: port of
`tpu_deer/parallel/mesh.py`.

  * The mesh is a 2-D `DeviceMesh` with axes ("data", "model") over the
    processes of the default process group, one device a process, rank r
    at (r // model, r % model): "data" outermost, as in the reference.
    Batches shard over "data"; parameters are laid out by the rules below.
  * The rules give, for each `state_dict` tensor, the mesh axis that each
    of its dimensions is split over (None: not split), in the tensor's own
    axis order. They are the reference's rules on the flax tree, read
    through `convert.py`: a tensor's flax path decides what is split, a
    flax Dense kernel [in, out] is a torch weight [out, in] (so "shard the
    out axis" is torch dim 0), and FSDP's "largest axis divisible by the
    data size" is chosen among the flax leaf's axes in flax's order, ties
    to the first, then carried to the torch axis.
  * `shard_params` places each tensor as a `DTensor` on the mesh: `Shard(d)`
    along a mesh axis that splits dim d, `Replicate()` along the others.
    A split follows `torch.chunk` (pieces of ceil(n / k) rows, the last ones
    shorter or empty), the boundaries JAX's uneven shards take. Every
    process holds the full tensor (a seeded init, or a checkpoint) and keeps
    its own piece, so placing takes no communication.

`MeshLayout` is what the trainer uses: the pieces its `state_dict()` gives,
the all-gather of the outputs and the all-reduce of the gradients over
"data", and the global batch's dropout masks (`row_dropout`; see
`train/trainer.py`). `shard_moe_params` places a state_dict on an expert
axis (the reference's expert-parallel layout) and `expert_parallel` makes
each MoEFusion of a module hold and run only its process's experts
(`_ExpertParallelMoE`, a subclass of `models/fusion.py:MoEFusion` given to
each instance; the model layer knows nothing of process groups).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_deer_torch.convert import _KERNEL_AXES, flax_key, member_axes
from tpu_deer_torch.models.layers import dense, softmax
from tpu_deer_torch.parallel.collectives import psum, sum_grads

AXES = ("data", "model")
PARAM_SHARDING_MODES = ("tp", "fsdp", "replicated", "ensemble")
# The reference's tensor-parallel tags (`tpu_deer/parallel/mesh.py:70-78`).
TP_TAGS = ("av_fusion_in", "av_fusion_out", "trimodal_fusion_in",
           "trimodal_fusion_out", "fusion_gate", "input_proj", "output_proj")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: all remaining processes
    model: int = 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def create_mesh(config: Optional[MeshConfig] = None,
                device_type: Optional[str] = None):
    """A ("data", "model") `DeviceMesh` over the processes of the default
    process group (`parallel/runtime.py:initialize_runtime` starts it).
    `device_type`: "cuda" or "cpu"; None takes "cuda" under NCCL, else
    "cpu". Raises ValueError when data × model is not the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    n = world_size()
    model = max(1, config.model)
    data = config.data if config.data > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not match {n} devices")
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "parallel.runtime.initialize_runtime first")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def mesh_shape(mesh) -> dict[str, int]:
    """{"data": size, "model": size} of a mesh (1 for an absent axis)."""
    names = mesh.mesh_dim_names or ()
    return {a: (mesh.size(names.index(a)) if a in names else 1) for a in AXES}


# -- layout rules on the flax tree --------------------------------------------

def flax_view(name: str, shape: Sequence[int]):
    """(flax path, flax shape, axes) of state_dict tensor `name`: the
    tensor's dim j is the flax leaf's dim axes[j]. An LSTM tensor, which
    has no single flax leaf, gives None."""
    if ".lstm." in f".{name}":
        return None
    ndim = len(shape)
    path = flax_key(name, ndim)
    lead = member_axes(name)
    axes = tuple(range(ndim))
    if path[-1] == "kernel":
        inner = _KERNEL_AXES[ndim - lead]
        axes = tuple(range(lead)) + tuple(lead + a for a in inner)
    flax_shape = [0] * ndim
    for j, a in enumerate(axes):
        flax_shape[a] = int(shape[j])
    return "/".join(path), tuple(flax_shape), axes


def _tp_spec(path: str, flax_shape) -> list:
    ndim = len(flax_shape)
    if ndim >= 2 and any(tag in path for tag in TP_TAGS):
        return [None] * (ndim - 1) + ["model"]
    return [None] * ndim


def flax_param_spec(path: str, flax_shape: Sequence[int], mode: str,
                    data_size: int, model_size: int = 1) -> tuple:
    """The reference's `param_spec` on a flax leaf (its "/"-joined path and
    shape): the mesh axis of each flax dim, or None."""
    ndim = len(flax_shape)
    if mode == "tp":
        return tuple(_tp_spec(path, flax_shape))
    if mode == "fsdp":
        spec = _tp_spec(path, flax_shape)
        if ndim < 2 or data_size <= 1:
            return tuple(spec)
        candidates = [i for i in range(ndim)
                      if spec[i] is None and flax_shape[i] % data_size == 0]
        if candidates:
            spec[max(candidates, key=lambda i: flax_shape[i])] = "data"
        return tuple(spec)
    if mode == "ensemble":
        if ndim >= 1 and model_size > 1 and flax_shape[0] % model_size == 0:
            return ("model",) + (None,) * (ndim - 1)
        return (None,) * ndim
    if mode == "replicated":
        return (None,) * ndim
    raise ValueError(f"unknown param_sharding mode {mode!r}; expected one of "
                     f"{PARAM_SHARDING_MODES}")


def param_spec(name: str, shape: Sequence[int], mode: str, data_size: int,
               model_size: int = 1, member_dims: int = 0) -> tuple:
    """The mesh axis ("data", "model" or None) of each dim of state_dict
    tensor `name` of `shape` under layout `mode` ('tp', 'fsdp', 'ensemble'
    or 'replicated'; another raises ValueError). An LSTM tensor follows the
    rules as a plain tensor of its own shape. `member_dims` leading axes
    are a stack's member axes ([K, ...] on both sides: a deep ensemble's
    parameters), which the rules see as the flax leaf's leading axes, as
    the reference's rules see a stacked tree's leaves; under 'ensemble' the
    tensor is such a stack, read as it is."""
    view = None if mode == "ensemble" else flax_view(name, shape[member_dims:])
    if view is None:
        return flax_param_spec(name, tuple(shape), mode, data_size, model_size)
    path, flax_shape, axes = view
    lead = tuple(int(n) for n in shape[:member_dims])
    axes = tuple(range(member_dims)) + tuple(member_dims + a for a in axes)
    flax_spec = flax_param_spec(path, lead + flax_shape, mode, data_size,
                                model_size)
    return tuple(flax_spec[a] for a in axes)


def param_sharding_rules(name: str, shape: Sequence[int]) -> tuple:
    """The tensor-parallel layout: the out axis of the fusion and projection
    kernels over "model", the rest replicated."""
    return param_spec(name, shape, "tp", 1)


def fsdp_sharding_rules(name: str, shape: Sequence[int], data_size: int) -> tuple:
    """ZeRO-style: the largest axis of every >= 2-D tensor that the data
    size divides, over "data", composed with the tensor-parallel rules;
    1-D tensors stay replicated."""
    return param_spec(name, shape, "fsdp", data_size)


def ensemble_sharding_rules(name: str, shape: Sequence[int],
                            model_size: int) -> tuple:
    """A member-stacked tensor's leading member axis over "model" (where
    the member count divides it)."""
    return param_spec(name, shape, "ensemble", 1, model_size)


# -- placement ------------------------------------------------------------------

def placements(spec: Sequence[Optional[str]], axes: Sequence[str] = AXES):
    """The DTensor placements (one a mesh axis, in `axes`' order: "data"
    then "model" by default) of a spec."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(spec.index(axis)) if axis in spec else Replicate()
                 for axis in axes)


def batch_sharding(mesh=None):
    """The placements of a batch: rows split over "data", replicated over
    "model"."""
    return placements(("data",))


def replicated_sharding(mesh=None):
    return placements(())


def coordinate(mesh) -> dict[str, int]:
    """This process's coordinate on each mesh axis."""
    coords = mesh.get_coordinate() or [0] * mesh.ndim
    names = mesh.mesh_dim_names or AXES
    return {a: (coords[names.index(a)] if a in names else 0) for a in AXES}


def chunk_range(length: int, parts: int, index: int) -> tuple[int, int]:
    """[start, stop) of piece `index` of `parts` along an axis of `length`
    (torch.chunk's split: pieces of ceil(length / parts))."""
    size = math.ceil(length / parts) if length else 0
    start = min(length, index * size)
    return start, min(length, start + size)


def region(shape: Sequence[int], spec: Sequence[Optional[str]],
           sizes: Mapping[str, int], coords: Mapping[str, int]) -> list:
    """[[start, stop], ...] of the piece at `coords` of a tensor of `shape`
    laid out by `spec` on a mesh of `sizes`."""
    return [list(chunk_range(n, sizes[a], coords[a])) if a else [0, n]
            for n, a in zip(shape, spec)]


def all_regions(shape, spec, sizes) -> list:
    """The distinct pieces of a tensor over every mesh coordinate, sorted."""
    out = {tuple(map(tuple, region(shape, spec, sizes, {"data": d, "model": m})))
           for d in range(sizes["data"]) for m in range(sizes["model"])}
    return [list(map(list, r)) for r in sorted(out)]


def local_piece(tensor: torch.Tensor, spec, sizes, coords) -> torch.Tensor:
    """The view of `tensor` that this coordinate holds."""
    for dim, (start, stop) in enumerate(region(tensor.shape, spec, sizes, coords)):
        tensor = tensor.narrow(dim, start, stop - start)
    return tensor


def to_dtensor(local: torch.Tensor, mesh, spec, shape) -> Any:
    """`local` (this process's piece) as a DTensor of global `shape`."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = tuple(int(s) for s in torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local, mesh, placements(spec, mesh.mesh_dim_names),
                              run_check=False, shape=shape, stride=stride)


def shard_params(params: Mapping[str, torch.Tensor], mesh, mode: str = "tp") -> dict:
    """A state_dict placed on the mesh: name → DTensor laid out by `mode`
    ('tp', 'fsdp', 'ensemble' or 'replicated'). Every process passes the
    full tensors and keeps its piece (a copy)."""
    sizes, coords = mesh_shape(mesh), coordinate(mesh)
    out = {}
    for name, t in params.items():
        spec = param_spec(name, t.shape, mode, sizes["data"], sizes["model"])
        piece = local_piece(t.detach(), spec, sizes, coords).clone()
        out[name] = to_dtensor(piece, mesh, spec, t.shape)
    return out


def shard_batch(batch: Mapping[str, Any], mesh,
                device: Optional[torch.device] = None) -> dict[str, torch.Tensor]:
    """This process's rows of a host batch sharded over "data" (the rows of
    its data coordinate; every process of one data coordinate holds the
    same rows), as tensors on `device`."""
    sizes, coords = mesh_shape(mesh), coordinate(mesh)
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(np.ascontiguousarray(v)) if not torch.is_tensor(v) else v
        start, stop = chunk_range(v.shape[0], sizes["data"], coords["data"])
        out[k] = v[start:stop].to(device) if device is not None else v[start:stop]
    return out


class _GatherRows(torch.autograd.Function):
    """All-gather of row blocks over a group, as a differentiable op of a
    loss that every rank of the group computes alike: the backward returns
    this rank's rows of the (identical) cotangent, with no communication."""

    @staticmethod
    def forward(ctx, x, group, index, size):
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.index, ctx.rows = index, x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(0, ctx.index * ctx.rows, ctx.rows), None, None, None


class MeshLayout:
    """The layout of a trainer's parameters on a mesh (`mode` as
    `shard_params`). Every process keeps the whole parameters and optimizer
    state and runs the same update on them: the step is replicated data
    parallelism whatever the layout (the gradients of each process's rows
    summed over "data"). The layout decides the pieces that `dtensor` gives
    (the trainer's `state_dict()`), and so what each process of a sharded
    checkpoint writes. A tensor is *split* where a mesh axis of size > 1
    divides it."""

    def __init__(self, mesh, mode: str, params: Mapping[str, torch.Tensor],
                 member_dims: int = 0):
        self.mesh = mesh
        self.mode = mode
        self.sizes, self.coords = mesh_shape(mesh), coordinate(mesh)
        self.specs = {n: param_spec(n, p.shape, mode, self.sizes["data"],
                                    self.sizes["model"], member_dims)
                      for n, p in params.items()}
        self.split = [n for n, s in self.specs.items()
                      if any(a and self.sizes[a] > 1 for a in s)]
        self.data_group = mesh.get_group("data") if self.sizes["data"] > 1 else None

    def dtensor(self, name: str, full: torch.Tensor):
        """This process's piece of the whole tensor `full` (a view) as a
        DTensor placed by the layout."""
        spec = self.specs[name]
        return to_dtensor(local_piece(full, spec, self.sizes, self.coords),
                          self.mesh, spec, full.shape)

    def rows(self, n: int) -> slice:
        """This process's rows of a global batch of `n` rows."""
        return slice(*chunk_range(n, self.sizes["data"], self.coords["data"]))

    # -- the step's collectives ------------------------------------------------
    def gather_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The global batch's rows of `x` (this process's rows along `dim`),
        gathered over "data"; differentiable (`_GatherRows`)."""
        if self.data_group is None:
            return x
        return _GatherRows.apply(x.movedim(dim, 0), self.data_group,
                                 self.coords["data"],
                                 self.sizes["data"]).movedim(0, dim)

    def reduce_grads(self, grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Σ over "data" of every rank's gradients (each from its own rows),
        in one all-reduce of the flattened gradients."""
        if self.data_group is None:
            return list(grads)
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.data_group)
        out, offset = [], 0
        for g in grads:
            out.append(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return out

    def dropout(self, model: torch.nn.Module):
        """A context in which `model`'s dropouts draw the masks of the
        global batch and keep this process's rows (`row_dropout`); a no-op
        where "data" is 1."""
        if self.data_group is None:
            return contextlib.nullcontext()
        return row_dropout(model, self.coords["data"], self.sizes["data"])


def _row_dropout(module: torch.nn.Dropout, batch_dim: int, index: int,
                 parts: int, x: torch.Tensor) -> torch.Tensor:
    if not module.training:
        return x
    shape = list(x.shape)
    rows = shape[batch_dim]
    shape[batch_dim] = rows * parts
    noise = F.dropout(torch.ones(shape, dtype=x.dtype, device=x.device),
                      module.p, True).narrow(batch_dim, index * rows, rows)
    return x.mul_(noise) if module.inplace else x * noise


@contextlib.contextmanager
def row_dropout(model: torch.nn.Module, index: int, parts: int):
    """Run the body with every `nn.Dropout` of `model` applying the rows of
    block `index` (of `parts`) of the mask that it draws for the global
    batch, whose batch axis is `parts` times this process's: from one
    generator state every process of a data-parallel step draws the masks
    that one forward over the global batch draws, as the reference's step
    over global arrays does, not one mask a shard repeated. The mask is
    `F.dropout` of ones, the noise `F.dropout` multiplies its input by,
    and it advances the generator as a dropout of the global batch does.
    The batch axis is a module's leading member axes (`convert.member_axes`:
    1 inside a member-stacked subtree, else 0). A checkpointed forward
    enters the context again when it is recomputed."""
    swapped = []
    for name, module in model.named_modules():
        if isinstance(module, torch.nn.Dropout):
            module.forward = functools.partial(
                _row_dropout, module, member_axes(f"{name}.p"), index, parts)
            swapped.append(module)
    try:
        yield
    finally:
        for module in swapped:
            del module.forward


# -- expert parallelism -----------------------------------------------------------

def _is_expert(name: str) -> bool:
    return "experts" in name.split(".")


def shard_moe_params(params: Mapping[str, torch.Tensor], mesh,
                     axis_name: str = "expert") -> dict:
    """The reference's expert-parallel placement of a state_dict: tensors
    under an `experts` module (their leading axis the expert axis) split
    along it over the `axis_name` axis of `mesh` (any DeviceMesh that has
    it), everything else (the gate, the rest of the model) replicated.
    Every process passes the full tensors and keeps its piece (a copy), as
    `shard_params`; name → DTensor."""
    parts = mesh.size(list(mesh.mesh_dim_names).index(axis_name))
    index = mesh.get_local_rank(axis_name)
    out = {}
    for name, t in params.items():
        spec = (None,) * t.dim()
        piece = t.detach()
        if _is_expert(name) and t.dim() >= 1:
            spec = (axis_name,) + spec[1:]
            piece = piece[slice(*chunk_range(t.shape[0], parts, index))]
        out[name] = to_dtensor(piece.clone(), mesh, spec, t.shape)
    return out


class _ExpertParallelMoE:
    """The forward of a MoEFusion that holds experts [lo, hi) of E only
    (`expert_parallel` sets the class of each instance to a subclass that
    puts this first): it runs those experts, weights them by their columns
    of the replicated gate, and one psum over the group sums the blend.
    The gate's and the input's gradients from the experts are summed over
    the group (each process's part comes from its experts); the experts'
    are their own."""

    expert_group = None
    expert_range = (0, 0)

    def forward(self, modalities) -> torch.Tensor:
        group = self.expert_group
        x = torch.cat(list(modalities), dim=-1)
        gate = softmax(dense(self.gate, x, self.dtype))  # [B, E]
        start, stop = self.expert_range
        outs = self.experts(sum_grads(x, group))  # [E_local, B, D]
        gate = sum_grads(gate, group)[:, start:stop]
        return psum(torch.einsum("be,ebd->bd", gate.to(outs.dtype), outs), group)


@functools.lru_cache(maxsize=None)
def _expert_parallel_class(base: type) -> type:
    return type("ExpertParallel" + base.__name__, (_ExpertParallelMoE, base), {})


def expert_parallel(model: torch.nn.Module, mesh,
                    axis_name: str = "expert") -> torch.nn.Module:
    """Make every MoEFusion of `model` expert-parallel over the `axis_name`
    axis of `mesh`: each process keeps its experts (`torch.chunk`'s split
    of E, the pieces `shard_moe_params` gives: rows of every expert
    parameter) and runs only those, and one psum over the axis sums the
    gate-weighted blend (`_ExpertParallelMoE`). Every process starts from
    the same full model (a seeded init, or a checkpoint). In place;
    returns `model`."""
    from tpu_deer_torch.models.fusion import MoEFusion

    names = list(mesh.mesh_dim_names)
    parts = mesh.size(names.index(axis_name))
    index = mesh.get_local_rank(axis_name)
    group = mesh.get_group(axis_name)
    for module in model.modules():
        if not isinstance(module, MoEFusion):
            continue
        start, stop = chunk_range(module.gate.out_features, parts, index)
        with torch.no_grad():
            for layer in module.experts.mlp.layers:
                for name in ("weight", "bias"):
                    p = getattr(layer, name)
                    p.data = p.data[start:stop].clone()
        module.__class__ = _expert_parallel_class(type(module))
        module.expert_group, module.expert_range = group, (start, stop)
    return model
