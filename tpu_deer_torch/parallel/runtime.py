"""Multi-process runtime on torch.distributed: port of
`tpu_deer/parallel/runtime.py`.

Every process runs the same program on one device and joins the default
process group: NCCL on a CUDA device, gloo where the caller asks for the
CPU. The mesh is built over all processes (rank-major, "data" outermost).
A caller that feeds each process its own slice of every global batch
(`data/pipeline.py:BatchIterator(..., process_index, process_count)`)
gets each process's rows of the global batch from
`DistributedRuntime.shard_batch`. `DEERTrainer` does not take such slices:
every process holds the datasets, iterates the global batches and keeps
its rows (`train/trainer.py`).

A single process is a no-op: `initialize_runtime()` starts no group unless
asked (`RuntimeConfig.multiprocess`, a `coordinator_address`, or
`TPU_DEER_MULTIPROCESS=1` in the environment). Nothing tells a process of
its cluster: the caller gives the rendezvous (`coordinator_address`
"host:port", read as tcp://, or any init-method URL such as file:///...),
the world size and the rank, or runs under `torchrun`, whose environment
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) is then read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.parallel.mesh import (
    MeshConfig,
    create_mesh,
    shard_batch,
    shard_params,
)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """How to join (or not) a multi-process group. For explicit wiring set
    all three of coordinator_address / num_processes / process_id; without
    them the torchrun environment is read."""

    multiprocess: bool = False
    coordinator_address: Optional[str] = None  # "host:port" or a URL
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_device_ids: Optional[Sequence[int]] = None  # the CUDA device to use


class DistributedRuntime:
    """A handle over the (possibly single-process) world."""

    def __init__(self, initialized_distributed: bool, device: torch.device):
        self.initialized_distributed = initialized_distributed
        self.device = device

    @property
    def process_index(self) -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def process_count(self) -> int:
        return dist.get_world_size() if dist.is_initialized() else 1

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend() if dist.is_initialized() else None

    def global_mesh(self, config: Optional[MeshConfig] = None):
        """The ("data", "model") mesh over every process (rank order, which
        is the order BatchIterator's per-process slices assume)."""
        return create_mesh(config, self.device.type)

    def shard_batch(self, batch: Mapping[str, Any], mesh) -> dict:
        """This process's rows of the global batch, from the rows each
        process passes (its `BatchIterator` slice, global_batch /
        process_count rows): the slices are all-gathered in rank order and
        the process keeps the rows of its "data" coordinate. A single
        process degrades to `mesh.shard_batch`."""
        arrays = {k: torch.as_tensor(np.ascontiguousarray(v)).to(self.device)
                  for k, v in batch.items()}
        if self.process_count > 1:
            gathered = {}
            for k, v in arrays.items():
                parts = [torch.empty_like(v) for _ in range(self.process_count)]
                dist.all_gather(parts, v.contiguous())
                gathered[k] = torch.cat(parts)
            arrays = gathered
        return shard_batch(arrays, mesh)

    def put_params(self, params: Mapping[str, torch.Tensor], mesh,
                   mode: str = "tp") -> dict:
        """A state_dict placed on the global mesh by the layout rules; every
        process holds the full copy and keeps its own pieces."""
        return shard_params(params, mesh, mode=mode)


def _want_distributed(config: RuntimeConfig) -> bool:
    return (config.multiprocess or config.coordinator_address is not None
            or os.environ.get("TPU_DEER_MULTIPROCESS") == "1")


def initialize_runtime(config: Optional[RuntimeConfig] = None,
                       device: DeviceLike = None) -> DistributedRuntime:
    """Join the process group when asked (see the module docstring) and
    return the handle. `device`: None or "cuda" is this process's CUDA
    device (the config's `local_device_ids[0]`, else LOCAL_RANK, else the
    rank modulo the card count), "cuda:<i>" card i, and the group runs on
    NCCL; "cpu" runs gloo. Safe to call in a single-process program, where
    it only resolves the device."""
    config = config or RuntimeConfig()
    if not _want_distributed(config):
        return DistributedRuntime(False, resolve_device(device))
    env = os.environ
    rank = (config.process_id if config.process_id is not None
            else int(env.get("RANK", 0)))
    world = (config.num_processes if config.num_processes is not None
             else int(env.get("WORLD_SIZE", 1)))
    address = config.coordinator_address
    init_method = ("env://" if address is None
                   else address if "://" in address else f"tcp://{address}")
    device = torch.device("cuda") if device is None else resolve_device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run the group on gloo")
        if config.local_device_ids:
            index = int(config.local_device_ids[0])
        else:
            index = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", index)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kwargs)
    return DistributedRuntime(True, device)


def shutdown_runtime(runtime: DistributedRuntime) -> None:
    if runtime.initialized_distributed and dist.is_initialized():
        dist.destroy_process_group()
