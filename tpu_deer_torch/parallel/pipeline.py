"""Pipeline parallelism: the GPipe microbatch schedule over the processes
of a group. Port of `tpu_deer/parallel/pipeline.py`.

Process i holds the parameters of stage i only. With M microbatches and S
stages the schedule runs M + S - 1 ticks: at tick t every stage applies
itself to the activation it holds (stage 0 to microbatch t, clipped to the
last one), the last stage keeps its result as microbatch t - (S - 1), and
each stage passes its result to the next with `collectives.ppermute`
(i → i + 1, no wraparound). A final `psum` replicates the last stage's
outputs. The reference's `lax.scan` is a Python loop over the ticks here.

Gradients flow back through the ppermutes (the backward of one is the send
in the reverse direction). As in the reference, every tick of every stage
is in the graph, the idle ones through a `where` that takes nothing from
them, so every process runs the same backward exchanges in the same order.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from tpu_deer_torch.parallel.collectives import (
    group_rank,
    group_size,
    ppermute,
    psum,
)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *,
                   num_microbatches: int, group=None) -> torch.Tensor:
    """Run `x` through the S stages of `group` (one a process, in rank
    order; None: the default group).

    stage_fn: a shape-preserving stage body `(params, h) -> h`.
    stage_params: this process's stage's parameters (any structure
      stage_fn takes).
    x: the whole batch [B, ...] (every process passes it); it is split into
      `num_microbatches` equal microbatches along axis 0.

    Returns the last stage's outputs [B, ...] on every process."""
    s, idx, m = group_size(group), group_rank(group), num_microbatches
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    xs = x.reshape((m, b // m) + tuple(x.shape[1:]))
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == s - 1, device=x.device)
    perm = [(i, i + 1) for i in range(s - 1)]
    recv = torch.zeros_like(xs[0])
    outbuf = [torch.zeros_like(xs[0]) for _ in range(m)]
    ticks = m + s - 1
    for t in range(ticks):
        h = torch.where(first, xs[min(t, m - 1)], recv)
        out = stage_fn(stage_params, h)
        done = min(max(t - (s - 1), 0), m - 1)
        store = torch.tensor(bool(idx == s - 1 and t >= s - 1), device=x.device)
        outbuf[done] = torch.where(store, out, outbuf[done])
        if t < ticks - 1:  # the last tick's sends would never be read
            recv = ppermute(out, group, perm)
    full = torch.where(last, torch.stack(outbuf), 0.0)
    return psum(full, group).reshape(x.shape)


def pipeline_sharded(mesh, stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stacked_params: Any, x: torch.Tensor, *,
                     num_microbatches: int, axis_name: str = "stage") -> torch.Tensor:
    """`pipeline_apply` over the `axis_name` axis of `mesh` (a DeviceMesh)
    from stacked parameters: every leaf [S, ...] (every process passes
    them), of which this process takes its stage's slice; x is replicated
    and the output comes back replicated. The gradient of a stacked leaf
    lands in this process's slice (and that of x on stage 0), so their sum
    over the processes is the global gradient."""
    idx = mesh.get_local_rank(axis_name)
    local = _tree_map(lambda p: p[idx], stacked_params)
    return pipeline_apply(stage_fn, local, x, num_microbatches=num_microbatches,
                          group=mesh.get_group(axis_name))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)
