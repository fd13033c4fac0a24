"""Collectives over a process group for the sequence, pipeline and expert
layouts: the port's `jax.lax.ppermute` and `jax.lax.psum` inside
`shard_map` (tpu_deer/parallel/{sequence,pipeline}.py, and the mixture
reduction XLA inserts for the expert-sharded MoEFusion).

  * `exchange` sends tensors along a permutation of the group's ranks with
    `dist.batch_isend_irecv`, every rank listing its sends before its
    receives, one tensor after another in the order given; a rank that a
    pair maps to itself keeps its tensors, so no rank ever sends to itself
    (a group of one sends nothing).
  * `ppermute` is `exchange` as an autograd function: its backward is the
    exchange along the inverse permutation, as JAX's VJP of ppermute is. A
    rank that no pair sends to receives zeros.
  * `psum` sums over the group; its backward passes the cotangent through
    unchanged. Every rank computes the same loss from the summed value, so
    each holds the whole cotangent already: summing it again would scale
    the gradients by the group's size.
  * `sum_grads` is the identity whose backward sums the cotangent over the
    group: the input of work split over the group (each rank's experts),
    whose gradient is the sum of every rank's part.

A group is a `torch.distributed` process group (None: the default group);
ranks in a permutation are ranks within the group.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

Perm = Sequence[tuple[int, int]]


def group_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def ring(n: int) -> list[tuple[int, int]]:
    """Rank i → i + 1 (mod n)."""
    return [(i, (i + 1) % n) for i in range(n)]


def exchange(tensors: Sequence[torch.Tensor], group,
             perm: Perm) -> list[torch.Tensor]:
    """Send `tensors` to the rank `perm` maps this rank to and return the
    tensors received from the rank that maps to it (new contiguous
    buffers shaped like `tensors`); zeros where no rank maps to this
    one."""
    me = group_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if dst == [me] and src == [me]:
        return list(tensors)
    out = [torch.zeros_like(t, memory_format=torch.contiguous_format)
           for t in tensors]
    peer = lambda r: r if group is None else dist.get_global_rank(group, r)
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer(d), group)
           for d in dst for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, peer(r), group) for r in src for t in out]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, tuple(perm)
        return exchange([x], group, perm)[0]

    @staticmethod
    def backward(ctx, grad):
        inverse = [(d, s) for s, d in ctx.perm]
        return exchange([grad], ctx.group, inverse)[0], None, None


def ppermute(x: torch.Tensor, group, perm: Perm) -> torch.Tensor:
    """`jax.lax.ppermute(x, axis, perm)` over `group`: differentiable, the
    backward the exchange along the inverse permutation."""
    return _PPermute.apply(x, group, perm)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        if group_size(group) > 1:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ of `x` over `group`; the backward passes the (identical on every
    rank) cotangent through."""
    return _Psum.apply(x, group)


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        if group_size(ctx.group) > 1:
            dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_grads(x: torch.Tensor, group) -> torch.Tensor:
    """`x` itself; the backward sums the cotangent over `group`."""
    return _SumGrads.apply(x, group)
