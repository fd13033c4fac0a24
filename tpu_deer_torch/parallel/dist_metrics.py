"""Distributed metric reduction through sufficient statistics: port of
`tpu_deer/parallel/dist_metrics.py`.

CCC is a function of (n, Σx, Σy, Σx², Σy², Σxy), all additive, so one small
all-reduce of each shard's statistics gives the global value without
gathering predictions (`core/metrics.py:ccc_from_stats`).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from tpu_deer_torch.core.metrics import CCCStats, ccc_sufficient_stats


def psum_tree(tree: Any, group=None) -> Any:
    """Every tensor leaf of a (nested tuple, list or dict) tree summed over
    `group` (a process group, e.g. `mesh.get_group("data")`; None: the
    default group), as new tensors in one all-reduce."""
    leaves: list[torch.Tensor] = []

    def collect(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                collect(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                collect(v)

    collect(tree)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves]).clone()
    dist.all_reduce(flat, group=group)
    it = iter(torch.split(flat, [t.numel() for t in leaves]))

    def rebuild(t):
        if isinstance(t, torch.Tensor):
            return next(it).view(t.shape).to(t.dtype)
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(rebuild(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(rebuild(v) for v in t)
        return t

    return rebuild(tree)


def global_ccc_stats(y_true: torch.Tensor, y_pred: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     group=None) -> CCCStats:
    """This shard's CCC sufficient statistics, summed over `group` (a
    process group, e.g. `mesh.get_group("data")`) where one is given;
    without, the caller sums the shards' statistics on the host."""
    stats = ccc_sufficient_stats(y_true, y_pred, mask)
    return stats if group is None else psum_tree(stats, group)
