"""Sequence parallelism: ring attention over a time axis split across the
processes of a group. Port of `tpu_deer/parallel/sequence.py`.

Each process keeps its block of queries; the key/value blocks (and the key
mask) travel around the ring, one hop per block, and every hop folds one
(query block, key block) tile into a running (O, lse). A tile is what the
flash-attention forward computes on one tile of its own loop, so each hop
is one launch of K3a (`kernels/flash_attention.py:flash_attention_fwd`):
softmax(q·kᵀ/√D, masked keys filled with -1e30)·v and its log-sum-exp.

The backward is a second ring, written out: torch's autograd does not cross
point-to-point sends (the reference gets it from the VJP of ppermute). With
the global lse of the forward and δ = rowsum(dO∘O), one hop's gradients are
what K3b (dq, δ) and K3c (dk, dv) compute on the tile; dq stays with its
queries, and the dk/dv accumulators travel with their key block, home again
after n hops.

A row of a batch element whose keys are all masked (the whole sequence, not
one block): the reference's ring gives the mean of v over all T keys (every
score is -1e30, so each weighs 1), and dq = dk = 0, dv = ΣdO / T. A tile
with no valid key gives lse ≈ -1e30 with log(T_blk) lost in float32, so a
log-sum-exp merge of two such tiles would add their outputs. The merge
keeps such rows apart instead: it adds the tiles' outputs (each the mean of
its block's v) until a tile with a valid key arrives, which then replaces
them, and divides by n at the end if none came. In the backward the kernels
take p = 1/T_blk on such a row (`NO_VALID_KEY`), so its cotangent is
divided by n first.

`forward_hop` and `backward_hop` are the hops. One autograd function runs
them over a transport of key blocks: `ring_attention` passes the blocks
round a process group, `fold_attention` rotates n key blocks in one process
through the same loops (the ring's arithmetic, its dk/dv accumulators'
travel and return included, on one card). On the card the hops are the kernels,
which take float32 contiguous tensors with D in {32, 64} and raise
otherwise; on the CPU the wrappers run their plain twins.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_deer_torch.kernels import flash_attention as k3
from tpu_deer_torch.kernels.flash_attention import NO_VALID_KEY
from tpu_deer_torch.parallel.collectives import exchange, group_size, ring


def forward_hop(q, k, v, kv_mask, o_run=None, lse_run=None):
    """Fold the tile (q, this key block) into the running (O, lse) [B, H,
    Tq, D], [B, H, Tq] (None before the first hop): K3a on the tile, then
    the log-sum-exp merge, with rows that have seen no valid key yet kept
    as a sum of the tiles' outputs."""
    o, lse = k3.flash_attention_fwd(q, k, v, kv_mask)
    if o_run is None:
        return o, lse
    valid = lse > NO_VALID_KEY  # this tile has a valid key for the row
    seen = lse_run > NO_VALID_KEY  # an earlier tile had one
    lse_new = torch.where(valid, torch.where(seen, torch.logaddexp(lse_run, lse),
                                             lse), lse_run)
    w_run = torch.where(seen, torch.exp(lse_run - lse_new), 0.0)[..., None]
    merged = o_run * w_run + o * torch.exp(lse - lse_new)[..., None]
    o_new = torch.where(valid[..., None], merged,
                        torch.where(seen[..., None], o_run, o_run + o))
    return o_new, lse_new


def finish_forward(o_run, lse_run, n: int) -> torch.Tensor:
    """O after n hops: a row that no tile gave a valid key holds the sum of
    n block means of v, so its O is that sum / n (the mean over all T)."""
    return torch.where((lse_run > NO_VALID_KEY)[..., None], o_run, o_run / n)


def backward_cotangent(do, lse, n: int) -> torch.Tensor:
    """dO as the hops take it: divided by n on the rows with no valid key
    anywhere, where the kernels weigh each key of a block 1/T_blk and the
    ring's function weighs it 1/T."""
    return torch.where((lse > NO_VALID_KEY)[..., None], do, do / n).contiguous()


def backward_hop(q, k, v, kv_mask, o, do, lse):
    """One tile's (dq, dk, dv) against the global (O, lse) and dO (from
    `backward_cotangent`): K3b gives δ and dq, K3c dk and dv."""
    delta, dq = k3.flash_attention_bwd_dq(q, k, v, kv_mask, o, do, lse)
    dk, dv = k3.flash_attention_bwd_dkv(q, k, v, kv_mask, do, lse, delta)
    return dq, dk, dv


class _Ring:
    """The ring's transport over a process group: each process holds its
    own key block; passing on sends to rank i + 1 and receives from rank
    i − 1."""

    def __init__(self, group):
        self.group, self.n = group, group_size(group)

    def blocks(self, k, v, kv_mask):
        return [k, v, kv_mask]

    def pass_on(self, tensors):
        return exchange(tensors, self.group, ring(self.n))

    def home(self, dk, dv):
        return dk, dv


class _Fold:
    """The ring's transport in one process: k/v/mask cut into n key blocks,
    held by n virtual ranks of which only rank 0 has queries. Passing on
    rotates the blocks (rank i's to rank i + 1); a virtual rank without
    queries adds nothing to the dk/dv accumulators it passes, so a block
    that arrives without them comes with zeros."""

    def __init__(self, n: int):
        self.n = n

    def blocks(self, k, v, kv_mask):
        step = k.shape[2] // self.n
        self.slots = [_float32(k[:, :, i * step:(i + 1) * step],
                               v[:, :, i * step:(i + 1) * step],
                               kv_mask[:, i * step:(i + 1) * step])
                      for i in range(self.n)]
        return self.slots[0]

    def pass_on(self, tensors):
        self.slots[0] = list(tensors)
        self.slots = self.slots[-1:] + self.slots[:-1]
        got = self.slots[0]
        return got + [torch.zeros_like(t) for t in tensors[len(got):]]

    def home(self, dk, dv):
        """Every block's (dk, dv), home at its virtual rank: along T."""
        self.slots[0] = [dk, dv]
        return (torch.cat([s[-2] for s in self.slots], dim=2),
                torch.cat([s[-1] for s in self.slots], dim=2))


class _RingAttention(torch.autograd.Function):
    """The ring's forward and backward hops over a transport (`_Ring` or
    `_Fold`)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, transport):
        n = transport.n
        held = transport.blocks(k, v, kv_mask)
        o = lse = None
        for hop in range(n):
            o, lse = forward_hop(q, *held, o, lse)
            if hop < n - 1:  # after n - 1 hops every block has been seen
                held = transport.pass_on(held)
        o = finish_forward(o, lse, n)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.transport = transport
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        transport = ctx.transport
        n = transport.n
        do = backward_cotangent(do, lse, n)
        held = transport.blocks(k, v, kv_mask)
        dq = dk = dv = None
        for hop in range(n):
            dq_t, dk_t, dv_t = backward_hop(q, *held[:3], o, do, lse)
            dq = dq_t if dq is None else dq + dq_t
            dk = dk_t if hop == 0 else held[3] + dk_t
            dv = dv_t if hop == 0 else held[4] + dv_t
            # The accumulators travel with their block: home after n hops.
            if hop < n - 1:
                held = transport.pass_on(held[:3] + [dk, dv])
        dk, dv = transport.home(*transport.pass_on([dk, dv])[-2:])
        return dq, dk, dv, None, None


def _float32(*tensors):
    """The tensors as the kernels take them: float32, contiguous, 16-byte
    aligned (a contiguous slice may start off a 16-byte boundary)."""
    out = []
    for t in tensors:
        t = t.to(torch.float32).contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: Optional[torch.Tensor] = None, *,
                   group=None) -> torch.Tensor:
    """Attention over a time axis split across the processes of `group`
    (None: the default group), in rank order. Shapes are this process's
    blocks: q, k, v [B, H, T/n, D], kv_mask [B, T/n] (1 = valid key). The
    result is this process's block [B, H, T/n, D] of softmax(q·kᵀ/√D)·v
    over the whole sequence, in q's dtype (computed in float32);
    differentiable in q, k and v."""
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[0], k.shape[2], device=k.device)
    qf, kf, vf, mf = _float32(q, k, v, kv_mask)
    return _RingAttention.apply(qf, kf, vf, mf, _Ring(group)).to(q.dtype)


def fold_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: Optional[torch.Tensor] = None, *,
                   n_blocks: int) -> torch.Tensor:
    """The ring's hops in one process: q [B, H, Tq, D] against k, v
    [B, H, T, D] cut into `n_blocks` key blocks of T / n_blocks, passed
    round a ring of n virtual ranks (`_Fold`) by the ring's own forward and
    backward; equals attention over the whole T. Differentiable in q, k
    and v."""
    if k.shape[2] % n_blocks:
        raise ValueError(f"T {k.shape[2]} not divisible by {n_blocks} blocks")
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[0], k.shape[2], device=k.device)
    qf, kf, vf, mf = _float32(q, k, v, kv_mask)
    return _RingAttention.apply(qf, kf, vf, mf, _Fold(n_blocks)).to(q.dtype)


def ring_attention_sharded(mesh, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           kv_mask: Optional[torch.Tensor] = None, *,
                           axis_name: str = "seq") -> torch.Tensor:
    """Ring attention on the global [B, H, T, D] arrays (every process
    passes them) with T split over the `axis_name` axis of `mesh` (a
    `DeviceMesh`) and, where the mesh has a "data" axis, B split over it.
    Returns this process's block [B/data, H, T/n, D] (as `shard_batch`
    returns a process's rows); the gradient of each global input lands in
    the block this process read, so the sum over the processes is the
    global gradient. T must be divisible by the axis size (pad upstream;
    the mask makes padded keys inert)."""
    names = list(mesh.mesh_dim_names)
    axis = names.index(axis_name)
    n, index = mesh.size(axis), mesh.get_local_rank(axis_name)
    t = q.shape[2]
    if t % n or k.shape[2] != t:
        raise ValueError(f"T {t} must be divisible by the '{axis_name}' axis "
                         f"({n}), with k and v of q's length")
    if kv_mask is None:
        kv_mask = torch.ones(q.shape[0], t, device=q.device)
    rows = slice(None)
    if "data" in names:
        from tpu_deer_torch.parallel.mesh import chunk_range

        rows = slice(*chunk_range(q.shape[0], mesh.size(names.index("data")),
                                  mesh.get_local_rank("data")))
    block = slice(index * (t // n), (index + 1) * (t // n))
    return ring_attention(q[rows, :, block], k[rows, :, block],
                          v[rows, :, block], kv_mask[rows, block],
                          group=mesh.get_group(axis_name))
