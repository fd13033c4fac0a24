"""The optimizer both trainers use: optax's chain clip_by_global_norm →
adamw per parameter group → EMA, under optax.MultiSteps when gradients
accumulate.

  * accumulation (`accum_steps` = k): the running mean acc + (g - acc) /
    (n + 1) of k micro-batch gradients, and one update on the k-th;
  * the clip scales every gradient by max_norm / norm when norm > max_norm,
    the norm taken over every parameter, those of no group included;
  * AdamW (b1 0.9, b2 0.999, eps 1e-8 outside the square root, decoupled
    weight decay on the group's parameters) at `schedule(count)` times the
    group's scale and the caller's `lr_scale`, the count taken before it
    increments; parameters in no group take no update;
  * the EMA of every parameter, before the update (`ema_decay` > 0), on
    real updates only.

The step is written with `torch._foreach_*` ops so that the clip scale and
an optional update gate (a device 0/1 scalar) stay on the device: a step
does not wait for the card. A parameter with no gradient takes a zero one,
as in optax, where the moments then decay and weight decay still applies.

The update reads no host value that changes from step to step, so that a
CUDA graph can capture it once and replay it (`DEERTrainer`'s fused
epochs): the update count lives on the device too (`count`, which the
update advances), and the learning rate and both bias corrections come from
a table indexed by it, one row a count, computed once on the host in
float64 from `schedule` and stored in float32 (`reserve`). `lr_scale` may be
a device scalar. The host keeps the count and the micro-step as plain ints
(`state`, what a checkpoint holds) and advances them itself (`advance`), so
it never reads the device's. `step` is the eager call: `update` at the
current micro-step, then `advance`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamW:
    """State: per trained parameter the first and second moments; the update
    count; the EMA of every parameter; the accumulated gradient and the
    micro-step. `groups`: group name → (lr scale, parameter names)."""

    # Rows the schedule table grows by at least.
    TABLE_ROWS = 1024

    def __init__(self, params: dict[str, torch.nn.Parameter],
                 groups: dict[str, tuple[float, list[str]]],
                 schedule: Callable[[int], float], weight_decay: float,
                 max_norm: float, accum_steps: int = 1, ema_decay: float = 0.0):
        self.params = params
        self.groups = groups
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.accum = max(1, accum_steps)
        self.ema_decay = ema_decay
        trained = [n for _, names in groups.values() for n in names]
        zeros = lambda names: {n: torch.zeros_like(params[n]) for n in names}
        self.state = {"count": 0, "mu": zeros(trained), "nu": zeros(trained)}
        if ema_decay > 0:
            self.state["ema"] = {n: p.detach().clone() for n, p in params.items()}
        if self.accum > 1:
            self.state["mini_step"] = 0
            self.state["acc"] = zeros(list(params))
        device = next(iter(params.values())).device
        # The device's copy of state["count"] ([1] int64): the update reads
        # its table row by it and advances it.
        self.count = torch.zeros(1, dtype=torch.int64, device=device)
        # Row c: schedule(c), 1 - B1^(c+1), 1 - B2^(c+1) (float32).
        self.table = torch.empty(0, 3, device=device)

    def state_dict(self) -> dict:
        """The live state (a checkpoint copies it)."""
        return self.state

    def load_state_dict(self, state: dict) -> None:
        with torch.no_grad():
            _copy_into(self.state, state)
            self.count.fill_(self.state["count"])

    @property
    def phase(self) -> int:
        """The micro-step the next call is (0 without accumulation)."""
        return self.state.get("mini_step", 0)

    def reserve(self, counts: int) -> None:
        """Make the table hold the rows of every count below `counts`. A
        larger table is a new tensor: a graph captured over the old one must
        be captured again."""
        if counts <= len(self.table):
            return
        rows = max(counts, 2 * len(self.table), self.TABLE_ROWS)
        table = torch.tensor([(self.schedule(c), 1.0 - B1 ** (c + 1),
                               1.0 - B2 ** (c + 1)) for c in range(rows)],
                             dtype=torch.float64)
        self.table = table.to(torch.float32).to(self.count.device)

    def clip(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Scale `grads` in place to a global norm of at most max_norm."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, torch.where(
            norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm))
        return grads

    def step(self, grads: list[Optional[torch.Tensor]], gate=None,
             lr_scale=1.0) -> None:
        """One optimizer call with the gradients of every parameter (in
        `params` order; None for none). `gate`: a device 0/1 scale of the
        update, or None."""
        self.reserve(self.state["count"] + 1)
        self.update(grads, gate, lr_scale, self.phase)
        self.advance()

    def advance(self) -> None:
        """The host's side of one call: the micro-step and the count."""
        if self.accum > 1:
            self.state["mini_step"] = (self.state["mini_step"] + 1) % self.accum
            if self.state["mini_step"]:
                return
        self.state["count"] += 1

    def update(self, grads: list[Optional[torch.Tensor]], gate, lr_scale,
               phase: int) -> None:
        """The device's side of one call at micro-step `phase`: no host
        value it reads changes between calls of one phase, and nothing waits
        for the card. The table must hold the row of the device's count."""
        st = self.state
        names = list(self.params)
        grads = [torch.zeros_like(self.params[k]) if g is None else g
                 for k, g in zip(names, grads)]
        if self.accum > 1:
            acc = [st["acc"][k] for k in names]
            torch._foreach_add_(acc, torch._foreach_div(
                torch._foreach_sub(grads, acc), float(phase + 1)))
            if phase < self.accum - 1:
                return
            grads = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
        grads = dict(zip(names, self.clip(grads)))
        with torch.no_grad():
            if "ema" in st:
                ema = [st["ema"][k] for k in names]
                torch._foreach_mul_(ema, self.ema_decay)
                torch._foreach_add_(ema, [self.params[k] for k in names],
                                    alpha=1.0 - self.ema_decay)
            lr, bc1, bc2 = self.table.index_select(0, self.count)[0].unbind()
            for scale, group in self.groups.values():
                if not group:
                    continue
                p = [self.params[k] for k in group]
                g = [grads[k] for k in group]
                mu = [st["mu"][k] for k in group]
                nu = [st["nu"][k] for k in group]
                torch._foreach_mul_(mu, B1)
                torch._foreach_add_(mu, g, alpha=1.0 - B1)
                torch._foreach_mul_(nu, B2)
                torch._foreach_addcmul_(nu, g, g, value=1.0 - B2)
                denom = torch._foreach_div(nu, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, EPS)
                upd = torch._foreach_div(mu, bc1)
                torch._foreach_div_(upd, denom)
                torch._foreach_add_(upd, p, alpha=self.weight_decay)
                factor = lr * scale * lr_scale
                torch._foreach_mul_(upd, factor if gate is None else gate * factor)
                torch._foreach_sub_(p, upd)
            self.count.add_(1)


def _copy_into(dst: dict, src: dict) -> None:
    for key, value in src.items():
        if isinstance(value, dict):
            _copy_into(dst[key], value)
        elif isinstance(value, torch.Tensor):
            dst[key].copy_(value)
        else:
            dst[key] = int(value)
