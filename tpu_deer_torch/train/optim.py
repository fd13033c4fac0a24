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
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamW:
    """State: per trained parameter the first and second moments; the update
    count; the EMA of every parameter; the accumulated gradient and the
    micro-step. `groups`: group name → (lr scale, parameter names)."""

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

    def state_dict(self) -> dict:
        """The live state (a checkpoint copies it)."""
        return self.state

    def load_state_dict(self, state: dict) -> None:
        with torch.no_grad():
            _copy_into(self.state, state)

    def clip(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Scale `grads` in place to a global norm of at most max_norm."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, torch.where(
            norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm))
        return grads

    def step(self, grads: list[Optional[torch.Tensor]], gate=None,
             lr_scale: float = 1.0) -> None:
        """One optimizer call with the gradients of every parameter (in
        `params` order; None for none). `gate`: a device 0/1 scale of the
        update, or None."""
        st = self.state
        names = list(self.params)
        grads = [torch.zeros_like(self.params[k]) if g is None else g
                 for k, g in zip(names, grads)]
        if self.accum > 1:
            n = st["mini_step"]
            acc = [st["acc"][k] for k in names]
            torch._foreach_add_(acc, torch._foreach_div(
                torch._foreach_sub(grads, acc), float(n + 1)))
            if n < self.accum - 1:
                st["mini_step"] = n + 1
                return
            grads = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
            st["mini_step"] = 0
        grads = dict(zip(names, self.clip(grads)))
        with torch.no_grad():
            if "ema" in st:
                ema = [st["ema"][k] for k in names]
                torch._foreach_mul_(ema, self.ema_decay)
                torch._foreach_add_(ema, [self.params[k] for k in names],
                                    alpha=1.0 - self.ema_decay)
            count = st["count"] + 1
            base_lr = self.schedule(st["count"])
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
                denom = torch._foreach_div(nu, 1.0 - B2**count)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, EPS)
                upd = torch._foreach_div(mu, 1.0 - B1**count)
                torch._foreach_div_(upd, denom)
                torch._foreach_add_(upd, p, alpha=self.weight_decay)
                factor = base_lr * scale * lr_scale
                torch._foreach_mul_(upd, factor if gate is None else gate * factor)
                torch._foreach_sub_(p, upd)
            st["count"] = count


def _copy_into(dst: dict, src: dict) -> None:
    for key, value in src.items():
        if isinstance(value, dict):
            _copy_into(dst[key], value)
        elif isinstance(value, torch.Tensor):
            dst[key].copy_(value)
        else:
            dst[key] = int(value)
