"""Deep ensembles: K flagship models trained, evaluated and served as one.

Port of `tpu_deer/train/ensemble.py`. The members' parameters are stacked
on a leading axis (`torch.func.stack_module_state`: every state_dict entry
[K, ...]), and the model is a module on the meta device that holds no
weights: every forward is `torch.func.functional_call` of it with one
member's slice, vmapped over the stack (`torch.func.vmap`), so the
flagship's [B, in] x [in, out] GEMMs become K-times batched GEMMs in one
launch each, and a fused epoch captures the whole K-member step in one CUDA
graph, as a single model's.

Members stay independent, as in the reference:
  * gradients: the differentiated total is the SUM of the member losses,
    so its gradient in member k's slice is member k's own gradient (the
    monitored loss is the member mean);
  * clipping: the global-norm clip runs per member (`MemberAdamW.clip`, a
    [K] norm), not over the stack, whose joint norm is ~sqrt(K) larger; the
    reported `grad_norm` is the joint norm (monitoring only);
  * randomness: the vmap draws each member's own dropout masks
    (`randomness="different"`).
The non-finite gate covers the whole stacked step: one member's NaN skips
the step for all K. Spike backoff and plateau watch the member-mean train
loss and the combined validation CCC.

Under a device mesh (`mesh=`, `runtime=`) the step is the single model's
(`train/trainer.py`): replicated data parallelism, each process's rows of
every member's outputs all-gathered over "data", the global batch's
dropout masks, the gradients summed over "data". With
`TrainingConfig(param_sharding="ensemble")` the member axis is split over
"model" in `state_dict()`'s DTensors and a sharded checkpoint (the
reference's layout); the other layouts read the stack's leaves as the
reference's rules read a stacked tree's.

Prediction and validation combine the members by moment matching
(`core/nig.py:combine_members`), so evaluators, calibration and conformal
intervals read an ensemble as they read one model. `predict(return_nig=
True)`, `predict(return_fused=True)` and `predict_mc_dropout` raise, as the
reference's do.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call, stack_module_state, vmap

from tpu_deer_torch.core.nig import combine_members
from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    create_complete_deer_model,
    member_forward,
    structure,
)
from tpu_deer_torch.models.layers import weak_constant
from tpu_deer_torch.train.optim import AdamW
from tpu_deer_torch.train.rng import remat
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig


def member_seed(seed: int, k: int) -> int:
    """Member k's init seed: distinct for every (seed, k)."""
    return int(np.random.SeedSequence([seed, k]).generate_state(1)[0])


def create_deer_ensemble(config: Optional[DEERModelConfig] = None,
                         n_members: int = 4, seed: int = 0,
                         device: DeviceLike = None
                         ) -> tuple[CompleteDEERModel, dict[str, torch.Tensor]]:
    """(the module's structure on the meta device, the stacked parameters
    {state_dict name: [K, ...]} on `device`: None = the CUDA card). Member
    k is `create_complete_deer_model` at `member_seed(seed, k)`."""
    if n_members < 1:
        raise ValueError(f"n_members must be >= 1, got {n_members}")
    config = config or DEERModelConfig()
    device = resolve_device(device)
    members = [create_complete_deer_model(config, seed=member_seed(seed, k),
                                          device=device)
               for k in range(n_members)]
    params, _ = stack_module_state(members)
    return structure(config), {k: v.detach() for k, v in params.items()}


class MemberAdamW(AdamW):
    """AdamW over member-stacked parameters with the global-norm clip taken
    per member: member k's gradients are scaled by max_norm / (norm_k +
    1e-12) where norm_k >= max_norm (the reference's `_per_member_clip`);
    low-precision leaves as `optax.global_norm` and that rule compute them
    there, in the leaves' dtype."""

    def clip(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        if self.low:
            norm = torch.sqrt(self._sum_of_squares(grads, member_dims=1))
            dt = norm.dtype
            scale = torch.where(
                norm < self.max_norm, torch.ones_like(norm),
                weak_constant(self.max_norm, dt) / (norm + weak_constant(1e-12, dt)))
        else:
            norms = torch.stack([torch.linalg.vector_norm(g.reshape(len(g), -1), dim=1)
                                 for g in grads])
            norm = torch.linalg.vector_norm(norms, dim=0)
            scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                                self.max_norm / (norm + 1e-12))
        for g in grads:
            g.mul_(scale.view(-1, *(1,) * (g.dim() - 1)))
        return grads


class EnsembleTrainer(DEERTrainer):
    """DEERTrainer over a stacked K-member parameter set (from
    `create_deer_ensemble`); everything else — schedules, curriculum,
    staging, fused epochs, checkpoints (the state's "model" entry is the
    stack, and meta.json records `ensemble_members`), EMA, non-finite
    containment — is the single model's."""

    optimizer_cls = MemberAdamW
    _member_dims = 1

    def __init__(self, model: CompleteDEERModel, stacked_params: dict,
                 config: TrainingConfig = TrainingConfig(),
                 steps_per_epoch: int = 100, mesh=None, runtime=None,
                 device: DeviceLike = None):
        if not stacked_params:
            raise ValueError("empty parameter set")
        sizes = {v.shape[0] if v.dim() else None for v in stacked_params.values()}
        if len(sizes) != 1 or None in sizes:
            raise ValueError(
                "stacked params must share a leading member axis; got leading "
                f"sizes {sorted(map(str, sizes))} — build the stack with "
                "create_deer_ensemble()")
        self.n_members = sizes.pop()
        if device is None and runtime is not None:
            device = runtime.device
        target = resolve_device(device)
        self._stack = {k: v.detach().to(target).clone().requires_grad_(True)
                       for k, v in stacked_params.items()}
        super().__init__(model, config, steps_per_epoch=steps_per_epoch,
                         mesh=mesh, runtime=runtime, device=device)

    def _place(self, model: CompleteDEERModel) -> CompleteDEERModel:
        # The module's structure (create_deer_ensemble's is on the meta
        # device already; a module with weights is replaced by one without).
        return model if next(model.parameters()).is_meta else structure(model.config)

    def _trained_params(self) -> dict[str, torch.Tensor]:
        return self._stack

    def _model_state(self) -> dict:
        return {k: v.detach() for k, v in self._params.items()}

    def _load_model_state(self, state: dict) -> None:
        with torch.no_grad():
            for k, v in self._params.items():
                v.copy_(state[k])

    # -- training ----------------------------------------------------------
    def _loss_fn(self, batch: dict, dataset_weight):
        args = (batch["audio"], batch["video"], batch["text"])
        layout = self._layout
        if self.config.remat or layout is not None:
            def forward(params, *x):
                with layout.dropout(self.model) if layout else nullcontext():
                    return vmap(lambda p: functional_call(self.model, p, x),
                                randomness="different")(params)

            # One checkpointed block around the vmapped member forwards:
            # the reference checkpoints each member's forward inside its
            # vmap, which torch.func.vmap refuses (the recomputation runs
            # outside the vmap); both recompute the same function.
            out = (remat(forward, self._params, *args, recompute=self._recompute)
                   if self.config.remat else forward(self._params, *args))
            if layout is not None:  # every member's rows of the global batch
                out, batch = self._global_batch(out, batch)
            losses, auxes = vmap(
                lambda o: self._loss_terms(o, batch, dataset_weight))(out)
        else:
            terms = lambda out: self._loss_terms(out, batch, dataset_weight)
            losses, auxes = member_forward(self.model, self._params, *args,
                                           terms, randomness="different")
        aux = {k: v.mean(0) for k, v in auxes.items()}
        aux["loss"] = losses.detach().mean()
        return losses.sum(), aux

    # -- ensemble prediction -------------------------------------------------
    def _eval_step(self, batch: dict, params: Optional[dict] = None,
                   with_fused: bool = False, with_nig: bool = False) -> dict:
        self.model.eval()
        with torch.no_grad():
            member = member_forward(
                self.model, self._params if params is None else params,
                batch["audio"], batch["video"], batch["text"],
                lambda out: self._eval_outputs(out, batch["labels"]))
            res = combine_members(member)
        return {k: v.cpu().numpy() for k, v in res.items()}

    def predict(self, dataset, batch_size=None, use_ema=False,
                return_fused=False, return_nig=False) -> dict:
        """The combined prediction (moment matching, with the
        variance-space `eabs`). The raw-NIG and fused-feature variants are
        member-level and raise."""
        if return_nig:
            raise NotImplementedError(
                "return_nig over a stacked ensemble is not defined — a "
                "mixture of K NIG posteriors is not NIG, so there are no "
                "combined (nu, alpha, beta) to return. Inspect one member "
                "via DEERTrainer on member_params(k); the combined "
                "closed-form E|err| channel is already in predict()'s 'eabs' "
                "key.")
        if return_fused:
            raise NotImplementedError(
                "return_fused over a stacked ensemble is ambiguous (fused "
                "features are per-member). Fit feature-space detectors on a "
                "single member (member_params(k)) or serve through "
                "serve.InferenceEngine(ensemble=True), which exposes the "
                "member-mean fused representation for OOD fitting.")
        return super().predict(dataset, batch_size=batch_size, use_ema=use_ema)

    def predict_mc_dropout(self, *args, **kwargs):
        raise NotImplementedError(
            "MC dropout over a stacked ensemble is not supported — the "
            "ensemble's cross-member disagreement already provides the "
            "sampling-based epistemic signal. Run predict_mc_dropout on a "
            "single member via DEERTrainer on member_params(k).")

    # -- member access -------------------------------------------------------
    def member_params(self, k: int) -> dict[str, torch.Tensor]:
        """Member `k`'s state_dict (a copy), e.g. to load into a
        CompleteDEERModel and serve or train it alone."""
        if not 0 <= k < self.n_members:
            raise IndexError(f"member {k} out of range [0, {self.n_members})")
        return {name: v[k].detach().clone() for name, v in self._params.items()}
