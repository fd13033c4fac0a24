"""DEER trainer for the flagship model: train and eval steps, multi-dataset
curriculum, early stopping, checkpoints.

Port of `tpu_deer/train/trainer.py`. What a step does, as the reference's
optax chain does it:

  * forward in train mode, the DEER loss (`multitask` or `combined`) plus
    the calibration-alignment term (and the aleatoric moment term when its
    weight is set), times the dataset's weight;
  * non-finite containment (`skip_nonfinite_updates`): when the loss or the
    gradient norm is not finite, the gradients become 0 and, without
    accumulation, the update too; the reported scalars are 0 and
    `nonfinite_skipped` is 1;
  * gradient accumulation (`grad_accum_steps` = k): the running mean
    acc + (g - acc) / (n + 1) of k micro-batch gradients, and one update on
    the k-th (optax.MultiSteps); schedules count updates;
  * clip to a global norm (optax.clip_by_global_norm), then AdamW per group
    (optax.adamw: b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    decoupled weight decay on the group's parameters): parameters under
    `audio_encoder`, `video_encoder`, `text_encoder` at `encoder_lr_scale`
    times the schedule, the rest at 1×, and parameters under a
    `frozen_prefixes` entry (state_dict name prefixes) not at all, though
    their gradients count in the clip's norm;
  * EMA of the parameters before the update (`ema_decay` > 0), on real
    updates only;
  * the update times the plateau and spike scales (and the non-finite
    gate, a device scalar, so that a step does not wait for the card).
    Accumulation, clip, AdamW and EMA are `train/optim.py:AdamW`, which the
    raw trainer shares.

The schedule (`warmup_cosine_decay_schedule` from 0, `exponential_decay`,
or constant for `plateau` and `constant`) is evaluated at the update count
before it increments, so the first cosine update runs at lr 0, as optax's.
Dropout draws from the trainer's own generator, seeded from `config.seed`
(`train/rng.py`); a checkpoint carries its state, so a resumed run repeats
the straight one. Validation, the serving-channel choice, plateau and spike
backoff with rollback to the best state, checkpointing and `predict`
follow the reference.

Fused epochs (`fused_epochs=True`; the reference's one `lax.scan` an
epoch): the epoch's datasets are staged once as one array set, the epoch's
[steps, batch] global index matrix and per-step dataset weights are copied
to the device once, and one step function does everything on the device:
it reads row i of the matrix and weight i (i a device counter), gathers the
batch, runs the forward, loss, gradients, the non-finite gate and the
optimizer's update (`train/optim.py`), adds the step's scalars into device
sums and advances i. The epoch's metrics are the sums over the steps,
fetched once. On a card that function is captured in a CUDA graph (one a
micro-step phase under accumulation) after `GRAPH_WARMUP` eager steps on a
side stream, which are the epoch's first real steps, and replayed for the
rest; between replays the host only seeds the dropout generator
(`train/rng.py`) and counts. A failed capture raises. The graph bakes in
the TF32 and bf16-reduction settings in force when it was captured; a
change of them captures again. On the CPU the same function runs
uncaptured. Data over `STAGE_BYTES_LIMIT` take the per-step path, as in
the reference.

A model whose `compute_dtype` is below float32 (bf16) trains through
both steps as it is: its layers cast to that dtype where flax's `dtype=`
does, while the loss, the NIG terms and the optimizer stay float32 and
the gradients land in the float32 parameters (explicit casts, not
`torch.autocast`, whose LayerNorm and softmax return float32 and whose
weight-cast cache must be off in a capture).

Distillation: a dataset with `teacher_mu` and `teacher_unc` arrays
(`train/distill.py:add_teacher_targets`) adds distill_mu_weight ·
MSE(mu, teacher_mu) and distill_unc_weight · MSE(log(unc + 1e-4),
log(teacher_unc + 1e-4)) to the loss, on the per-step and the fused path
(staged only where every dataset of the epoch has them). `predict_mc_dropout`
runs S dropout-on forwards of each batch as one `torch.func.vmap` (each
sample its own masks) and combines them by moment matching
(`core/nig.py:combine_members`). `train/ensemble.py:EnsembleTrainer` is
this trainer over a stacked K-member parameter set.

Knobs that only pick how XLA executes, or belong to later work, raise
NotImplementedError away from their defaults: `remat=True`,
`storage_dtype` other than float32, and a `mesh` or `runtime`. `rng_impl`
is accepted and has no effect.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
import weakref
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from tpu_deer_torch.core import losses as loss_lib
from tpu_deer_torch.core import metrics as metrics_lib
from tpu_deer_torch.core.nig import combine_members, nig_expected_abs_error
from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    layout_meta,
    uncertainty_outputs,
)
from tpu_deer_torch.train.checkpoint import CheckpointManager
from tpu_deer_torch.train.optim import AdamW
from tpu_deer_torch.train.rng import draw_seed, forked_rng, seed_global, seeded_dropout
from tpu_deer_torch.utils.logging import MetricWriter


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """The reference's TrainingConfig: same fields, same defaults."""

    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    gradient_clip: float = 1.0
    batch_size: int = 32
    num_epochs: int = 100
    scheduler: str = "cosine"  # cosine | exponential | plateau | constant
    warmup_epochs: int = 5
    early_stopping_patience: int = 10
    encoder_lr_scale: float = 0.5
    # state_dict name prefixes whose parameters take no update.
    frozen_prefixes: tuple = ()
    dataset_weights: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {"iemocap": 1.0, "ravdess": 0.8, "meld": 0.6})
    curriculum_learning: bool = True
    val_frequency: int = 1
    save_frequency: int = 10
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    loss_variant: str = "v2"
    loss_type: str = "multitask"  # multitask | combined
    evidence_weight: float = 1.0
    kl_weight: float = 0.1
    calibration_alignment_weight: float = 0.05
    # Log-space moment matching of beta / (alpha - 1) to the squared
    # residual; off by default.
    aleatoric_moment_weight: float = 0.0
    distill_mu_weight: float = 1.0
    distill_unc_weight: float = 0.5
    skip_nonfinite_updates: bool = True
    # Per-epoch loss-spike detector: a train loss beyond median + threshold
    # robust sigmas of the last `spike_window` clean epochs multiplies the
    # lr scale by `spike_backoff_factor` (backoff) and restores the best
    # validation state (rollback); clean epochs recover the scale.
    spike_backoff: bool = True
    spike_threshold: float = 6.0
    spike_backoff_factor: float = 0.5
    spike_window: int = 8
    spike_recovery: float = 1.2
    spike_rollback: bool = True
    rng_impl: str = "rbg"  # accepted, no effect (see train/rng.py)
    remat: bool = False
    storage_dtype: str = "float32"
    param_sharding: str = "tp"  # only read under a mesh, which is not ported
    grad_accum_steps: int = 1
    ema_decay: float = 0.0
    ema_eval: bool = False
    fused_epochs: Optional[bool] = None
    seed: int = 42


def _check_supported(config: TrainingConfig, mesh, runtime) -> None:
    unported = {
        "remat=True": config.remat,
        f"storage_dtype={config.storage_dtype!r}": config.storage_dtype != "float32",
        "a device mesh": mesh is not None,
        "a distributed runtime": runtime is not None,
    }
    for what, given in unported.items():
        if given:
            raise NotImplementedError(
                f"DEERTrainer with {what} is not ported yet (ROADMAP queue 1, "
                f"items 5 and 13)")


# Dataset arrays a step reads (the teacher targets where a dataset has them).
BATCH_KEYS = ("audio", "video", "text", "labels", "teacher_mu", "teacher_unc")
ENCODERS = ("audio_encoder", "video_encoder", "text_encoder")


def warmup_cosine_schedule(peak: float, warmup_steps: int, decay_steps: int,
                           end_value: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(init_value=0, ...): linear from 0
    to `peak` over `warmup_steps`, then cosine down to `end_value` at
    `decay_steps`."""
    alpha = 0.0 if peak == 0.0 else end_value / peak
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak * (min(max(count, 0), warmup_steps) / warmup_steps)
        t = min(count - warmup_steps, cosine_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak * ((1.0 - alpha) * decay + alpha)

    return schedule


def exponential_schedule(init_value: float, transition_steps: int,
                         decay_rate: float) -> Callable[[int], float]:
    """optax.exponential_decay (continuous, from step 0)."""
    return lambda count: (init_value if count <= 0 else
                          init_value * decay_rate ** (count / transition_steps))


@dataclasses.dataclass
class _FusedRun:
    """The device buffers a fused epoch's step reads and writes. A captured
    graph holds their addresses, so between epochs they are written in
    place, never rebound."""

    data: dict  # the epoch's datasets, staged as one array set
    idx: torch.Tensor  # [steps, batch] int64 global row indices
    weights: torch.Tensor  # [steps] float32 dataset weights
    lr_scale: torch.Tensor  # [] float32
    i: torch.Tensor  # [1] int64: the step within the epoch
    sums: Optional[torch.Tensor] = None  # the step scalars' sums
    keys: tuple = ()  # their names
    eager: int = 0  # steps taken uncaptured (the warm-up on a card)
    # micro-step phase → (graph, the optimizer's table and the TF32
    # settings it was captured with)
    graphs: dict = dataclasses.field(default_factory=dict)
    stream: Optional[torch.cuda.Stream] = None  # the warm-up's side stream


class DEERTrainer:
    """Trains `model` (a CompleteDEERModel with its weights, moved to
    `device`: None = the CUDA card) with `config`. `steps_per_epoch` sizes
    the schedules, as in the reference."""

    # Training data up to this size is staged on the device once and each
    # batch gathered there from its index vector; larger data is sliced on
    # the host and copied per step.
    STAGE_BYTES_LIMIT = 6_000_000_000
    # Eager steps a fused run takes on a card before its first capture (at
    # least one of each micro-step phase): lazy set-up such as cuBLAS's
    # workspaces must happen outside a capture.
    GRAPH_WARMUP = 3
    optimizer_cls = AdamW
    n_members = 1  # models trained together (train/ensemble.py)

    def __init__(self, model: CompleteDEERModel,
                 config: TrainingConfig = TrainingConfig(),
                 steps_per_epoch: int = 100, mesh=None, runtime=None,
                 device: DeviceLike = None):
        _check_supported(config, mesh, runtime)
        self.device = resolve_device(device)
        self.model = self._place(model)
        self.config = config
        self.steps_per_epoch = max(1, steps_per_epoch)
        self._accum = max(1, config.grad_accum_steps)
        self.total_steps = max(
            1, (self.steps_per_epoch * config.num_epochs) // self._accum)
        self._updates_per_epoch = max(1, self.steps_per_epoch // self._accum)
        self.schedule = self._build_schedule()
        self._params = self._trained_params()
        groups = {"encoder": (config.encoder_lr_scale, []), "main": (1.0, [])}
        for name in self._params:
            if name.startswith(tuple(config.frozen_prefixes)):
                continue
            groups["encoder" if name.split(".")[0] in ENCODERS else "main"][1].append(name)
        self.optimizer = self.optimizer_cls(
            self._params, groups, self.schedule, config.weight_decay,
            config.gradient_clip, config.grad_accum_steps, config.ema_decay)
        self.step = 0  # micro-steps
        self.generator = torch.Generator().manual_seed(config.seed)
        self.history: dict[str, list] = {
            "train_loss": [], "val_loss": [], "val_ccc": [], "val_mae": [],
            "val_ece": [], "learning_rate": []}
        self._best_state = None  # spike rollback: copy of the best state
        self._staged: dict[int, Optional[dict]] = {}  # id → arrays or None
        self._combined: dict[tuple, Optional[tuple]] = {}  # ids → staged
        self._run: Optional[_FusedRun] = None
        self.graph_replays = 0  # fused steps replayed from a CUDA graph
        self.graph_capture_s = 0.0  # host seconds spent capturing them
        self._plateau_scale = 1.0
        self._plateau_best = -np.inf
        self._plateau_wait = 0
        self._spike_scale = 1.0
        self._spike_history: list[float] = []

    def _layout_meta(self) -> dict:
        """The model's layout for a checkpoint's metadata (serving rebuilds
        the model from it)."""
        config = getattr(self.model, "config", None)
        return layout_meta(config) if isinstance(config, DEERModelConfig) else {}

    def _place(self, model: CompleteDEERModel) -> CompleteDEERModel:
        return model.to(self.device)

    def _trained_params(self) -> dict[str, torch.Tensor]:
        """The tensors the optimizer updates, by state_dict name."""
        return dict(self.model.named_parameters())

    # -- state -------------------------------------------------------------
    def state_dict(self) -> dict:
        """The full training state: what a checkpoint holds (parameters,
        optimizer state with the EMA, step, dropout generator)."""
        return {"model": self._model_state(),
                "optimizer": self.optimizer.state_dict(), "step": self.step,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self._load_model_state(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])

    def _model_state(self) -> dict:
        return self.model.state_dict()

    def _load_model_state(self, state: dict) -> None:
        self.model.load_state_dict(state)

    def _copy_state(self) -> dict:
        return copy.deepcopy(self.state_dict())

    # -- device-resident data ------------------------------------------------
    # The caches below are keyed by the datasets' ids (a dataset is not
    # hashable). An entry goes when one of its datasets is freed, before a
    # new dataset can take the id, and its device arrays go with it; the
    # finalizers hold the trainer weakly, so they keep no arrays alive.
    def _drop_when_freed(self, cache: str, key, datasets) -> None:
        trainer = weakref.ref(self)

        def drop():
            t = trainer()
            if t is not None:
                getattr(t, cache).pop(key, None)

        for d in datasets:
            weakref.finalize(d, drop)

    def _stage(self, dataset: ArrayDataset) -> Optional[dict]:
        key = id(dataset)
        if key not in self._staged:
            arrays = {k: v for k, v in dataset.arrays.items() if k in BATCH_KEYS}
            nbytes = sum(v.nbytes for v in arrays.values())
            self._staged[key] = None if nbytes > self.STAGE_BYTES_LIMIT else {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}
            self._drop_when_freed("_staged", key, [dataset])
        return self._staged[key]

    def _stage_combined(self, datasets: Mapping[str, ArrayDataset]):
        """The datasets staged as one array set with each one's row offset,
        for a fused epoch's global indices: (arrays, offsets), or None above
        STAGE_BYTES_LIMIT. Keys that not every dataset has are left out (a
        partial column would misalign the global indices)."""
        key = tuple(sorted((n, id(d)) for n, d in datasets.items()))
        if key not in self._combined:
            names = sorted(datasets)
            common = [k for k in BATCH_KEYS
                      if all(k in d.arrays for d in datasets.values())]
            sizes = [len(datasets[n]) for n in names]
            offsets = dict(zip(names, (sum(sizes[:j]) for j in range(len(names)))))
            nbytes = sum(datasets[n].arrays[k].nbytes for n in names for k in common)
            staged = {}
            for k in common if nbytes <= self.STAGE_BYTES_LIMIT else ():
                parts = [torch.from_numpy(np.ascontiguousarray(datasets[n].arrays[k]))
                         .to(self.device) for n in names]
                staged[k] = parts[0] if len(parts) == 1 else torch.cat(parts)
            self._combined[key] = (staged, offsets) if staged else None
            self._drop_when_freed("_combined", key, datasets.values())
        return self._combined[key]

    def _batch_from_indices(self, dataset: ArrayDataset, idx: np.ndarray) -> dict:
        """Gather on the device when the dataset is staged; otherwise slice
        on the host and copy."""
        staged = self._stage(dataset)
        if staged is not None:
            index = torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)
            return {k: v.index_select(0, index) for k, v in staged.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(self.device)
                for k, v in dataset.arrays.items() if k in BATCH_KEYS}

    # -- schedule ------------------------------------------------------------
    def _build_schedule(self) -> Callable[[int], float]:
        cfg = self.config
        warmup = min((cfg.warmup_epochs * self.steps_per_epoch) // self._accum,
                     self.total_steps // 2)
        if cfg.scheduler == "cosine":
            return warmup_cosine_schedule(
                cfg.learning_rate, max(1, warmup),
                max(self.total_steps, warmup + 2), cfg.learning_rate * 0.01)
        if cfg.scheduler == "exponential":
            return exponential_schedule(cfg.learning_rate,
                                        self._updates_per_epoch, 0.95)
        # plateau and constant: a flat base (plateau scales on the host).
        return lambda count: cfg.learning_rate

    # -- loss and steps ----------------------------------------------------
    def _loss_fn(self, batch: dict, dataset_weight):
        """(the differentiated loss, the step's scalars)."""
        out = self.model(batch["audio"], batch["video"], batch["text"])
        return self._loss_terms(out, batch, dataset_weight)

    def _loss_terms(self, out: dict, batch: dict, dataset_weight):
        """The loss of the model's outputs `out` on `batch`, and the step's
        scalars."""
        cfg = self.config
        dim_names = self.model.config.dim_names
        ps = [out[f"{n}_params"] for n in dim_names]
        y = batch["labels"]
        lcfg = loss_lib.DEERLossConfig(
            variant=cfg.loss_variant, evidence_weight=cfg.evidence_weight,
            kl_weight=cfg.kl_weight, reg_weight=0.1 * cfg.evidence_weight,
            kl_weight_v2=0.1 * cfg.kl_weight)
        if cfg.loss_type == "combined":
            loss_out = loss_lib.combined_deer_loss(ps, y, lcfg)
        else:
            loss_out = loss_lib.multi_task_deer_loss(ps, y, lcfg)
        total = loss_out["total_loss"]
        # Calibration alignment: calibrated uncertainty toward the realized
        # |error| (the error itself takes no gradient).
        err = torch.abs(out["mu_all"] - y).detach()
        cal_loss = torch.mean(torch.square(out["calibrated_uncertainty"] - err))
        total = total + cfg.calibration_alignment_weight * cal_loss
        zero = torch.zeros((), device=y.device)
        moment_loss = zero
        if cfg.aleatoric_moment_weight > 0:
            aleatoric = torch.cat(
                [p.beta / torch.clamp(p.alpha - 1.0, min=1e-8) for p in ps], -1)
            moment_loss = torch.mean(torch.square(
                torch.log(aleatoric + 1e-4) - torch.log(torch.square(err) + 1e-4)))
            total = total + cfg.aleatoric_moment_weight * moment_loss
        distill_mu = distill_unc = zero
        if "teacher_mu" in batch:
            distill_mu = torch.mean(torch.square(out["mu_all"] - batch["teacher_mu"]))
            distill_unc = torch.mean(torch.square(
                torch.log(out["uncertainty_all"] + 1e-4)
                - torch.log(batch["teacher_unc"] + 1e-4)))
            total = (total + cfg.distill_mu_weight * distill_mu
                     + cfg.distill_unc_weight * distill_unc)
        total = total * dataset_weight
        aux = {
            "loss": total,
            "distill_mu": distill_mu,
            "distill_unc": distill_unc,
            "nll": loss_out.get(f"{dim_names[0]}_nll_loss", zero),
            "mse": torch.mean(torch.square(out["mu_all"] - y)),
            "calibration_alignment": cal_loss,
            "aleatoric_moment": moment_loss,
            "mean_uncertainty": torch.mean(out["uncertainty_all"]),
        }
        return total, {k: v.detach() for k, v in aux.items()}

    def _train_step(self, batch: dict, dataset_weight: float,
                    lr_scale: float) -> dict[str, torch.Tensor]:
        """One micro-step; returns the step's scalars on the device."""
        self.model.train()
        with seeded_dropout(self.generator, self.device):
            loss, aux = self._loss_fn(batch, dataset_weight)
        grads, gate, aux = self._gated_grads(loss, aux)
        self.optimizer.step(grads, gate, lr_scale)
        self.step += 1
        return aux

    def _gated_grads(self, loss, aux):
        """The step's gradients, the update gate and the step's scalars, the
        non-finite containment applied; nothing waits for the card."""
        params = list(self._params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        aux["grad_norm"] = grad_norm
        gate = None
        if self.config.skip_nonfinite_updates:
            ok = torch.isfinite(grad_norm) & torch.isfinite(loss.detach())
            okf = ok.to(torch.float32)
            # A where, not a product: NaN * 0 is NaN.
            grads = [torch.where(ok, g, 0.0) for g in grads]
            aux = {k: torch.where(ok, v, 0.0) for k, v in aux.items()}
            aux["nonfinite_skipped"] = 1.0 - okf
            # Under accumulation the bad micro-batch already adds a zero
            # gradient to the mean; gating the emitted update would drop
            # the good ones.
            gate = okf if self._accum == 1 else None
        return grads, gate, aux

    # -- fused epochs --------------------------------------------------------
    def _fused_epoch(self, train_iterators: dict, epoch: int, combined: tuple,
                     lr_scale: float) -> dict[str, float]:
        staged, offsets = combined
        rows, weights = [], []
        for name, idx, _ in self._multi_dataset_iterator(train_iterators, epoch):
            rows.append(idx + offsets[name])
            weights.append(self.config.dataset_weights.get(name.lower(), 1.0))
        if not rows:
            return {}
        return self._fused_rows(staged, rows, weights, lr_scale)

    def _fused_rows(self, staged: dict, rows: Sequence[np.ndarray],
                    weights: Sequence[float], lr_scale: float) -> dict[str, float]:
        """The fused steps of `rows` (one global index vector into `staged`
        a step) at their dataset weights; returns the steps' mean scalars,
        fetched once. Calls with the same staged data and as many rows of
        one batch size reuse one run, and so its graphs."""
        run = self._run
        shape = (len(rows), len(rows[0]))
        if run is None or run.data is not staged or tuple(run.idx.shape) != shape:
            run = self._run = _FusedRun(
                staged, torch.empty(shape, dtype=torch.int64, device=self.device),
                torch.empty(len(rows), device=self.device),
                torch.empty((), device=self.device),
                torch.empty(1, dtype=torch.int64, device=self.device))
        run.idx.copy_(torch.from_numpy(np.stack(rows).astype(np.int64)))
        run.weights.copy_(torch.tensor(weights, dtype=torch.float32))
        run.lr_scale.fill_(lr_scale)
        run.i.zero_()
        if run.sums is not None:
            run.sums.zero_()
        opt = self.optimizer
        opt.reserve(opt.state["count"] + len(rows) // self._accum + 1)
        self.model.train()
        with forked_rng(self.device):
            for _ in rows:
                seed_global(self.device, draw_seed(self.generator))
                self._fused_step(run)
                opt.advance()
                self.step += 1
        return dict(zip(run.keys, (run.sums / len(rows)).tolist()))

    def _fused_step(self, run: _FusedRun) -> None:
        """One step of a fused epoch: uncaptured on the CPU and during a
        card's warm-up (on a side stream), else a replay of the phase's
        graph, captured first where it is missing or stale."""
        phase = self.optimizer.phase
        if self.device.type != "cuda":
            self._fused_body(run, phase)
            run.eager += 1
            return
        if run.eager < max(self.GRAPH_WARMUP, self._accum):
            run.stream = run.stream or torch.cuda.Stream(self.device)
            run.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(run.stream):
                self._fused_body(run, phase)
            torch.cuda.current_stream(self.device).wait_stream(run.stream)
            run.eager += 1
            return
        settings = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
                    torch.get_float32_matmul_precision())
        graph, table, captured = run.graphs.get(phase, (None, None, None))
        if table is not self.optimizer.table or captured != settings:
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with torch.cuda.graph(graph):
                self._fused_body(run, phase)
            self.graph_capture_s += time.perf_counter() - t0
            run.graphs[phase] = (graph, self.optimizer.table, settings)
        graph.replay()
        self.graph_replays += 1

    def _fused_body(self, run: _FusedRun, phase: int) -> None:
        """The fused step's device work at micro-step `phase`: no host sync,
        no host value that changes between steps."""
        idx = run.idx.index_select(0, run.i)[0]
        batch = {k: v.index_select(0, idx) for k, v in run.data.items()}
        loss, aux = self._loss_fn(batch, run.weights.index_select(0, run.i)[0])
        grads, gate, aux = self._gated_grads(loss, aux)
        self.optimizer.update(grads, gate, run.lr_scale, phase)
        values = torch.stack(list(aux.values()))
        if run.sums is None:
            run.keys, run.sums = tuple(aux), torch.zeros_like(values)
        run.sums.add_(values)
        run.i.add_(1)

    def _eval_step(self, batch: dict, params: Optional[dict] = None,
                   with_fused: bool = False, with_nig: bool = False) -> dict:
        self.model.eval()
        args = (batch["audio"], batch["video"], batch["text"])
        with torch.no_grad():
            out = (self.model(*args) if params is None
                   else functional_call(self.model, params, args))
            res = self._eval_outputs(out, batch["labels"], with_fused, with_nig)
        return {k: v.cpu().numpy() for k, v in res.items()}

    def _eval_outputs(self, out: dict, labels: torch.Tensor,
                      with_fused: bool = False, with_nig: bool = False) -> dict:
        """The eval step's outputs from the model's outputs `out`."""
        dim_names = self.model.config.dim_names
        ps = [out[f"{n}_params"] for n in dim_names]
        loss = loss_lib.multi_task_deer_loss(
            ps, labels, loss_lib.DEERLossConfig(variant=self.config.loss_variant))
        res = uncertainty_outputs(out, dim_names)
        res["eabs"] = torch.cat([nig_expected_abs_error(p) for p in ps], -1)
        res["loss"] = loss["total_loss"]
        if with_fused:
            # float32 (exact) for numpy, which has no bfloat16.
            res["fused"] = out["fused_features"].float()
        if with_nig:
            for field in ("nu", "alpha", "beta"):
                res[field] = torch.cat([getattr(p, field) for p in ps], -1)
        return res


    # -- curriculum multi-dataset sampling ---------------------------------
    def _curriculum_probabilities(self, dataset_names: Sequence[str],
                                  epoch: int) -> np.ndarray:
        """Early (< 30% of epochs): mostly the highest-weight dataset; mid
        (30-60%): a blend; late: proportional to the dataset weights."""
        weights = np.array(
            [self.config.dataset_weights.get(n.lower(), 1.0) for n in dataset_names],
            dtype=np.float64)
        proportional = weights / weights.sum()
        if not self.config.curriculum_learning or len(dataset_names) == 1:
            return proportional
        progress = epoch / max(1, self.config.num_epochs)
        primary = np.zeros_like(proportional)
        primary[int(np.argmax(weights))] = 1.0
        if progress < 0.3:
            mix = 0.7 * primary + 0.3 * proportional
        elif progress < 0.6:
            blend = (progress - 0.3) / 0.3
            mix = ((1 - blend) * (0.7 * primary + 0.3 * proportional)
                   + blend * proportional)
        else:
            mix = proportional
        return mix / mix.sum()

    def _multi_dataset_iterator(self, iterators: dict, epoch: int):
        """Interleave batch indices of several datasets at the curriculum's
        probabilities. Yields (name, idx, mask)."""
        names = list(iterators.keys())
        probs = self._curriculum_probabilities(names, epoch)
        streams = {n: iter(it.epoch_indices(epoch)) for n, it in iterators.items()}
        total = sum(len(it) for it in iterators.values())
        rng = np.random.default_rng(self.config.seed * 100003 + epoch)
        produced = 0
        while produced < total and streams:
            live = list(streams.keys())
            p = np.array([probs[names.index(n)] for n in live])
            p = p / p.sum()
            name = rng.choice(live, p=p)
            try:
                idx, mask = next(streams[name])
                yield name, idx, mask
                produced += 1
            except StopIteration:
                del streams[name]

    # -- epochs --------------------------------------------------------------
    def train_epoch(self, train_iterators: dict, epoch: int) -> dict[str, float]:
        lr_scale = self._plateau_scale * self._spike_scale
        combined = (self._stage_combined({n: it.dataset for n, it in
                                          train_iterators.items()})
                    if self.config.fused_epochs else None)
        if combined is not None:
            return self._fused_epoch(train_iterators, epoch, combined, lr_scale)
        auxs = []
        for name, idx, _ in self._multi_dataset_iterator(train_iterators, epoch):
            batch = self._batch_from_indices(train_iterators[name].dataset, idx)
            auxs.append(self._train_step(
                batch, float(self.config.dataset_weights.get(name.lower(), 1.0)),
                lr_scale))
        if not auxs:
            return {}
        return {k: float(np.mean(torch.stack([a[k] for a in auxs]).cpu().numpy()))
                for k in auxs[0]}

    def validate_epoch(self, val_iterators: dict,
                       use_ema: Optional[bool] = None) -> dict:
        if use_ema is None:
            use_ema = self.config.ema_eval and self.config.ema_decay > 0
        params = self.ema_params if use_ema else None
        if use_ema and params is None:
            raise ValueError("use_ema=True requires TrainingConfig.ema_decay > 0")
        preds, targets, uncs, cal_uncs, eabs = [], [], [], [], []
        loss_sum, loss_count = 0.0, 0.0
        for it in val_iterators.values():
            for idx, mask_arr in it.epoch_indices(0):
                out = self._eval_step(self._batch_from_indices(it.dataset, idx),
                                      params)
                mask = mask_arr.astype(bool)
                preds.append(out["mu"][mask])
                targets.append(it.dataset.arrays["labels"][idx][mask])
                uncs.append(out["uncertainty"][mask])
                cal_uncs.append(out["calibrated_uncertainty"][mask])
                eabs.append(out["eabs"][mask])
                # Weight each batch's loss by its real rows, so the padding
                # of the last batch does not skew val_loss.
                n_real = float(mask.sum())
                loss_sum += float(out["loss"]) * n_real
                loss_count += n_real
        preds = np.concatenate(preds)
        targets = np.concatenate(targets)
        results = metrics_lib.evaluate_predictions(preds, targets,
                                                   np.concatenate(uncs))
        results["ece_calibrated"] = metrics_lib.ece_np(
            preds, targets, np.concatenate(cal_uncs))
        results["ece_eabs"] = metrics_lib.ece_np(preds, targets,
                                                 np.concatenate(eabs))
        # The learned channel ships only when it beats the closed-form
        # E|err| channel on validation ECE; ties go to the latter.
        results["serving_channel"] = (
            "calibrated" if results["ece_calibrated"] < results["ece_eabs"]
            else "eabs")
        results["val_loss"] = float(loss_sum / max(loss_count, 1.0))
        return results

    def train(self, train_datasets: Mapping[str, ArrayDataset],
              val_datasets: Mapping[str, ArrayDataset],
              num_epochs: Optional[int] = None,
              logger: Optional[MetricWriter] = None,
              checkpoints: Optional[CheckpointManager] = None,
              resume: bool = False) -> dict:
        cfg = self.config
        num_epochs = num_epochs or cfg.num_epochs
        train_iters = {n: BatchIterator(d, cfg.batch_size, shuffle=True,
                                        drop_last=True, seed=cfg.seed)
                       for n, d in train_datasets.items()}
        val_iters = {n: BatchIterator(d, cfg.batch_size, shuffle=False)
                     for n, d in val_datasets.items()}

        start_epoch = 0
        best_ccc = -np.inf
        best_serving_channel = "eabs"
        if resume and checkpoints is not None and checkpoints.latest_step() is not None:
            self.load_state_dict(checkpoints.restore(map_location=self.device))
            meta = checkpoints.metadata()["metrics"]
            start_epoch = int(meta.get("epoch", 0)) + 1
            best_ccc = float(meta.get("best_ccc", -np.inf))
            best_serving_channel = meta.get(
                "best_serving_channel", meta.get("serving_channel", "eabs"))

        # The optimizer's table covers the run up front (a fused run's graph
        # would be captured again over a larger one).
        steps = sum(len(it) for it in train_iters.values())
        self.optimizer.reserve(self.optimizer.state["count"] + 1 + max(
            0, num_epochs - start_epoch) * (steps // self._accum + 1))
        patience = 0
        t0 = time.time()
        for epoch in range(start_epoch, num_epochs):
            train_metrics = self.train_epoch(train_iters, epoch)
            self.history["train_loss"].append(train_metrics.get("loss", float("nan")))
            spiked = self._spike_update(
                train_metrics.get("loss"),
                nonfinite_frac=train_metrics.get("nonfinite_skipped", 0.0))
            if spiked and cfg.spike_rollback and self._best_state is not None:
                self.load_state_dict(self._best_state)
                if logger:
                    logger.scalar("train/spike_rollback", 1.0, epoch)
            lr = (self.schedule(self.step // self._accum)
                  * self._plateau_scale * self._spike_scale)
            self.history["learning_rate"].append(lr)
            if logger:
                logger.scalars(train_metrics, epoch, prefix="train/")
                logger.scalar("train/lr", lr, epoch)
                if spiked:
                    logger.scalar("train/lr_spike_backoff", self._spike_scale, epoch)

            if (epoch + 1) % cfg.val_frequency == 0:
                val = self.validate_epoch(val_iters)
                self.history["val_loss"].append(val["val_loss"])
                self.history["val_ccc"].append(val["ccc_average"])
                self.history["val_mae"].append(val["mae_average"])
                self.history["val_ece"].append(val.get("ece", float("nan")))
                if logger:
                    logger.scalars(val, epoch, prefix="val/")
                self._plateau_update(val["ccc_average"])
                is_best = val["ccc_average"] > best_ccc
                if is_best:
                    best_ccc = val["ccc_average"]
                    best_serving_channel = val["serving_channel"]
                    patience = 0
                    if cfg.spike_rollback:
                        self._best_state = self._copy_state()
                else:
                    patience += 1
                if checkpoints is not None and (
                        is_best or (epoch + 1) % cfg.save_frequency == 0):
                    checkpoints.save(
                        self.state_dict(), step=self.step,
                        metrics={"epoch": epoch, "best_ccc": best_ccc,
                                 "best_serving_channel": best_serving_channel,
                                 **val, **({"ensemble_members": self.n_members}
                                           if self.n_members > 1 else {})},
                        is_best=is_best, model=self._layout_meta())
                if patience >= cfg.early_stopping_patience:
                    break

        if checkpoints is not None:
            checkpoints.wait()
        return {
            "history": self.history,
            "best_val_ccc": float(best_ccc),
            "serving_channel": best_serving_channel,
            "epochs_run": epoch + 1 if num_epochs > start_epoch else start_epoch,
            "training_time_s": time.time() - t0,
            "final_step": self.step,
        }

    def _spike_update(self, loss: Optional[float],
                      nonfinite_frac: float = 0.0) -> bool:
        """Per-epoch loss-spike detector: True when this epoch's train loss
        is non-finite, more than 1% of its steps were skipped, or it lies
        beyond median + spike_threshold · sigma of the last clean epochs
        (sigma = max(1.4826 MAD, 5% of |median|, 1e-3)). Spiked epochs stay
        out of the history."""
        cfg = self.config
        if loss is None or not (cfg.spike_backoff or cfg.spike_rollback):
            return False
        hist = self._spike_history
        spiked = False
        if not np.isfinite(loss) or nonfinite_frac > 0.01:
            spiked = True
        elif len(hist) >= 3:
            med = float(np.median(hist))
            mad = float(np.median(np.abs(np.asarray(hist) - med)))
            sigma = max(1.4826 * mad, 0.05 * abs(med), 1e-3)
            spiked = loss > med + cfg.spike_threshold * sigma
        if spiked:
            if cfg.spike_backoff:
                self._spike_scale = max(
                    self._spike_scale * cfg.spike_backoff_factor, 1e-3)
        else:
            hist.append(float(loss))
            del hist[: -cfg.spike_window]
            if cfg.spike_backoff:
                self._spike_scale = min(self._spike_scale * cfg.spike_recovery, 1.0)
        return spiked

    def _plateau_update(self, metric: float) -> None:
        if self.config.scheduler != "plateau":
            return
        if metric > self._plateau_best + 1e-5:
            self._plateau_best = metric
            self._plateau_wait = 0
        else:
            self._plateau_wait += 1
            if self._plateau_wait >= 5:
                self._plateau_scale = max(self._plateau_scale * 0.5, 1e-3)
                self._plateau_wait = 0

    # -- evaluation convenience -------------------------------------------
    @property
    def params(self) -> dict[str, torch.Tensor]:
        """The trained parameters by state_dict name (an ensemble's
        stacked [K, ...])."""
        return self._params

    @property
    def n_parameters(self) -> int:
        return sum(p.numel() for p in self._params.values())

    @property
    def ema_params(self) -> Optional[dict]:
        """EMA shadow weights by state_dict name (None unless ema_decay > 0)."""
        return self.optimizer.state.get("ema")

    def predict(self, dataset: ArrayDataset, batch_size: Optional[int] = None,
                use_ema: bool = False, return_fused: bool = False,
                return_nig: bool = False) -> dict:
        params = self.ema_params if use_ema else None
        if use_ema and params is None:
            raise ValueError("use_ema=True requires TrainingConfig.ema_decay > 0")
        if return_fused and return_nig:
            raise ValueError("predict(return_fused=True, return_nig=True) is "
                             "not supported — request them in two calls")
        it = BatchIterator(dataset, batch_size or self.config.batch_size,
                           shuffle=False)
        keys = ("mu", "uncertainty", "calibrated_uncertainty", "aleatoric",
                "epistemic", "eabs")
        if return_fused:
            keys += ("fused",)
        elif return_nig:
            keys += ("nu", "alpha", "beta")
        outs: dict[str, list] = {k: [] for k in keys}
        masks = []
        for idx, mask_arr in it.epoch_indices(0):
            out = self._eval_step(self._batch_from_indices(dataset, idx), params,
                                  with_fused=return_fused, with_nig=return_nig)
            masks.append(mask_arr.astype(bool))
            for k in keys:
                outs[k].append(out[k])
        mask = np.concatenate(masks)
        return {k: np.concatenate(v)[mask] for k, v in outs.items()}

    def predict_mc_dropout(self, dataset: ArrayDataset, n_samples: int = 16,
                           batch_size: Optional[int] = None, seed: int = 0) -> dict:
        """Monte-Carlo-dropout predictive uncertainty (Gal & Ghahramani
        2016): per batch, `n_samples` dropout-on forwards run as one
        `torch.func.vmap` over the batch repeated S times, each sample with
        its own masks (`randomness="different"`: the draw of a dropout is
        one [S, B, ...] draw, laid out as a forward over the S·B rows of the
        repeated batch would draw it), then combined by moment matching
        (`core/nig.py:combine_members`): mu the sample mean, epistemic the
        mean NIG epistemic plus the variance of the sample means. The
        draws come from the device's generator seeded with `seed`
        (`train/rng.py`, forked: nothing outside sees it), so a seed
        repeats."""
        if n_samples < 1:
            raise ValueError(f"n_samples must be >= 1, got {n_samples}")
        it = BatchIterator(dataset, batch_size or self.config.batch_size,
                           shuffle=False)
        keys = ("mu", "uncertainty", "calibrated_uncertainty", "aleatoric",
                "epistemic")
        outs: dict[str, list] = {k: [] for k in keys}
        masks = []
        self.model.train()
        try:
            with torch.no_grad(), forked_rng(self.device):
                seed_global(self.device, seed)
                for idx, mask_arr in it.epoch_indices(0):
                    batch = self._batch_from_indices(dataset, idx)
                    out = combine_members(self._mc_samples(batch, n_samples))
                    masks.append(mask_arr.astype(bool))
                    for k in keys:
                        outs[k].append(out[k].cpu().numpy())
        finally:
            self.model.eval()
        mask = np.concatenate(masks)
        return {k: np.concatenate(v)[mask] for k, v in outs.items()}

    def _mc_samples(self, batch: dict, n_samples: int) -> dict:
        """[S, B, ...] outputs of S dropout-on forwards of `batch`."""
        rep = lambda x: x.unsqueeze(0).repeat(n_samples, *(1,) * x.dim())
        return torch.func.vmap(
            lambda a, v, t: uncertainty_outputs(self.model(a, v, t),
                                                self.model.config.dim_names),
            randomness="different")(*(rep(batch[k]) for k in ("audio", "video", "text")))


def create_trainer(model_config: Optional[DEERModelConfig] = None,
                   training_config: Optional[TrainingConfig] = None,
                   steps_per_epoch: int = 100, mesh=None, seed: int = 42,
                   device: DeviceLike = None) -> DEERTrainer:
    """Build the model (seeded init) and its trainer in one call."""
    from tpu_deer_torch.models.deer_model import create_complete_deer_model

    model = create_complete_deer_model(model_config, seed=seed, device=device)
    return DEERTrainer(model, training_config or TrainingConfig(seed=seed),
                       steps_per_epoch=steps_per_epoch, mesh=mesh, device=device)


def run_complete_training_pipeline(
    model_config: Optional[DEERModelConfig] = None,
    training_config: Optional[TrainingConfig] = None,
    train_datasets: Optional[Mapping[str, ArrayDataset]] = None,
    val_datasets: Optional[Mapping[str, ArrayDataset]] = None,
    experiment_dir: Optional[str] = None,
    mesh=None,
    device: DeviceLike = None,
) -> dict:
    """Build model and trainer, train, return the results (with "trainer").
    Without datasets it trains on the synthetic fixture."""
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.models.deer_model import create_complete_deer_model

    training_config = training_config or TrainingConfig()
    if train_datasets is None or val_datasets is None:
        splits = make_synthetic_splits(SyntheticConfig(seed=training_config.seed))
        train_datasets = {"synthetic": ArrayDataset(splits["train"], "synthetic")}
        val_datasets = {"synthetic": ArrayDataset(splits["val"], "synthetic")}
    model = create_complete_deer_model(model_config, seed=training_config.seed,
                                       device=device)
    steps_per_epoch = sum(len(d) // training_config.batch_size
                          for d in train_datasets.values())
    trainer = DEERTrainer(model, training_config, steps_per_epoch=steps_per_epoch,
                          mesh=mesh, device=device)
    logger = checkpoints = None
    if experiment_dir:
        logger = MetricWriter(f"{experiment_dir}/logs")
        checkpoints = CheckpointManager(f"{experiment_dir}/models")
    try:
        results = trainer.train(train_datasets, val_datasets, logger=logger,
                                checkpoints=checkpoints)
    finally:
        if logger is not None:
            logger.close()
    results["trainer"] = trainer
    return results
