"""Root-cause a training spike of the headline recipe at seed 2, through the
port: find the epoch whose loss jumps, the step inside it that breaks, and
what that step does to each module.

    python -m tpu_deer_torch.experiments.spike_study
    python -m tpu_deer_torch.experiments.spike_study --quick --platform cpu

Twin of `experiments/spike_study.py`, with its flags, defaults, phases,
detectors and payload keys. The headline recipe at `--seed` (data seed
42 + seed, init seed seed; 1,048,576 rows, batch 4,096, lr 1.2e-3 cosine
over 100 epochs with 5 warm-up epochs, dropout 0.05, KL 0.01, calibration
0.15, validation every 10 epochs, spike backoff and rollback off):

  1. the trajectory, fused epochs (a CUDA graph of the step on the card)
     through `DEERTrainer.train_epoch`, a copy of the whole training state
     (`_copy_state`: parameters, optimizer with its table's count, step and
     the dropout generator) kept for each of the last epochs from
     `--watch_from` on, until an epoch's loss exceeds the median of the
     four before it by 0.05 (the reference's epoch-level detector) or
     `--epochs` have run;
  2. the spike epoch replayed per step from its snapshot (`load_state_dict`)
     through `_multi_dataset_iterator`, `_batch_from_indices` and
     `_train_step(batch, 1.0, 1.0)`, each step's loss and gradient norm
     read from its scalars (fetched once); a step is bad if its loss
     exceeds the median of the first 8 by 0.3 or its gradient norm 20×
     theirs;
  3. the first bad step dissected from the snapshot replayed to it: the
     pre-clip gradient of `_loss_fn` at the step's generator state (the
     dropout draws the step then takes) and its norm per module, whether
     the clip saturates, the NIG parameters' extremes before and after the
     step (`nig_stats`), and each module's parameter norm before and its
     change in the step. Modules carry the reference's names
     (`convert.py:flax_key`: `heads.<dim>` is `deer_head_<dim>`).

The model computes in bfloat16 on the card, as the reference's does on its
TPU, and in float32 on the CPU. A spike is chaotic: where this seed does
not spike on the card the twin writes the reference's "no spike
reproduced" report; it searches no other seed.

Differences from the reference: `--platform` picks the card (`cuda`, the
default; it raises without one) or the CPU; `--quick` (4,096 rows at batch
256, 6 epochs watched from 2) runs where `--platform` says; results go to
`results_torch/RESULTS_spike_h100.{json,md}` (`--quick`: `..._quick`), and
the payload's `platform` names the card and its power limit.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from tpu_deer_torch.experiments import twin


def module_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    """The L2 norm of the tensors (by state_dict name) of each of the
    reference's top-level modules, keyed by its name (float32 squares),
    fetched from the device once."""
    from tpu_deer_torch.convert import flax_key

    modules: dict[str, list[str]] = {}
    for name, t in tensors.items():
        modules.setdefault(flax_key(name, t.dim())[0], []).append(name)
    sq = torch.stack([sum(torch.sum(torch.square(tensors[n].float()))
                          for n in names) for names in modules.values()])
    return dict(zip(modules, np.sqrt(sq.double().cpu().numpy()).tolist()))


def nig_stats(trainer, batch: dict) -> dict:
    """The NIG parameters' extremes and means per dimension on `batch`
    (the model in eval mode), fetched from the device once."""
    model = trainer.model
    model.eval()
    with torch.no_grad():
        out = model(batch["audio"], batch["video"], batch["text"])
        keys = ("alpha_min", "alpha_mean", "nu_min", "nu_mean", "beta_max",
                "beta_mean", "mu_absmax")
        stats = []
        for n in model.config.dim_names:
            p = out[f"{n}_params"]
            stats.append(torch.stack([
                p.alpha.min(), p.alpha.mean(), p.nu.min(), p.nu.mean(),
                p.beta.max(), p.beta.mean(), p.mu.abs().max()]).float())
        values = torch.stack(stats).cpu().numpy()
    return {n: dict(zip(keys, map(float, row)))
            for n, row in zip(model.config.dim_names, values)}


def preclip_grads(trainer, batch: dict, weight: float = 1.0):
    """(loss, the step's scalars, {name: gradient}) of `_loss_fn` on
    `batch`, before the clip, with the dropout draws the next `_train_step`
    takes: the trainer's generator is put back where it was."""
    from tpu_deer_torch.train.rng import seeded_dropout

    state = trainer.generator.get_state()
    trainer.model.train()
    with seeded_dropout(trainer.generator, trainer.device, trainer._recompute):
        loss, aux = trainer._loss_fn(batch, weight)
    trainer.generator.set_state(state)
    names = list(trainer.params)
    grads = torch.autograd.grad(loss, [trainer.params[n] for n in names],
                                allow_unused=True)
    return loss.detach(), aux, {n: (torch.zeros_like(trainer.params[n])
                                    if g is None else g)
                                for n, g in zip(names, grads)}


def dissect(trainer, batch: dict, step: int, clip: float) -> tuple[dict, float]:
    """Phase 3 on one step, which is taken here: (the reference's
    dissection record, the step's own gradient norm)."""
    pre_nig = nig_stats(trainer, batch)
    pre = {n: p.detach().clone() for n, p in trainer.params.items()}
    pre_norms = module_norms(pre)
    loss, aux0, grads = preclip_grads(trainer, batch)
    gmod = module_norms(grads)
    gtot = float(np.sqrt(sum(v * v for v in gmod.values())))
    aux1 = trainer._train_step(batch, 1.0, 1.0)
    post_nig = nig_stats(trainer, batch)
    delta = module_norms({n: trainer.params[n].detach().float() - pre[n].float()
                          for n in pre})
    scalars = torch.stack([loss.float(), aux0["nll"].float(),
                           aux0["calibration_alignment"].float(),
                           aux0["mean_uncertainty"].float(),
                           aux1["grad_norm"].float()]).cpu().numpy()
    return {
        "step": step,
        "loss_at_step": float(scalars[0]),
        "aux_nll": float(scalars[1]),
        "aux_calibration": float(scalars[2]),
        "aux_mean_uncertainty": float(scalars[3]),
        "grad_norm_preclip_total": gtot,
        "clip_saturated": gtot > clip,
        "grad_module_norms": gmod,
        "param_module_norms_pre": pre_norms,
        "param_delta_norms": delta,
        "nig_pre": pre_nig,
        "nig_post": post_nig,
    }, float(scalars[4])


def replay(trainer, iters: dict, epoch: int, snapshot: dict,
           stop: int | None = None):
    """The epoch from `snapshot`, per step: (losses, grad norms, each
    step's batch indices). With `stop`, only the steps before it."""
    trainer.load_state_dict(snapshot)
    auxes, rows = [], []
    for name, idx, _ in trainer._multi_dataset_iterator(iters, epoch):
        if stop is not None and len(rows) == stop:
            break
        rows.append(idx)
        batch = trainer._batch_from_indices(iters[name].dataset, idx)
        aux = trainer._train_step(batch, 1.0, 1.0)
        auxes.append(torch.stack([aux["loss"].float(), aux["grad_norm"].float()]))
    if not auxes:
        return np.zeros(0), np.zeros(0), rows
    values = torch.stack(auxes).double().cpu().numpy()
    return values[:, 0], values[:, 1], rows


def bad_steps(losses: np.ndarray, gnorms: np.ndarray) -> np.ndarray:
    """The reference's rule: loss above the first 8 steps' median + 0.3, or
    gradient norm above 20× theirs."""
    med, gmed = np.median(losses[:8]), np.median(gnorms[:8])
    return np.nonzero((losses > med + 0.3) | (gnorms > 20.0 * max(gmed, 1e-6)))[0]


def spiked(losses: list[float], epoch: int, watch_from: int) -> bool:
    """The reference's epoch-level detector: from `watch_from` on, the loss
    above the median of the four epochs before it + 0.05."""
    return (epoch >= watch_from and len(losses) > 4
            and losses[-1] > np.median(losses[-5:-1]) + 0.05)


def build(args, device, compute_dtype=None):
    """(trainer, iterators, training config) of the headline recipe at
    `args.seed`, computing in `compute_dtype` (None: bfloat16 on the card,
    float32 on the CPU)."""
    from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        create_complete_deer_model,
    )
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

    splits = make_synthetic_splits(SyntheticConfig(
        n_train=args.n_train, n_val=args.n_train // 8, n_test=args.n_train // 8,
        seed=42 + args.seed))
    train_ds = ArrayDataset(splits["train"], "synthetic")
    config = DEERModelConfig(dropout=0.05, compute_dtype=compute_dtype
                             or twin.compute_dtype(device))
    model = create_complete_deer_model(config, seed=args.seed, device=device)
    steps = len(train_ds) // args.batch_size
    tcfg = TrainingConfig(
        learning_rate=1.2e-3, batch_size=args.batch_size, num_epochs=100,
        warmup_epochs=5, scheduler="cosine", early_stopping_patience=10**6,
        val_frequency=10, kl_weight=0.01, calibration_alignment_weight=0.15,
        fused_epochs=device.type == "cuda", spike_backoff=False,
        spike_rollback=False)
    trainer = DEERTrainer(model, tcfg, steps_per_epoch=steps, device=device)
    # The table of learning rates for the whole horizon, so the fused
    # step's graph is captured once.
    trainer.optimizer.reserve(1 + tcfg.num_epochs * (steps + 1))
    iters = {"synthetic": BatchIterator(train_ds, args.batch_size, shuffle=True,
                                        drop_last=True, seed=tcfg.seed)}
    return trainer, iters, tcfg


def report(payload: dict, args, wall: float) -> list[str]:
    """The reference's Markdown report of a dissected spike."""
    platform, losses = payload["platform"], payload["epoch_losses"]
    rep, dissect_ = payload["replay"], payload.get("dissection")
    md = [
        f"# Training-spike dissection — headline seed {args.seed}, the port",
        "",
        f"- platform **{platform}**, data seed {42 + args.seed} / init seed "
        f"{args.seed}, the headline recipe ({args.n_train:,} x bs "
        f"{args.batch_size}, lr 1.2e-3 cosine, kl 0.01), spike_backoff/rollback "
        f"OFF to observe the raw dynamics. {wall:.0f}s total.",
        "",
        f"Epoch-level: loss {losses[-2]:+.3f} → {losses[-1]:+.3f} at epoch "
        f"{payload['spike_epoch']} (the reference's TPU run: epoch 64).",
        "",
        "## Unfused replay of the spike epoch",
        "",
        f"- {rep['n_steps']} steps; first bad step **{rep['first_bad_step']}**, "
        f"{rep['n_bad_steps']} bad steps (loss > opening-median+0.3 OR grad "
        "norm > 20x opening median)",
        f"- per-step loss range [{rep['loss_min']:+.3f}, {rep['loss_max']:+.3f}]; "
        f"grad-norm median {rep['grad_norm_median']:.2f}, max "
        f"**{rep['grad_norm_max']:.1f}** (clip 1.0)",
    ]
    if dissect_:
        g, d = dissect_["grad_module_norms"], dissect_["param_delta_norms"]
        top_g = sorted(g, key=g.get, reverse=True)[:3]
        top_d = sorted(d, key=d.get, reverse=True)[:3]
        head_g = {k: v for k, v in g.items() if k.startswith("deer_head_")}
        if head_g:
            worst = max(head_g, key=head_g.get)
            amin = dissect_["nig_pre"].get(worst[len("deer_head_"):], {}).get(
                "alpha_min")
            if amin is not None:
                md += [
                    "",
                    f"**Mechanism**: the gradient is dominated by `{worst}` "
                    f"(norm {head_g[worst]:.1f} of "
                    f"{dissect_['grad_norm_preclip_total']:.1f} total) whose "
                    f"alpha_min sits at {amin:.3f} — the evidential NLL's "
                    "1/(alpha-1) term is steep there.",
                ]
        md += [
            "",
            f"## Dissection of step {dissect_['step']}",
            "",
            f"- loss at the step: {dissect_['loss_at_step']:+.3f} (NLL "
            f"{dissect_['aux_nll']:+.3f}, calibration "
            f"{dissect_['aux_calibration']:+.3f})",
            f"- pre-clip global grad norm **"
            f"{dissect_['grad_norm_preclip_total']:.1f}** — clip "
            f"{'SATURATED' if dissect_['clip_saturated'] else 'not saturated'}"
            " (the update direction is preserved; the clip bounds magnitude "
            "only)",
            "- largest per-module grad norms: "
            + ", ".join(f"{k} {g[k]:.2f}" for k in top_g),
            "- largest per-module param deltas this step: "
            + ", ".join(f"{k} {d[k]:.4f}" for k in top_d),
            "- NIG extremes before → after (per dim):",
        ]
        for n, pre in dissect_["nig_pre"].items():
            post = dissect_["nig_post"][n]
            md.append(
                f"  - {n}: alpha_min {pre['alpha_min']:.3f} → "
                f"{post['alpha_min']:.3f}, nu_min {pre['nu_min']:.4f} → "
                f"{post['nu_min']:.4f}, beta_max {pre['beta_max']:.2f} → "
                f"{post['beta_max']:.2f}, |mu|_max {pre['mu_absmax']:.2f} → "
                f"{post['mu_absmax']:.2f}")
    md += ["", "Reproduce: `python -m tpu_deer_torch.experiments.spike_study` "
           "on the card (`--quick --platform cpu` for a CPU smoke)."]
    return md


def main(argv=None) -> int:
    p = twin.parser(__doc__, "spike")
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--n_train", type=int, default=1048576)
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--epochs", type=int, default=70,
                   help="how far to run (the reference's seed-2 spike: epoch 64)")
    p.add_argument("--watch_from", type=int, default=60,
                   help="snapshot states from this epoch on")
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "spike")
    if args.quick:
        args.n_train, args.batch_size = 4096, 256
        args.epochs, args.watch_from = 6, 2
    t0 = time.time()
    trainer, iters, tcfg = build(args, device)

    print("phase 1: trajectory to the spike…", file=sys.stderr, flush=True)
    snapshots: dict[int, dict] = {}
    losses: list[float] = []
    spike_epoch = None
    for epoch in range(args.epochs):
        if epoch >= args.watch_from:
            snapshots[epoch] = trainer._copy_state()
            snapshots = {e: s for e, s in snapshots.items() if e >= epoch - 2}
        losses.append(trainer.train_epoch(iters, epoch).get("loss", float("nan")))
        if epoch % 10 == 0 or epoch >= args.watch_from:
            print(f"  epoch {epoch}: loss {losses[-1]:+.4f} "
                  f"t={time.time() - t0:.0f}s", file=sys.stderr, flush=True)
        if spiked(losses, epoch, args.watch_from):
            spike_epoch = epoch
            break

    payload = {"platform": platform, "seed": args.seed,
               "recipe": {"n_train": args.n_train, "batch": args.batch_size},
               "epoch_losses": losses, "spike_epoch": spike_epoch}
    if spike_epoch is None:
        md = [
            "# Training-spike dissection — no spike reproduced",
            "",
            f"- platform **{platform}**, seed {args.seed}, {len(losses)} epochs "
            "run, no epoch-level loss jump detected under this configuration "
            f"(the reference's TPU run spiked at epoch 64). "
            f"{time.time() - t0:.0f}s total.",
        ]
        twin.write(args.out, md, payload)
        return 0

    print(f"phase 2: unfused replay of epoch {spike_epoch}…", file=sys.stderr,
          flush=True)
    step_losses, gnorms, rows = replay(trainer, iters, spike_epoch,
                                       snapshots[spike_epoch])
    bad = bad_steps(step_losses, gnorms)
    payload["replay"] = {
        "n_steps": len(step_losses),
        "loss_min": float(step_losses.min()),
        "loss_max": float(step_losses.max()),
        "first_bad_step": int(bad[0]) if len(bad) else None,
        "n_bad_steps": int(len(bad)),
        "grad_norm_max": float(gnorms.max()),
        "grad_norm_median": float(np.median(gnorms)),
    }
    print(f"  replay: {len(bad)} bad steps, first at "
          f"{payload['replay']['first_bad_step']}, grad_norm max "
          f"{gnorms.max():.1f}", file=sys.stderr, flush=True)
    if len(bad):
        s_star = int(bad[0])
        print(f"phase 3: dissect step {s_star}…", file=sys.stderr, flush=True)
        replay(trainer, iters, spike_epoch, snapshots[spike_epoch], stop=s_star)
        batch = trainer._batch_from_indices(iters["synthetic"].dataset,
                                            rows[s_star])
        payload["dissection"], _ = dissect(trainer, batch, s_star,
                                           tcfg.gradient_clip)
    twin.write(args.out, report(payload, args, time.time() - t0), payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
