"""The bf16-storage train-step slowdown, bisected into stages, through the
port.

    python -m tpu_deer_torch.experiments.bf16_diag
    python -m tpu_deer_torch.experiments.bf16_diag --quick --platform cpu

Twin of `experiments/bf16_diag.py`, with its flags, stages and payload
keys. The flagship (seed 0) on one seeded batch (`--batch` 16,384 rows),
its parameters stored in float32 or bfloat16, dropout on, the multi-task
DEER loss; six stages, each a step function of device tensors captured as
one CUDA graph on the card and replayed `--k` times a timing (median of
`--reps`), so a time is the card's work and not Python's launches:

  fwd          — forward and loss (no gradient);
  grad         — forward and backward, the gradients consumed by a norm;
  sgd          — + p -= lr · g;
  clip+sgd     — + the global-norm clip of `train/optim.py:AdamW` first;
  adamw        — + clip and `AdamW` (the trainer's optimizer: under bf16
                 storage `_update_low`, optax's roundings op by op);
  adamw-f32opt — gradients, clip, moments and update in float32, the
                 update cast to the parameter's dtype at apply (the
                 reference's master-moment variant, `f32opt_update` here:
                 `AdamW`'s float32 arithmetic op for op, so at float32
                 storage it is the `adamw` stage in every bit).

Beside each time: the kernels and memory operations one replay puts on the
card (the profiler). The twin measures only; it changes nothing in
`train/optim.py`.

Differences from the reference: the model computes in bfloat16 on the card
and float32 on the CPU (as the reference's on its TPU and CPU), TF32 off;
`--platform` picks the card (`cuda`, the default; it raises without one)
or the CPU; results go to `results_torch/RESULTS_bf16_diag_h100.{json,md}`
(`--quick`: batch 256, k 2, one rep, `..._quick`), the platform naming the
card and its power limit. No time of the reference's TPU run is compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_deer_torch.experiments import twin

STAGES = ("fwd", "grad", "sgd", "clip+sgd", "adamw", "adamw-f32opt")
LR, WEIGHT_DECAY, MAX_NORM = 1e-3, 1e-5, 1.0


def f32_optimizer(params: dict):
    """The `AdamW` whose clip, table, count and float32 moments
    `f32opt_update` uses for `params` (one group, every parameter): built
    over the float32 parameters themselves and float32 stand-ins for the
    others, which it never writes."""
    from tpu_deer_torch.train.optim import AdamW

    masters = {k: p if p.dtype == torch.float32
               else torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()}
    return AdamW(masters, {"main": (1.0, list(masters))}, lambda c: LR,
                 WEIGHT_DECAY, MAX_NORM)


def f32opt_update(opt, params: list, grads: list) -> None:
    """One step of the reference's adamw-f32opt (optax's clip → adamw on
    float32 gradients, moments and parameter copies; updates cast to each
    parameter's dtype, then added): `AdamW.update`'s float32 path op for
    op, with the update applied through the cast."""
    from tpu_deer_torch.train.optim import B1, B2, EPS

    st = opt.state
    names = list(opt.params)
    with torch.no_grad():
        g = opt.clip([x.float() for x in grads])
        lr, bc1, bc2 = opt.table.index_select(0, opt.count)[0].unbind()
        p32 = [x.float() for x in params]
        mu = [st["mu"][k] for k in names]
        nu = [st["nu"][k] for k in names]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - B2)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, p32, alpha=opt.weight_decay)
        torch._foreach_mul_(upd, lr * 1.0 * 1.0)
        torch._foreach_sub_(params, [u.to(p.dtype) for u, p in zip(upd, params)])
        opt.count.add_(1)


def build_step(variant: str, storage: str, batch: int, device, steps: int):
    """(step function of no arguments, the model): the stage `variant`
    with parameters stored in `storage`; `steps` bounds the optimizer's
    count (its learning-rate table)."""
    from tpu_deer_torch.convert import flax_key
    from tpu_deer_torch.core import losses as loss_lib
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        create_complete_deer_model,
    )
    from tpu_deer_torch.models.layers import torch_dtype
    from tpu_deer_torch.train.optim import AdamW

    config = DEERModelConfig(
        compute_dtype="bfloat16" if device.type == "cuda" else "float32")
    model = create_complete_deer_model(config, seed=0, device=device).train()
    params = dict(model.named_parameters())
    if storage != "float32":
        for p in params.values():
            if p.is_floating_point():
                p.data = p.data.to(torch_dtype(storage))
    rng = np.random.default_rng(0)
    arrays = {
        "audio": rng.standard_normal((batch, 84)).astype(np.float32),
        "video": rng.standard_normal((batch, 256)).astype(np.float32),
        "text": rng.standard_normal((batch, 768)).astype(np.float32),
        "labels": np.tanh(rng.standard_normal((batch, 3))).astype(np.float32),
    }
    b = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    names, plist = list(params), list(params.values())

    def loss_fn():
        out = model(b["audio"], b["video"], b["text"])
        ps = [out[f"{n}_params"] for n in config.dim_names]
        return loss_lib.multi_task_deer_loss(
            ps, b["labels"], loss_lib.DEERLossConfig())["total_loss"]

    def grads_of():
        """The loss and every parameter's gradient, zeros for those the
        loss does not reach (the calibration layer), as jax.grad gives."""
        loss = loss_fn()
        grads = torch.autograd.grad(loss, plist, allow_unused=True)
        return loss, [torch.zeros_like(p) if g is None else g
                      for p, g in zip(plist, grads)]

    if variant == "fwd":
        def step():
            with torch.no_grad():
                return loss_fn()
        return step, model

    if variant == "grad":
        def step():
            loss, grads = grads_of()
            return loss + 0.0 * torch.stack(torch._foreach_norm(grads)).norm()
        return step, model

    opt = AdamW(params, {"main": (1.0, names)}, lambda c: LR, WEIGHT_DECAY,
                MAX_NORM, norm_order=sorted(names, key=lambda k: flax_key(
                    k, params[k].dim())))
    opt.reserve(steps)
    if variant == "adamw-f32opt":
        f32opt = f32_optimizer(params)
        f32opt.reserve(steps)

    def step():
        loss, grads = grads_of()
        if variant == "adamw":
            opt.update(grads, None, 1.0, 0)
        elif variant == "adamw-f32opt":
            f32opt_update(f32opt, plist, grads)
        else:
            if variant == "clip+sgd":
                opt.clip(grads)
            with torch.no_grad():
                torch._foreach_add_(plist, grads, alpha=-LR)
        return loss

    return step, model


def run_stage(variant: str, storage: str, args, device, sync):
    """(ms a step, kernels a replay or None) of one stage."""
    steps = args.k * (args.reps + 1) + 16
    step, model = build_step(variant, storage, args.batch, device, steps)
    call = twin.graphed(step, device)
    ms = twin.median_ms(call, args.k, args.reps, sync)
    kernels = twin.device_kernels(call, device)
    del call, step, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return ms, kernels


def main(argv=None) -> int:
    p = twin.parser(__doc__, "bf16_diag")
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--k", type=int, default=30, help="steps per timing")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "bf16_diag")
    if args.quick:
        args.batch, args.k, args.reps = 256, 2, 1
    sync = twin.synchronize(device)

    rows = []
    t0 = time.time()
    for variant in STAGES:
        row = {"variant": variant}
        for storage in ("float32", "bfloat16"):
            ms, kernels = run_stage(variant, storage, args, device, sync)
            row[storage] = ms
            row[f"{storage}_kernels"] = kernels
            print(f"{variant:>14} {storage:>9}: {ms:8.3f} ms/step, "
                  f"{kernels} kernels a replay", flush=True)
        row["bf16_over_f32"] = row["bfloat16"] / row["float32"]
        rows.append(row)
    payload = {"platform": platform, "batch": args.batch, "k": args.k,
               "reps": args.reps, "elapsed_s": time.time() - t0, "rows": rows}

    ref = twin.reference("bf16_diag")
    md = [
        "# bf16-storage slowdown bisect — the port on the card",
        "",
        f"- platform: **{platform}**, batch {args.batch}, "
        f"{'bfloat16' if device.type == 'cuda' else 'float32'} compute, "
        f"dropout on; each stage one CUDA graph of the step, {args.k} "
        f"replays a timing and one synchronize, the median of {args.reps}; "
        f"{payload['elapsed_s']:.0f}s total. Stages in "
        "`tpu_deer_torch/experiments/bf16_diag.py`.",
        "- kernels: the kernels and memory operations one replay puts on "
        "the card (the profiler; — where not measured).",
        "",
        "| stage | f32 storage ms | bf16 storage ms | bf16/f32 | kernels "
        "f32 / bf16 |",
        "|---|---|---|---|---|",
    ]
    count = lambda n: "—" if n is None else str(n)
    for r in rows:
        md.append(f"| {r['variant']} | {r['float32']:.3f} | "
                  f"{r['bfloat16']:.3f} | {r['bf16_over_f32']:.2f}x | "
                  f"{count(r['float32_kernels'])} / "
                  f"{count(r['bfloat16_kernels'])} |")
    if ref:
        md += ["", "The reference's ratios on its TPU (times not compared): "
               + ", ".join(f"{r['variant']} {r['bf16_over_f32']:.2f}x"
                           for r in ref["rows"]) + "."]
    md += [
        "",
        "Reading: the first stage whose bf16/f32 ratio jumps well above 1.0 "
        "carries the mechanism; `adamw` against `adamw-f32opt` isolates the "
        "bf16 optimizer arithmetic from the backward's.",
        "",
        "Reproduce: `python -m tpu_deer_torch.experiments.bf16_diag` on the "
        "card (`--quick --platform cpu` for a CPU smoke).",
    ]
    twin.write(args.out, md, payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
