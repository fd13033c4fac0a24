"""The stacked layout (`stacked_compute=True`) against the default one on
the card: the forward and the full train step at batch 16,384.

    python -m tpu_deer_torch.experiments.stacked_bench
    python -m tpu_deer_torch.experiments.stacked_bench --quick --platform cpu

Twin of `experiments/stacked_bench.py`: the flagship's forward and its full
train step (forward, DEER loss, backward, clip, AdamW) at batch 16,384 in
float32, for the default layout and for the stacked one (the three
encoder trunks and the three evidence networks as batched products over
[3, ...] parameters, `models/stacked.py`), each graphed (a CUDA graph
replayed: the forward's, and the fused train step's, `DEERTrainer` with
fused epochs) and eager. Each time is the host clock over `--k` calls
ending in a synchronize, the median of `--reps` such runs; MFU is FLOPs
(`utils/profiling.py:cost_analysis_summary`) over time against the card's
float32 peak (67 TFLOP/s: TF32 is off) and its bf16 peak (989 TFLOP/s, the
port's bench's yardstick). The stacked forward runs on the default
weights through `stack_params`, and its outputs are held against the
default's. Results: results_torch/RESULTS_stacked_h100.{json,md}; the
reference's TPU times (experiments/RESULTS_stacked.md) are not compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_deer_torch.experiments import twin

SEED = 0


def _graphed(fn, device):
    """A CUDA graph of `fn()` (two warm-up runs on a side stream) and its
    replay."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph.replay, out


def main(argv=None) -> int:
    p = twin.parser(__doc__, "stacked")
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--k", type=int, default=30)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "stacked")
    if args.quick:
        args.batch, args.k, args.reps = 256, 2, 1

    from tpu_deer_torch.data.pipeline import ArrayDataset
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.models.deer_model import (
        CompleteDEERModel,
        DEERModelConfig,
        create_complete_deer_model,
    )
    from tpu_deer_torch.models.stacked import stack_params
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig
    from tpu_deer_torch.utils.profiling import (
        cost_analysis_summary,
        peak_flops_per_chip,
        profile_training_speed,
    )

    cuda = device.type == "cuda"
    sync = twin.synchronize(device)
    b = args.batch
    splits = make_synthetic_splits(SyntheticConfig(n_train=2 * b, n_val=8,
                                                   n_test=8, seed=SEED))
    train_ds = ArrayDataset(splits["train"], "stacked")
    x = tuple(torch.from_numpy(splits["train"][k][:b]).to(device)
              for k in ("audio", "video", "text"))
    default = create_complete_deer_model(seed=SEED, device=device)
    stacked = CompleteDEERModel(DEERModelConfig(stacked_compute=True))
    stacked.load_state_dict(stack_params(default.state_dict()))
    models = {"default": default, "stacked": stacked.to(device).eval()}

    t0 = time.time()
    rows = {"fwd": {}, "train": {}}
    flops = {}
    with torch.inference_mode():
        outs = {k: m(*x)["mu_all"] for k, m in models.items()}
    fwd_diff = float((outs["stacked"] - outs["default"]).abs().max())
    for key, model in models.items():
        def fwd(model=model):
            with torch.inference_mode():
                return model(*x)["mu_all"]

        rows["fwd"][f"{key}_eager"] = twin.median_ms(fwd, args.k, args.reps, sync)
        if cuda:
            replay, _ = _graphed(fwd, device)
            rows["fwd"][f"{key}_graphed"] = twin.median_ms(replay, args.k,
                                                       args.reps, sync)
        flops[f"fwd_{key}"] = cost_analysis_summary(fwd)["flops"]

        for fused in ((True, False) if cuda else (False,)):
            trainer = DEERTrainer(
                CompleteDEERModel(models[key].config).to(device),
                TrainingConfig(batch_size=b, num_epochs=1, fused_epochs=fused),
                steps_per_epoch=2, device=device)
            trainer.model.load_state_dict(models[key].state_dict())
            times = [profile_training_speed(trainer, train_ds, iters=args.k,
                                            sync_per_step=False)["step_ms_mean"]
                     for _ in range(args.reps)]
            rows["train"][f"{key}_{'graphed' if fused else 'eager'}"] = float(
                np.median(times))
            if not fused:
                batch = trainer._batch_from_indices(train_ds, np.arange(b))
                flops[f"train_{key}"] = cost_analysis_summary(
                    trainer._train_step, batch, 1.0, 1.0)["flops"]
            del trainer
        print(f"{key}: " + ", ".join(f"{stage} {k} {v:.3f} ms"
                                     for stage, r in rows.items()
                                     for k, v in r.items() if k.startswith(key)),
              flush=True)
    elapsed = time.time() - t0

    bf16_peak = peak_flops_per_chip(device)
    fp32_peak = peak_flops_per_chip(device, dtype="float32")
    mfu = {}
    for stage, r in rows.items():
        for name, ms in r.items():
            f = flops[f"{stage}_{name.split('_')[0]}"]
            mfu[f"{stage}_{name}"] = {
                "fp32_pct": (100.0 * f / (ms / 1e3) / fp32_peak
                             if cuda and fp32_peak else None),
                "bf16_pct": (100.0 * f / (ms / 1e3) / bf16_peak
                             if cuda and bf16_peak else None)}
    fmt = lambda v: "not measured" if v is None else f"{v:.1f}%"
    md = [
        "# Stacked batched-product layout — the port on the card",
        "",
        f"- platform: **{platform}**, float32 (TF32 off), batch {b}, "
        f"{args.k} calls per timing, median of {args.reps}, "
        f"{elapsed:.0f}s total",
        "- 'stacked' = `models/stacked.py` (the three encoder trunks and the "
        "three evidence networks as batched products over [3, ...] "
        "parameters) on the default weights through `stack_params`: "
        f"forward max |Δμ| {fwd_diff:.2e} against 'default'",
        "- graphed = one CUDA graph replayed (the train step's is "
        "`DEERTrainer`'s fused step); eager = the same calls launched op by "
        "op",
        "",
        "| stage | run | default ms | stacked ms | speedup | MFU fp32 peak "
        "(default / stacked) | MFU bf16 peak (default / stacked) |",
        "|---|---|---|---|---|---|---|",
    ]
    for stage, r in rows.items():
        for run in ("graphed", "eager"):
            if f"default_{run}" not in r:
                continue
            d, s = r[f"default_{run}"], r[f"stacked_{run}"]
            md.append(
                f"| {stage} | {run} | {d:.3f} | {s:.3f} | {d / s:.2f}x | "
                f"{fmt(mfu[f'{stage}_default_{run}']['fp32_pct'])} / "
                f"{fmt(mfu[f'{stage}_stacked_{run}']['fp32_pct'])} | "
                f"{fmt(mfu[f'{stage}_default_{run}']['bf16_pct'])} / "
                f"{fmt(mfu[f'{stage}_stacked_{run}']['bf16_pct'])} |")
    md += ["", "FLOPs per call (`cost_analysis_summary`): "
           + ", ".join(f"{k} {v / 1e9:.1f} G" for k, v in flops.items()),
           "", "Reproduce: `python -m tpu_deer_torch.experiments.stacked_bench` "
               "on the card (`--quick --platform cpu` for a CPU smoke)."]
    twin.write(args.out, md, {"rows": rows, "flops": flops, "mfu": mfu,
                              "fwd_max_abs_diff": fwd_diff,
                              "platform": platform, "elapsed_s": elapsed,
                              "args": vars(args)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
