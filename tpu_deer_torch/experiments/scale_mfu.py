"""Train-step MFU of the flagship's architecture from its own width to
production widths, on one card.

    python -m tpu_deer_torch.experiments.scale_mfu
    python -m tpu_deer_torch.experiments.scale_mfu --quick --platform cpu

Twin of `experiments/scale_mfu.py`, with its plans: the flagship (width 1:
encoder 256, fusion 512) at batch 16,384 in the default and the stacked
layout, width 4 (~62M parameters) at 2,048-16,384, width 8 (~240M) at
4,096 and 8,192, and width 8 with bf16 parameter storage at 8,192. The
step is `DEERTrainer`'s fused step (a CUDA graph replayed; `--iters` steps
after its warm-up), bf16 compute on the card, float32 on the CPU, as in
the reference. MFU is FLOPs (`utils/profiling.py:cost_analysis_summary`,
one eager step) over the step's time against the card's bf16 peak; the
roofline share is the two-ceiling bound of those FLOPs and the per-op
bytes (an over-count of the device's traffic, so it may pass 100%) over
the step's time. Each trainer is freed before the next. Results:
results_torch/RESULTS_scale_h100.{json,md} (`--quick`: `..._quick`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_deer_torch.experiments import twin

PLANS = (
    (1, (16384,), "float32", False),
    (1, (16384,), "float32", True),
    (4, (2048, 4096, 8192, 16384), "float32", False),
    (8, (4096, 8192), "float32", False),
    (8, (8192,), "bfloat16", False),
)
QUICK_PLANS = (
    (1, (64, 128), "float32", False),
    (1, (128,), "float32", True),
)


def measure(width_mult: int, batch_sizes, iters: int, device: torch.device,
            storage_dtype: str = "float32", stacked: bool = False) -> list[dict]:
    from tpu_deer_torch.data.pipeline import ArrayDataset
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        count_parameters,
        create_complete_deer_model,
    )
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig
    from tpu_deer_torch.utils.profiling import (
        cost_analysis_summary,
        peak_flops_per_chip,
        peak_hbm_bandwidth,
        profile_training_speed,
        roofline_seconds,
    )

    cuda = device.type == "cuda"
    config = DEERModelConfig(encoder_dim=256 * width_mult,
                             fusion_dim=512 * width_mult,
                             compute_dtype="bfloat16" if cuda else "float32",
                             stacked_compute=stacked)
    peak = peak_flops_per_chip(device) if cuda else None
    hbm_bw = peak_hbm_bandwidth(device) if cuda else None
    splits = make_synthetic_splits(SyntheticConfig(n_train=max(batch_sizes) * 2,
                                                   n_val=8, n_test=8))
    ds = ArrayDataset(splits["train"], "scale")
    rows = []
    for bs in batch_sizes:
        trainer = DEERTrainer(
            create_complete_deer_model(config, seed=0, device=device),
            TrainingConfig(batch_size=bs, num_epochs=1, fused_epochs=cuda,
                           storage_dtype=storage_dtype),
            steps_per_epoch=4, device=device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        stats = profile_training_speed(trainer, ds, iters=iters, sync_per_step=False)
        wall = time.time() - t0
        cost = cost_analysis_summary(
            trainer._train_step, trainer._batch_from_indices(ds, np.arange(bs)),
            1.0, 1.0)
        step_s = stats["step_ms_mean"] / 1e3
        row = {
            "batch_size": bs,
            "storage": storage_dtype,
            "stacked": stacked,
            "params": count_parameters(trainer.model),
            "step_ms": stats["step_ms_mean"],
            "samples_per_sec": stats["samples_per_sec"],
            "mfu_pct": 100.0 * cost["flops"] / (step_s * peak) if peak else None,
            "roofline_pct": (100.0 * roofline_seconds(cost["flops"], cost["bytes"],
                                                      peak, hbm_bw) / step_s
                             if peak and hbm_bw else None),
            "intensity": cost["flops"] / max(cost["bytes"], 1.0),
            "flops": cost["flops"],
            "bytes": cost["bytes"],
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                  if cuda else None),
        }
        rows.append(row)
        print(f"  width {width_mult} bs={bs}: {row['samples_per_sec']:,.0f} "
              f"samples/s, step {row['step_ms']:.3f} ms, MFU {_pct(row['mfu_pct'])}, "
              f"roofline {_pct(row['roofline_pct'])}, intensity "
              f"{row['intensity']:.1f} FLOP/B ({wall:.0f} s with the warm-up)",
              flush=True)
        del trainer
        if cuda:
            torch.cuda.empty_cache()
    return rows


def _pct(v) -> str:
    return "not measured" if v is None else f"{v:.1f}%"


def main(argv=None) -> int:
    p = twin.parser(__doc__, "scale")
    p.add_argument("--iters", type=int, default=30)
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "scale")
    plans, iters = (QUICK_PLANS, 3) if args.quick else (PLANS, args.iters)
    t0 = time.time()
    results = []
    for width_mult, batch_sizes, storage, stacked in plans:
        print(f"width {width_mult}, storage {storage}, stacked {stacked}:",
              flush=True)
        results.append({"width_mult": width_mult, "rows": measure(
            width_mult, batch_sizes, iters, device, storage, stacked)})
    payload = {"platform": platform, "quick": args.quick, "iters": iters,
               "plans": results, "elapsed_s": time.time() - t0}
    twin.write(args.out, report(payload, device), payload)
    return 0


def report(payload: dict, device) -> list[str]:
    """The Markdown table, and the prose computed from this run."""
    from tpu_deer_torch.utils.profiling import peak_flops_per_chip, peak_hbm_bandwidth

    peak = peak_flops_per_chip(device) if device.type == "cuda" else None
    hbm = peak_hbm_bandwidth(device) if device.type == "cuda" else None
    md = [
        "# Train-step MFU across widths — the port on the card",
        "",
        f"- platform: **{payload['platform']}**, one card; the step is the "
        "fused train step (forward, DEER loss, backward, clip, AdamW) replayed "
        f"from its CUDA graph, {payload['iters']} steps after the warm-up, "
        f"bf16 compute; {payload['elapsed_s']:.0f} s in all. Generated by "
        "`python -m tpu_deer_torch.experiments.scale_mfu`.",
        "- MFU: FLOPs of one eager step (`cost_analysis_summary`) over the "
        "step's time, against the card's dense bf16 peak. Roofline: the "
        "larger of FLOPs/peak and per-op bytes/bandwidth over the step's "
        "time; the per-op bytes over-count the device's traffic, so a share "
        "above 100% is that count's artifact.",
        "- 'stacked' = `models/stacked.py` (the three encoder trunks and the "
        "three evidence networks as batched products over [3, ...] "
        "parameters).",
        "",
        "| width | params | batch | storage | layout | samples/s | step ms | "
        "MFU | roofline | FLOP/B | peak memory |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for plan in payload["plans"]:
        for r in plan["rows"]:
            mem = ("not measured" if r["peak_memory_bytes"] is None
                   else f"{r['peak_memory_bytes'] / 2**30:.2f} GiB")
            md.append(
                f"| {plan['width_mult']} | {r['params']:,} | {r['batch_size']} | "
                f"{'bf16' if r['storage'] == 'bfloat16' else 'f32'} | "
                f"{'stacked' if r['stacked'] else 'default'} | "
                f"{r['samples_per_sec']:,.0f} | {r['step_ms']:.3f} | "
                f"{_pct(r['mfu_pct'])} | {_pct(r['roofline_pct'])} | "
                f"{r['intensity']:.1f} | {mem} |")
    rows = [(p["width_mult"], r) for p in payload["plans"] for r in p["rows"]]
    if peak and hbm:
        ridge = peak / hbm
        best_w, best = max(rows, key=lambda wr: wr[1]["mfu_pct"] or 0.0)
        md += ["", f"The card's ridge is {ridge:.0f} FLOP/B (bf16 peak over "
               "bandwidth). " + ", ".join(
                   f"width {w} at batch {r['batch_size']} ({r['storage']}) "
                   f"{r['intensity']:.0f} FLOP/B" for w, r in rows) + ". "
               f"The highest MFU is {_pct(best['mfu_pct'])} at width {best_w}, "
               f"batch {best['batch_size']}."]
        f32 = {r["batch_size"]: r for w, r in rows
               if w == 8 and r["storage"] == "float32"}
        bf = [r for w, r in rows if w == 8 and r["storage"] == "bfloat16"]
        for r in bf:
            if r["batch_size"] in f32:
                base = f32[r["batch_size"]]
                md.append(f"At width 8, batch {r['batch_size']}, bf16 storage "
                          f"takes {r['step_ms']:.3f} ms against "
                          f"{base['step_ms']:.3f} with float32 "
                          f"({base['step_ms'] / r['step_ms']:.2f}×).")
    md += ["", "Reproduce: `python -m tpu_deer_torch.experiments.scale_mfu` on "
           "the card (`--quick --platform cpu` for a CPU smoke)."]
    return md


if __name__ == "__main__":
    raise SystemExit(main())
