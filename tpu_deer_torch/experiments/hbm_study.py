"""The flagship train step against the card's memory and matmul ceilings.

    python -m tpu_deer_torch.experiments.hbm_study
    python -m tpu_deer_torch.experiments.hbm_study --quick --platform cpu

Twin of `experiments/hbm_study.py`: three measured ceilings on one card,
set beside an analytic traffic floor of the flagship's train step.

  1. Bandwidth: `y.mul_(a).add_(b)` chained `k` times over an [n] float32
     buffer. Each call launches two elementwise kernels, each reading and
     writing every element once: 16 bytes an element a call.
  2. Matmul ceiling: the flagship's layer widths as a dense chain ([B,
     1108] → 256, 6 × 256 → 256, → 512, 2 × 512 → 512, → 12, tanh between)
     at batch B, float32 (TF32 off: outside the tensor cores) and bf16;
     achieved FLOP/s against the card's peak for that dtype
     (`utils/profiling.py:peak_flops_per_chip`).
  3. The real train step (`DEERTrainer`, fused: a CUDA graph replayed;
     bf16 compute on the card, float32 on the CPU, as in the reference)
     with float32 and with bf16 parameter storage
     (`TrainingConfig.storage_dtype`).

The floor (`analytic_traffic_floor`, the reference's formula) counts the
inputs, four passes over the parameters, the moments' and gradients' reads
and writes, and the stored activations written in the forward and read in
the backward. The activations' bytes a sample are measured here: the
tensors autograd saves for the backward in one train-mode forward
(`saved_tensors_hooks`), over the batch. Results:
results_torch/RESULTS_hbm_h100.{json,md} (`--quick`: `..._quick`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_deer_torch.experiments import twin

# The flagship forward's matmul skeleton (the reference's chain).
CHAIN_DIMS = [1108, 256] + [256] * 6 + [512, 512, 512, 12]


def measure_hbm_bandwidth(n_floats: int, k_iters: int,
                          device: torch.device) -> dict:
    """`k_iters` chained y = y·a + b over an [n_floats] float32 buffer, as
    two in-place kernels (mul_, add_) of 8 bytes an element each: 16
    bytes an element an iteration. Returns the achieved GB/s."""
    y = torch.ones(n_floats, device=device)

    def chain():
        for _ in range(k_iters):
            y.mul_(1.0000001).add_(1e-7)

    secs = twin.median_ms(chain, 1, 3, twin.synchronize(device)) / 1e3
    traffic = 16.0 * n_floats * k_iters
    return {"gbps": traffic / secs / 1e9, "secs": secs,
            "buffer_mb": 4.0 * n_floats / 1e6, "iters": k_iters,
            "bytes_per_element_iter": 16, "kernels_per_iter": 2}


def matmul_chain_flops(batch: int) -> float:
    """FLOPs of one pass of the chain (2 a multiply-add)."""
    return sum(2.0 * batch * CHAIN_DIMS[i] * CHAIN_DIMS[i + 1]
               for i in range(len(CHAIN_DIMS) - 1))


def measure_matmul_ceiling(batch: int, dtype_name: str, k_iters: int,
                           device: torch.device) -> dict:
    """The chain `k_iters` times (a fresh input each pass, the weights
    resident); achieved TFLOP/s and MFU against the dtype's peak."""
    from tpu_deer_torch.models.layers import torch_dtype
    from tpu_deer_torch.utils.profiling import peak_flops_per_chip

    dt = torch_dtype(dtype_name)
    rng = np.random.default_rng(0)
    ws = [torch.from_numpy(rng.standard_normal((CHAIN_DIMS[i], CHAIN_DIMS[i + 1]))
                           * 0.05).to(device=device, dtype=dt)
          for i in range(len(CHAIN_DIMS) - 1)]
    x0 = torch.from_numpy(rng.standard_normal((batch, CHAIN_DIMS[0]))).to(
        device=device, dtype=dt)
    carry = torch.zeros((), device=device, dtype=dt)

    def chain():
        nonlocal carry
        for _ in range(k_iters):
            h = x0 + carry
            for w in ws:
                h = h @ w if w.shape[1] == 12 else torch.tanh(h @ w)
            carry = carry + h.sum() * 1e-12

    with torch.no_grad():
        secs = twin.median_ms(chain, 1, 3, twin.synchronize(device)) / 1e3
    achieved = matmul_chain_flops(batch) * k_iters / secs
    peak = peak_flops_per_chip(device, dtype=dtype_name)
    return {"dtype": dtype_name, "batch": batch, "tflops": achieved / 1e12,
            "mfu_pct": 100.0 * achieved / peak if peak else None,
            "secs_per_iter": secs / k_iters,
            "peak_tflops": peak / 1e12 if peak else None}


def activation_bytes_per_sample(model, batch: dict) -> float:
    """Bytes of the tensors autograd saves for the backward in one
    train-mode forward of `model` on `batch` whose leading axis runs over
    the rows (a multiple of the batch), each storage once, over the rows.
    The parameters and their compute-dtype copies are left out."""
    rows = len(batch["audio"])
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    seen: dict[int, int] = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if t.dim() and t.shape[0] % rows == 0 and ptr not in params:
            seen.setdefault(ptr, t.untyped_storage().nbytes())
        return t

    model.train()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = model(batch["audio"], batch["video"], batch["text"])
    del out
    return sum(seen.values()) / rows


def measure_train_step(batch: int, storage_dtype: str, iters: int,
                       device: torch.device, stacked: bool = False) -> dict:
    """The flagship's train step (fused on the card: its CUDA graph
    replayed), bf16 compute on the card, float32 on the CPU."""
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
        profile_training_speed,
    )

    cuda = device.type == "cuda"
    config = DEERModelConfig(compute_dtype="bfloat16" if cuda else "float32",
                             stacked_compute=stacked)
    splits = make_synthetic_splits(SyntheticConfig(n_train=batch * 2, n_val=8,
                                                   n_test=8))
    ds = ArrayDataset(splits["train"], "hbm")
    trainer = DEERTrainer(
        create_complete_deer_model(config, seed=0, device=device),
        TrainingConfig(batch_size=batch, num_epochs=1, fused_epochs=cuda,
                       storage_dtype=storage_dtype),
        steps_per_epoch=4, device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    stats = profile_training_speed(trainer, ds, iters=iters, sync_per_step=False)
    peak_mem = torch.cuda.max_memory_allocated(device) if cuda else None
    step_batch = trainer._batch_from_indices(ds, np.arange(batch))
    cost = cost_analysis_summary(trainer._train_step, step_batch, 1.0, 1.0)
    peak = peak_flops_per_chip(device) if cuda else None
    step_s = stats["step_ms_mean"] / 1e3
    return {
        "storage_dtype": storage_dtype,
        "stacked": stacked,
        "batch": batch,
        "params": count_parameters(trainer.model),
        "step_ms": stats["step_ms_mean"],
        "samples_per_sec": stats["samples_per_sec"],
        "mfu_pct": 100.0 * cost["flops"] / (step_s * peak) if peak else None,
        "flops": cost["flops"],
        # The reference's key: here the per-aten-op bytes of one eager step.
        "xla_bytes": cost["bytes"],
        "peak_memory_bytes": peak_mem,
        "compute_dtype": config.compute_dtype,
    }


def analytic_traffic_floor(batch: int, n_params: int, storage_bytes: int,
                           act_bytes_per_sample: float) -> float:
    """Lower bound on bytes/step for the memory-bound hypothesis."""
    inputs = batch * (84 + 256 + 768) * 4
    params = 4 * n_params * storage_bytes  # fwd read, bwd read, update r+w
    moments = 2 * 2 * n_params * storage_bytes  # two moments, read+write
    grads = 2 * n_params * storage_bytes  # write + read
    acts = 2 * batch * act_bytes_per_sample  # write fwd, read bwd
    return float(inputs + params + moments + grads + acts)


def _activation_bytes(batch: int, device: torch.device) -> float:
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        create_complete_deer_model,
    )

    cuda = device.type == "cuda"
    model = create_complete_deer_model(
        DEERModelConfig(compute_dtype="bfloat16" if cuda else "float32"),
        seed=0, device=device)
    rows = make_synthetic_splits(SyntheticConfig(n_train=batch, n_val=8,
                                                 n_test=8))["train"]
    return activation_bytes_per_sample(model, {
        k: torch.from_numpy(rows[k]).to(device) for k in ("audio", "video", "text")})


def main(argv=None) -> int:
    p = twin.parser(__doc__, "hbm")
    p.add_argument("--iters", type=int, default=60)
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "hbm")
    cuda = device.type == "cuda"
    if args.quick:
        bw_n, bw_k, batch, mm_k, iters = 1 << 20, 8, 256, 4, 3
    else:
        bw_n, bw_k, batch, mm_k, iters = 1 << 28, 32, 16384, 64, args.iters
    t0 = time.time()

    bw = measure_hbm_bandwidth(bw_n, bw_k, device)
    print(f"1) bandwidth: {bw['gbps']:.1f} GB/s ({bw['buffer_mb']:.0f} MB, "
          f"{bw_k} chained mul_/add_ pairs)", flush=True)
    mm = [measure_matmul_ceiling(batch, d, mm_k, device)
          for d in (("bfloat16", "float32") if cuda else ("float32",))]
    for m in mm:
        print(f"2) matmul chain {m['dtype']}: {m['tflops']:.1f} TFLOP/s "
              f"({_pct(m['mfu_pct'])} of the dtype's peak)", flush=True)
    steps = [measure_train_step(batch, sd, iters, device)
             for sd in ("float32", "bfloat16")]
    for s in steps:
        print(f"3) train step, {s['storage_dtype']} storage: {s['step_ms']:.3f} ms, "
              f"{s['samples_per_sec']:,.0f} samples/s, MFU {_pct(s['mfu_pct'])}",
              flush=True)
    act_bytes = _activation_bytes(min(batch, 4096), device)
    n_params = steps[0]["params"]
    floors = {s["storage_dtype"]: analytic_traffic_floor(
        batch, n_params, 2 if s["storage_dtype"] == "bfloat16" else 4, act_bytes)
        for s in steps}
    elapsed = time.time() - t0

    payload = {"platform": platform, "quick": args.quick, "hbm_bandwidth": bw,
               "matmul_ceiling": mm, "train_steps": steps,
               "analytic_floor_bytes": floors,
               "activation_bytes_per_sample": act_bytes, "elapsed_s": elapsed}
    twin.write(args.out, report(payload, batch), payload)
    return 0


def _pct(v) -> str:
    return "not measured" if v is None else f"{v:.1f}%"


def report(payload: dict, batch: int) -> list[str]:
    """The Markdown report, its verdict computed from this run's numbers."""
    bw, mm, steps = (payload[k] for k in ("hbm_bandwidth", "matmul_ceiling",
                                          "train_steps"))
    floors = payload["analytic_floor_bytes"]
    md = [
        "# The flagship train step against the card's ceilings",
        "",
        f"- platform: **{payload['platform']}**, batch {batch}; every time "
        "is the host clock to a synchronize, median of 3 runs after a "
        f"warm-up; {payload['elapsed_s']:.0f} s in all. Generated by "
        "`python -m tpu_deer_torch.experiments.hbm_study`.",
        "",
        f"## 1. Achieved bandwidth: **{bw['gbps']:.1f} GB/s**",
        "",
        f"`y.mul_(a).add_(b)` chained {bw['iters']} times over a "
        f"{bw['buffer_mb']:.0f} MB float32 buffer: two kernels a pass, each "
        "reading and writing every element once (16 B an element a pass).",
        "",
        "## 2. Matmul ceiling at the flagship's layer widths",
        "",
        "| dtype | TFLOP/s | peak TFLOP/s | % of peak |",
        "|---|---|---|---|",
    ]
    for m in mm:
        peak = "not known" if m["peak_tflops"] is None else f"{m['peak_tflops']:.0f}"
        md.append(f"| {m['dtype']} | {m['tflops']:.1f} | {peak} | "
                  f"{_pct(m['mfu_pct'])} |")
    md += [
        "",
        "float32 runs with TF32 off, outside the tensor cores; its peak is the "
        "card's float32 rate, not half the bf16 one.",
        "",
        f"## 3. Train step ({steps[0]['compute_dtype']} compute): float32 vs "
        "bf16 parameter storage",
        "",
        f"Stored activations, measured: {payload['activation_bytes_per_sample']:,.0f} "
        "B a sample (the tensors autograd saves in one train-mode forward).",
        "",
        "| storage | step ms | samples/s | MFU (bf16 peak) | peak memory | "
        "traffic floor | floor at the measured bandwidth |",
        "|---|---|---|---|---|---|---|",
    ]
    for s in steps:
        fl = floors[s["storage_dtype"]]
        mem = ("not measured" if s["peak_memory_bytes"] is None
               else f"{s['peak_memory_bytes'] / 2**30:.2f} GiB")
        md.append(f"| {s['storage_dtype']} | {s['step_ms']:.3f} | "
                  f"{s['samples_per_sec']:,.0f} | {_pct(s['mfu_pct'])} | {mem} | "
                  f"{fl / 1e6:.1f} MB | {1e3 * fl / (bw['gbps'] * 1e9):.3f} ms |")
    floor_ms = 1e3 * floors["float32"] / (bw["gbps"] * 1e9)
    step_ms = steps[0]["step_ms"]
    md += ["", "## Verdict", ""]
    if step_ms > 3.0 * floor_ms:
        md.append(f"- The step ({step_ms:.3f} ms) is {step_ms / floor_ms:.1f}× "
                  f"its memory floor ({floor_ms:.3f} ms at the measured "
                  f"{bw['gbps']:.0f} GB/s): it is **not bound by memory "
                  "bandwidth** at this batch.")
    else:
        md.append(f"- The step ({step_ms:.3f} ms) is within 3× of its memory "
                  f"floor ({floor_ms:.3f} ms): memory traffic is a first-order "
                  "cost at this batch.")
    bf16_mm = next((m for m in mm if m["dtype"] == "bfloat16"), None)
    if bf16_mm is not None and steps[0]["mfu_pct"] is not None:
        md.append(f"- The bare bf16 chain at these widths reaches "
                  f"{_pct(bf16_mm['mfu_pct'])} of the bf16 peak; the whole step "
                  f"{_pct(steps[0]['mfu_pct'])}. The rest of the step (NIG heads, "
                  "loss, dropout, optimizer, ~1,000 small kernels in one graph) "
                  "is the gap between them.")
    d = steps[1]["step_ms"] - steps[0]["step_ms"]
    saved_ms = 1e3 * (floors["float32"] - floors["bfloat16"]) / (bw["gbps"] * 1e9)
    if d > 0:
        why = ("slower: the bytes it saves are worth at most "
               f"{saved_ms:.3f} ms at the measured bandwidth, so the "
               "difference is the extra work of the bf16 update (optax's "
               "arithmetic copied op by op, about 15 kernels a parameter "
               "tensor) and not traffic")
    elif -d > 2.0 * saved_ms:
        why = (f"faster by more than the {saved_ms:.3f} ms its saved bytes "
               "are worth at the measured bandwidth")
    else:
        why = (f"faster by about what its saved bytes are worth "
               f"({saved_ms:.3f} ms at the measured bandwidth)")
    md.append(f"- bf16 storage moves the step by {d:+.3f} ms "
              f"({steps[0]['step_ms']:.3f} → {steps[1]['step_ms']:.3f}): "
              f"{why}.")
    md += ["", "Reproduce: `python -m tpu_deer_torch.experiments.hbm_study` on "
           "the card (`--quick --platform cpu` for a CPU smoke)."]
    return md


if __name__ == "__main__":
    raise SystemExit(main())
