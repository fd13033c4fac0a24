"""The port's hand-written kernels against their plain twins and PyTorch's
own calls, across the reference's shapes, on the card.

    python -m tpu_deer_torch.experiments.kernel_bench
    python -m tpu_deer_torch.experiments.kernel_bench --quick --platform cpu

Twin of `experiments/kernel_bench.py`:

  1. Attention, float32 (TF32 off), at B8 H8 T1024, B2 H8 T4096 and B1 H8
     T8192, D 64, no mask: forward, and forward+backward of the output's
     mean. Rows: K3a-c (`kernels/flash_attention.py:flash_attention`), the
     plain twin (the einsum-softmax path that `models/attention.py` takes
     below the flash thresholds; the reference's XLA baseline),
     `torch.nn.functional.scaled_dot_product_attention` as a yardstick,
     and the path `resolve_use_flash("auto", T, training)` picks for
     inference and for training. Each kernel is held against its plain
     twin on the shape's inputs (K3_TOL).
  2. K2 (`kernels/mfcc_frames.py`) at 16,384 frames a call against its
     plain twin.
  3. The front-end from the raw signal at B 64 × 65,536 samples by the
     paths of `ops/audio_frontend.py:mfcc_from_signal`: "pallas" (K1),
     "conv" and "frames".

The reference sweeps its Pallas block sizes; each kernel here runs as the
port builds it. Every time is the host clock over `k` calls ending in a
synchronize, the median of 3 runs after a warm-up, over `k`. Results:
results_torch/RESULTS_kernels_h100.{md,json} (`--quick`: `..._quick`).
"""

from __future__ import annotations

import time

import torch

from tpu_deer_torch.experiments import twin

SHAPES = ((8, 8, 1024, 64), (2, 8, 4096, 64), (1, 8, 8192, 64))
QUICK_SHAPES = ((1, 2, 256, 64),)
K3_TOL = (1e-4, 5e-5)  # chip_smoke.py's phase-7 tolerance (rtol, atol)


def attention_flops(b: int, h: int, t: int, d: int) -> float:
    """QKᵀ and PV, a multiply-add as 2 (the reference's count)."""
    return 4.0 * b * h * t * t * d


def _check(name, got, ref):
    err = (got - ref).abs()
    bad = err > K3_TOL[1] + K3_TOL[0] * ref.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} of {bad.numel()} values "
                             f"outside rtol={K3_TOL[0]} atol={K3_TOL[1]}; max "
                             f"abs err {err.max().item():.3e}")
    return err.max().item()


def check_attention_kernels(q, k, v) -> dict:
    """K3a, K3b and K3c against their plain twins on (q, k, v), no mask, a
    random dO: {kernel: max abs err}."""
    from tpu_deer_torch.kernels import flash_attention as k3

    mask = torch.ones(q.shape[0], k.shape[2], device=q.device)
    do = torch.randn_like(q)
    o, lse = k3.flash_attention_fwd(q, k, v, mask)
    o_p, lse_p = k3.flash_attention_fwd_plain(q, k, v, mask)
    delta, dq = k3.flash_attention_bwd_dq(q, k, v, mask, o_p, do, lse_p)
    delta_p, dq_p = k3.flash_attention_bwd_dq_plain(q, k, v, mask, o_p, do, lse_p)
    dk, dv = k3.flash_attention_bwd_dkv(q, k, v, mask, do, lse_p, delta_p)
    dk_p, dv_p = k3.flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse_p, delta_p)
    return {"K3a": max(_check("K3a O", o, o_p), _check("K3a lse", lse, lse_p)),
            "K3b": max(_check("K3b delta", delta, delta_p), _check("K3b dq", dq, dq_p)),
            "K3c": max(_check("K3c dk", dk, dk_p), _check("K3c dv", dv, dv_p))}


def attention_row(shape, k_calls: int, device, check: bool = True) -> dict:
    """Forward and forward+backward ms of each attention path at `shape`
    (B, H, T, D), with the kernels held against their plain twins."""
    import torch.nn.functional as F

    from tpu_deer_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )
    from tpu_deer_torch.models.attention import resolve_use_flash

    b, h, t, d = shape
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(b, h, t, d, device=device, generator=gen)
               for _ in range(3))
    paths = {"flash": flash_attention, "plain": flash_attention_plain,
             "sdpa": lambda q, k, v: F.scaled_dot_product_attention(q, k, v)}
    sync = twin.synchronize(device)
    row = {"shape": f"B{b} H{h} T{t} D{d}"}
    flops = attention_flops(b, h, t, d)
    if check:
        row["max_abs_err"] = check_attention_kernels(q, k, v)
    for name, attn in paths.items():
        with torch.no_grad():
            row[f"{name}_fwd_ms"] = twin.median_ms(lambda: attn(q, k, v), k_calls,
                                                     3, sync)
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))

        def fwd_bwd(attn=attn):
            out = attn(qg, kg, vg).mean()
            torch.autograd.grad(out, (qg, kg, vg))

        row[f"{name}_bwd_ms"] = twin.median_ms(fwd_bwd, k_calls, 3, sync)
        row[f"{name}_fwd_tflops"] = flops / row[f"{name}_fwd_ms"] / 1e9
        # fwd+bwd ~ 3.5x the forward's FLOPs (FlashAttention-2 accounting).
        row[f"{name}_bwd_tflops"] = 3.5 * flops / row[f"{name}_bwd_ms"] / 1e9
    for phase, training in (("fwd", False), ("bwd", True)):
        pick = "flash" if resolve_use_flash("auto", t, training=training) else "plain"
        row[f"auto_{phase}_pick"] = pick
        row[f"auto_{phase}_ms"] = row[f"{pick}_{phase}_ms"]
    return row


def frames_rows(n_frames: int, k_calls: int, device) -> list[dict]:
    """K2 and its plain twin on `n_frames` random frames."""
    from tpu_deer_torch.ops.audio_frontend import AudioFrontendConfig, mfcc_frames

    cfg = AudioFrontendConfig()
    gen = torch.Generator(device=device).manual_seed(2)
    frames = torch.randn(n_frames, cfg.n_fft, device=device, generator=gen)
    flops = 2.0 * n_frames * (2 * cfg.n_fft * (cfg.n_fft // 2 + 1)
                              + (cfg.n_fft // 2 + 1) * cfg.n_mels
                              + cfg.n_mels * cfg.n_mfcc)
    rows = []
    for name, plain in (("K2", False), ("plain", True)):
        ms = twin.median_ms(lambda: mfcc_frames(frames, cfg, plain=plain),
                            k_calls, 3, twin.synchronize(device))
        rows.append({"name": name, "ms": ms, "tflops": flops / ms / 1e9,
                     "us_per_frame": ms * 1e3 / n_frames})
    return rows


def signal_rows(b: int, t: int, k_calls: int, device) -> list[dict]:
    """The front-end from the raw signal by each path."""
    from tpu_deer_torch.ops.audio_frontend import AudioFrontendConfig, mfcc_from_signal

    cfg = AudioFrontendConfig()
    gen = torch.Generator(device=device).manual_seed(3)
    sig = torch.randn(b, t, device=device, generator=gen)
    frames = b * (t // cfg.hop_length + 1)
    flops = 2.0 * frames * (2 * cfg.n_fft * (cfg.n_fft // 2 + 1)
                            + (cfg.n_fft // 2 + 1) * cfg.n_mels
                            + cfg.n_mels * cfg.n_mfcc)
    rows = []
    for name in ("pallas", "conv", "frames"):
        ms = twin.median_ms(lambda: mfcc_from_signal(sig, cfg, path=name),
                            k_calls, 3, twin.synchronize(device))
        rows.append({"name": "K1" if name == "pallas" else name, "path": name,
                     "ms": ms, "tflops": flops / ms / 1e9,
                     "us_per_frame": ms * 1e3 / frames,
                     "rt_factor": (b * t / cfg.sample_rate) / (ms / 1e3)})
    return rows


def main(argv=None) -> int:
    p = twin.parser(__doc__, "kernels")
    p.add_argument("--k", type=int, default=20, help="calls a timed run")
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "kernels")
    if args.quick:
        shapes, n_frames, (b, t), k_calls = QUICK_SHAPES, 256, (4, 16384), 2
    else:
        shapes, n_frames, (b, t), k_calls = SHAPES, 16384, (64, 65536), args.k
    t0 = time.time()
    attn = []
    for shape in shapes:
        attn.append(attention_row(shape, k_calls, device))
        r = attn[-1]
        print(f"attention {r['shape']}: fwd flash {r['flash_fwd_ms']:.3f} ms, "
              f"plain {r['plain_fwd_ms']:.3f}, SDPA {r['sdpa_fwd_ms']:.3f}; fwd+bwd "
              f"flash {r['flash_bwd_ms']:.3f}, plain {r['plain_bwd_ms']:.3f}, SDPA "
              f"{r['sdpa_bwd_ms']:.3f}; auto picks {r['auto_fwd_pick']}/"
              f"{r['auto_bwd_pick']}", flush=True)
    frames = frames_rows(n_frames, k_calls, device)
    signal = signal_rows(b, t, k_calls, device)
    elapsed = time.time() - t0
    payload = {"platform": platform, "quick": args.quick, "attention": attn,
               "mfcc_frames": frames, "signal": signal, "signal_shape": [b, t],
               "frames": n_frames, "calls_per_run": k_calls, "elapsed_s": elapsed}
    twin.write(args.out, report(payload), payload)
    return 0


def report(payload: dict) -> list[str]:
    """The Markdown report; its verdicts computed from this run."""
    attn, b_t = payload["attention"], payload["signal_shape"]
    md = [
        "# Kernel benchmarks — the port's kernels against their plain twins",
        "",
        f"- platform: **{payload['platform']}**, float32 (TF32 off); each "
        f"time is {payload['calls_per_run']} calls to a synchronize, the "
        f"median of 3 runs, over the calls; {payload['elapsed_s']:.0f} s in "
        "all. Generated by `python -m tpu_deer_torch.experiments.kernel_bench`.",
        "- K3a-c stream K and V tiles (O(T·D) memory); the plain twin and "
        "the flash-off path of `models/attention.py` build the [T, T] scores.",
        "",
        "## Attention (forward / forward+backward), ms",
        "",
        "| shape | K3 fwd | plain fwd | SDPA fwd | K3 f+b | plain f+b | SDPA f+b "
        "| K3 fwd TFLOP/s | auto (fwd / f+b) | K3a / K3b / K3c max abs err |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in attn:
        e = r.get("max_abs_err", {})
        errs = " / ".join(f"{e[k]:.1e}" for k in ("K3a", "K3b", "K3c")) if e else "—"
        md.append(
            f"| {r['shape']} | {r['flash_fwd_ms']:.3f} | {r['plain_fwd_ms']:.3f} | "
            f"{r['sdpa_fwd_ms']:.3f} | {r['flash_bwd_ms']:.3f} | "
            f"{r['plain_bwd_ms']:.3f} | {r['sdpa_bwd_ms']:.3f} | "
            f"{r['flash_fwd_tflops']:.1f} | {r['auto_fwd_pick']} "
            f"{r['auto_fwd_ms']:.3f} / {r['auto_bwd_pick']} {r['auto_bwd_ms']:.3f} "
            f"| {errs} |")
    mispicks = [f"{r['shape']} {ph}" for r in attn for ph in ("fwd", "bwd")
                if r[f"auto_{ph}_ms"] > min(r[f"flash_{ph}_ms"], r[f"plain_{ph}_ms"])]
    md += ["", "`use_flash=\"auto\"` (`models/attention.py`, the reference's "
           "thresholds: flash from T 2048 in inference and 1024 in training) "
           "picks one of K3 and the plain path; its column is that path's "
           "time. Verdict: " + (
               "auto picks the faster of the two at every shape and phase "
               "above." if not mispicks else
               "auto picks the slower path at " + ", ".join(mispicks) +
               " (the thresholds are kept: the flash branch skips attention "
               "dropout, so moving them changes what training computes).")]
    md += ["", f"## K2: MFCC from frames ({payload['frames']:,} frames a call)", "",
           "| path | ms / call | µs / frame | attained TFLOP/s (DFT count) |",
           "|---|---|---|---|"]
    for r in payload["mfcc_frames"]:
        md.append(f"| {r['name']} | {r['ms']:.3f} | {r['us_per_frame']:.4f} | "
                  f"{r['tflops']:.1f} |")
    md += ["", f"## The front-end from the raw signal (B {b_t[0]} × {b_t[1]:,} "
           "samples)", "",
           "| path | ms / call | µs / frame | attained TFLOP/s (DFT count) | × real time |",
           "|---|---|---|---|---|"]
    for r in payload["signal"]:
        md.append(f"| {r['name']} ({r['path']}) | {r['ms']:.3f} | "
                  f"{r['us_per_frame']:.4f} | {r['tflops']:.1f} | "
                  f"{r['rt_factor']:,.0f} |")
    k1 = next(r for r in payload["signal"] if r["path"] == "pallas")
    others = [r for r in payload["signal"] if r is not k1]
    md += ["", "From the signal: " + ", ".join(
               f"{r['name']} takes {r['ms'] / k1['ms']:.2f}× K1's time"
               for r in others) + ". The attained rates count a dense DFT, "
           "which K1 and K2 replace by an FFT (far fewer operations), so "
           "theirs can pass the card's float32 peak.",
           "", "Reproduce: `python -m tpu_deer_torch.experiments.kernel_bench` on "
           "the card (`--quick --platform cpu` for a CPU smoke)."]
    return md


if __name__ == "__main__":
    raise SystemExit(main())
