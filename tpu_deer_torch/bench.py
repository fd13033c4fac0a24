"""Benchmark of the flagship's main path on one card.

    python -m tpu_deer_torch.bench [--quick] [--platform {auto,cuda,cpu}]

Port of the root `bench.py`. Prints ONE JSON line on stdout:

  {"metric": "p50_per_sample_latency_ms", "value": N, "unit": "ms",
   "vs_baseline": 47/N}

Baseline: the original implementation claims 47 ms per sample of inference
latency (BASELINE.md); vs_baseline > 1 is faster. The sections keep
`bench.py`'s shapes, at the flagship's full width (3,918,324 params),
computing in bfloat16 on the card and float32 on the CPU (parameters, NIG
math and calibration stay float32):

  * serving: `InferenceEngine.predict` (numpy in and out, each bucket a
    CUDA graph on the card) at batch 256 (p50 and p99 per sample, the
    headline) and batch 1, beside the host round trip of a tiny op;
  * int8 serving at batch 256 (`quantize_weights=True`);
  * forward throughput: batch 4,096 × 512 forwards, each a replay of one
    CUDA graph of "draw the inputs on the device → forward → mean" (the
    default CUDA generator, which a graph may use), one synchronize;
  * the audio front-end: 1,024 utterances of 3 s through
    `extract_utterance_features_batch` (kernel K1);
  * streaming: 256 streams of 256 ms chunks through `StreamingRecognizer`
    (kernel K2 inside the tick's CUDA graph);
  * train throughput at batch 16,384: 100 steps of the fused step's CUDA
    graph back to back, one synchronize (`utils/profiling.py`), the eager
    step's time beside;
  * MFU and roofline of the forward and the train step, from FLOPs and
    per-op bytes of one eager call against the card's peak bf16 rate and
    HBM bandwidth (`utils/profiling.py`).

Each timed span ends in a host fetch or a synchronize. The bench sets TF32
off and cuBLAS's bf16 reduced-precision reductions off (split-K partials
then add in float32, as XLA accumulates). `--platform auto` (the default)
and `cuda` need a card and raise without one; `--platform cpu` runs on the
CPU. `--quick` runs every section at `bench.py`'s tiny shapes as a
structural smoke and prints `quick_structural_smoke`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

BASELINE_MS = 47.0
SEED = 0
PLATFORMS = {"auto": None, "cuda": "cuda", "cpu": "cpu"}


@dataclasses.dataclass
class BenchResult:
    """What a run measured: the JSON record and the stderr lines."""

    record: dict
    lines: list


def _e2e_times_ms(call: Callable, arg_list) -> np.ndarray:
    """Host ms of each call; every call returns host (numpy) values."""
    times = []
    for args in arg_list:
        t0 = time.perf_counter()
        call(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(times)


def _kernel_counts() -> dict[str, int]:
    from tpu_deer_torch.kernels.mfcc_frames import mfcc_frames
    from tpu_deer_torch.kernels.mfcc_signal import mfcc_signal

    return {"mfcc_signal": mfcc_signal.launches,
            "mfcc_frames": mfcc_frames.launches}


def _launched(before: dict[str, int]) -> dict[str, int]:
    return {k: n - before[k] for k, n in _kernel_counts().items()}


def _forward_throughput(model, device: torch.device, b: int, k: int,
                        reps: int) -> tuple[list, float]:
    """Host seconds of `reps` runs of k forwards at batch b, each forward on
    inputs drawn on the device, and the last forward's mean μ. On the card
    one forward is a CUDA graph, replayed k times a run."""
    cfg = model.config

    def body():
        a, v, t = (torch.randn((b, d), device=device)
                   for d in (cfg.audio_dim, cfg.video_dim, cfg.text_dim))
        return model(a, v, t)["mu_all"].mean()

    torch.manual_seed(SEED)
    with torch.inference_mode():
        if device.type == "cuda":
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(2):
                    body()
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = body()
            step = graph.replay
        else:
            out = None

            def step():
                nonlocal out
                out = body()
        times = []
        for _ in range(reps + 1):  # the first run warms up
            t0 = time.perf_counter()
            for _ in range(k):
                step()
            mean = float(out)  # the fetch covers the run
            times.append(time.perf_counter() - t0)
    return times[1:], mean


def run(quick: bool = False, device=None,
        compute_dtype: Optional[str] = None) -> BenchResult:
    """Every section on `device` (None = the card; raises without one), the
    flagship computing in `compute_dtype` (None: bfloat16 on the card,
    float32 on the CPU, as `bench.py` picks)."""
    from tpu_deer_torch.device import resolve_device

    device = resolve_device(device)
    lines: list[str] = []

    def mark(section: str) -> None:
        print(f"# [{time.strftime('%H:%M:%S')}] {section}", file=sys.stderr,
              flush=True)

    mark("model")
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        count_parameters,
        create_complete_deer_model,
    )
    from tpu_deer_torch.serve import InferenceEngine

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        card = torch.cuda.get_device_name(device)
    else:
        card = "cpu"
    if compute_dtype is None:
        compute_dtype = "bfloat16" if device.type == "cuda" else "float32"
    config = DEERModelConfig(compute_dtype=compute_dtype)
    model = create_complete_deer_model(config, seed=SEED, device=device)
    n_params = count_parameters(model)
    rng = np.random.default_rng(SEED)

    def make_batch(b):
        return tuple(rng.standard_normal((b, d)).astype(np.float32)
                     for d in (config.audio_dim, config.video_dim,
                               config.text_dim))

    mark("host round-trip floor")
    tiny = torch.arange(8, dtype=torch.float32, device=device)
    bump = lambda x, i: (x + i).cpu().numpy()
    bump(tiny, 0.0)
    rtt = _e2e_times_ms(bump, [(tiny, float(i + 1))
                               for i in range(2 if quick else 15)])
    rtt_ms = float(np.percentile(rtt, 50))

    mark("batch-1 latency")
    engine = InferenceEngine(model, device=device)
    engine.warmup()  # one CUDA graph a bucket on the card
    b1 = _e2e_times_ms(engine.predict,
                       [make_batch(1) for _ in range(2 if quick else 30)])
    b1_p50 = float(np.percentile(b1, 50))

    mark("serving p50 (batch 256)")
    serve_b = 8 if quick else 256
    sv = _e2e_times_ms(engine.predict,
                       [make_batch(serve_b) for _ in range(2 if quick else 20)])
    p50 = float(np.percentile(sv, 50)) / serve_b
    p99 = float(np.percentile(sv, 99)) / serve_b

    mark("int8 serving")
    engine_q = InferenceEngine(model, quantize_weights=True, device=device)
    engine_q.warmup()
    svq = _e2e_times_ms(engine_q.predict,
                        [make_batch(serve_b) for _ in range(2 if quick else 20)])
    p50_q = float(np.percentile(svq, 50)) / serve_b
    del engine_q

    mark("forward throughput")
    b, k = (16, 2) if quick else (4096, 512)
    ft, fwd_mean = _forward_throughput(model, device, b, k, 1 if quick else 3)
    if not np.isfinite(fwd_mean):
        raise AssertionError(f"forward throughput: mean μ {fwd_mean}")
    fwd_time = float(np.percentile(ft, 50))
    throughput = k * b / fwd_time

    mark("audio front-end (K1)")
    from tpu_deer_torch.ops.audio_frontend import (
        AudioFrontendConfig,
        extract_utterance_features_batch,
    )

    acfg = AudioFrontendConfig()
    n_utt = 4 if quick else 1024
    utt_len = acfg.sample_rate // 2 if quick else acfg.sample_rate * 3
    sigs = torch.from_numpy(rng.standard_normal((n_utt, utt_len))
                            .astype(np.float32)).to(device)
    fe = lambda: extract_utterance_features_batch(sigs, acfg).cpu().numpy()
    before = _kernel_counts()
    fe()
    fts = []
    for _ in range(1 if quick else 5):
        t0 = time.perf_counter()
        fe()
        fts.append((time.perf_counter() - t0) * 1e3 / n_utt)
    fe_p50 = float(np.percentile(fts, 50))
    k1_launches = _launched(before)["mfcc_signal"]
    del sigs

    mark("streaming sessions (K2)")
    from tpu_deer_torch.stream import StreamingConfig, StreamingRecognizer

    n_streams = 4 if quick else 256
    scfg = StreamingConfig()
    before = _kernel_counts()
    rec = StreamingRecognizer(model, n_streams=n_streams, cfg=scfg,
                              device=device)
    rec.warmup()  # captures the tick's graph on the card
    chunk_s = scfg.chunk_samples / scfg.frontend.sample_rate
    chunks = rng.standard_normal((n_streams, scfg.chunk_samples)).astype(
        np.float32)
    rec.push(chunks)
    sts = []
    for _ in range(2 if quick else 10):
        t0 = time.perf_counter()
        rec.push(chunks)  # returns numpy (a host fetch)
        sts.append(time.perf_counter() - t0)
    stream_p50 = float(np.percentile(sts, 50))
    rtf = n_streams * chunk_s / stream_p50
    k2_launches = _launched(before)["mfcc_frames"]
    stream_graphed = rec.graphs and rec._graph is not None
    del rec

    mark("train-step throughput")
    from tpu_deer_torch.data.pipeline import ArrayDataset
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig
    from tpu_deer_torch.utils.profiling import (
        cost_analysis_summary,
        peak_flops_per_chip,
        peak_hbm_bandwidth,
        profile_training_speed,
        roofline_seconds,
    )

    train_bs = 32 if quick else 16384
    splits = make_synthetic_splits(
        SyntheticConfig(n_train=train_bs * 2, n_val=8, n_test=8))
    train_ds = ArrayDataset(splits["train"], "bench")

    def trainer_for(fused: bool):
        return DEERTrainer(
            create_complete_deer_model(config, seed=SEED, device=device),
            TrainingConfig(batch_size=train_bs, num_epochs=1,
                           fused_epochs=fused),
            steps_per_epoch=4, device=device)

    graphed = device.type == "cuda"
    trainer = trainer_for(graphed)
    train_stats = profile_training_speed(
        trainer, train_ds, iters=3 if quick else 100, sync_per_step=False)
    eager = trainer_for(False) if graphed else trainer
    eager_stats = (profile_training_speed(eager, train_ds, iters=20,
                                          sync_per_step=False)
                   if graphed else train_stats)
    del trainer

    mark("mfu / roofline accounting")
    peak = peak_flops_per_chip(device)
    hbm_bw = peak_hbm_bandwidth(device)

    def forward(a, v, t):
        with torch.inference_mode():
            out = model(a, v, t)
            return out["mu_all"], out["calibrated_uncertainty"]

    fwd_cost = cost_analysis_summary(
        forward, *(torch.from_numpy(x).to(device) for x in make_batch(b)))
    train_batch = eager._batch_from_indices(train_ds, np.arange(train_bs))
    train_cost = cost_analysis_summary(eager._train_step, train_batch, 1.0, 1.0)

    def mfu(flops_per_call, calls_per_sec):
        if not (peak and flops_per_call):
            return None
        return 100.0 * flops_per_call * calls_per_sec / peak

    def roofline(cost, secs_per_call):
        """% of the two-ceiling bound attained; the bytes ceiling counts
        per-op bytes, so >100% is that accounting, not a measurement
        error."""
        if not (peak and hbm_bw):
            return None, None
        sol = roofline_seconds(cost["flops"], cost["bytes"], peak, hbm_bw)
        return 100.0 * sol / secs_per_call, cost["flops"] / max(cost["bytes"], 1.0)

    mfu_fwd = mfu(fwd_cost["flops"], throughput / b)
    mfu_train = mfu(train_cost["flops"], train_stats["samples_per_sec"] / train_bs)
    rl_fwd, ai_fwd = roofline(fwd_cost, fwd_time / k)
    rl_train, ai_train = roofline(train_cost, train_stats["step_ms_mean"] / 1e3)
    fmt = lambda v: f"{v:.1f}%" if v is not None else "n/a"
    fmt_ai = lambda v: f"{v:.0f}" if v is not None else "n/a"
    peak_note = f" (peak {peak / 1e12:.0f} TF bf16)" if peak else ""
    step_kind = "graphed" if graphed else "eager"
    lines.append(
        f"# platform={device.type} ({card}) params={n_params:,} "
        f"dtype={compute_dtype} p50/sample={p50:.6f}ms p99/sample={p99:.6f}ms "
        f"(serving batch {serve_b}, predict numpy in/out) | batch-1 e2e "
        f"{b1_p50:.4f}ms (host round-trip floor {rtt_ms:.4f}ms) | "
        f"throughput={throughput:,.0f} samples/s/chip (batch {b} x{k} "
        f"forwards) | train {train_stats['samples_per_sec']:,.0f} "
        f"samples/s/chip (bs {train_stats['batch_size']}, {step_kind} step "
        f"{train_stats['step_ms_mean']:.4f}ms; eager "
        f"{eager_stats['samples_per_sec']:,.0f} samples/s, step "
        f"{eager_stats['step_ms_mean']:.4f}ms) | mfu_fwd={fmt(mfu_fwd)} "
        f"mfu_train={fmt(mfu_train)}{peak_note}"
        + (f" | roofline_fwd={fmt(rl_fwd)} roofline_train={fmt(rl_train)} "
           f"vs the per-op bytes bound, which over-counts device-memory "
           f"traffic (>100% is that accounting); intensity "
           f"{fmt_ai(ai_fwd)}/{fmt_ai(ai_train)} FLOP/B, ridge "
           f"{peak / hbm_bw:.0f}" if peak and hbm_bw else ""))
    lines.append(
        f"# audio frontend (3s utt) p50 {fe_p50:.6f}ms/utt ({n_utt}-utt "
        f"dispatch; K1 wrapper launches {k1_launches})")
    lines.append(
        f"# int8 serving p50/sample={p50_q:.6f}ms (batch {serve_b}; "
        f"{compute_dtype} {p50:.6f}ms) | streaming: {rtf:,.0f}x real time "
        f"({n_streams} live streams/push, {chunk_s * 1e3:.0f}ms chunks, push "
        f"p50 {stream_p50 * 1e3:.4f}ms; K2 wrapper launches "
        f"{k2_launches}, "
        f"{'at the tick graph capture' if stream_graphed else 'eager'})")
    record = {
        "metric": "p50_per_sample_latency_ms",
        "value": round(p50, 4),
        "unit": "ms",
        "vs_baseline": round(BASELINE_MS / p50, 2),
    }
    if quick:
        # Structural smoke only: every section ran, timings meaningless.
        record = {"metric": "quick_structural_smoke", "value": 1.0,
                  "unit": "ok", "vs_baseline": None}
    return BenchResult(record, lines)


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true",
                   help="every section at tiny shapes (a structural smoke)")
    p.add_argument("--platform", choices=sorted(PLATFORMS), default="auto",
                   help="auto/cuda: the CUDA card (raises without one); cpu")
    args = p.parse_args(argv)
    result = run(quick=args.quick, device=PLATFORMS[args.platform])
    for line in result.lines:
        print(line, file=sys.stderr)
    print(json.dumps(result.record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
