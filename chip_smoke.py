#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from tpu_deer_torch/kernels/csrc with nvcc
(into build/kernels), then:

  1. card  — prints the card's name and power limit and the build time;
  2. K1    — the fused MFCC kernel against its plain PyTorch twin on the
             card at B ∈ {1, 64} × the four length buckets plus one odd length,
             and its time beside the plain twin's and its bound;
  3. slice — the flagship model (3,918,324 params, seeded init) behind
             MultimodalFeatureExtractor → InferenceEngine.predict on 300
             synthetic utterances (0.5-12 s, all four length buckets) with
             video frames and texts, at request sizes 1, 8, 64, 256 and 300;
             checks the outputs, the kernel launches, and that features and
             predictions from the kernel match those from the plain twin.

The last two lines of stdout are a {"kernels": [...]} record and
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero and prints no result. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
SR = 16000
N_UTTERANCES = 300
F32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# (rtol, atol) for mfcc, logmel, power, timefeats: float32 sums of 1024
# products in another order (cuBLAS vs the kernel's FMA chain); ZCR exact.
K1_TOL = ((2e-3, 5e-3), (2e-4, 1e-3), (2e-4, 1e-3), (1e-4, 1e-5))
# Features and predictions, kernel vs plain twin (rtol, atol).
FEAT_TOL = (1e-4, 1e-5)
WORDS = ("i am so happy sad angry calm tired excited this is terrible great "
         "fine leave me alone wonderful awful really not sure why you did "
         "that").split()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def check_close(name, got, ref, rtol, atol):
    """Raise if any |got - ref| > atol + rtol |ref|; return max |got - ref|."""
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} values outside "
            f"rtol={rtol} atol={atol}; max abs err {err.max().item():.3e}")
    return err.max().item()


def time_ms(fn, reps=20, warmup=3):
    """Median of per-call CUDA-event times (ms)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile_window(torch, label, fn):
    """Print the device's busy share and top kernels over one call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, launches = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            launches += 1
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not kernels:
        print(f"profile {label}: wall {wall_ms:.3f} ms under the profiler; "
              f"device time not measured (the profiler saw no kernels)")
        return
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    print(f"profile {label}: wall {wall_ms:.3f} ms under the profiler, "
          f"{launches} device events, {busy:.3f} ms on the device "
          f"(busy {100 * busy / wall_ms:.1f}%); top: "
          + "; ".join(f"{name[:48]} {ms:.3f} ms" for name, ms in top))


def voice(rng, n, f0):
    """A harmonic tone with slow vibrato plus a little noise, [n] float32."""
    t = np.arange(n) / SR
    phase = 2 * np.pi * f0 * (t + 0.01 * np.sin(2 * np.pi * 3.0 * t))
    sig = sum(np.sin(h * phase) / h for h in (1, 2, 3, 4))
    return (0.3 * sig + 0.01 * rng.normal(size=n)).astype(np.float32)


def k1_work(cfg, b, tp, n, mel_nnz):
    """(FLOPs, bytes) that K1's function needs at the least, on b signals of
    tp padded samples and n frames each.

    The DFT is counted at a real FFT's cost, 2.5 n_fft log2(n_fft) per frame
    (K1 itself does the dense product, 4 n_fft n_bins), and the mel product
    at the filterbank's nonzeros. Bytes: the signal read once, the four
    outputs written once, and the window, mel and DCT bases (an FFT needs no
    DFT matrices)."""
    bins, mels, ceps, fft = cfg.n_bins, cfg.n_mels, cfg.n_mfcc, cfg.n_fft
    per_frame = (fft                            # window
                 + 2.5 * fft * math.log2(fft)   # real FFT
                 + 3 * bins                     # power
                 + 2 * mel_nnz                  # mel
                 + mels                         # log
                 + 2 * mels * ceps              # DCT
                 + 2 * fft                      # RMS: square, sum
                 + fft)                         # ZCR: compare and count
    flops = b * n * per_frame
    bases = fft + bins * mels + mels * ceps
    outputs = b * n * (ceps + mels + bins + 2)
    return flops, 4 * (b * tp + bases + outputs)


def phase_kernel(torch, taf, k1):
    """K1 against its plain twin on the card; returns the kernels record."""
    cfg = taf.AudioFrontendConfig()
    bases = taf._device_bases(cfg, torch.device("cuda"))
    rng = np.random.default_rng(SEED)
    shapes = [(b, int(s * SR)) for b in (1, 64) for s in (2.0, 4.0, 8.0, 16.0)]
    shapes.append((3, 3 * SR + 17))  # frames not a multiple of the block
    max_err, main = 0.0, None
    for b, n in shapes:
        sig = np.stack([voice(rng, n, rng.uniform(90, 300)) for _ in range(b)])
        x_pad, frames = taf._pad_for_frames(torch.from_numpy(sig).cuda(), cfg)
        before = k1.mfcc_signal.launches
        got = k1.mfcc_signal(x_pad, bases, cfg.n_fft, cfg.hop_length)
        torch.cuda.synchronize()
        if k1.mfcc_signal.launches != before + 1:
            raise AssertionError("mfcc_signal did not count its launch")
        ref = k1.mfcc_signal_plain(x_pad, bases, cfg.n_fft, cfg.hop_length)
        errs = []
        for name, g, r, (rtol, atol) in zip(
                ("mfcc", "logmel", "power", "timefeats"), got, ref, K1_TOL):
            if g.shape != r.shape or not torch.isfinite(g).all():
                raise AssertionError(f"{name}: shape {tuple(g.shape)} or "
                                     f"non-finite values")
            errs.append(check_close(f"K1 {name} B={b} T={n}", g, r, rtol, atol))
        if not torch.equal(got[3][..., 1], ref[3][..., 1]):
            raise AssertionError(f"K1 ZCR differs from the plain twin, B={b} T={n}")
        max_err = max(max_err, *errs)
        print(f"K1 vs plain B={b} T={n} N={frames}: max abs err mfcc "
              f"{errs[0]:.3e} logmel {errs[1]:.3e} power {errs[2]:.3e} "
              f"timefeats {errs[3]:.3e}; ZCR equal")
        if (b, n) == (64, 4 * SR):
            main = (x_pad, frames)

    # Timing at the main path's shape: one 4 s bucket of 64 utterances.
    x_pad, frames = main
    run = lambda fn: (lambda: fn(x_pad, bases, cfg.n_fft, cfg.hop_length))
    kernel_ms = time_ms(run(k1.mfcc_signal))
    plain_ms = time_ms(run(k1.mfcc_signal_plain))
    window = bases["window"]
    stft_ms = time_ms(lambda: torch.stft(
        x_pad, cfg.n_fft, cfg.hop_length, window=window, center=False,
        return_complex=True).abs().square())
    b, tp = x_pad.shape
    mel_nnz = int(torch.count_nonzero(bases["mel"]))
    flops, nbytes = k1_work(cfg, b, tp, frames, mel_nnz)
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    dense = b * frames * 4 * cfg.n_fft * cfg.n_bins
    print(f"K1 at B=64, 4 s bucket (N={frames}): kernel {kernel_ms:.4f} ms, "
          f"plain twin {plain_ms:.4f} ms; bound {max(t_ops, t_bytes):.4f} ms "
          f"({flops / 1e9:.4f} GFLOP f32 at FFT cost -> {t_ops:.4f} ms, "
          f"{nbytes / 1e6:.2f} MB -> {t_bytes:.4f} ms)")
    print(f"informational, not the bound: K1's dense DFT alone is "
          f"{dense / 1e9:.2f} GFLOP -> {dense / F32_FLOPS * 1e3:.4f} ms at the "
          f"f32 rate")
    print(f"informational, not the same function: torch.stft power spectrum "
          f"only, same shape: {stft_ms:.4f} ms")
    return {
        "name": "mfcc_signal",
        "route": "cuda",
        "source": "tpu_deer_torch/kernels/csrc/mfcc_signal.cu",
        "replaces": "tpu_deer/ops/audio_frontend.py:380",  # _mfcc_signal_kernel
        "launches": None,  # filled from the slice's run
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def phase_slice(torch, k1):
    """The serving path at full model width; returns K1's launch count."""
    from tpu_deer_torch.data.features import LENGTH_BUCKETS_S
    from tpu_deer_torch.data.features import MultimodalFeatureExtractor
    from tpu_deer_torch.models.deer_model import (
        count_parameters,
        create_complete_deer_model,
    )
    from tpu_deer_torch.serve import InferenceEngine

    rng = np.random.default_rng(SEED + 1)
    n_utt = N_UTTERANCES
    durations = rng.uniform(0.5, 12.0, size=n_utt)
    signals = [voice(rng, int(d * SR), rng.uniform(90, 300)) for d in durations]
    frames = [rng.uniform(size=(8, 64, 64)).astype(np.float32)
              for _ in range(n_utt)]
    texts = [" ".join(rng.choice(WORDS, size=rng.integers(3, 12)))
             for _ in range(n_utt)]
    buckets_used = {next((s for s in LENGTH_BUCKETS_S if d <= s),
                         LENGTH_BUCKETS_S[-1]) for d in durations}

    model = create_complete_deer_model(seed=SEED)
    n_params = count_parameters(model)
    if n_params != 3_918_324:
        raise AssertionError(f"model has {n_params} params")
    extractor = MultimodalFeatureExtractor()
    engine = InferenceEngine(model)
    sizes = (1, 8, 64, 256, 300)

    # The main path, counted: featurise everything, then serve every size.
    k1.mfcc_signal.launches = 0
    audio = extractor.audio.extract_batch(signals)
    video = np.stack([extractor.video.extract_from_frames(f) for f in frames])
    text = extractor.text.extract_batch(texts)
    outs = {n: engine.predict(audio[:n], video[:n], text[:n]) for n in sizes}
    launches = k1.mfcc_signal.launches
    if launches != len(buckets_used):
        raise AssertionError(f"K1 launched {launches} times for "
                             f"{len(buckets_used)} length buckets")
    print(f"slice: {n_utt} utterances in buckets {sorted(buckets_used)} s, "
          f"K1 launches {launches}, model params {n_params}")

    for n, out in outs.items():
        rows = min(n, n_utt)
        for key, v in out.items():
            if len(v) != rows or not np.isfinite(v).all():
                raise AssertionError(f"predict({n})[{key}]: bad shape or values")
        if out["mu"].shape != (rows, 3):
            raise AssertionError(f"mu has shape {out['mu'].shape}")
        np.testing.assert_allclose(out["attention_weights"].sum(-1), 1.0,
                                   rtol=0, atol=1e-5)
        if not (out["expected_abs_error"] > 0).all():
            raise AssertionError("expected_abs_error must be positive")

    # Kernel vs plain twin, on the card, through the same entry points.
    audio_plain = extractor.audio.extract_batch(signals, plain=True)
    err = check_close("features kernel vs plain", torch.from_numpy(audio),
                      torch.from_numpy(audio_plain), *FEAT_TOL)
    pred_plain = engine.predict(audio_plain, video, text)
    pred_err = max(check_close(f"prediction {key} kernel vs plain",
                               torch.from_numpy(outs[sizes[-1]][key]),
                               torch.from_numpy(v), *FEAT_TOL)
                   for key, v in pred_plain.items())
    print(f"slice: features kernel vs plain max abs err {err:.3e}, "
          f"predictions {pred_err:.3e}")

    # Timing (after the counted run).
    reps = 3
    t_feat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        extractor.audio.extract_batch(signals)
        t_feat.append(time.perf_counter() - t0)
    feat_ms = float(np.median(t_feat)) * 1e3
    print(f"featurisation: {feat_ms:.2f} ms for {n_utt} utterances "
          f"({float(durations.sum()):.1f} s of audio), "
          f"{feat_ms / n_utt:.4f} ms per utterance (host clock, p50 of {reps})")
    for n in sizes:
        lat = []
        for _ in range(30):
            t0 = time.perf_counter()
            engine.predict(audio[:n], video[:n], text[:n])
            lat.append(time.perf_counter() - t0)
        print(f"predict request size {n}: p50 {np.median(lat) * 1e3:.4f} ms "
              f"(host clock, 30 requests, outputs copied to the host)")
    profile_window(torch, f"featurise {n_utt} utterances",
                   lambda: extractor.audio.extract_batch(signals))
    for n in (1, 256):
        profile_window(torch, f"predict {n}",
                       lambda: engine.predict(audio[:n], video[:n], text[:n]))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpu_deer_torch.kernels import build
    from tpu_deer_torch.kernels import mfcc_signal as k1
    from tpu_deer_torch.ops import audio_frontend as taf

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = build.build("mfcc_signal")
    print(f"build: {time.perf_counter() - t0:.1f} s for mfcc_signal")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  mfcc_signal: {line.strip()}")

    record = phase_kernel(torch, taf, k1)
    record["launches"] = phase_slice(torch, k1)

    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
