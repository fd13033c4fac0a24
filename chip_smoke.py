#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, streaming, raw-media training,
feature-level training-to-int8-serving, export, real-corpus and model-zoo
paths on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from tpu_deer_torch/kernels/csrc with nvcc
(into build/kernels, one nvcc per source, all started together), then:

  1. card   — prints the card's name and power limit and the build time;
  2. K1     — the fused MFCC-from-signal kernel (a shared-memory FFT)
              against its plain PyTorch twin on the card at B ∈ {1, 64} ×
              the four length buckets plus one odd length, and on silence,
              a DC offset, a tone at the Nyquist bin and an impulse (with
              noise) at n_fft 512, 1024 and 2048; each output equal bit for
              bit across two runs; n_fft 768 refused; its registers and
              shared memory; its time beside the plain twin's and its
              bound;
  3. slice  — the flagship model (3,918,324 params, seeded init) behind
              MultimodalFeatureExtractor → InferenceEngine.predict on 300
              synthetic utterances (0.5-12 s, all four length buckets) with
              video frames and texts, at request sizes 1, 8, 64, 256 and 300,
              each bucket a CUDA graph captured at warm-up; checks the
              outputs, the kernel launches, that features and predictions
              from the kernel match those from the plain twin, and the
              graphed predictions against the eager engine's (the count of
              elements differing in any bit); p50, busy share and capture
              time graphed and eager;
  4. K2     — the fused MFCC-from-frames kernel against its plain twin at
              R ∈ {16, 4096, 597} rows of n_fft 1024 and 597 rows of n_fft
              512, and on the same edge cases at n_fft 512 and 1024; bit for
              bit across two runs; n_fft 768 refused; its registers and
              shared memory; its time at the tick's 4096 rows beside its
              bound;
  5. stream — a StreamingRecognizer over the flagship at 256 streams, chunk
              4096, with an OOD detector: 8 ticks replayed from the tick's
              CUDA graph (one with inactive slots, one after a reset)
              against 8 eager ticks (outputs and state), kernel path vs
              plain twin, a slot's streamed features vs the offline
              extractor (K1) on the same audio; the 8 replayed ticks run
              under the profiler, and K2's launches are its device events
              there, one a tick (raises where they are not measured);
  6. server — serve() on 127.0.0.1 with 64 stream slots and an OOD
              detector, graphed: 16 clients × 4 /stream/push plus /predict
              requests, responses held against a direct StreamingRecognizer
              run (graphed, and it against an eager one) and a direct
              predict; then tick latency graphed and eager with a profile
              of each, and push latency;
  7. K3     — the flash-attention kernels (K3a forward, K3b dq, K3c dk/dv):
              the count of tensor-core (HGMMA) and cp.async (LDGSTS)
              instructions in each kernel's SASS; all six outputs
              against their plain twins at B·H = 8, T = 100, D = 32, at
              D = 64, with a hole of whole 64-key tiles (keys 64-191),
              ragged Tq = 130 != Tk = 300 and live key tiles past the
              first 32 (Tk = 2200), each at D = 32 and 64 with an
              all-masked element, and at the training shape B = 64, H = 4,
              T = 2048, D = 32 under two masks (prefix lengths in [T/8, T];
              4-16 valid keys, phase 8's padding), each against a second
              run bit for bit; their times on the share of live key tiles
              beside their 3xTF32 bounds (float32 FMA bounds printed
              beside), the plain twins and PyTorch's SDPA; the K3-vs-SDPA
              crossover, forward and forward+backward, over T in {256, 512,
              1024, 2048, 4096};
  8. train  — RawSequenceTrainer on a 768/96/96-utterance IEMOCAP-layout
              fixture (seed 42, transcripts padded to 2,048 tokens) at the
              CLI's full width: 24 steps (lr 2e-3, batch 64, 2 epochs) and
              predict on the test split, with the launches of K1, K3a-c and
              the embedding gradient on every step and predict batch; step
              time, val CCC; the same seeded run again from a fresh model,
              equal bit for bit (val CCC, parameters, predictions); a
              profiled step with K3a's share of its device time; the
              embedding gradient at the step's shape against its plain twin
              and timed beside its byte bound; the step time at the CLI's
              own 16 tokens (no K3); then 3 steps, each run with the
              kernels and with their plain twins from the same seeded
              state, and the first kernel step twice, equal bit for bit;
  9. K4     — the stochastic int8 quantizer (one cooperative launch): the
              card's on-chip capacity (resident blocks, bytes staged per
              block); against its plain twins at [1, 1], [7, 13], [768, 512],
              3 elements past that capacity (each share then reads its rest
              from L2) and [4096, 4096], with the given words and with
              Philox words: equal values and scale bits, a seed repeats bit
              for bit and another differs, the reference's bounds; its time
              at [4096, 4096] between CUDA events and on the device (one
              kernel a call and no memset, or it raises) beside the plain
              twins', both modes' byte bounds and w.to(torch.int8) as a byte
              yardstick;
 10. main   — the feature-level main path: `tpu_deer_torch.cli.main --mode
              full --quick` at the flagship's width (3,918,324 params) with
              every artifact checked; the best checkpoint served by
              InferenceEngine.from_checkpoint in float and int8 (int8 vs
              float, int8 vs the dequantized weights in float, int8 on the
              card; graphed vs eager, predict p50 and busy share at 1-300),
              the plots it wrote (the static figures where matplotlib
              imports, else the dashboard, the data export and the reason),
              exported by `cli --mode export` in float and int8 (export
              wall, each file's bytes) and served by ExportedEngine (graphed
              vs eager, vs the live engine, p50), and `python -m
              tpu_deer_torch.server` in a subprocess over the artifact and
              over the checkpoint with 4 stream slots (/healthz, one
              /predict, a session's push), with K4's launches over both
              (0: the engines round to nearest, as the reference's); K4
              by direct calls of its public function on each of the
              checkpoint's 44 Dense kernels, each held against the plain
              twin (the launches the record reports: no entry point of
              either package launches K4), then the 44 calls timed (host
              clock to a synchronize, device time); (d) the headline recipe
              (`--recipe uncertainty`: batch 4096, fused epochs) on 131,072
              rows for 2 epochs (64 steps) as the pipeline builds it: a CUDA
              graph of the train step replayed for every step after the
              warm-up (raises unless the replays are the steps less the
              warm-up), then the same without fused epochs (eager steps):
              step p50 and epoch wall both ways, the capture's time; 8
              graphed and 8 eager steps from one state and seed with
              dropout on, parameters within rtol 1e-5 / atol 1e-5 (and the
              count of tensors differing in any bit); the device's busy
              share over an epoch of replays and over an eager step; (e)
              the headline experiment's twin (`tpu_deer_torch.experiments
              .synthetic_headline`, bf16 on the card) at 131,072 rows for
              10 epochs, its JSON and Markdown written and its metrics
              finite;
 11. bench  — the port's bench at full size, `tpu_deer_torch.bench.main()`
              (the flagship in bf16: serving at batch 1 and 256, int8,
              4,096 × 512 graphed forwards, 1,024 utterances of 3 s through
              K1, 256 streams with K2 in the tick's graph, 100 graphed train
              steps at batch 16,384, MFU and roofline), its stderr lines
              and JSON line printed with the phase's wall, then the same
              sections in float32 for comparison; raises unless
              the dtype is bfloat16 and the value finite, K1 launched in
              the front-end section and K2 captured in the stream
              section's tick graph (the counts zeroed just before), and the
              bf16 forward on the card is within BF16_TOL of the CPU's bf16
              forward (256 rows); then the outputs that cuBLAS's bf16
              reduced-precision reductions move, a graphed forward's time
              at 4,096 rows with them off and on, and bf16 predict at 1 and
              256 rows under the profiler.

 12. ensemble — a K = 4 deep ensemble of the flagship (15,673,296 params,
              `train/ensemble.py`) on benchmark_v2 at the ensemble study's
              131,072 rows, batch 2,048, dropout 0.1, float32: 2 fused
              epochs graphed (one CUDA graph of the vmapped K-member step)
              and the same 2 eagerly from one state (losses and parameters
              within rtol/atol 1e-5), step p50 both ways, capture time, the
              device time and busy share over an epoch of replays and over
              an eager step; one dropout-off step against 4 single-model
              DEERTrainer steps from the member slices (losses; gradients,
              each also against the single model's in float64; parameters
              within 2 lr); the combined predict on 8,192 rows, and
              predict_mc_dropout (S = 8) on member 0 against a host loop
              over the samples of a seeded forward of the repeated batch
              (1e-5) and against itself (bit for bit), wall and device
              times; the checkpoint served by InferenceEngine.from_checkpoint
              (ensemble_members=4) in float and int8 at 1-300 rows, graphed
              equal to eager in every element, p50 and device time at 1
              and 256 rows, int8 μ within 0.05 of float; `cli --mode export
              --ensemble 4` served by ExportedEngine (1e-5 of the live
              engine) and `python -m tpu_deer_torch.server --checkpoint DIR
              --ensemble 4` in a subprocess (/healthz, /predict);
              add_teacher_targets(ensemble=True) over the 131,072 rows and a
              fused epoch of distill_study.py's student on them (distill_mu
              and distill_unc finite and > 0); no kernel of K1-K4 or the
              embedding gradient launches on this path (raises otherwise).
 13. corpus — the real-corpus path on fixture corpora in the IEMOCAP,
              RAVDESS and MELD layouts (192 utterances each, real-format
              wavs, transcripts and CSVs): (a) all three through
              `data/registry.py:load_configured_datasets` at AUTO, each
              loader's wall split into decode, K1, MLM, text and video; K1
              launched once a length bucket, the embedding-gradient kernel
              once an MLM step (the 4-layer 256-d encoder pretrained on the
              corpus's own train transcripts on the card), K3's count (0
              expected: 128 tokens), the MLM loss falling; one MLM step's
              embedding gradient at full width (ids [64, 128], dropout off)
              through the kernel lookup against the plain one, each with the
              tied logits, against its two shares added, and the kernel on
              the step's dX against its plain twin, within EMB_TOL; IEMOCAP
              and RAVDESS loaded again with K1's plain twin, the 84-d vectors
              against K1's within FEAT_TOL;
              (b) IEMOCAP again with a fresh cache, the MLM encoder, its loss
              curve and every feature array equal bit for bit; (c)
              MultiDatasetFramework's joint training (fused epochs) and the
              transfer matrix at the flagship's width; (d) `cli --mode full
              --quick` with `datasets.paths` on the three trees (every corpus
              tested, the text backends recorded) and `cli --raw --quick
              --raw_dataset` in each layout, K1's in-graph launches; (e)
              CrossValidationEvaluator (2 folds) and AblationStudy (A, A+T)
              at 1 epoch on the flagship.
 14. zoo    — the model zoo and the rest of the audio front-end: (a) the
              flagship with each fusion type (hierarchical, attention,
              bilinear, concat, adaptive, moe) and the stacked layout at
              full width, each with the reference's parameter count: 4
              fused steps at batch 512 on benchmark_v2 rows graphed against
              4 eager ones from one state (GRAPH_TOL), graphed predict at 1
              and 256 rows equal to eager in every bit, int8 μ within 0.05
              of float, step p50s; the stacked forward on stack_params of
              the trained hierarchical weights against the default forward;
              (b) the enhanced 84-d vectors of 64 utterances through K1
              (one launch) against the plain twin within FEAT_TOL, the
              conv route's products against the plain twin's within
              K1_TOL (its vectors' disagreement shown), with their times;
              (c) the native WAV decoder built from native/wavio.cpp and
              used for 44.1 and 48 kHz stereo wavs (against scipy's
              samples), 192 decodes in 8 threads native against scipy;
              (d) UnifiedSequenceEncoder in eval at 2,048 tokens, batch 8:
              K3a once a text layer, outputs against use_flash=False within
              K3_TOL; HierarchicalDEERFusionModel at batch 256 graphed
              against eager.

The last two lines of stdout are a {"kernels": [...]} record and
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero and prints no result. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import base64
import copy
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0
SR = 16000
N_UTTERANCES = 300
KERNELS = ("mfcc_signal", "mfcc_frames", "flash_attention",
           "quantize_int8", "embedding_grad")  # csrc/<name>.cu
STREAMS = 256  # concurrent streams per tick (the shape of bench.py:281-283)
TICKS = 8
SERVER_SLOTS, CLIENTS, PUSHES = 64, 16, 4
DEVICE = "cuda"  # phases 4-6 and 8 (a CPU rehearsal sets "cpu")
F32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
TF32_FLOPS = 495e12  # H100 SXM dense TF32 (K3's bound: 3xTF32)
# K3 against its plain twin (rtol, atol): float32 FMAs in another order than
# cuBLAS's over up to 2,048 keys; lse and δ are sums of the same kind.
K3_TOL = (1e-4, 5e-5)
K3_SHAPE = (64, 4, 2048, 32)  # B, H, T, D of the training step's text layers
CROSSOVER_T = (256, 512, 1024, 2048, 4096)  # K3 vs SDPA at B = 16, H = 4, D = 32
RAW_FIXTURE = (768, 96, 96)  # cli.py --raw, non-quick
RAW_BATCH = 64  # cli.py --raw, non-quick
# Transcripts padded to 2,048 tokens so that both train (>= 1024) and predict
# (>= 2048) take K3; the CLI's loader pads to 16 (no K3), and the fixture's
# transcripts hold ~9 tokens, so nearly all of K3's keys are padding here.
RAW_MAX_TOKENS = 2048
CLI_MAX_TOKENS = 16  # load_raw_corpus's default, as cli.py --raw loads it
RAW_STEPS_COMPARED = 3
# Training steps with the kernels vs their plain twins, each from the same
# state. Losses and clipped gradients (rtol, atol): float32 forward and
# backward through ~40 layers with K1's and K3's sums in another order.
# Parameters after an AdamW step of lr 2e-3: Adam steps by about g/|g|, so a
# gradient difference ε moves an entry's step by about lr·ε/|g|. Entries
# whose plain gradient is at least GRAD_FLOOR (100× the largest gradient
# difference, 7.8e-7, of the card's first runs) are held within PARAM_ATOL
# (5× that estimate); an entry whose exact gradient is ~0 steps ±lr on float
# noise, so it is shown, not held.
TRAIN_TOL = {"loss": (1e-4, 1e-5), "grads": (1e-3, 1e-6)}
GRAD_FLOOR, PARAM_ATOL = 1e-4, 1e-4
# The embedding gradient against its plain twin in float64 (rtol, atol): a
# float32 sum of up to ~130,000 rows of the padding id, taken in pieces of
# 64 and then over the pieces.
EMB_TOL = (1e-5, 1e-3)
# (rtol, atol) for mfcc, logmel, power, timefeats: float32 sums of 1024
# products in another order (cuBLAS vs the kernel's FMA chain); ZCR exact.
K1_TOL = ((2e-3, 5e-3), (2e-4, 1e-3), (2e-4, 1e-3), (1e-4, 1e-5))
# Features and predictions, kernel vs plain twin (rtol, atol).
FEAT_TOL = (1e-4, 1e-5)
K4_SHAPES = ((1, 1), (7, 13), (768, 512), (4096, 4096))  # [768, 512]: the
# flagship's largest Dense kernel (fusion_gate); [4096, 4096] is timed, and
# phase 9 adds [capacity + 3] before it (k4_shapes): the card's staged
# capacity is its own, so that entry is computed there.
K4_ABOVE_CAPACITY = 3  # elements past the capacity: each share reads 16 from L2
K4_NAME = "quantize_one_pass"  # the kernel's name in the profiler
# K4's bounds, as tests/test_quantization.py:64-67 holds the reference:
# values in [-127, 127] and |q·s - w| <= 1.01 s everywhere; |mean(q·s - w)|
# <= 0.05 s where the mean has >= 4,096 terms (its standard deviation is at
# most 0.5 s / sqrt(n), 0.0078 s there; the reference tests 8,192).
K4_MEAN_MIN = 4096
QUICK_ROWS = (512, 128, 128)  # cli.py --quick's synthetic splits, seed 42
# The headline recipe (cli.py --recipe uncertainty: batch 4096, fused
# epochs) on 131,072 synthetic training rows for 2 epochs (64 steps).
STEP_ROWS, STEP_EPOCHS = 131072, 2
# Graphed steps against eager ones from one state (rtol, atol): the same
# float32 device work in the same order, so equal bits are expected; the
# limit allows for a cuBLAS algorithm that differs between a capture and an
# eager launch.
COMPARE_STEPS, GRAPH_TOL = 8, (1e-5, 1e-5)
# The headline experiment's twin, cut from 1,048,576 rows and 100 epochs
# (validation every 10 epochs: one validation).
TWIN_ROWS, TWIN_EPOCHS = 131072, 10
PREDICT_SIZES = (1, 8, 64, 256, 300)  # every bucket, and a chunked request
# Phase 12: a K = 4 ensemble of the flagship at the ensemble study's data
# (benchmark_v2, 131,072 rows, batch 2,048), 2 fused epochs graphed and
# eager; prediction and MC dropout on the study's 8,192 evaluation rows.
ENS_MEMBERS, ENS_ROWS, ENS_BATCH, ENS_EVAL, ENS_EPOCHS = 4, 131072, 2048, 8192, 2
# MC dropout against the repeated-batch forward (rtol, atol): the same masks,
# GEMMs of another shape, moments in float32 against float64.
MC_SAMPLES, MC_TOL = 8, (1e-5, 1e-5)
# A K-member step's gradients against K single-model steps' (no dropout): the
# flagship's float32 gradient at 2,048 rows is ~2e-3 (norm) from its float64
# gradient on the CPU as well, and cuBLAS's batched and single GEMMs sum in
# another order, so each float32 path carries its own such error. Held: the
# ensemble's distance from the float64 gradient within this factor of the
# single model's.
ENS_GRAD_FACTOR = 2.0
# The bf16 forward on the card against the CPU's (tests/test_torch_bf16_cuda.py):
# |card − cpu| within these fractions of the CPU's own bf16-vs-float32 gap
# on the same inputs (max, mean); BF16_ROWS standard-normal rows, seed 0.
BF16_TOL = (0.5, 0.25)
BF16_ROWS = 256
BF16_TIMED_ROWS = 4096  # the bench's forward batch
# Phase 13: the real-corpus path. Fixture corpora in the three layouts,
# 192 utterances each (<= 200, so --quick keeps every split): IEMOCAP and
# MELD 96/48/48 train/val/test, RAVDESS 8 an actor; wavs of these lengths
# (s), one K1 length bucket a corpus (8 s and 4 s; MELD's features take no
# audio). Joint training and each transfer source: 2 epochs at batch 32;
# `cli --raw --quick` in each layout: 2 epochs.
CORPUS_ROWS, CORPUS_PER_ACTOR = (96, 48, 48), 8
CORPUS_SECONDS = {"iemocap": 4.5, "ravdess": 3.5, "meld": 0.8}
CORPUS_EPOCHS, CORPUS_BATCH, RAW_CLI_EPOCHS = 2, 32, 2
CORPUS_NAMES = {"iemocap": "IEMOCAP", "ravdess": "RAVDESS", "meld": "MELD"}
# Phase 14: the model zoo at the flagship's width (its parameter counts are
# the reference's, experiments/RESULTS_fusion.md), 4 fused steps each at
# batch 512 on benchmark_v2 rows (dropout 0.1, lr 1e-4: at the fusion
# study's 1e-3 without its 64-step warm-up the bilinear fusion's loss jumps
# to ~1e9 within 8 steps on either package, and int8 then serves a model
# far from its float one), graphed against eager from one state; graphed
# predict at ZOO_PREDICT rows.
ZOO_LAYOUTS = {"hierarchical": {}, "attention": {"fusion_type": "attention"},
               "bilinear": {"fusion_type": "bilinear"},
               "concat": {"fusion_type": "concat"},
               "adaptive": {"fusion_type": "adaptive"},
               "moe": {"fusion_type": "moe"},
               "stacked": {"stacked_compute": True}}
ZOO_COUNTS = {"hierarchical": 3_918_324, "attention": 2_736_117,
              "bilinear": 36_027_380, "concat": 2_997_236,
              "adaptive": 37_081_336, "moe": 3_657_720, "stacked": 3_918_324}
ZOO_BATCH, ZOO_STEPS, ZOO_PREDICT, ZOO_LR = 512, 4, (1, 256), 1e-4
INT8_MU_TOL = 0.05  # int8 μ against float, as phases 10 and 12 hold it
# The bilinear form (and the adaptive blend that holds it) leaves the fused
# features unnormalized (|x| ~ 11 at init, against ~1 for the others), so
# the per-channel int8 rounding of the heads' first kernels moves μ by up to
# ~0.09 (the reference's quantize_tree, which the port's equals, does the
# same): their int8 gap is shown, and the int8 engine held to the float
# forward of its dequantized weights, as every layout's.
INT8_UNNORMALIZED = ("bilinear", "adaptive")
# The enhanced 84-d vectors of 64 voiced utterances of 3 s; 192 decodes of a
# 44.1 kHz and a 48 kHz stereo wav of 3 s in 8 threads; the unified
# encoder's text at 2,048 tokens (K3a at inference) for a batch of 8; the
# standalone hierarchical model at batch 256.
ENH_UTTERANCES, ENH_SECONDS = 64, 3.0
DECODES, DECODE_THREADS, DECODE_SECONDS = 192, 8, 3.0
UNIFIED_B, UNIFIED_T = 8, 2048
HIER_BATCH = 256
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


def graph_vs_eager(torch, label, got, ref):
    """Graphed outputs against the eager path's through the same entry point
    ({key: array}): booleans equal, numbers within GRAPH_TOL (equal bits are
    expected). Returns (elements differing in any bit, elements, max abs
    err)."""
    differ = total = 0
    err = 0.0
    for key, r in ref.items():
        g = np.asarray(got[key])
        r = np.asarray(r)
        if g.shape != r.shape:
            raise AssertionError(f"{label} {key}: shape {g.shape} graphed, "
                                 f"{r.shape} eager")
        differ += int((g != r).sum())
        total += r.size
        if r.dtype == bool:
            if not np.array_equal(g, r):
                raise AssertionError(f"{label} {key}: graphed and eager differ")
            continue
        err = max(err, check_close(f"{label} {key} graphed vs eager",
                                   torch.from_numpy(g), torch.from_numpy(r),
                                   *GRAPH_TOL))
    return differ, total, err


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


def profiled(torch, fn, expect, windows, markers=64):
    """Run fn under the profiler; returns ([(device event name, ms)], wall
    ms) of the first of up to `windows` windows that lost none of fn's
    device events, else None. On the H100 the profiler drops the first
    device events of a window, more of them the longer the process has
    run (one more every 5-25 s; now and then all). So each window first
    runs `markers` empty kernels (torch.cuda._sleep(1), doubled at each
    retry) and counts only if one of them and, for each name in `expect`,
    at least its count of fn's device events came through."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(markers):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        kept = sum("spin_kernel" in name for name, _ in events)
        events = [(name, ms) for name, ms in events if "spin_kernel" not in name]
        short = {key: n for key, n in (expect or {}).items()
                 if sum(key in name for name, _ in events) < n}
        if kept and events and not short:
            return events, wall_ms
        print(f"profiler: a window lost {markers - kept} of its {markers} "
              f"markers" + "".join(f", {key} < {n}" for key, n in short.items()))
        markers *= 2
    return None


def device_ms(torch, fn, calls=20, expect=(), windows=3):
    """Device time per call of fn (ms): its kernels' and memsets' device
    time under the profiler over `calls` calls, each of the kernels named
    in `expect` seen once a call; None (not measured) if no window had
    them all. For kernels of tens of microseconds, where time_ms also
    counts the gaps while the host enqueues the next launch."""
    fn()

    def run():
        for _ in range(calls):
            fn()

    got = profiled(torch, run, {key: calls for key in expect}, windows)
    return None if got is None else sum(ms for _, ms in got[0]) / calls


def ms_text(ms):
    """A device time from device_ms as text."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def profile_window(torch, label, fn, expect=None, windows=1):
    """Print the device's busy share and top kernels over one call of fn
    (taken again, up to `windows` calls, while the profiler misses one of
    the `expect` launches: see `profiled`); returns {kernel name: device
    ms} ({} if not measured)."""
    got = profiled(torch, fn, expect, windows)
    if got is None:
        print(f"profile {label}: device time not measured (the profiler "
              f"missed device events in {windows} window(s))")
        return {}
    events, wall_ms = got
    kernels = {}
    for name, ms in events:
        kernels[name] = kernels.get(name, 0.0) + ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    print(f"profile {label}: wall {wall_ms:.3f} ms under the profiler, "
          f"{len(events)} device events, {busy:.3f} ms on the device "
          f"(busy {100 * busy / wall_ms:.1f}%); top: "
          + "; ".join(f"{name[:48]} {ms:.3f} ms" for name, ms in top))
    return kernels


def voice(rng, n, f0):
    """A harmonic tone with slow vibrato plus a little noise, [n] float32."""
    t = np.arange(n) / SR
    phase = 2 * np.pi * f0 * (t + 0.01 * np.sin(2 * np.pi * 3.0 * t))
    sig = sum(np.sin(h * phase) / h for h in (1, 2, 3, 4))
    return (0.3 * sig + 0.01 * rng.normal(size=n)).astype(np.float32)


def edge_signal(kind, n, rng):
    """[n] float32: silence, a DC offset, a tone at the Nyquist bin
    (alternating ±0.4) or an impulse, all but silence with voice()'s noise
    (0.01): a noiseless tone leaves float noise in empty mel bands, where
    the log amplifies it."""
    if kind == "zero":
        return np.zeros(n, dtype=np.float32)
    sig = 0.01 * rng.normal(size=n)
    if kind == "dc":
        sig += 0.5
    elif kind == "nyquist":
        sig += 0.4 * (-1.0) ** np.arange(n)
    else:
        sig[n // 3] += 1.0
    return sig.astype(np.float32)


EDGE_KINDS = ("zero", "dc", "nyquist", "impulse")


def check_mfcc(torch, label, got, ref, kind=None):
    """K1/K2 outputs against the plain twin's within K1_TOL (finite, same
    shapes; silence: power exactly 0); returns the max abs errors."""
    errs = []
    for name, g, r, (rtol, atol) in zip(
            ("mfcc", "logmel", "power", "timefeats"), got, ref, K1_TOL):
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{label} {name}: shape {tuple(g.shape)} or "
                                 f"non-finite values")
        errs.append(check_close(f"{label} {name}", g, r, rtol, atol))
    if kind == "zero" and (got[2].any() or ref[2].any()):
        raise AssertionError(f"{label}: power of silence is not 0")
    return errs


def check_repeat(torch, label, fn):
    """fn() twice: every output equal bit for bit (no atomics, fixed sums)."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(first, second)):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: output {i} differs between two "
                                 f"runs")
    return first


def ptxas_usage(report, kernel):
    """["<kernel><n>: R registers, S B spill stores, ..."] from nvcc's
    -Xptxas -v report for the instances of `kernel` (a name in the mangled
    entry), [] when the library was already built."""
    lines, fn = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            fn = None
            if kernel in name:
                fn = f"{kernel}<{name.split('ILi')[1].split('E')[0]}>"
        elif fn and "spill" in line:
            spill = line.strip()
        elif fn and "registers" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            lines.append(f"{fn}: {regs}, {spill}")
            fn = None
    return lines


def fft_flops(cfg, frames):
    """The FFT design's own float operations for `frames` frames: windowing
    (n_fft), an M = n_fft/2-point complex FFT (5 M log2 M), the real split
    (16 a bin) and the power (3 a bin)."""
    m = cfg.n_fft // 2
    return frames * (cfg.n_fft + 5 * m * math.log2(m) + 19 * (m + 1))


def k1_work(cfg, b, tp, n, mel_nnz):
    """(FLOPs, bytes) that K1's function needs at the least, on b signals of
    tp padded samples and n frames each.

    The DFT is counted at a real FFT's cost, 2.5 n_fft log2(n_fft) per frame,
    and the mel product at the filterbank's nonzeros. Bytes: the signal read once, the four
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


def phase_kernel(torch, taf, k1, report):
    """K1 against its plain twin on the card; returns the kernels record.
    `report` is nvcc's for K1's library ("" if it was built already)."""
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
        got = check_repeat(torch, f"K1 B={b} T={n}", lambda: k1.mfcc_signal(
            x_pad, bases, cfg.n_fft, cfg.hop_length))
        if k1.mfcc_signal.launches != before + 2:
            raise AssertionError("mfcc_signal did not count its launches")
        ref = k1.mfcc_signal_plain(x_pad, bases, cfg.n_fft, cfg.hop_length)
        errs = check_mfcc(torch, f"K1 B={b} T={n}", got, ref)
        if not torch.equal(got[3][..., 1], ref[3][..., 1]):
            raise AssertionError(f"K1 ZCR differs from the plain twin, B={b} T={n}")
        max_err = max(max_err, *errs)
        print(f"K1 vs plain B={b} T={n} N={frames}: max abs err mfcc "
              f"{errs[0]:.3e} logmel {errs[1]:.3e} power {errs[2]:.3e} "
              f"timefeats {errs[3]:.3e}; ZCR equal; bit-equal across 2 runs")
        if (b, n) == (64, 4 * SR):
            main = (x_pad, frames)

    # The FFT's edge cases at each n_fft the kernel takes.
    for n_fft in k1.SUPPORTED_N_FFT:
        ecfg = taf.AudioFrontendConfig(n_fft=n_fft)
        ebases = taf._device_bases(ecfg, torch.device("cuda"))
        for kind in EDGE_KINDS:
            sig = np.stack([edge_signal(kind, 24017, rng) for _ in range(3)])
            x_pad, _ = taf._pad_for_frames(torch.from_numpy(sig).cuda(), ecfg)
            label = f"K1 {kind} n_fft={n_fft}"
            got = check_repeat(torch, label, lambda: k1.mfcc_signal(
                x_pad, ebases, n_fft, ecfg.hop_length))
            ref = k1.mfcc_signal_plain(x_pad, ebases, n_fft, ecfg.hop_length)
            errs = check_mfcc(torch, label, got, ref, kind)
            if not torch.equal(got[3][..., 1], ref[3][..., 1]):
                raise AssertionError(f"{label}: ZCR differs from the plain twin")
            max_err = max(max_err, *errs)
        print(f"K1 edge cases n_fft={n_fft} ({', '.join(EDGE_KINDS)}; B=3 "
              f"T=24017): within K1_TOL, ZCR equal, silence's power 0, "
              f"bit-equal across 2 runs")
    odd = taf.AudioFrontendConfig(n_fft=768)
    x_odd, _ = taf._pad_for_frames(torch.zeros(1, 8000, device="cuda"), odd)
    before = k1.mfcc_signal.launches
    try:
        k1.mfcc_signal(x_odd, taf._device_bases(odd, torch.device("cuda")),
                       768, odd.hop_length)
        raise AssertionError("K1 took n_fft 768")
    except ValueError as err:
        if "power-of-two" not in str(err) or k1.mfcc_signal.launches != before:
            raise
    print("K1 n_fft 768 (not a power of two): refused before any launch")

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
    kernel_dev = device_ms(torch, run(k1.mfcc_signal), expect=("mfcc_signal",))
    mel_nnz = int(torch.count_nonzero(bases["mel"]))
    flops, nbytes = k1_work(cfg, b, tp, frames, mel_nnz)
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    fft = fft_flops(cfg, b * frames)
    smem, blocks = k1.launch_config(0, cfg.n_fft, cfg.n_mels, cfg.n_mfcc)
    tiles = b * -(-frames // 8)
    print(f"K1 at B=64, 4 s bucket (N={frames}): kernel {kernel_ms:.4f} ms "
          f"between CUDA events, {ms_text(kernel_dev)} on the device, plain "
          f"twin {plain_ms:.4f} ms; bound {max(t_ops, t_bytes):.4f} ms "
          f"({flops / 1e9:.4f} GFLOP f32 at FFT cost -> {t_ops:.4f} ms, "
          f"{nbytes / 1e6:.2f} MB -> {t_bytes:.4f} ms)")
    print(f"informational, not the bound: K1's FFT (window, 5 M log2 M for "
          f"M = {cfg.n_fft // 2}, real split and power) is {fft / 1e9:.4f} "
          f"GFLOP -> {fft / F32_FLOPS * 1e3:.4f} ms at the f32 rate")
    print(f"K1 launch: {blocks} blocks of 256 threads resident ({blocks // 132}"
          f" a SM on 132), grid {min(blocks, tiles)} over {tiles} tiles of 8 "
          f"frames, {smem} B of dynamic shared memory a block")
    for line in ptxas_usage(report, "mfcc_signal_kernel") or ["not rebuilt"]:
        print(f"K1 ptxas: {line}")
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
    engine = InferenceEngine(model)  # graphed: one CUDA graph a bucket
    eager = InferenceEngine(model, graphs=False)
    engine.warmup()  # captures every bucket, as the server's start-up does
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
    differ = total = 0
    graph_err = 0.0
    for n, out in outs.items():
        d, t, e = graph_vs_eager(torch, f"predict({n})", out,
                                 eager.predict(audio[:n], video[:n], text[:n]))
        differ, total, graph_err = differ + d, total + t, max(graph_err, e)
    print(f"slice: predict graphed vs eager at sizes {sizes}: {differ} of "
          f"{total} elements differ in any bit, max abs err {graph_err:.3e} "
          f"(GRAPH_TOL); capture ms per bucket "
          + ", ".join(f"{b}: {sec * 1e3:.1f}"
                      for b, sec in engine.bucket_graphs.capture_s.items()))

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
    feats = (audio, video, text)
    for n in sizes:
        print(f"predict request size {n}: p50 graphed "
              f"{predict_p50(engine, feats, n):.4f} ms, eager "
              f"{predict_p50(eager, feats, n):.4f} ms (host clock, 30 "
              f"requests, outputs copied to the host)")
    profile_window(torch, f"featurise {n_utt} utterances",
                   lambda: extractor.audio.extract_batch(signals))
    for n in (1, 256):
        for label, e in (("graphed", engine), ("eager", eager)):
            profile_window(torch, f"predict {n} {label}",
                           lambda: e.predict(audio[:n], video[:n], text[:n]))
    return launches


def k2_work(cfg, rows, mel_nnz):
    """(FLOPs, bytes) that K2's function needs at the least, on `rows`
    frames: as k1_work, without RMS and ZCR, and with the frames (not a
    signal) read once."""
    bins, mels, ceps, fft = cfg.n_bins, cfg.n_mels, cfg.n_mfcc, cfg.n_fft
    per_frame = (fft                            # window
                 + 2.5 * fft * math.log2(fft)   # real FFT
                 + 3 * bins                     # power
                 + 2 * mel_nnz                  # mel
                 + mels                         # log
                 + 2 * mels * ceps)             # DCT
    bases = fft + bins * mels + mels * ceps
    outputs = rows * (ceps + mels + bins)
    return rows * per_frame, 4 * (rows * fft + bases + outputs)


def voiced_frames(torch, taf, rng, cfg, rows):
    """[rows, n_fft] contiguous frames of voice() audio on the card."""
    sig = voice(rng, rows * cfg.hop_length, rng.uniform(90, 300))
    frames = taf.frame_signal(torch.from_numpy(sig).to(DEVICE), cfg)
    return frames[:rows].contiguous()


def phase_k2(torch, taf, k2, report):
    """K2 against its plain twin on the card; returns the kernels record.
    `report` is nvcc's for K2's library ("" if it was built already)."""
    rng = np.random.default_rng(SEED + 2)
    main_rows = STREAMS * (4096 // 256)  # the tick's rows: 256 streams × 16
    max_err, timed = 0.0, None
    for n_fft, rows in ((1024, 16), (1024, main_rows), (1024, 37 * 16 + 5),
                        (512, 37 * 16 + 5)):
        cfg = taf.AudioFrontendConfig(n_fft=n_fft)
        bases = taf._device_bases(cfg, torch.device(DEVICE))
        frames = voiced_frames(torch, taf, rng, cfg, rows)
        before = k2.mfcc_frames.launches
        got = check_repeat(torch, f"K2 R={rows} n_fft={n_fft}",
                           lambda: k2.mfcc_frames(frames, bases, n_fft))
        if k2.mfcc_frames.launches != before + 2:
            raise AssertionError("mfcc_frames did not count its launches")
        ref = k2.mfcc_frames_plain(frames, bases, n_fft)
        errs = check_mfcc(torch, f"K2 R={rows} n_fft={n_fft}", got, ref)
        max_err = max(max_err, *errs)
        print(f"K2 vs plain R={rows} n_fft={n_fft}: max abs err mfcc "
              f"{errs[0]:.3e} logmel {errs[1]:.3e} power {errs[2]:.3e}; "
              f"bit-equal across 2 runs")
        if (n_fft, rows) == (1024, main_rows):
            timed = (frames, bases, cfg)

    for n_fft in k2.SUPPORTED_N_FFT:
        ecfg = taf.AudioFrontendConfig(n_fft=n_fft)
        ebases = taf._device_bases(ecfg, torch.device(DEVICE))
        for kind in EDGE_KINDS:
            frames = torch.from_numpy(np.stack(
                [edge_signal(kind, n_fft, rng) for _ in range(101)])).to(DEVICE)
            label = f"K2 {kind} n_fft={n_fft}"
            got = check_repeat(torch, label,
                               lambda: k2.mfcc_frames(frames, ebases, n_fft))
            ref = k2.mfcc_frames_plain(frames, ebases, n_fft)
            max_err = max(max_err, *check_mfcc(torch, label, got, ref, kind))
        print(f"K2 edge cases n_fft={n_fft} ({', '.join(EDGE_KINDS)}; R=101):"
              f" within K1_TOL, silence's power 0, bit-equal across 2 runs")
    odd = taf.AudioFrontendConfig(n_fft=768)
    before = k2.mfcc_frames.launches
    try:
        k2.mfcc_frames(torch.zeros(4, 768, device=DEVICE),
                       taf._device_bases(odd, torch.device(DEVICE)), 768)
        raise AssertionError("K2 took n_fft 768")
    except ValueError:
        if k2.mfcc_frames.launches != before:
            raise
    print("K2 n_fft 768: refused before any launch")

    frames, bases, cfg = timed
    run = lambda fn: (lambda: fn(frames, bases, cfg.n_fft))
    kernel_ms = time_ms(run(k2.mfcc_frames))
    plain_ms = time_ms(run(k2.mfcc_frames_plain))
    kernel_dev = device_ms(torch, run(k2.mfcc_frames), expect=("mfcc_frames",))
    mel_nnz = int(torch.count_nonzero(bases["mel"]))
    flops, nbytes = k2_work(cfg, main_rows, mel_nnz)
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    fft = fft_flops(cfg, main_rows)
    smem, blocks = k2.launch_config(0, cfg.n_fft, cfg.n_mels, cfg.n_mfcc)
    tiles = -(-main_rows // 8)
    print(f"K2 at R={main_rows} (one tick of {STREAMS} streams), n_fft "
          f"{cfg.n_fft}: kernel {kernel_ms:.4f} ms between CUDA events, "
          f"{ms_text(kernel_dev)} on the device, plain twin {plain_ms:.4f} "
          f"ms; bound {max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.4f} GFLOP "
          f"f32 at FFT cost -> {t_ops:.4f} ms, {nbytes / 1e6:.2f} MB -> "
          f"{t_bytes:.4f} ms)")
    print(f"informational, not the bound: K2's FFT (window, 5 M log2 M for "
          f"M = {cfg.n_fft // 2}, real split and power) is {fft / 1e9:.4f} "
          f"GFLOP -> {fft / F32_FLOPS * 1e3:.4f} ms at the f32 rate")
    print(f"K2 launch: {blocks} blocks of 256 threads resident ({blocks // 132}"
          f" a SM on 132), grid {min(blocks, tiles)} over {tiles} tiles of 8 "
          f"rows, {smem} B of dynamic shared memory a block")
    for line in ptxas_usage(report, "mfcc_frames_kernel") or ["not rebuilt"]:
        print(f"K2 ptxas: {line}")
    return {
        "name": "mfcc_frames",
        "route": "cuda",
        "source": "tpu_deer_torch/kernels/csrc/mfcc_frames.cu",
        "replaces": "tpu_deer/ops/audio_frontend.py:135",  # _mfcc_kernel
        "launches": None,  # filled from the stream phase's run
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def context(rng, n):
    """(video [n, 256], text [n, 768]) context features, as the extractors
    make them from frames and transcripts."""
    from tpu_deer_torch.data.features import (
        TextFeatureExtractor,
        VideoFeatureExtractor,
    )

    video = np.stack([VideoFeatureExtractor().extract_from_frames(
        rng.uniform(size=(8, 64, 64)).astype(np.float32)) for _ in range(n)])
    text = TextFeatureExtractor().extract_batch(
        [" ".join(rng.choice(WORDS, size=rng.integers(3, 12)))
         for _ in range(n)])
    return video, text


def check_outputs(out, rows, label):
    """Every push output finite with the recognizer's shapes."""
    shapes = {"features": (rows, 84), "mu": (rows, 3), "uncertainty": (rows, 3),
              "calibrated_uncertainty": (rows, 3),
              "expected_abs_error": (rows, 3), "ood_score": (rows,)}
    if set(out) != set(shapes):
        raise AssertionError(f"{label}: keys {sorted(out)}")
    for key, shape in shapes.items():
        if out[key].shape != shape or not np.isfinite(out[key]).all():
            raise AssertionError(f"{label} {key}: shape {out[key].shape} or "
                                 f"non-finite values")
    if not (out["expected_abs_error"] > 0).all():
        raise AssertionError(f"{label}: expected_abs_error must be positive")


def phase_stream(torch, k2, model, detector):
    """256 live streams at full width, the tick replayed from its CUDA
    graph; returns (K2 launches, the graphed and the eager recognizer, the
    last tick's chunks and context)."""
    from tpu_deer_torch.ops.audio_frontend import (
        extract_utterance_features_batch,
    )
    from tpu_deer_torch.stream import StreamingConfig, StreamingRecognizer

    cfg = StreamingConfig()  # n_fft 1024, hop 256, chunk 4096 (256 ms)
    chunk = cfg.chunk_samples
    rng = np.random.default_rng(SEED + 3)
    audio = np.stack([voice(rng, TICKS * chunk, rng.uniform(90, 300))
                      for _ in range(STREAMS)])
    video, text = context(rng, STREAMS)
    inactive = np.arange(STREAMS) % 5 == 4  # idle on tick 3
    reset_ids = [3, 7, 11]  # ended and restarted before tick 5
    recs = {plain: StreamingRecognizer(model, STREAMS, cfg, detector,
                                       device=DEVICE, plain=plain)
            for plain in (False, True)}
    eager = StreamingRecognizer(model, STREAMS, cfg, detector, device=DEVICE,
                                graphs=False)

    def drive(rec):
        outs, states = [], []
        for t in range(TICKS):
            if t == 5:
                rec.reset_streams(reset_ids)
            active = ~inactive if t == 3 else None
            outs.append(rec.push(audio[:, t * chunk:(t + 1) * chunk],
                                 video, text, active))
            states.append({f"state {i}": f.cpu().numpy().copy()
                           for i, f in enumerate(rec.state)})
        return outs, states

    # The main path, counted from the device's own events: the tick's graph
    # is captured first, as StreamingSessionService does at start-up (two
    # eager warm-up runs and the capture call K2's wrapper), then every
    # slot starts from silence and TICKS ticks replay it. A replay launches
    # K2 from the graph, not through its wrapper, so K2's launches are its
    # device events in that run (a window that lost some is run again).
    rec = recs[False]
    rec.warmup()
    replays = lambda: rec._graph.replays if rec.graphs else 0
    run = {}

    def main_path():
        rec.reset_streams(np.arange(STREAMS))
        k2.mfcc_frames.launches = 0
        before = replays()
        run["outs"], run["states"] = drive(rec)
        run["wrapper"] = k2.mfcc_frames.launches
        run["replays"] = replays() - before

    got = profiled(torch, main_path, {"mfcc_frames": TICKS}, windows=6)
    if got is None:
        raise AssertionError(f"K2's launches in the main path's {TICKS} "
                             f"ticks not measured: the profiler missed "
                             f"device events in every window")
    k2_ms = [ms for name, ms in got[0] if "mfcc_frames" in name]
    outs, states, wrapper = run["outs"], run["states"], run["wrapper"]
    if len(k2_ms) != TICKS or (rec.graphs and (
            wrapper or run["replays"] != TICKS)):
        raise AssertionError(
            f"{len(k2_ms)} K2 device events in {TICKS} ticks ({run['replays']}"
            f" replays, the wrapper's count {wrapper})")
    launches = len(k2_ms)
    print(f"stream: {STREAMS} streams × {TICKS} ticks of {chunk} samples, "
          f"{run['replays']} replayed from the tick's graph (capture "
          f"{(rec.capture_s or 0) * 1e3:.1f} ms); {launches} K2 device "
          f"events in them (profiler; the wrapper's count {wrapper}): one a "
          f"tick, {np.median(k2_ms):.4f} ms on the device (median); slots "
          f"{int(inactive.sum())} idle on tick 3, {len(reset_ids)} reset "
          f"before tick 5")
    for t, out in enumerate(outs):
        check_outputs(out, STREAMS, f"tick {t}")

    eager_outs, eager_states = drive(eager)
    differ = total = 0
    err = 0.0
    for t in range(TICKS):
        for got, ref in ((outs[t], eager_outs[t]), (states[t], eager_states[t])):
            d, n, e = graph_vs_eager(torch, f"tick {t}", got, ref)
            differ, total, err = differ + d, total + n, max(err, e)
    print(f"stream: {TICKS} graphed vs {TICKS} eager ticks (outputs and "
          f"state): {differ} of {total} elements differ in any bit, max abs "
          f"err {err:.3e} (GRAPH_TOL)")

    plain_outs, _ = drive(recs[True])
    err = max(check_close(f"tick {t} {key} kernel vs plain",
                          torch.from_numpy(out[key]),
                          torch.from_numpy(ref[key]), *FEAT_TOL)
              for t, (out, ref) in enumerate(zip(outs, plain_outs))
              for key in ref)
    print(f"stream: every output of every tick, kernel vs plain: max abs "
          f"err {err:.3e}")

    # Card-side cross-check of K2 against K1: slot 0 streamed every tick.
    offline = extract_utterance_features_batch(
        torch.from_numpy(audio[:1]).to(DEVICE))[0].cpu().numpy()
    streamed = outs[-1]["features"][0]
    corr = float(np.corrcoef(streamed, offline)[0, 1])
    if not corr > 0.99:
        raise AssertionError(f"streamed vs offline correlation {corr}")
    print(f"stream: slot 0 after {TICKS} ticks vs the offline extractor (K1) "
          f"on the same {TICKS * chunk} samples: correlation {corr:.7f}, "
          f"mean abs diff {np.abs(streamed - offline).mean():.3e}")

    last = audio[:, -chunk:]
    return launches, rec, eager, last, video, text


def phase_server(torch, model, detector):
    """serve() with 64 stream slots; returns the /stream/push latencies."""
    from tpu_deer_torch.serve import InferenceEngine
    from tpu_deer_torch.server import (
        PredictionService,
        StreamingSessionService,
        serve,
    )
    from tpu_deer_torch.stream import StreamingRecognizer

    rng = np.random.default_rng(SEED + 4)
    chunk = 4096
    # Clients send 16-bit PCM (pcm16_b64), as a live client would; the
    # direct run below gets the same samples as the server decodes them.
    pcm = np.stack([voice(rng, PUSHES * chunk, rng.uniform(90, 300))
                    for _ in range(CLIENTS)])
    pcm = np.clip(np.round(pcm * 32767), -32768, 32767).astype("<i2")
    audio = pcm.astype(np.float32) / 32768.0
    video, text = context(rng, CLIENTS)
    # Graphed, as main() serves: the tick captured at construction, every
    # bucket at warm-up, before the server's threads start.
    streaming = StreamingSessionService(model, SERVER_SLOTS,
                                        ood_detector=detector, device=DEVICE)
    engine = InferenceEngine(model, ood_detector=detector, device=DEVICE)
    engine.warmup()
    service = PredictionService(engine, (84, 256, 768), micro_batch=True,
                                streaming=streaming)
    server = serve(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(
            url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    slots, resps, lat = [None] * CLIENTS, [None] * CLIENTS, []
    errors, barrier, lock = [], threading.Barrier(CLIENTS), threading.Lock()

    def client(i):
        try:
            sid = post("/stream/start", {"video": video[i].tolist(),
                                         "text": text[i].tolist()})["session_id"]
            slots[i] = streaming.sessions[sid]
            barrier.wait(timeout=60)
            resps[i] = []
            for k in range(PUSHES):
                t0 = time.perf_counter()
                resps[i].append(post("/stream/push", {
                    "session_id": sid, "pcm16_b64": base64.b64encode(
                        pcm[i, k * chunk:(k + 1) * chunk].tobytes()).decode()}))
                with lock:
                    lat.append(time.perf_counter() - t0)
            post("/stream/end", {"session_id": sid})
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    feats = [rng.normal(size=(n, d)).astype(np.float32)
             for n in (1, 5, 3) for d in (84, 256, 768)]
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(CLIENTS)]
        for t in threads:
            t.start()
        predicted = []
        for j in range(3):  # /predict while the sessions stream
            a, v, t_ = feats[3 * j:3 * j + 3]
            predicted.append((post("/predict", {"audio": a.tolist(),
                                                "video": v.tolist(),
                                                "text": t_.tolist()}),
                              engine.predict(a, v, t_)))
        for t in threads:
            t.join(timeout=300)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"stream clients failed: {errors[:3]}")
        ticks = streaming.ticks
    finally:
        server.shutdown()
        server.server_close()
        streaming.close()
        service.batcher.close()
        thread.join(timeout=30)

    for got, ref in predicted:
        for key in ("mu", "uncertainty", "calibrated_uncertainty",
                    "expected_abs_error", "ood_score"):
            check_close(f"/predict {key}", torch.tensor(got[key]),
                        torch.from_numpy(ref[key]).double(), *FEAT_TOL)
        if got["is_ood"] != ref["is_ood"].tolist():
            raise AssertionError("/predict is_ood differs from predict")

    # The same chunks through a direct recognizer, each session in its slot,
    # graphed as the service's, and through an eager one.
    rec = StreamingRecognizer(model, SERVER_SLOTS, ood_detector=detector,
                              device=DEVICE)
    rec_eager = StreamingRecognizer(model, SERVER_SLOTS, ood_detector=detector,
                                    device=DEVICE, graphs=False)
    ctx_v = np.zeros((SERVER_SLOTS, 256), np.float32)
    ctx_t = np.zeros((SERVER_SLOTS, 768), np.float32)
    ctx_v[slots], ctx_t[slots] = video, text
    err, differ, total, graph_err = 0.0, 0, 0, 0.0
    for k in range(PUSHES):
        chunks = np.zeros((SERVER_SLOTS, chunk), np.float32)
        chunks[slots] = audio[:, k * chunk:(k + 1) * chunk]
        active = np.zeros(SERVER_SLOTS, bool)
        active[slots] = True
        out = rec.push(chunks, ctx_v, ctx_t, active)
        d, n, e = graph_vs_eager(torch, f"push {k}", out,
                                 rec_eager.push(chunks, ctx_v, ctx_t, active))
        differ, total, graph_err = differ + d, total + n, max(graph_err, e)
        for i, slot in enumerate(slots):
            resp = resps[i][k]
            for key in ("mu", "uncertainty", "calibrated_uncertainty",
                        "expected_abs_error", "ood_score"):
                err = max(err, check_close(
                    f"/stream/push client {i} push {k} {key}",
                    torch.tensor(resp[key]),
                    torch.from_numpy(np.asarray(out[key][slot])).double(),
                    *FEAT_TOL))
            if resp["is_ood"] != bool(resp["ood_score"] > rec.ood_threshold):
                raise AssertionError("/stream/push is_ood disagrees with "
                                     "its score")
    print(f"server: {CLIENTS} clients × {PUSHES} /stream/push in {ticks} "
          f"ticks ({CLIENTS * PUSHES / ticks:.2f} sessions a tick) + 3 "
          f"/predict; responses vs a direct recognizer: max abs err "
          f"{err:.3e}; /predict vs predict within FEAT_TOL; the direct "
          f"recognizer graphed vs eager: {differ} of {total} elements differ "
          f"in any bit, max abs err {graph_err:.3e} (GRAPH_TOL)")
    return lat


def phase_stream_timing(torch, recs, chunks, video, text, push_lat):
    """Tick latency (host clock), graphed and eager, with a profiled tick
    each; push latency."""
    reps = 30
    audio_s = STREAMS * chunks.shape[1] / SR
    for label, rec in recs.items():
        lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            rec.push(chunks, video, text)
            lat.append(time.perf_counter() - t0)
        p50 = float(np.median(lat))
        print(f"stream tick at {STREAMS} streams, {label}: p50 "
              f"{p50 * 1e3:.4f} ms (host clock, {reps} ticks, outputs copied "
              f"to the host); real-time factor {audio_s / p50:.1f} "
              f"({audio_s:.3f} s of audio a tick)")
        profile_window(torch, f"stream tick {STREAMS} {label}",
                       lambda: rec.push(chunks, video, text),
                       expect={"mfcc_frames": 1}, windows=3)
    print(f"/stream/push under {CLIENTS} clients: p50 "
          f"{np.median(push_lat) * 1e3:.4f} ms, max "
          f"{np.max(push_lat) * 1e3:.4f} ms (host clock, "
          f"{len(push_lat)} pushes of 16-bit PCM, HTTP + JSON included)")


def ood_detector(rng):
    """An input_norm-space detector fitted on features like the sessions'."""
    from tpu_deer_torch.eval.ood import MahalanobisOOD

    video, text = context(rng, 512)
    audio = rng.normal(size=(512, 84)).astype(np.float32)
    return MahalanobisOOD().fit_modalities(audio, video, text)


def k3_case(torch, b, h, tq, tk, d, mask, seed):
    """(q, k, v, mask, dO) on the card for a [b, tk] key mask (1 = valid)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, n, d, generator=g) for n in (tq, tk, tk, tq))
    return [x.cuda() for x in (q, k, v, mask.to(torch.float32), do)]


def prefix_mask(torch, lengths, t):
    """[len(lengths), t]: lengths[i] valid keys at the start of element i."""
    return (torch.arange(t)[None, :] < torch.as_tensor(lengths)[:, None]).float()


def hole_mask(torch, b, t):
    """[b, t]: element 0 with keys 64-191 masked (whole 64-key tiles between
    valid keys), element 1 with a prefix of 2t/3 valid keys, the rest
    all-masked."""
    mask = torch.zeros(b, t)
    mask[0] = 1.0
    mask[0, 64:192] = 0.0
    mask[1, :2 * t // 3] = 1.0
    return mask


def far_mask(torch, b, t):
    """[b, t]: element 0 with valid keys 10-19 and 2100-2149 only (live
    tiles on both sides of the 32-tile window K3b reads at a time),
    element 1 all valid, the rest all-masked."""
    mask = torch.zeros(b, t)
    mask[0, 10:20] = 1.0
    mask[0, 2100:2150] = 1.0
    mask[1] = 1.0
    return mask


def live_tile_share(torch, mask, tile=64):
    """The share of 64-key tiles (per element) that hold a valid key."""
    b, t = mask.shape
    pad = torch.zeros(b, -(-t // tile) * tile, device=mask.device)
    pad[:, :t] = mask
    return (pad.view(b, -1, tile) > 0).any(-1).float().mean().item()


def sass_counts(build, lib_name):
    """{kernel function: {instruction: count}} of HGMMA (wgmma) and LDGSTS
    (cp.async) in the built library's SASS (cuobjdump)."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build._target(lib_name))],
                          check=True, capture_output=True, text=True,
                          timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HGMMA": 0, "LDGSTS": 0}
        elif fn:
            for op in counts[fn]:
                if f" {op}." in line:
                    counts[fn][op] += 1
    return counts


def k3_work(b, h, t, d, lengths):
    """(FLOPs, bytes) that K3a, K3b, K3c's functions need at [B, H, T, D]
    when element i has lengths[i] > 0 valid keys: a masked key adds exactly
    0 to O, dq, dk and dv, so only valid keys count. Operations 4, 6 and 8
    · H·T·D·Σ lengths; bytes with q-side rows (T·D floats) and the valid
    keys' k and v rows read once, each output written once in full, T-long
    lse and δ and the [B, T] mask."""
    keys = int(sum(lengths))
    rows, kv, stats, mask = b * h * t * d * 4, h * keys * d * 4, b * h * t * 4, b * t * 4
    base = h * t * d * keys
    return {"fwd": (4 * base, 2 * rows + 2 * kv + stats + mask),      # q k v → O, lse
            "dq": (6 * base, 4 * rows + 2 * kv + 2 * stats + mask),   # q k v O dO lse → dq δ
            "dkv": (8 * base, 4 * rows + 2 * kv + 2 * stats + mask)}  # q k v dO lse δ → dk dv


def check_k3(torch, k3, label, case, errs):
    """Runs K3a-c on case = (q, k, v, mask, dO) and holds all six outputs
    against the plain twins (K3_TOL), each kernel's to a second run (bit
    for bit), and an all-masked element to reference_attention's values;
    returns (o, lse, δ)."""
    q, k, v, mask, do = case
    counters = (k3.flash_attention_fwd, k3.flash_attention_bwd_dq,
                k3.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    o, lse = k3.flash_attention_fwd(q, k, v, mask)
    delta, dq = k3.flash_attention_bwd_dq(q, k, v, mask, o, do, lse)
    dk, dv = k3.flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta)
    torch.cuda.synchronize()
    if [c.launches for c in counters] != [n + 1 for n in before]:
        raise AssertionError("a K3 wrapper did not count its launch")
    ro, rlse = k3.flash_attention_fwd_plain(q, k, v, mask)
    rdelta, rdq = k3.flash_attention_bwd_dq_plain(q, k, v, mask, o, do, lse)
    rdk, rdv = k3.flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse, delta)
    line = []
    for kern, name, got, ref in (("fwd", "O", o, ro), ("fwd", "lse", lse, rlse),
                                 ("dq", "delta", delta, rdelta),
                                 ("dq", "dq", dq, rdq), ("dkv", "dk", dk, rdk),
                                 ("dkv", "dv", dv, rdv)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"K3 {name} {label}: non-finite values")
        err = check_close(f"K3 {name} {label}", got, ref, *K3_TOL)
        errs[kern] = max(errs[kern], err)
        line.append(f"{name} {err:.3e}")
    # No atomics and no order that varies: a second run repeats bit for bit.
    o2, lse2 = k3.flash_attention_fwd(q, k, v, mask)
    delta2, dq2 = k3.flash_attention_bwd_dq(q, k, v, mask, o, do, lse)
    dk2, dv2 = k3.flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta)
    if not all(torch.equal(a, b) for a, b in ((o, o2), (lse, lse2), (delta, delta2),
                                               (dq, dq2), (dk, dk2), (dv, dv2))):
        raise AssertionError(f"K3 {label}: a second run differs")
    dead = [i for i in range(mask.shape[0]) if not mask[i].any()]
    tk = k.shape[2]
    for i in dead:  # reference_attention's values
        if dq[i].any() or dk[i].any():
            raise AssertionError("K3: dq, dk of an all-masked element not 0")
        if not (lse[i] < k3.NO_VALID_KEY).all():
            raise AssertionError("K3: an all-masked element's lse reads as valid")
        check_close("K3 all-masked O", o[i], v[i].mean(1, keepdim=True)
                    .expand_as(o[i]), *K3_TOL)
        check_close("K3 all-masked dv", dv[i], (do[i].sum(1, keepdim=True)
                    / tk).expand_as(dv[i]), *K3_TOL)
    b, h, tq, d = q.shape
    print(f"K3 vs plain, {label} (B={b} H={h} Tq={tq} Tk={tk} D={d}): max abs "
          f"err {', '.join(line)}; K3a-c repeat bit for bit"
          + ("; all-masked element: mean of v, lse < -5e29, dq = dk = 0, "
             "dv = sum dO / Tk"
             if dead else ""))
    return o, lse, delta


def phase_k3(torch, build, k3):
    """K3a-c against their plain twins on the card; returns the three
    kernels' records (launches filled in by phase 8)."""
    import torch.nn.functional as F

    counts = sass_counts(build, "flash_attention")
    for kernel in ("fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel"):
        for inst in ("32", "64"):
            found = [c for fn, c in counts.items()
                     if kernel in fn and f"ILi{inst}E" in fn]
            if len(found) != 1:
                raise AssertionError(f"{kernel}<{inst}> not in the library's SASS")
            c = found[0]
            print(f"K3 SASS {kernel} D={inst}: {c['HGMMA']} HGMMA, "
                  f"{c['LDGSTS']} LDGSTS (cp.async)")
            if not c["HGMMA"] or not c["LDGSTS"]:
                raise AssertionError(f"{kernel}<{inst}> has no tensor-core or "
                                     f"cp.async instruction")

    rng = np.random.default_rng(SEED + 6)
    b, h, t, d = K3_SHAPE
    lengths = list(rng.integers(t // 8, t + 1, size=b))
    # Phase 8's padding: a few real tokens in each 2,048-key element.
    sparse = list(np.random.default_rng(SEED + 7).integers(4, 17, size=b))
    cases = [
        ("B·H=8 T=100 D=32", (2, 4, 100, 100, 32), prefix_mask(torch, [60, 0], 100)),
        ("B·H=4 T=200 D=64", (2, 2, 200, 200, 64), prefix_mask(torch, [200, 0], 200)),
    ]
    for cd in (32, 64):
        cases += [(f"whole-tile hole D={cd}", (3, 2, 300, 300, cd), hole_mask(torch, 3, 300)),
                  (f"ragged Tq != Tk D={cd}", (3, 2, 130, 300, cd), hole_mask(torch, 3, 300)),
                  (f"live tiles past the first 32 D={cd}", (3, 2, 70, 2200, cd),
                   far_mask(torch, 3, 2200))]
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for label, (cb, ch, ctq, ctk, cd), mask in cases:
        check_k3(torch, k3, label, k3_case(torch, cb, ch, ctq, ctk, cd, mask, SEED),
                 errs)

    # Timing at the training shape, under two masks.
    library, records = {}, []
    for mask_label, mask_lengths in (("prefix lengths in [T/8, T]", lengths),
                                     ("4-16 valid keys", sparse)):
        q, k, v, mask, do = k3_case(torch, b, h, t, t, d,
                                    prefix_mask(torch, mask_lengths, t), SEED)
        o, lse, delta = check_k3(torch, k3, f"training shape, {mask_label}",
                                 (q, k, v, mask, do), errs)
        fns = {
            "fwd": (lambda: k3.flash_attention_fwd(q, k, v, mask),
                    lambda: k3.flash_attention_fwd_plain(q, k, v, mask)),
            "dq": (lambda: k3.flash_attention_bwd_dq(q, k, v, mask, o, do, lse),
                   lambda: k3.flash_attention_bwd_dq_plain(q, k, v, mask, o, do, lse)),
            "dkv": (lambda: k3.flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta),
                    lambda: k3.flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse,
                                                             delta)),
        }
        first = not records
        if first:  # SDPA does not depend on the mask: timed once
            add_mask = torch.where(mask > 0, 0.0, -1e30)[:, None, None, :]
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=add_mask)
            library = {
                "fwd": time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=add_mask)),
                "bwd": time_ms(lambda: torch.autograd.grad(
                    sdpa_out, leaves, do, retain_graph=True)),
            }
            del leaves, sdpa_out
        work = k3_work(b, h, t, d, mask_lengths)
        live = 100 * live_tile_share(torch, mask)
        print(f"K3 timing inputs, {mask_label}: {int(sum(mask_lengths))} valid "
              f"keys of {b * t} ({100 * sum(mask_lengths) / (b * t):.1f}%), "
              f"{live:.1f}% of the 64-key tiles live; the bounds count valid "
              f"keys only; K3a, K3b and K3c skip the tiles with no valid key")
        # (kernel, record name, the TPU kernel's body: _fwd_kernel,
        # _bwd_dq_kernel, _bwd_dkv_kernel)
        for kern, name, line in (("fwd", "flash_attention_fwd", 44),
                                 ("dq", "flash_attention_bwd_dq", 85),
                                 ("dkv", "flash_attention_bwd_dkv", 116)):
            kernel_ms = time_ms(fns[kern][0], reps=10)
            plain_ms = time_ms(fns[kern][1], reps=10) if first else None
            flops, nbytes = work[kern]
            t_ops = 3 * flops / TF32_FLOPS * 1e3  # 3xTF32
            t_f32 = flops / F32_FLOPS * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            lib_ms = library["fwd" if kern == "fwd" else "bwd"]
            print(f"K3 {kern} at B={b} H={h} T={t} D={d}, {mask_label}: kernel "
                  f"{kernel_ms:.4f} ms on {live:.1f}% live key tiles"
                  + (f", plain twin {plain_ms:.4f} ms, SDPA "
                     f"{'forward' if kern == 'fwd' else 'backward (all of dq, dk, dv)'} "
                     f"{lib_ms:.4f} ms" if first else "")
                  + f"; bound {max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.1f} "
                  f"GFLOP at 3xTF32 -> {t_ops:.4f} ms, {nbytes / 1e6:.1f} MB -> "
                  f"{t_bytes:.4f} ms); float32 FMA bound {max(t_f32, t_bytes):.4f} ms")
            if first:
                records.append({
                    "name": name,
                    "route": "cuda",
                    "source": "tpu_deer_torch/kernels/csrc/flash_attention.cu",
                    "replaces": f"tpu_deer/ops/flash_attention.py:{line}",
                    "launches": None,  # filled from the training phase's run
                    "max_abs_err": None,  # every phase-7 case, below
                    "ms": kernel_ms,
                    "plain_ms": plain_ms,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "library_ms": lib_ms,
                })
        del q, k, v, do, o, lse, delta, fns
    for record, kern in zip(records, ("fwd", "dq", "dkv")):
        record["max_abs_err"] = errs[kern]

    # Crossover against SDPA (B = 16, H = 4, D = 32, a padding mask).
    for ct in CROSSOVER_T:
        lengths = list(rng.integers(ct // 8, ct + 1, size=16))
        q, k, v, mask, do = k3_case(torch, 16, 4, ct, ct, 32,
                                    prefix_mask(torch, lengths, ct), SEED + ct)
        add_mask = torch.where(mask > 0, 0.0, -1e30)[:, None, None, :]

        def fwd_bwd(fn):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            return lambda: torch.autograd.grad(fn(*leaves), leaves, do)

        flash = lambda q_, k_, v_: k3.flash_attention(q_, k_, v_, mask)
        sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=add_mask)
        times = [time_ms(lambda: flash(q, k, v), reps=10),
                 time_ms(lambda: sdpa(q, k, v), reps=10),
                 time_ms(fwd_bwd(flash), reps=10), time_ms(fwd_bwd(sdpa), reps=10)]
        print(f"K3 vs SDPA crossover, B=16 H=4 D=32 T={ct}: forward K3 "
              f"{times[0]:.4f} ms, SDPA {times[1]:.4f} ms; forward+backward "
              f"K3 {times[2]:.4f} ms, SDPA {times[3]:.4f} ms")
    return records


def phase_embedding(torch, emb, ids, vocab_size, d):
    """The embedding-gradient kernel at phase 8's shape (a batch's token ids,
    dX [64, 2048, d]) against its plain twin, and against a second run bit
    for bit; its time beside its byte bound. Returns its record."""
    from tpu_deer_torch.data.vocab import PAD_ID

    ids = ids.long().contiguous()
    dx = torch.randn(*ids.shape, d, generator=torch.Generator().manual_seed(SEED)
                     ).to(DEVICE)
    before = emb.embedding_grad.launches
    got = emb.embedding_grad(ids, dx, vocab_size)
    again = emb.embedding_grad(ids, dx, vocab_size)
    torch.cuda.synchronize()
    if emb.embedding_grad.launches != before + 2:
        raise AssertionError("embedding_grad did not count its launches")
    if not torch.equal(got, again):
        raise AssertionError("embedding_grad: a second run differs")
    ref = emb.embedding_grad_plain(ids, dx.double(), vocab_size)
    err = check_close("embedding grad", got.double(), ref, *EMB_TOL)
    run = lambda fn: (lambda: fn(ids, dx, vocab_size))
    kernel_ms = time_ms(run(emb.embedding_grad))
    dev_ms = device_ms(torch, run(emb.embedding_grad),
                       expect=("piece_kernel", "join_kernel"))
    plain_ms = time_ms(run(emb.embedding_grad_plain))
    zeros = torch.zeros(vocab_size, d, device=dx.device)
    flat_ids, flat = ids.reshape(-1), dx.reshape(-1, d)
    lib_ms = time_ms(lambda: torch.index_add(zeros, 0, flat_ids, flat))
    n = ids.numel()
    nbytes = 4 * n * d + 8 * n + 4 * vocab_size * d  # dX, ids in; dW out
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    pad = (ids == PAD_ID).float().mean().item()
    print(f"embedding grad at phase 8's shape ({n} ids, {100 * pad:.1f}% PAD_ID, "
          f"D={d}, V={vocab_size}): max abs err {err:.3e} vs the plain twin in "
          f"float64, a second run equal bit for bit; kernel {kernel_ms:.4f} ms a "
          f"call (sort included; {ms_text(dev_ms)} on the device), plain twin "
          f"{plain_ms:.4f} ms, torch.index_add {lib_ms:.4f} ms; bound "
          f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB)")
    return {
        "name": "embedding_grad",
        "route": "cuda",
        "source": "tpu_deer_torch/kernels/csrc/embedding_grad.cu",
        # not a TPU kernel: the gradient of flax nn.Embed's lookup
        "replaces": "tpu_deer/models/encoders.py:328",
        "launches": None,  # filled from the training phase's run
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": lib_ms,
    }


def phase_train(torch, k1, k3, emb):
    """Raw-media training at the CLI's full width; returns the launches of
    K1, K3a, K3b, K3c and the embedding gradient in the counted run, and
    the embedding gradient's record."""
    import tempfile

    from tpu_deer_torch.data.raw_corpus import (
        generate_raw_fixture,
        load_raw_corpus,
    )
    from tpu_deer_torch.models import attention, encoders
    from tpu_deer_torch.models.hierarchical_deer import (
        create_raw_sequence_model,
    )
    from tpu_deer_torch.ops import audio_frontend as taf
    from tpu_deer_torch.train.raw_trainer import (
        RawSequenceTrainer,
        RawTrainingConfig,
    )

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="raw_fixture_") as root:
        generate_raw_fixture(root, *RAW_FIXTURE, seed=42)
        splits, vocab = load_raw_corpus(root, max_tokens=RAW_MAX_TOKENS)
        cli_tr = load_raw_corpus(root, max_tokens=CLI_MAX_TOKENS)[0]["train"]
    tr, val, test = splits["train"], splits["val"], splits["test"]
    print(f"train: fixture {RAW_FIXTURE} utterances written and loaded in "
          f"{time.perf_counter() - t0:.1f} s; signals {tr['signal'].shape}, "
          f"video {tr['video_frames'].shape}, tokens {tr['token_ids'].shape} "
          f"({tr['token_mask'].sum(1).mean():.1f} real on average; the CLI "
          f"pads to {CLI_MAX_TOKENS}), vocab {vocab.vocab_size}")
    model_kw = dict(encoder_dim=128, fusion_dim=256, vocab_size=vocab.vocab_size,
                    num_heads=4, dropout=0.1)
    cfg = RawTrainingConfig(learning_rate=2e-3, batch_size=RAW_BATCH,
                            num_epochs=2)
    model = create_raw_sequence_model(seed=SEED, device=DEVICE, **model_kw)
    n_params = sum(p.numel() for p in model.parameters() if p.requires_grad)
    trainer = RawSequenceTrainer(model, cfg, device=DEVICE)

    counters = (k1.mfcc_signal, k3.flash_attention_fwd,
                k3.flash_attention_bwd_dq, k3.flash_attention_bwd_dkv,
                emb.embedding_grad)
    read = lambda: [c.launches for c in counters]

    def timed(trainer, steps):
        """Wrap trainer's step to append (seconds, launches) to steps."""
        step_fn = trainer._train_step

        def timed_step(batch):
            before = read()
            t_start = time.perf_counter()
            loss = step_fn(batch)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t_start,
                          [a - b for a, b in zip(read(), before)]))
            return loss

        trainer._train_step = timed_step
        return step_fn

    steps = []
    step_fn = timed(trainer, steps)
    # The main path, counted: 2 epochs (with val predicts), then predict.
    for c in counters:
        c.launches = 0
    result = trainer.train(tr, val)
    pred = trainer.predict(test)
    launches = read()
    trainer._train_step = step_fn

    n_steps = cfg.num_epochs * (len(tr["labels"]) // cfg.batch_size)
    batches = -(-len(val["labels"]) // cfg.batch_size) * cfg.num_epochs + \
        -(-len(test["labels"]) // cfg.batch_size)
    if len(steps) != n_steps or any(d != [1, 2, 2, 2, 1] for _, d in steps):
        raise AssertionError(f"train steps launched {[d for _, d in steps]}, "
                             f"expected [1, 2, 2, 2, 1] (K1, K3a, K3b, K3c, "
                             f"embedding grad) each")
    want = [n_steps + batches, 2 * (n_steps + batches), 2 * n_steps, 2 * n_steps,
            n_steps]
    if launches != want:
        raise AssertionError(f"launches K1, K3a, K3b, K3c, embedding grad "
                             f"{launches}, want {want} ({n_steps} steps, "
                             f"{batches} predict batches)")
    losses = result["history"]["train_loss"]
    if not np.isfinite(losses).all() or pred["mu"].shape != (len(test["labels"]), 3) \
            or not np.isfinite(pred["mu"]).all() \
            or not (pred["uncertainty"] > 0).all():
        raise AssertionError("training produced non-finite losses or outputs")
    from tpu_deer_torch.core.metrics import ccc_np

    test_ccc = float(np.mean([ccc_np(test["labels"][:, i], pred["mu"][:, i])
                              for i in range(3)]))
    step_ms = [1e3 * t for t, _ in steps]
    print(f"train: {n_params} trained params, {n_steps} steps of "
          f"{cfg.batch_size} at {RAW_MAX_TOKENS} tokens: step p50 "
          f"{np.median(step_ms):.4f} ms (first {step_ms[0]:.1f} ms, host clock "
          f"to a synchronize); epoch losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; val CCC "
          f"{', '.join(f'{x:.4f}' for x in result['history']['val_ccc'])}; "
          f"test CCC {test_ccc:.4f}")
    print(f"train: launches K1 {launches[0]}, K3a {launches[1]}, K3b "
          f"{launches[2]}, K3c {launches[3]}, embedding grad {launches[4]}: "
          f"[1, 2, 2, 2, 1] on each of {n_steps} steps, [1, 2, 0, 0, 0] on "
          f"each of {batches} predict batches")

    # The same seeded run again, from a fresh model: nothing in the step may
    # vary by run (no atomics on float data, no order that varies).
    m2 = create_raw_sequence_model(seed=SEED, device=DEVICE, **model_kw)
    t2 = RawSequenceTrainer(m2, cfg, device=DEVICE)
    result2 = t2.train(tr, val)
    pred2 = t2.predict(test)
    params2 = dict(m2.named_parameters())
    differ = [n for n, p in model.named_parameters() if not torch.equal(p, params2[n])]
    ccc, ccc2 = result["history"]["val_ccc"], result2["history"]["val_ccc"]
    if ccc != ccc2 or differ or not np.array_equal(pred["mu"], pred2["mu"]):
        raise AssertionError(f"the seeded run did not repeat: val CCC {ccc} vs "
                             f"{ccc2}; {len(differ)} parameters differ "
                             f"({', '.join(differ[:8])})")
    print(f"train: the seeded 2-epoch run again from a fresh model: val CCC "
          f"{', '.join(f'{x:.4f}' for x in ccc2)}, all {len(params2)} parameters "
          f"and the test predictions equal bit for bit")
    del m2, t2, params2

    staged = trainer._stage(tr)
    batch = trainer._gather(staged, np.arange(cfg.batch_size))
    step_launches = {"mfcc_signal": 1, "fwd_kernel": 2, "bwd_dq_kernel": 2,
                     "bwd_dkv_kernel": 2, "piece_kernel": 1, "join_kernel": 1}
    kernels = profile_window(torch, "train step", lambda: trainer._train_step(batch),
                             expect=step_launches, windows=3)
    if kernels:  # the step's device time by kernel group, first match
        groups = (("K3a", ("fwd_kernel",)), ("K3b", ("bwd_dq_kernel",)),
                  ("K3c", ("bwd_dkv_kernel",)), ("K1", ("mfcc_signal",)),
                  ("embedding grad", ("piece_kernel", "join_kernel")),
                  ("its id sort", ("RadixSort",)), ("cuDNN", ("cudnn",)),
                  ("GEMMs", ("gemm", "Kernel2")), ("reductions", ("reduce_kernel",)),
                  ("elementwise", ("elementwise",)))
        split = {label: 0.0 for label, _ in groups} | {"other": 0.0}
        for name, ms in kernels.items():
            label = next((label for label, keys in groups
                          if any(key in name for key in keys)), "other")
            split[label] += ms
        busy = sum(kernels.values())
        print(f"train step on the device: {busy:.3f} ms; " + "; ".join(
            f"{label} {ms:.3f} ms ({100 * ms / busy:.1f}%)"
            for label, ms in split.items()))
    emb_record = phase_embedding(torch, emb, batch["token_ids"], vocab.vocab_size,
                                 model.text_encoder.model_dim)

    # The same step at the CLI's own transcript length (no K3: T < 1024).
    cli_steps = []
    m = create_raw_sequence_model(seed=SEED, device=DEVICE, **model_kw)
    t16 = RawSequenceTrainer(m, cfg, device=DEVICE)
    timed(t16, cli_steps)
    t16.train(cli_tr, num_epochs=1)
    if any(d != [1, 0, 0, 0, 1] for _, d in cli_steps):
        raise AssertionError(f"steps at {CLI_MAX_TOKENS} tokens launched "
                             f"{[d for _, d in cli_steps]}, expected K1 and "
                             f"the embedding gradient only")
    cli_ms = [1e3 * t for t, _ in cli_steps]
    print(f"train: the same step at the CLI's {CLI_MAX_TOKENS} tokens: p50 "
          f"{np.median(cli_ms[1:]):.4f} ms over {len(cli_ms) - 1} steps after "
          f"the first ({cli_ms[0]:.1f} ms); K1 and the embedding gradient once "
          f"a step, no K3")
    profile_window(torch, f"train step at {CLI_MAX_TOKENS} tokens",
                   lambda: t16._train_step(t16._gather(
                       t16._stage(cli_tr), np.arange(cfg.batch_size))),
                   expect={"mfcc_signal": 1, "piece_kernel": 1, "join_kernel": 1},
                   windows=3)
    del m, t16

    # Kernels against plain twins over 3 steps. Each step runs the plain
    # twins of K1 and K3 (patched in where the front-end and
    # MultiHeadAttention call the wrappers), then the kernels, from the same
    # parameters, optimizer state, batch and dropout draws (the trainer's
    # generator reseeded); the next step
    # starts from the kernel path's. Carried on separately, the two paths
    # part: an entry whose exact gradient is ~0 takes an Adam step of ±lr
    # on float noise, and the next steps' gradients differ by far more than
    # the kernels' rounding.
    saved = (attention.flash_attention, taf.mfcc_signal, encoders.embedding_lookup)
    m = create_raw_sequence_model(seed=SEED + 1, device=DEVICE, **model_kw)
    t3 = RawSequenceTrainer(m, cfg, device=DEVICE)
    staged = t3._stage(tr)
    clip = t3.optimizer.clip

    def one_step(batch, seed, plain):
        """(loss, clipped gradients, parameters after, gradients before the
        clip) of one step, its launches checked: K1 and K3 with the kernels,
        none with the twins."""
        if plain:
            attention.flash_attention = k3.flash_attention_plain
            taf.mfcc_signal = k1.mfcc_signal_plain
            encoders.embedding_lookup = emb.embedding_lookup_plain
        clipped, raw = {}, {}

        def keep_clipped(grads):
            raw.update((n, g.clone()) for n, g in zip(t3.optimizer.params, grads))
            clip(grads)
            clipped.update((n, g.clone())
                           for n, g in zip(t3.optimizer.params, grads))
            return grads

        t3.optimizer.clip = keep_clipped
        try:
            t3.generator.manual_seed(seed)  # the dropout draws
            before = read()
            loss = float(t3._train_step(batch))
            launched = [a - b for a, b in zip(read(), before)]
        finally:
            attention.flash_attention, taf.mfcc_signal, encoders.embedding_lookup = saved
            t3.optimizer.clip = clip
        want = [0] * 5 if plain else [1, 2, 2, 2, 1]
        if launched != want:
            raise AssertionError(f"{'plain' if plain else 'kernel'} step "
                                 f"launched K1, K3a-c, embedding grad "
                                 f"{launched}, want {want}")
        return (loss, clipped,
                {n: p.detach().clone() for n, p in m.named_parameters()}, raw)

    rows = []
    for step in range(RAW_STEPS_COMPARED):
        batch = t3._gather(staged, np.arange(step * cfg.batch_size,
                                             (step + 1) * cfg.batch_size))
        start = copy.deepcopy((m.state_dict(), t3.optimizer.state_dict()))
        if step == 0:  # the kernel step twice: no gradient may vary by run
            again = []
            for _ in range(2):
                again.append(one_step(batch, SEED, plain=False)[3])
                m.load_state_dict(start[0])
                t3.optimizer.load_state_dict(start[1])
            varying = [n for n in again[0]
                       if not torch.equal(again[0][n], again[1][n])]
            if varying:
                raise AssertionError(f"step 1 with the kernels twice from the "
                                     f"same state: {len(varying)} of "
                                     f"{len(again[0])} gradients differ in their "
                                     f"bits ({', '.join(varying)})")
        pl, pg, pp, _ = one_step(batch, SEED + step, plain=True)
        m.load_state_dict(start[0])
        t3.optimizer.load_state_dict(start[1])
        kl, kg, kp, _ = one_step(batch, SEED + step, plain=False)
        label = f"step {step + 1} kernels vs plain"
        loss_err = check_close(f"{label}: loss", torch.tensor(kl),
                               torch.tensor(pl), *TRAIN_TOL["loss"])
        grad_err = max(check_close(f"{label}: gradient {n}", kg[n], pg[n],
                                   *TRAIN_TOL["grads"]) for n in pg)
        diffs = torch.cat([(kp[n] - pp[n]).abs().flatten() for n in pp])
        held = torch.cat([(pg[n].abs() >= GRAD_FLOOR).flatten() if n in pg
                          else torch.zeros(pp[n].numel(), dtype=torch.bool,
                                           device=pp[n].device) for n in pp])
        held_err = diffs[held].max().item()
        if held_err > PARAM_ATOL:
            raise AssertionError(f"{label}: parameters with |gradient| >= "
                                 f"{GRAD_FLOOR} differ by {held_err:.3e} > "
                                 f"{PARAM_ATOL}")
        rows.append(f"step {step + 1}: loss {kl:.7f} vs {pl:.7f} (err "
                    f"{loss_err:.3e}), gradients {grad_err:.3e} (largest "
                    f"{max(g.abs().max().item() for g in pg.values()):.3e}), "
                    f"parameters {held_err:.3e} on the {int(held.sum())} of "
                    f"{held.numel()} with |g| >= {GRAD_FLOOR}, the rest up to "
                    f"{diffs[~held].max().item() if (~held).any() else 0:.3e}")
    print(f"train: K1, K3 and the embedding gradient vs their plain twins, "
          f"each step from the same state; " + "; ".join(rows))
    print(f"train: step 1 with the kernels twice from the same state: all "
          f"{len(again[0])} gradients equal bit for bit")
    return launches, emb_record


def k4_bounds(torch, q, s, w, label):
    """The reference's bounds on K4's result (see K4_SHAPES)."""
    err = q.to(torch.float32) * s - w
    if q.dtype != torch.int8 or int(q.min()) < -127 or int(q.max()) > 127:
        raise AssertionError(f"K4 {label}: values outside [-127, 127]")
    scale = float(s.reshape(()))
    worst = float(err.abs().max())
    if worst > 1.01 * scale:
        raise AssertionError(f"K4 {label}: |q·s - w| {worst:.3e} > 1.01 s")
    mean = float(err.double().mean())
    if w.numel() >= K4_MEAN_MIN and abs(mean) > 0.05 * scale:
        raise AssertionError(f"K4 {label}: |mean(q·s - w)| {abs(mean):.3e} "
                             f"> 0.05 s = {0.05 * scale:.3e}")
    return worst / scale, mean / scale


def k4_err(torch, got, ref, label):
    """Raise unless K4's (q, scale) equals the plain twin's (values and the
    scale's bits); return the largest difference, as floats."""
    (q, s), (rq, rs) = got, ref
    if not (torch.equal(q, rq) and torch.equal(s.view(torch.int32),
                                               rs.view(torch.int32))):
        raise AssertionError(f"K4 {label}: values or scale differ from the "
                             f"plain twin")
    return max(float((q.float() - rq.float()).abs().max()),
               float((s - rs).abs().max()))


def k4_shapes(capacity):
    """K4_SHAPES with [capacity + K4_ABOVE_CAPACITY] before the timed last."""
    return K4_SHAPES[:-1] + ((capacity + K4_ABOVE_CAPACITY,),) + K4_SHAPES[-1:]


def k4_device_ms(torch, fn, calls=20, windows=3):
    """K4's device time a call (ms) under the profiler, or None (not
    measured); raises unless the window holds exactly one K4 kernel a call
    and no other device event (no memset)."""
    fn()
    got = profiled(torch, lambda: [fn() for _ in range(calls)], {K4_NAME: calls},
                   windows)
    if got is None:
        return None
    names = [name for name, _ in got[0]]
    others = sorted({name for name in names if K4_NAME not in name})
    if others or len(names) != calls:
        raise AssertionError(f"K4: {len(names)} device events for {calls} "
                             f"calls, others {others}")
    return sum(ms for _, ms in got[0]) / calls


def k4_calls_ms(torch, quantize, weights, reps=20):
    """Calls quantize(w, seed=i) on each of `weights` in turn: (median host
    ms of the whole round to a synchronize over `reps` rounds, its device
    ms under the profiler or None, the device events in that window)."""
    def one_round():
        for i, w in enumerate(weights):
            quantize(w, seed=i)

    one_round()
    torch.cuda.synchronize()
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        one_round()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    got = profiled(torch, one_round, {}, 3)
    dev = None if got is None else sum(ms for _, ms in got[0])
    return float(np.median(host)), dev, None if got is None else len(got[0])


def phase_k4(torch, k4):
    """K4 against its plain twins on the card (DEVICE); returns its record."""
    g = torch.Generator().manual_seed(SEED + 9)
    seed = 2**40 + 12345  # both key words in use
    max_err = 0.0
    resident, stage_bytes = k4.launch_config(torch.cuda.current_device())
    capacity = k4.staged_capacity(DEVICE)
    print(f"K4 on chip: {resident} blocks of {k4.THREADS} threads resident (a "
          f"cooperative grid), {stage_bytes} B of w staged per block in shared "
          f"memory: {capacity} elements ({4 * capacity / 1e6:.1f} MB) staged whole")
    for shape in k4_shapes(capacity):
        w = torch.randn(shape, generator=g).to(DEVICE)
        bits = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                             generator=g).to(DEVICE)
        before = (k4.quantize_int8_stochastic.launches,
                  k4.quantize_int8_stochastic_bits.launches)
        got = {"bits": k4.quantize_int8_stochastic_bits(w, bits),
               "philox": k4.quantize_int8_stochastic(w, seed)}
        torch.cuda.synchronize()
        if (k4.quantize_int8_stochastic.launches,
                k4.quantize_int8_stochastic_bits.launches) != (before[0] + 1,
                                                               before[1] + 1):
            raise AssertionError("a K4 wrapper did not count its launch")
        refs = {"bits": k4.quantize_int8_stochastic_bits_plain(w, bits),
                "philox": k4.quantize_int8_stochastic_plain(w, seed)}
        for mode, (q, s) in got.items():
            max_err = max(max_err, k4_err(torch, (q, s), refs[mode],
                                          f"{mode} {shape}"))
        q, s = got["philox"]
        again = k4.quantize_int8_stochastic(w, seed)
        if not (torch.equal(again[0], q) and torch.equal(again[1], s)):
            raise AssertionError(f"K4 {shape}: one seed did not repeat")
        differs = not torch.equal(k4.quantize_int8_stochastic(w, seed + 1)[0], q)
        if w.numel() >= 64 and not differs:
            raise AssertionError(f"K4 {shape}: another seed gave the same values")
        worst, mean = k4_bounds(torch, q, s, w, f"{shape}")
        path = "staged whole" if w.numel() <= capacity else "rest from L2"
        print(f"K4 vs plain {shape} ({path}): given words and Philox words "
              f"equal (values and scale bits); seed repeats (bit for bit), "
              f"another seed {'differs' if differs else 'gives the same values'}; "
              f"max |q·s - w| {worst:.4f} s, mean {mean:+.2e} s")
    n = w.numel()  # the last shape, [4096, 4096]
    kernel_ms = time_ms(lambda: k4.quantize_int8_stochastic(w, seed))
    bits_ms = time_ms(lambda: k4.quantize_int8_stochastic_bits(w, bits))
    dev_ms = k4_device_ms(torch, lambda: k4.quantize_int8_stochastic(w, seed))
    dev_bits_ms = k4_device_ms(torch, lambda: k4.quantize_int8_stochastic_bits(w, bits))
    plain_ms = time_ms(lambda: k4.quantize_int8_stochastic_plain(w, seed))
    plain_bits_ms = time_ms(lambda: k4.quantize_int8_stochastic_bits_plain(w, bits))
    # A byte yardstick, not library_ms: w.to(torch.int8) moves the same 4 B
    # in and 1 B out an element but computes another function.
    cast_ms = time_ms(lambda: w.to(torch.int8))
    cast_dev_ms = device_ms(torch, lambda: w.to(torch.int8))
    # Bytes: w read once, q written once (the bits variant reads 4 B more).
    # Operations (abs, max, divide, add, floor, two clamps: 7 an element)
    # take 7n / F32_FLOPS, far below; Philox's integer work is not counted.
    t_bytes = 5 * n / HBM_BYTES_PER_S * 1e3
    t_bits = 9 * n / HBM_BYTES_PER_S * 1e3
    t_ops = 7 * n / F32_FLOPS * 1e3
    share = (lambda ms, bound: "not measured" if ms is None
             else f"{100 * bound / ms:.1f}% of its bound")
    print(f"K4 at {tuple(w.shape)}: kernel (Philox) {kernel_ms:.4f} ms, with "
          f"given words {bits_ms:.4f} ms (a call between CUDA events, as K1-K3); "
          f"device time {ms_text(dev_ms)} ({share(dev_ms, t_bytes)}), with given "
          f"words {ms_text(dev_bits_ms)} ({share(dev_bits_ms, t_bits)}) (one "
          f"{K4_NAME} launch a call and no other device event, profiler); plain "
          f"twin {plain_ms:.4f} ms (Philox words in torch on the card), "
          f"{plain_bits_ms:.4f} ms with given words; bound "
          f"{max(t_bytes, t_ops):.4f} ms ({5 * n / 1e6:.1f} MB -> {t_bytes:.4f} "
          f"ms; {9 * n / 1e6:.1f} MB with given words -> {t_bits:.4f} ms); no "
          f"PyTorch call computes it (torch.quantize_per_tensor rounds to "
          f"nearest); byte yardstick w.to(torch.int8) (4 B in, 1 B out) "
          f"{cast_ms:.4f} ms between CUDA events, {ms_text(cast_dev_ms)} on the "
          f"device")
    return {
        "name": "quantize_int8",
        "route": "cuda",
        "source": "tpu_deer_torch/kernels/csrc/quantize_int8.cu",
        "replaces": "tpu_deer/ops/quantization.py:114",  # quantize_int8_stochastic
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


def timed_method(cls, name, times, torch):
    """Patch cls.<name> to append each call's host seconds (to a
    synchronize) to times; returns the original."""
    fn = getattr(cls, name)

    def timed(self, *args, **kw):
        t_start = time.perf_counter()
        out = fn(self, *args, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t_start)
        return out

    setattr(cls, name, timed)
    return fn


def predict_p50(engine, feats, n, reps=30):
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.predict(*(f[:n] for f in feats))
        lat.append(time.perf_counter() - t0)
    return float(np.median(lat)) * 1e3


def check_plots(plots, plot_dir):
    """The quick run's plots: the interactive dashboard and the JSON data
    export always, the static figures where matplotlib imports (else the
    summary records why)."""
    from tpu_deer_torch.viz.report import NO_MATPLOTLIB

    try:
        import matplotlib  # noqa: F401
        static = True
    except ImportError:
        static = False
    need = ["interactive_report.html", "report_data.json"] + (
        ["summary.png", "va_space.png", "training_curves.png"] if static else [])
    missing = [f for f in need if not os.path.exists(os.path.join(plot_dir, f))]
    if missing or (plots.get("static") == NO_MATPLOTLIB) == static:
        raise AssertionError(f"plots: missing {missing}, summary {plots}")
    print(f"main: matplotlib imports: {'yes' if static else 'no'}; the quick "
          f"run wrote {len(os.listdir(plot_dir))} plot files "
          + ("" if static else f"(\"static\": {NO_MATPLOTLIB!r}) ")
          + f"into plots/: {', '.join(sorted(os.listdir(plot_dir)))}")


def phase_main(torch, k4):
    """The feature-level main path: CLI quick run, int8 serving of its
    checkpoint, K4 on its kernels. Returns K4's launches in (c) and its
    largest difference from the plain twin there."""
    import tempfile

    from tpu_deer_torch import cli
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.models.deer_model import CompleteDEERModel
    from tpu_deer_torch.ops import quantization as quant
    from tpu_deer_torch.serve import InferenceEngine
    from tpu_deer_torch.train.checkpoint import CheckpointManager
    from tpu_deer_torch.train.trainer import DEERTrainer

    platform = "auto" if DEVICE == "cuda" else DEVICE
    with tempfile.TemporaryDirectory(prefix="main_path_") as out:
        # (a) the CLI's quick run at the flagship's width.
        k4.quantize_int8_stochastic.launches = 0
        k4.quantize_int8_stochastic_bits.launches = 0
        steps = []
        step_fn = timed_method(DEERTrainer, "_train_step", steps, torch)
        t0 = time.perf_counter()
        try:
            rc = cli.main(["--mode", "full", "--quick", "--output_dir", out,
                           "--experiment_name", "quick", "--platform", platform])
        finally:
            DEERTrainer._train_step = step_fn
        wall = time.perf_counter() - t0
        exp = os.path.join(out, "quick")
        need = ["configs/config.yaml", "results/final_report.md",
                "results/ood_detector.npz", "models/best/state.pt",
                "models/best/meta.json", "logs/metrics.jsonl"] + [
            f"results/{n}.json" for n in ("training_history", "evaluation",
                                          "conformal", "pipeline_summary")]
        missing = [p for p in need if not os.path.exists(os.path.join(exp, p))]
        if rc != 0 or missing:
            raise AssertionError(f"cli --mode full --quick: rc {rc}, missing "
                                 f"{missing}")
        results = {}
        for name in ("pipeline_summary", "evaluation", "conformal"):
            with open(os.path.join(exp, "results", f"{name}.json")) as f:
                results[name] = json.load(f)
        summary, res = results["pipeline_summary"], results["evaluation"]["synthetic"]
        conformal = results["conformal"]["synthetic"]["empirical_coverage"]
        if res["n_parameters"] != 3_918_324 or res["n_samples"] != QUICK_ROWS[2] \
                or not all(math.isfinite(res[k]) for k in ("ccc_average", "ece")):
            raise AssertionError(f"quick run: {res['n_parameters']} params, "
                                 f"{res['n_samples']} test rows, bad metrics")
        check_plots(summary["plots"], os.path.join(exp, "plots"))
        with open(os.path.join(exp, "results", "final_report.md")) as f:
            if f"device: {DEVICE}" not in f.read():
                raise AssertionError("the quick run did not run on the card")
        print(f"main: cli --mode full --quick, {res['n_parameters']} params: "
              f"{len(steps)} steps, step p50 {np.median(steps[1:]) * 1e3:.4f} ms "
              f"(first {steps[0] * 1e3:.1f} ms; host clock to a synchronize), "
              f"wall {wall:.2f} s; best val CCC {summary['best_val_ccc']:.4f}, "
              f"test CCC {res['ccc_average']:.4f}, ECE {res['ece']:.4f}, "
              f"conformal 90% coverage {'/'.join(f'{c:.3f}' for c in conformal)}, "
              f"serving channel {summary['serving_channel']}")

        # (b) the best checkpoint served in float and in int8.
        models = os.path.join(exp, "models")
        channel = CheckpointManager(models).metadata("best")["metrics"]["serving_channel"]
        engines = {"float": InferenceEngine.from_checkpoint(models, device=DEVICE),
                   "int8": InferenceEngine.from_checkpoint(
                       models, quantize_weights=True, device=DEVICE)}
        eager = {k: InferenceEngine.from_checkpoint(
            models, quantize_weights=k == "int8", device=DEVICE, graphs=False)
            for k in engines}
        for e in engines.values():
            e.warmup()
        if any(e.serving_channel != channel for e in engines.values()):
            raise AssertionError("the engines did not take the checkpoint's "
                                 "serving channel")
        test = make_synthetic_splits(SyntheticConfig(
            n_train=QUICK_ROWS[0], n_val=QUICK_ROWS[1], n_test=QUICK_ROWS[2],
            seed=42))["test"]
        feats = [test[k] for k in ("audio", "video", "text")]
        preds = {k: e.predict(*feats) for k, e in engines.items()}
        mu_err = float(np.abs(preds["int8"]["mu"] - preds["float"]["mu"]).max())
        if not mu_err <= 0.05:
            raise AssertionError(f"int8 mu vs float mu {mu_err:.3e} > 0.05")
        q, scales = engines["int8"].quantized_weights
        kernels = [k for k, v in scales.items() if v.numel()]
        if len(kernels) != 44 or any(q[k].dtype != torch.int8
                                     or q[k].device.type != DEVICE for k in kernels):
            raise AssertionError("the int8 engine's kernels are not int8 on "
                                 "the card")
        deq = CompleteDEERModel(engines["float"].model.config)
        deq.load_state_dict(quant.dequantize_tree(q, scales))
        deq_pred = InferenceEngine(deq, device=DEVICE).predict(*feats)
        deq_err = max(check_close(f"int8 vs dequantized float {key}",
                                  torch.from_numpy(preds["int8"][key]),
                                  torch.from_numpy(v), *FEAT_TOL)
                      for key, v in deq_pred.items())
        float_bytes = sum(v.numel() * v.element_size()
                          for v in engines["float"].model.state_dict().values())
        int8_bytes = quant.quantized_size_bytes(q)
        if not int8_bytes < 0.4 * float_bytes:
            raise AssertionError(f"int8 weights {int8_bytes} B, float "
                                 f"{float_bytes} B")
        served = (k4.quantize_int8_stochastic.launches
                  + k4.quantize_int8_stochastic_bits.launches)
        print(f"main: K4 launches over (a) and (b): {served} (the engine's "
              f"quantize_tree rounds to nearest on the host, as the "
              f"reference's; no entry point of either package launches K4)")
        print(f"main: served from the best checkpoint (channel {channel}): "
              f"int8 vs float mu max abs diff {mu_err:.4e} (limit 0.05); int8 "
              f"vs float on its dequantized weights {deq_err:.3e}; 44 int8 "
              f"kernels on the card, {int8_bytes} B vs {float_bytes} B float "
              f"({int8_bytes / float_bytes:.3f})")
        big = [np.concatenate([f] * 3)[:max(PREDICT_SIZES)] for f in feats]
        for k, e in engines.items():
            differ = total = 0
            err = 0.0
            for n in PREDICT_SIZES:
                d, t, m = graph_vs_eager(
                    torch, f"{k} predict({n})",
                    e.predict(*(f[:n] for f in big)),
                    eager[k].predict(*(f[:n] for f in big)))
                differ, total, err = differ + d, total + t, max(err, m)
            print(f"main: {k} predict graphed vs eager at sizes "
                  f"{PREDICT_SIZES}: {differ} of {total} elements differ in "
                  f"any bit, max abs err {err:.3e} (GRAPH_TOL); capture ms "
                  f"per bucket " + ", ".join(
                      f"{b}: {sec * 1e3:.1f}"
                      for b, sec in e.bucket_graphs.capture_s.items()))
        for n in PREDICT_SIZES:
            print(f"main: predict {n}: float p50 graphed "
                  f"{predict_p50(engines['float'], big, n):.4f} ms, eager "
                  f"{predict_p50(eager['float'], big, n):.4f} ms; int8 p50 "
                  f"graphed {predict_p50(engines['int8'], big, n):.4f} ms, "
                  f"eager {predict_p50(eager['int8'], big, n):.4f} ms (host "
                  f"clock, 30 requests)")
        for n in (1, 256):
            for k in engines:
                for label, e in (("graphed", engines[k]), ("eager", eager[k])):
                    profile_window(torch, f"predict {n} {k} {label}",
                                   lambda: e.predict(*(f[:n] for f in big)))
        phase_export(torch, models, out, platform, engines, big)

        # (c) K4 by direct calls of its public function
        # (ops.quantization.quantize_int8_stochastic, the reference's
        # docs/API.md entry) on each Dense kernel of the checkpoint: the
        # counted run, each result then held against the plain twin.
        sd = CheckpointManager(models).restore_params("best")
        dense = [k for k, v in sd.items() if quant.contraction_axis(k, v) is not None]
        weights = [sd[k].to(DEVICE).contiguous() for k in dense]
        k4.quantize_int8_stochastic.launches = 0
        results = [quant.quantize_int8_stochastic(w, seed=i)
                   for i, w in enumerate(weights)]
        launches = k4.quantize_int8_stochastic.launches
        if len(dense) != 44 or (DEVICE == "cuda" and launches != 44):
            raise AssertionError(f"K4 on {len(dense)} kernels launched "
                                 f"{launches} times")
        worst = max(k4_bounds(torch, q_, s_, w, f"{k}")[0]
                    for k, w, (q_, s_) in zip(dense, weights, results))
        k4_max_err = max(k4_err(torch, got, quant.quantize_int8_stochastic_plain(
            w, seed=i), k) for i, (k, w, got) in enumerate(zip(dense, weights,
                                                               results)))
        print(f"main: K4 by direct calls on the checkpoint's {len(dense)} "
              f"Dense kernels ({sum(w.numel() for w in weights)} entries): "
              f"{launches} launches, each equal to the plain twin (values "
              f"and scale bits) and within the bounds (max |q·s - w| "
              f"{worst:.4f} s)")
        host_ms, dev_ms, events = k4_calls_ms(torch, quant.quantize_int8_stochastic,
                                              weights)
        print(f"main: the {len(dense)} direct K4 calls: {host_ms:.4f} ms host "
              f"clock to a synchronize (median of 20 rounds), {ms_text(dev_ms)} "
              f"on the device over {events} device events (profiler)")
        del weights, results, engines, eager
    return launches, k4_max_err


def wait_for_line(proc, marker, timeout):
    """The first line of proc's stderr holding `marker` (None if the
    process ends or `timeout` s pass first); a thread keeps draining the
    pipe after it."""
    found, lines = threading.Event(), []

    def drain():
        for line in proc.stderr:
            lines.append(line)
            if marker in line and not found.is_set():
                found.set()
        found.set()

    threading.Thread(target=drain, daemon=True).start()
    found.wait(timeout)
    hit = [line for line in lines if marker in line]
    return hit[0] if hit else None, lines


def phase_export(torch, models, out, platform, live, feats):
    """Phase 10(b'): the quick run's best checkpoint exported by `cli --mode
    export` in float and int8, served by ExportedEngine (graphed vs eager,
    vs the live engines); then `python -m tpu_deer_torch.server` in a
    subprocess, over the float artifact and over the checkpoint with 4
    stream slots."""
    from tpu_deer_torch import cli
    from tpu_deer_torch.export import load_exported

    dirs = {}
    for k, extra in (("float", []), ("int8", ["--int8"])):
        root = os.path.join(out, f"export_{k}")
        t0 = time.perf_counter()
        rc = cli.main(["--mode", "export", "--model_path", models,
                       "--output_dir", root, "--experiment_name", "export",
                       "--platform", platform, *extra])
        wall = time.perf_counter() - t0
        d = dirs[k] = os.path.join(root, "exported_model")
        sizes = {f: os.path.getsize(os.path.join(d, f))
                 for f in sorted(os.listdir(d))}
        programs = [n for f, n in sizes.items() if f.endswith(".pt2")]
        if rc != 0 or len(programs) != 4 or max(programs) >= sizes["params.npz"]:
            raise AssertionError(f"export {k}: rc {rc}, files {sizes}")
        engine = load_exported(d, device=DEVICE)
        eager = load_exported(d, device=DEVICE, graphs=False)
        t0 = time.perf_counter()
        engine.warmup()
        warm = time.perf_counter() - t0
        differ = total = 0
        err = live_err = 0.0
        for n in PREDICT_SIZES:
            rows = [f[:n] for f in feats]
            got = engine.predict(*rows)
            d_, t_, e_ = graph_vs_eager(torch, f"exported {k} predict({n})",
                                        got, eager.predict(*rows))
            ref = live[k].predict(*rows)
            live_err = max(live_err, *(check_close(
                f"exported {k} vs live {key}", torch.from_numpy(v),
                torch.from_numpy(ref[key]), *GRAPH_TOL)
                for key, v in got.items()))
            differ, total, err = differ + d_, total + t_, max(err, e_)
        print(f"export {k}: cli --mode export wall {wall:.2f} s; "
              f"{sum(sizes.values())} B in all: " + ", ".join(
                  f"{f} {n} B" for f, n in sizes.items())
              + f"; the programs hold no weights (each under params.npz)")
        print(f"export {k}: ExportedEngine warm-up (4 captures) {warm:.2f} s; "
              f"graphed vs eager at sizes {PREDICT_SIZES}: {differ} of "
              f"{total} elements differ in any bit, max abs err {err:.3e}; "
              f"vs the live graphed engine max abs err {live_err:.3e} "
              f"(GRAPH_TOL)")
        for n in PREDICT_SIZES:
            print(f"export {k}: predict {n}: p50 graphed "
                  f"{predict_p50(engine, feats, n):.4f} ms, eager "
                  f"{predict_p50(eager, feats, n):.4f} ms (host clock, 30 "
                  f"requests)")
        profile_window(torch, f"exported predict 256 {k} graphed",
                       lambda: engine.predict(*(f[:256] for f in feats)))
        del engine, eager

    # The server's own entry point, over the float artifact and over the
    # checkpoint with live sessions.
    rows = [f[:5] for f in feats]
    payload = dict(zip(("audio", "video", "text"), (r.tolist() for r in rows)))
    chunk = np.random.default_rng(SEED + 6).normal(
        scale=0.1, size=4096).astype(np.float32)
    for source, path, ref in (
            ("--exported", dirs["float"],
             load_exported(dirs["float"], device=DEVICE).predict(*rows)),
            ("--checkpoint", models, live["float"].predict(*rows))):
        extra = ["--stream_slots", "4"] if source == "--checkpoint" else []
        with served([source, path, "--platform", platform, *extra]) as (
                call, started):
            got = call("/predict", payload)
            err = max(check_close(f"server {source} /predict {key}",
                                  torch.tensor(got[key]),
                                  torch.from_numpy(ref[key]).double(),
                                  *FEAT_TOL)
                      for key in ("mu", "uncertainty", "calibrated_uncertainty",
                                  "expected_abs_error"))
            note = ""
            if extra:
                sid = call("/stream/start", {})["session_id"]
                pushed = call("/stream/push", {"session_id": sid,
                                               "audio": chunk.tolist()})
                call("/stream/end", {"session_id": sid})
                if len(pushed["mu"]) != 3 or not np.isfinite(pushed["mu"]).all():
                    raise AssertionError(f"server /stream/push: {pushed}")
                note = ", one session's start, push and end"
            health = call("/healthz")
            if health.get("status") != "ok" or health["requests_served"] != 1 \
                    or health.get("stream_slots", 0) != (4 if extra else 0):
                raise AssertionError(f"server {source} /healthz: {health}")
        print(f"export: python -m tpu_deer_torch.server "
              f"{' '.join([source, *extra])} (float): up in {started:.2f} s "
              f"(warm-up included), /healthz ok, /predict of 5 rows vs the "
              f"engine max abs err {err:.3e}{note}; exit 0 on SIGINT")


class served:
    """`python -m tpu_deer_torch.server <args> --port 0` in a subprocess:
    entered, (call(path, payload=None) -> JSON, seconds to start); on exit
    SIGINT, and a raise unless it exits 0."""

    def __init__(self, args):
        self.argv = [sys.executable, "-m", "tpu_deer_torch.server", *args,
                     "--port", "0"]

    def __enter__(self):
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            self.argv, cwd=os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.PIPE, text=True)
        line, lines = wait_for_line(self.proc, "listening on ", 300)
        if line is None:
            self._stop()
            raise AssertionError(f"{self.argv[3:]}: the server did not "
                                 "start:\n" + "".join(lines[-20:]))
        url = line.split("listening on ")[1].strip()

        def call(path, payload=None):
            data = None if payload is None else json.dumps(payload).encode()
            with urllib.request.urlopen(urllib.request.Request(
                    url + path, data=data), timeout=120) as r:
                return json.loads(r.read())

        return call, time.perf_counter() - t0

    def _stop(self):
        self.proc.send_signal(signal.SIGINT)  # the server closes, exits 0
        try:
            return self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=30)

    def __exit__(self, *exc):
        rc = self._stop()
        if rc != 0 and exc[0] is None:
            raise AssertionError(f"{self.argv[3:]}: the server exited {rc}")


def phase_recipe(torch):
    """The headline recipe: fused epochs as CUDA graphs of the train step,
    against eager steps; then the headline experiment's twin."""
    import tempfile

    from tpu_deer_torch import cli
    from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.experiments import synthetic_headline
    from tpu_deer_torch.train.trainer import DEERTrainer

    splits = make_synthetic_splits(SyntheticConfig(
        n_train=STEP_ROWS, n_val=4096, n_test=8, seed=42))
    data = {s: {"synthetic": ArrayDataset(splits[s], "synthetic")}
            for s in ("train", "val")}
    with tempfile.TemporaryDirectory(prefix="recipe_") as out:
        # (d) the recipe as the pipeline builds it (fused, graphed), then
        # without fused epochs (eager steps); validation after each epoch
        # (eager, between the replays).
        runs = {}
        for label, overrides, step_name in (
                ("graphed", {}, "_fused_step"),
                ("eager", {"training.fused_epochs": False}, "_train_step")):
            pipe = cli.MultimodalDEERPipeline(
                output_dir=out, experiment_name=label, recipe="uncertainty",
                overrides={"training.num_epochs": STEP_EPOCHS,
                           "training.val_frequency": 1, **overrides},
                device=DEVICE)
            pipe.create_model()
            pipe.datasets = data
            trainer = pipe.create_trainer()
            steps, epochs = [], []
            saved = (timed_method(DEERTrainer, step_name, steps, torch),
                     timed_method(DEERTrainer, "train_epoch", epochs, torch))
            try:
                res = trainer.train(data["train"], data["val"])
            finally:
                setattr(DEERTrainer, step_name, saved[0])
                DEERTrainer.train_epoch = saved[1]
            if not math.isfinite(res["best_val_ccc"]):
                raise AssertionError(f"recipe {label}: val CCC "
                                     f"{res['best_val_ccc']}")
            runs[label] = (trainer, steps, epochs, res)
        graphed, eager = runs["graphed"][0], runs["eager"][0]
        bs = graphed.config.batch_size
        n_steps = STEP_EPOCHS * STEP_ROWS // bs
        warm = graphed.GRAPH_WARMUP
        if not graphed.config.fused_epochs or graphed.step != n_steps \
                or graphed._run is None or graphed._run.eager != warm \
                or graphed.graph_replays != n_steps - warm:
            raise AssertionError(
                f"recipe uncertainty: fused {graphed.config.fused_epochs}, "
                f"{graphed.step} steps, {graphed.graph_replays} replays; want "
                f"{n_steps} steps, {n_steps - warm} of them replayed")
        staged = sum(v.numel() * v.element_size()
                     for v in graphed._run.data.values())
        for label, (_, steps, epochs, res) in runs.items():
            tail = steps[warm + 1:] if label == "graphed" else steps[1:]
            print(f"recipe: uncertainty {label} (batch {bs}, {STEP_ROWS} rows "
                  f"staged, {staged / 1e9:.2f} GB): {len(steps)} steps, p50 "
                  f"{np.median(tail) * 1e3:.4f} ms ({bs / np.median(tail):.0f} "
                  f"rows/s; host clock to a synchronize; first "
                  f"{steps[0] * 1e3:.1f} ms), epoch wall "
                  + " / ".join(f"{e:.3f}" for e in epochs)
                  + f" s, best val CCC {res['best_val_ccc']:.4f}")
        print(f"recipe: graphed: {warm} eager warm-up steps, then "
              f"{graphed.graph_replays} replays of one graph; the capture "
              f"took {graphed.graph_capture_s * 1e3:.1f} ms (host clock)")

        # Graphed against eager steps from one state and seed, dropout on:
        # the graphed trainer captures over an epoch of COMPARE_STEPS steps,
        # the eager one takes its state, and each runs one more epoch.
        small = ArrayDataset({k: v[:COMPARE_STEPS * bs]
                              for k, v in splits["train"].items()}, "synthetic")
        iters = {"synthetic": BatchIterator(small, bs, shuffle=True,
                                            drop_last=True,
                                            seed=graphed.config.seed)}
        graphed.train_epoch(iters, STEP_EPOCHS)
        eager.load_state_dict(graphed.state_dict())
        before = graphed.graph_replays
        got = graphed.train_epoch(iters, STEP_EPOCHS + 1)
        ref = eager.train_epoch(iters, STEP_EPOCHS + 1)
        if graphed.graph_replays - before != COMPARE_STEPS:
            raise AssertionError(f"{graphed.graph_replays - before} of "
                                 f"{COMPARE_STEPS} steps replayed")
        if not torch.equal(graphed.generator.get_state(),
                           eager.generator.get_state()):
            raise AssertionError("graphed and eager steps drew other seeds")
        want = eager.model.state_dict()
        err = max(check_close(f"graphed vs eager {name}", p, want[name],
                              *GRAPH_TOL)
                  for name, p in graphed.model.state_dict().items())
        differ = sum(not torch.equal(p, want[name])
                     for name, p in graphed.model.state_dict().items())
        print(f"recipe: {COMPARE_STEPS} graphed vs {COMPARE_STEPS} eager steps "
              f"from one state, dropout on: train loss {got['loss']:.7f} vs "
              f"{ref['loss']:.7f}; parameters max abs diff {err:.3e} (rtol, "
              f"atol {GRAPH_TOL}); {differ} of {len(want)} parameter tensors "
              f"differ in any bit")
        profile_window(torch, f"an epoch of {COMPARE_STEPS} graphed steps",
                       lambda: graphed.train_epoch(iters, STEP_EPOCHS + 2),
                       windows=3)
        batch = eager._batch_from_indices(small, np.arange(bs))
        profile_window(torch, f"eager train step at batch {bs}",
                       lambda: eager._train_step(batch, 1.0, 1.0))
        del graphed, eager, runs, data, splits, small, iters, batch

        # (e) the headline experiment's twin, cut to size.
        fused = []
        saved = timed_method(DEERTrainer, "_fused_step", fused, torch)
        stem = os.path.join(out, "twin", "RESULTS_synthetic_h100")
        t0 = time.perf_counter()
        try:
            rc = synthetic_headline.main(
                ["--n_train", str(TWIN_ROWS), "--epochs", str(TWIN_EPOCHS),
                 "--out", stem])
        finally:
            DEERTrainer._fused_step = saved
        wall = time.perf_counter() - t0
        with open(stem + ".json") as f:
            payload = json.load(f)
        with open(stem + ".md") as f:
            md = f.read()
        metrics = [payload["best_val_ccc"], payload["ece_calibrated"],
                   payload["test"]["ccc_average"], payload["test"]["ece"],
                   payload["uncertainty"]["uncertainty_error_correlation"]]
        n_twin = TWIN_EPOCHS * (TWIN_ROWS // bs)
        if rc != 0 or len(fused) != n_twin or not all(map(math.isfinite, metrics)) \
                or "| CCC average |" not in md or payload["n_params"] != 3_918_324:
            raise AssertionError(f"twin: rc {rc}, {len(fused)} of {n_twin} "
                                 f"fused steps, metrics {metrics}")
        print(f"recipe: the headline twin at {TWIN_ROWS} rows, {TWIN_EPOCHS} "
              f"epochs ({len(fused)} fused steps): wall {wall:.1f} s (train "
              f"{payload['train_time_s']:.1f} s), test CCC "
              f"{payload['test']['ccc_average']:.4f}, calibrated ECE "
              f"{payload['ece_calibrated']:.4f}, uncertainty-error r "
              f"{payload['uncertainty']['uncertainty_error_correlation']:.4f}; "
              f"platform {payload['platform']!r}")


def mc_reference(torch, trainer, dataset, n_samples, batch_size, seed):
    """predict_mc_dropout's numbers by another route: per batch one seeded
    forward over the batch repeated S times (S·B rows; its dropout draws
    are laid out as the vmapped [S, B, ...] draws), the S samples split off
    in a host loop and moment-matched in float64."""
    from tpu_deer_torch.data.pipeline import BatchIterator
    from tpu_deer_torch.models.deer_model import uncertainty_outputs
    from tpu_deer_torch.train.rng import forked_rng, seed_global

    names = trainer.model.config.dim_names
    outs, masks = {}, []
    trainer.model.train()
    with torch.no_grad(), forked_rng(trainer.device):
        seed_global(trainer.device, seed)
        for idx, mask in BatchIterator(dataset, batch_size,
                                       shuffle=False).epoch_indices(0):
            batch = trainer._batch_from_indices(dataset, idx)
            out = uncertainty_outputs(trainer.model(*(
                batch[k].repeat(n_samples, 1) for k in ("audio", "video", "text"))),
                names)
            b = len(idx)
            samples = [{k: v[i * b:(i + 1) * b].double().cpu().numpy()
                        for k, v in out.items()} for i in range(n_samples)]
            mu = np.mean([x["mu"] for x in samples], axis=0)
            d = np.var([x["mu"] for x in samples], axis=0)
            mean = lambda key: np.mean([x[key] for x in samples], axis=0)
            res = {"mu": mu, "aleatoric": mean("aleatoric"),
                   "epistemic": mean("epistemic") + d,
                   "calibrated_uncertainty": mean("calibrated_uncertainty") + d}
            res["uncertainty"] = res["aleatoric"] + res["epistemic"]
            for k, v in res.items():
                outs.setdefault(k, []).append(v)
            masks.append(mask.astype(bool))
    trainer.model.eval()
    keep = np.concatenate(masks)
    return {k: np.concatenate(v)[keep] for k, v in outs.items()}


def no_dropout(model):
    for m in model.modules():
        if type(m).__name__ == "Dropout":
            m.p = 0.0
    return model


def phase_ensemble(torch, wrappers):
    """Phase 12: a K = 4 deep ensemble of the full-width flagship trained
    (graphed against eager; one dropout-off step against 4 single-model
    steps), predicted, MC dropout on one member, served in float and int8,
    exported and served over HTTP, and distilled into a student."""
    import dataclasses
    import tempfile

    from tpu_deer_torch import cli
    from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
    from tpu_deer_torch.data.synthetic import benchmark_v2, make_synthetic_splits
    from tpu_deer_torch.export import load_exported
    from tpu_deer_torch.models.deer_model import (
        CompleteDEERModel,
        DEERModelConfig,
        create_complete_deer_model,
        member_forward,
    )
    from tpu_deer_torch.serve import InferenceEngine
    from tpu_deer_torch.train.checkpoint import CheckpointManager
    from tpu_deer_torch.train.distill import add_teacher_targets
    from tpu_deer_torch.train.ensemble import EnsembleTrainer, create_deer_ensemble
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

    for fn in wrappers:
        fn.launches = 0
    t_phase = time.perf_counter()
    platform = "auto" if DEVICE == "cuda" else DEVICE
    k, bs = ENS_MEMBERS, ENS_BATCH
    splits = make_synthetic_splits(benchmark_v2(n_train=ENS_ROWS, n_val=ENS_EVAL,
                                                n_test=8))
    train = ArrayDataset(splits["train"], "synthetic")
    val = ArrayDataset(splits["val"], "synthetic")
    cfg = DEERModelConfig(dropout=0.1)
    model, stack = create_deer_ensemble(cfg, k, seed=1, device=DEVICE)
    n_params = sum(v.numel() for v in stack.values())
    if n_params != k * 3_918_324:
        raise AssertionError(f"ensemble of {n_params} parameters")
    steps = ENS_ROWS // bs
    tcfg = TrainingConfig(learning_rate=2e-3, batch_size=bs, num_epochs=30,
                          warmup_epochs=2, scheduler="cosine", seed=1,
                          dataset_weights={"synthetic": 1.0}, fused_epochs=True)

    # (a) 2 fused epochs graphed and the same 2 eagerly from one state.
    graphed = EnsembleTrainer(model, stack, tcfg, steps_per_epoch=steps,
                              device=DEVICE)
    eager = EnsembleTrainer(model, stack, dataclasses.replace(
        tcfg, fused_epochs=False), steps_per_epoch=steps, device=DEVICE)
    iters = {"synthetic": BatchIterator(train, bs, shuffle=True, drop_last=True,
                                        seed=1)}
    times = {"graphed": [], "eager": []}
    losses = {"graphed": [], "eager": []}
    saved = (timed_method(DEERTrainer, "_fused_step", times["graphed"], torch),
             timed_method(DEERTrainer, "_train_step", times["eager"], torch))
    try:
        for epoch in range(ENS_EPOCHS):
            losses["graphed"].append(graphed.train_epoch(iters, epoch)["loss"])
            losses["eager"].append(eager.train_epoch(iters, epoch)["loss"])
    finally:
        DEERTrainer._fused_step, DEERTrainer._train_step = saved
    warm = graphed.GRAPH_WARMUP
    if DEVICE == "cuda" and graphed.graph_replays != ENS_EPOCHS * steps - warm:
        raise AssertionError(f"ensemble: {graphed.graph_replays} replays of "
                             f"{ENS_EPOCHS * steps} steps")
    for got, ref in zip(losses["graphed"], losses["eager"]):
        check_close("ensemble graphed vs eager loss", torch.tensor(got),
                    torch.tensor(ref), *GRAPH_TOL)
    err = max(check_close(f"ensemble graphed vs eager {name}", p,
                          eager.params[name], *GRAPH_TOL)
              for name, p in graphed.params.items())
    differ = sum(not torch.equal(p, eager.params[name])
                 for name, p in graphed.params.items())
    g_p50 = np.median(times["graphed"][warm:]) * 1e3
    e_p50 = np.median(times["eager"][1:]) * 1e3
    print(f"ensemble: K={k} flagship members ({n_params} params), "
          f"benchmark_v2 {ENS_ROWS} rows, batch {bs}, dropout 0.1, float32 "
          f"(TF32 off): {ENS_EPOCHS} fused epochs graphed ({warm} eager "
          f"warm-up steps, {graphed.graph_replays} replays) vs eager from one "
          f"state: train loss " + ", ".join(
              f"{a:.7f} vs {b:.7f}" for a, b in zip(losses["graphed"],
                                                   losses["eager"]))
          + f"; parameters max abs diff {err:.3e} (rtol, atol {GRAPH_TOL}), "
          f"{differ} of {len(stack)} tensors differ in any bit")
    print(f"ensemble: step p50 graphed {g_p50:.4f} ms, eager {e_p50:.4f} ms "
          f"(host clock to a synchronize; {k * bs / g_p50 * 1e3:.0f} member-"
          f"rows/s graphed); capture {graphed.graph_capture_s:.3f} s (host "
          f"clock)")
    kernels = profile_window(torch, f"an ensemble epoch of {steps} graphed "
                             f"steps", lambda: graphed.train_epoch(
                                 iters, ENS_EPOCHS), windows=3)
    if kernels:
        print(f"ensemble: device time per graphed step "
              f"{sum(kernels.values()) / steps:.4f} ms")
    batch = eager._batch_from_indices(train, np.arange(bs))
    profile_window(torch, f"eager ensemble step at batch {bs}",
                   lambda: eager._train_step(batch, 1.0, 1.0))
    del eager

    # One dropout-off step: the ensemble against 4 single-model trainers
    # started from the member slices, each gradient also against the
    # single model's in float64.
    cfg0 = DEERModelConfig(dropout=0.0)
    m0, s0 = create_deer_ensemble(cfg0, k, seed=3, device=DEVICE)
    tc0 = TrainingConfig(learning_rate=2e-3, batch_size=bs, scheduler="constant",
                         seed=1, dataset_weights={"synthetic": 1.0})
    ens = EnsembleTrainer(no_dropout(m0), s0, tc0, steps_per_epoch=steps,
                          device=DEVICE)
    args = (batch["audio"], batch["video"], batch["text"])
    ens.model.train()
    m_loss, _ = member_forward(ens.model, ens.params, *args,
                               lambda out: ens._loss_terms(out, batch, 1.0),
                               randomness="different")
    e_grads = torch.autograd.grad(m_loss.sum(), list(ens.params.values()))
    ens._train_step(batch, 1.0, 1.0)
    loss_err = param_err = 0.0
    acc = []  # per member: (|ens - f64|, |single - f64|, |ens - single|) norms
    for i in range(k):
        runs = {}
        for dtype in ("float32", "float64"):
            single = CompleteDEERModel(dataclasses.replace(cfg0, compute_dtype=dtype))
            single.load_state_dict({n: v[i] for n, v in s0.items()})
            st = DEERTrainer(no_dropout(single.to(getattr(torch, dtype))), tc0,
                             steps_per_epoch=steps, device=DEVICE)
            st.model.train()
            loss, _ = st._loss_fn({n: v.to(getattr(torch, dtype))
                                   for n, v in batch.items()}, 1.0)
            runs[dtype] = (st, loss, torch.autograd.grad(loss, list(st.params.values())))
        st, loss, grads = runs["float32"]
        loss_err = max(loss_err, check_close("ensemble vs single loss",
                                             m_loss[i].detach(), loss.detach(),
                                             *TRAIN_TOL["loss"]))
        # Gradients that are 0 in exact arithmetic (the attention's query and
        # key projections over one key) hold float noise only: left out.
        ref = runs["float64"][2]
        top = max(r.abs().max().item() for r in ref)
        keep = [j for j, r in enumerate(ref) if r.abs().max().item() > 1e-4 * top]
        flat = lambda gs: torch.cat([gs[j].double().flatten() for j in keep])
        g64, g32 = flat(ref), flat(grads)
        g_ens = flat([g[i] for g in e_grads])
        acc.append((((g_ens - g64).norm() / g64.norm()).item(),
                    ((g32 - g64).norm() / g64.norm()).item(),
                    ((g_ens - g32).norm() / g32.norm()).item()))
        if acc[-1][0] > ENS_GRAD_FACTOR * acc[-1][1] + 1e-6:
            raise AssertionError(f"member {i}: the ensemble's gradient is "
                                 f"{acc[-1][0]:.3e} from float64, the single "
                                 f"model's {acc[-1][1]:.3e}")
        st._train_step(batch, 1.0, 1.0)
        for n, p in st.params.items():
            param_err = max(param_err, (ens.params[n][i] - p).abs().max().item())
    bound = 2 * tc0.learning_rate * (1 + tc0.weight_decay * max(
        v.abs().max().item() for v in s0.values()))
    if param_err > bound:
        raise AssertionError(f"ensemble vs single step: parameters differ by "
                             f"{param_err:.3e} > {bound:.3e}")
    print(f"ensemble: one dropout-off step, K={k} batched vs {k} single "
          f"DEERTrainer steps from the member slices: loss max abs diff "
          f"{loss_err:.3e} (TRAIN_TOL); gradients (norm over the {len(keep)} "
          f"tensors not 0 in exact arithmetic, relative) ensemble vs single "
          + ", ".join(f"{c:.3e}" for _, _, c in acc) + "; against float64 "
          "ensemble " + ", ".join(f"{a:.3e}" for a, _, _ in acc) + ", single "
          + ", ".join(f"{b:.3e}" for _, b, _ in acc)
          + f" (the ensemble's within {ENS_GRAD_FACTOR}x the single model's "
          f"distance + 1e-6); parameters max abs diff {param_err:.3e} (Adam's "
          f"first step moves an entry by at most lr(1 + wd|p|), so the bound "
          f"that holds is twice that, {bound:.3e})")
    del ens, st, runs, m0, s0, e_grads, grads

    # (b) prediction, and MC dropout on member 0.
    t0 = time.perf_counter()
    pred = graphed.predict(val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(np.isfinite(v).all() and v.shape == (ENS_EVAL, 3)
               for v in pred.values()):
        raise AssertionError("ensemble predict: bad outputs")
    dev = device_ms(torch, lambda: graphed.predict(val), calls=3)
    print(f"ensemble: predict on {ENS_EVAL} rows {wall * 1e3:.2f} ms (host "
          f"clock, first call), {ms_text(dev)} on the device a call")
    member = CompleteDEERModel(cfg)
    member.load_state_dict(graphed.member_params(0))
    mc = DEERTrainer(member, tcfg, steps_per_epoch=steps, device=DEVICE)
    t0 = time.perf_counter()
    got = mc.predict_mc_dropout(val, n_samples=MC_SAMPLES, batch_size=bs, seed=SEED)
    wall = time.perf_counter() - t0
    ref = mc_reference(torch, mc, val, MC_SAMPLES, bs, SEED)
    mc_err = max(check_close(f"MC dropout {key}", torch.from_numpy(v).double(),
                             torch.from_numpy(ref[key]), *MC_TOL)
                 for key, v in got.items())
    again = mc.predict_mc_dropout(val, n_samples=MC_SAMPLES, batch_size=bs,
                                  seed=SEED)
    if not all(np.array_equal(v, again[key]) for key, v in got.items()):
        raise AssertionError("MC dropout: one seed gave two answers")
    dev = device_ms(torch, lambda: mc.predict_mc_dropout(
        val, n_samples=MC_SAMPLES, batch_size=bs, seed=SEED), calls=3)
    print(f"ensemble: MC dropout S={MC_SAMPLES} on {ENS_EVAL} rows: {wall * 1e3:.2f} "
          f"ms (host clock), {ms_text(dev)} on the device a call; vs a host "
          f"loop over S seeded samples max abs err {mc_err:.3e} (MC_TOL); a "
          f"seed repeats bit for bit")
    del mc, member

    with tempfile.TemporaryDirectory(prefix="ensemble_") as out:
        models = os.path.join(out, "models")
        CheckpointManager(models).save(
            graphed.state_dict(), graphed.step,
            metrics={"serving_channel": "eabs", "ensemble_members": k},
            is_best=True)

        # (c) serving the checkpoint, float and int8, graphed and eager.
        engines = {q: InferenceEngine.from_checkpoint(
            models, ensemble_members=k, quantize_weights=q == "int8",
            device=DEVICE) for q in ("float", "int8")}
        eagers = {q: InferenceEngine.from_checkpoint(
            models, ensemble_members=k, quantize_weights=q == "int8",
            device=DEVICE, graphs=False) for q in engines}
        for e in engines.values():
            e.warmup()
        feats = [splits["val"][c][:max(PREDICT_SIZES)]
                 for c in ("audio", "video", "text")]
        for q, e in engines.items():
            differ = total = 0
            for n in PREDICT_SIZES:
                d_, t_, _ = graph_vs_eager(torch, f"ensemble {q} predict({n})",
                                           e.predict(*(f[:n] for f in feats)),
                                           eagers[q].predict(*(f[:n] for f in feats)))
                differ, total = differ + d_, total + t_
            if DEVICE == "cuda" and differ:
                raise AssertionError(f"ensemble {q}: graphed and eager differ "
                                     f"in {differ} of {total} elements")
            print(f"ensemble: {q} engine graphed vs eager at {PREDICT_SIZES}: "
                  f"{differ} of {total} elements differ; p50 " + ", ".join(
                      f"{n}: {predict_p50(e, feats, n):.4f} ms"
                      for n in PREDICT_SIZES) + " (host clock, 30 requests); "
                  + "; ".join(f"{n} rows {ms_text(device_ms(torch, lambda: e.predict(*(f[:n] for f in feats))))} on the device"
                              for n in (1, 256)))
        live = engines["float"].predict(*feats)
        ref = {key: pred[key][:len(feats[0])] for key in ("mu", "uncertainty",
                                                          "calibrated_uncertainty")}
        live_err = max(check_close(f"ensemble engine vs trainer {key}",
                                   torch.from_numpy(live[key]),
                                   torch.from_numpy(v), *GRAPH_TOL)
                       for key, v in ref.items())
        q_err = float(np.abs(engines["int8"].predict(*feats)["mu"]
                             - live["mu"]).max())
        if not q_err <= 0.05:
            raise AssertionError(f"ensemble int8 mu vs float {q_err:.3e} > 0.05")
        print(f"ensemble: engine vs the trainer's predict max abs err "
              f"{live_err:.3e}; int8 vs float mu {q_err:.4e} (limit 0.05)")
        del eagers

        # (d) export and the server.
        root = os.path.join(out, "export")
        t0 = time.perf_counter()
        rc = cli.main(["--mode", "export", "--ensemble", str(k), "--model_path",
                       models, "--output_dir", root, "--experiment_name",
                       "export", "--platform", platform])
        wall = time.perf_counter() - t0
        d = os.path.join(root, "exported_model")
        sizes = {f: os.path.getsize(os.path.join(d, f)) for f in sorted(os.listdir(d))}
        exported = load_exported(d, device=DEVICE)
        exported.warmup()
        if rc != 0 or exported.manifest["ensemble_members"] != k:
            raise AssertionError(f"ensemble export: rc {rc}, {exported.manifest}")
        exp_err = 0.0
        for n in PREDICT_SIZES:
            rows = [f[:n] for f in feats]
            got = exported.predict(*rows)
            want = engines["float"].predict(*rows)
            exp_err = max(exp_err, *(check_close(
                f"ensemble exported vs live {key}", torch.from_numpy(v),
                torch.from_numpy(want[key]), *GRAPH_TOL) for key, v in got.items()))
        print(f"ensemble: cli --mode export --ensemble {k} wall {wall:.2f} s, "
              f"{sum(sizes.values())} B ({', '.join(f'{f} {n} B' for f, n in sizes.items())}); "
              f"ExportedEngine vs the live engine at {PREDICT_SIZES} max abs err "
              f"{exp_err:.3e}; predict 256 p50 {predict_p50(exported, feats, 256):.4f} ms")
        del exported
        rows = [f[:5] for f in feats]
        payload = dict(zip(("audio", "video", "text"), (r.tolist() for r in rows)))
        want = engines["float"].predict(*rows)
        with served(["--checkpoint", models, "--ensemble", str(k), "--platform",
                     platform]) as (call, started):
            got = call("/predict", payload)
            srv_err = max(check_close(f"ensemble server {key}", torch.tensor(got[key]),
                                      torch.from_numpy(want[key]).double(), *FEAT_TOL)
                          for key in ("mu", "uncertainty", "expected_abs_error"))
            health = call("/healthz")
            if health.get("status") != "ok" or health["requests_served"] != 1:
                raise AssertionError(f"ensemble server /healthz: {health}")
        print(f"ensemble: python -m tpu_deer_torch.server --checkpoint DIR "
              f"--ensemble {k}: up in {started:.2f} s, /healthz ok, /predict of "
              f"5 rows vs the engine max abs err {srv_err:.3e}; exit 0 on SIGINT")
        del engines

    # (e) distillation: the ensemble's combined outputs stamped on the
    # training rows, and a fused epoch of distill_study.py's student.
    t0 = time.perf_counter()
    stamped = add_teacher_targets(graphed.model, train, batch_size=bs,
                                  ensemble=True, params=graphed.params)
    wall = time.perf_counter() - t0
    if not all(np.isfinite(stamped.arrays[c]).all()
               for c in ("teacher_mu", "teacher_unc")):
        raise AssertionError("teacher targets are not finite")
    student = create_complete_deer_model(DEERModelConfig(
        encoder_dim=96, fusion_dim=128, encoder_layers=1, attention_heads=4),
        seed=2, device=DEVICE)
    s_tr = DEERTrainer(student, tcfg, steps_per_epoch=steps, device=DEVICE)
    t0 = time.perf_counter()
    res = s_tr.train_epoch({"synthetic": BatchIterator(
        stamped, bs, shuffle=True, drop_last=True, seed=2)}, 0)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    if not (np.isfinite(res["distill_mu"]) and res["distill_mu"] > 0
            and np.isfinite(res["distill_unc"]) and res["distill_unc"] > 0):
        raise AssertionError(f"student epoch: {res}")
    print(f"ensemble: add_teacher_targets(ensemble=True) over {ENS_ROWS} rows "
          f"{wall:.2f} s (host clock); the student ({s_tr.n_parameters} "
          f"params) one fused epoch ({s_tr.graph_replays} replays) {epoch_s:.2f} "
          f"s: loss {res['loss']:.5f}, distill_mu {res['distill_mu']:.5f}, "
          f"distill_unc {res['distill_unc']:.5f}")
    launched = {fn.__name__: fn.launches for fn in wrappers}
    if any(launched.values()):
        raise AssertionError(f"phase 12 launched kernels: {launched}")
    print(f"ensemble: kernel launches in phase 12: {launched} (none lies on "
          f"this path); phase wall {time.perf_counter() - t_phase:.1f} s")


class _Tee:
    """A text stream that writes to several (the bench's stderr goes to the
    terminal as it runs and is kept for the checks)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def bf16_vs_cpu(torch, state, rows):
    """The flagship's bf16 forward on the card (cuBLAS's bf16
    reduced-precision reductions off, then on) against the same forward on
    the CPU, held to BF16_TOL of the CPU's bf16-vs-float32 gap; returns
    {output: (max err, max gap, mean err, mean gap)} with the reductions
    off and the count of outputs that the flag moves."""
    from tpu_deer_torch.models.deer_model import CompleteDEERModel, DEERModelConfig

    rng = np.random.default_rng(SEED)
    inputs = [rng.standard_normal((rows, d)).astype(np.float32)
              for d in (84, 256, 768)]
    keys = ("mu_all", "uncertainty_all", "calibrated_uncertainty")
    matmul = torch.backends.cuda.matmul

    def forward(dtype, device, reduced=False):
        model = CompleteDEERModel(DEERModelConfig(compute_dtype=dtype))
        model.load_state_dict(state)
        model.to(device).eval()
        saved = matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_bf16_reduced_precision_reduction = reduced
        try:
            with torch.no_grad():
                out = model(*(torch.from_numpy(x).to(device) for x in inputs))
                return {k: out[k].float().cpu().numpy() for k in keys}
        finally:
            matmul.allow_bf16_reduced_precision_reduction = saved

    cpu, cpu_f32 = forward("bfloat16", "cpu"), forward("float32", "cpu")
    card, card_reduced = forward("bfloat16", DEVICE), forward(
        "bfloat16", DEVICE, reduced=True)
    stats = {}
    for key in keys:
        gap = np.abs(cpu[key] - cpu_f32[key])
        err = np.abs(card[key] - cpu[key])
        stats[key] = (float(err.max()), float(gap.max()), float(err.mean()),
                      float(gap.mean()))
        if err.max() > BF16_TOL[0] * gap.max() \
                or err.mean() > BF16_TOL[1] * gap.mean():
            raise AssertionError(
                f"bf16 {key}: card vs CPU max {err.max():.3g} / mean "
                f"{err.mean():.3g} against the CPU's bf16-vs-float32 gap "
                f"max {gap.max():.3g} / mean {gap.mean():.3g} (allowed "
                f"{BF16_TOL})")
    moved = sum(int((card[k] != card_reduced[k]).sum()) for k in keys)
    return stats, moved


def phase_bench(torch, k1, k2):
    """The port's bench at full size (`tpu_deer_torch.bench.main()`, bf16 on
    the card): its stderr lines and JSON line printed; raises unless the
    dtype is bfloat16, the value finite, K1 launched in the front-end
    section, K2 captured in the stream section's tick graph, and the bf16
    forward on the card within BF16_TOL of the CPU's. Then the bf16
    reduced-precision reductions (outputs they move, a graphed forward's
    time at the bench's batch with them off and on) and bf16 predict's
    device time at 1 and 256 rows."""
    import contextlib
    import io

    from tpu_deer_torch import bench
    from tpu_deer_torch.graphs import WARMUP_RUNS, GraphedCall
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        create_complete_deer_model,
    )
    from tpu_deer_torch.serve import InferenceEngine

    t0 = time.perf_counter()
    err, out = io.StringIO(), io.StringIO()
    k1.mfcc_signal.launches = k2.mfcc_frames.launches = 0
    with contextlib.redirect_stderr(_Tee(sys.stderr, err)), \
            contextlib.redirect_stdout(out):
        rc = bench.main([])
    k1_n, k2_n = k1.mfcc_signal.launches, k2.mfcc_frames.launches
    wall = time.perf_counter() - t0
    lines = [ln for ln in err.getvalue().splitlines()
             if ln.startswith("# ") and not ln.startswith("# [")]
    for line in lines:
        print(f"bench: {line}")
    record_line = out.getvalue().strip().splitlines()[-1]
    print(f"bench: {record_line}")
    record = json.loads(record_line)
    if rc != 0 or record["metric"] != "p50_per_sample_latency_ms" \
            or not math.isfinite(record["value"]) \
            or "dtype=bfloat16" not in lines[0]:
        raise AssertionError(f"bench: rc {rc}, record {record}, {lines[:1]}")
    # K1 runs only in the front-end section; K2 only in the stream section,
    # where the wrapper counts the tick's warm-up runs and its capture and
    # no replay (an eager tick would count once a push).
    if k1_n < 1 or k2_n != WARMUP_RUNS + 1:
        raise AssertionError(f"bench: K1 launched {k1_n} times in the "
                             f"front-end section, K2 {k2_n} (want "
                             f"{WARMUP_RUNS + 1}: the tick's capture)")
    print(f"bench: wall {wall:.1f} s; K1 wrapper launches {k1_n} (front-end "
          f"section), K2 {k2_n} (the stream tick's warm-up runs and capture; "
          f"its replays launch it inside the graph)")
    t1 = time.perf_counter()
    f32 = bench.run(compute_dtype="float32")  # the same sections in float32
    for line in f32.lines:
        print(f"bench float32: {line}")
    print(f"bench float32: {json.dumps(f32.record)}; wall "
          f"{time.perf_counter() - t1:.1f} s")

    state = create_complete_deer_model(seed=SEED, device="cpu").state_dict()
    stats, moved = bf16_vs_cpu(torch, state, BF16_ROWS)
    for key, (mx, gmx, mn, gmn) in stats.items():
        print(f"bench: bf16 {key} card vs CPU at {BF16_ROWS} rows: max "
              f"{mx:.3e} (CPU's bf16-vs-float32 gap {gmx:.3e}), mean {mn:.3e} "
              f"(gap {gmn:.3e}); within {BF16_TOL}")
    model = create_complete_deer_model(DEERModelConfig(compute_dtype="bfloat16"),
                                       seed=SEED, device=DEVICE)
    specs = [((BF16_TIMED_ROWS, d), torch.float32) for d in (84, 256, 768)]
    matmul = torch.backends.cuda.matmul
    times = {}
    for reduced in (False, True, True, False):
        # A graph of the forward (captured under the setting, which picks
        # cuBLAS's kernels), so the time is the device's, not the ~400
        # eager launches'.
        matmul.allow_bf16_reduced_precision_reduction = reduced
        forward = GraphedCall(lambda a, v, t: {"mu": model(a, v, t)["mu_all"]},
                              specs, torch.device(DEVICE))
        times.setdefault(reduced, []).append(time_ms(forward.graph.replay))
    matmul.allow_bf16_reduced_precision_reduction = False
    print(f"bench: bf16 reduced-precision reductions move {moved} of "
          f"{3 * 3 * BF16_ROWS} outputs at {BF16_ROWS} rows; a graphed forward "
          f"at {BF16_TIMED_ROWS} rows "
          f"{' / '.join(f'{t:.4f}' for t in times[False])} ms off, "
          f"{' / '.join(f'{t:.4f}' for t in times[True])} ms on (CUDA events "
          f"around a replay, turns off-on-on-off; the bench runs them off)")
    engine = InferenceEngine(model)
    engine.warmup()
    rng = np.random.default_rng(SEED + 11)
    for n in (1, 256):
        feats = [rng.normal(size=(n, d)).astype(np.float32)
                 for d in (84, 256, 768)]
        profile_window(torch, f"predict {n} bf16 graphed",
                       lambda: engine.predict(*feats), windows=3)
    print(f"bench: phase wall {time.perf_counter() - t0:.1f} s")


def write_corpora(root):
    """The three fixture corpora under `root` (raw_corpus's generators:
    real-format wavs, transcripts, CSVs): {name: its directory}."""
    from tpu_deer_torch.data import raw_corpus as rc

    roots = {name: os.path.join(root, name) for name in CORPUS_NAMES}
    rc.generate_raw_fixture(roots["iemocap"], *CORPUS_ROWS,
                            duration_s=CORPUS_SECONDS["iemocap"], seed=SEED)
    rc.generate_raw_fixture_ravdess(roots["ravdess"], n_per_actor=CORPUS_PER_ACTOR,
                                    duration_s=CORPUS_SECONDS["ravdess"], seed=SEED)
    rc.generate_raw_fixture_meld(roots["meld"], *CORPUS_ROWS,
                                 duration_s=CORPUS_SECONDS["meld"], seed=SEED)
    return roots


def plain_load(loader, root, cache_dir):
    """A corpus loaded again through its loader with a caller extractor
    whose audio takes K1's plain twin: (the loaded splits, the signals the
    loader sent to the front-end)."""
    from tpu_deer_torch.data.features import MultimodalFeatureExtractor

    extractor = MultimodalFeatureExtractor(device=DEVICE)
    plain, sent = extractor.audio.extract_batch, []

    def extract_batch(signals):
        sent.extend(signals)
        return plain(signals, plain=True)

    extractor.audio.extract_batch = extract_batch
    return loader(root, extractor=extractor, cache_dir=cache_dir), sent


def mlm_grad_check(torch, emb, featurizer, texts):
    """One MLM step's gradient of the token embedding at the featurizer's
    width, dropout off (its encoder in eval mode), from one masking of
    `texts`: the lookup's kernel plus the tied logits' product against the
    lookup's plain twin plus the same product; that sum against the
    kernel's share plus the product's alone (the lookup detached); and the
    kernel called on the step's (ids, dX) against its plain twin in
    float64. Raises outside EMB_TOL; returns (ids shape, errors)."""
    import torch.nn.functional as F

    from tpu_deer_torch.models import encoders
    from tpu_deer_torch.train import text_pretrain as tp

    enc, vocab = featurizer.encoder, featurizer.vocab
    ids, mask = (torch.from_numpy(a.astype(np.int64)).to(DEVICE)
                 for a in vocab.encode_batch(texts))
    draws = tp.mlm_draws(torch.Generator(device=DEVICE).manual_seed(SEED),
                         ids.shape, vocab.vocab_size, DEVICE)
    corrupted, selected = tp._apply_mlm_mask(ids, mask, featurizer.config.mask_prob,
                                             *draws)
    routes = {"kernel": (emb.embedding_lookup, 1),
              "plain": (emb.embedding_lookup_plain, 0),
              "tied only": (lambda i, w: F.embedding(i, w.detach()), 0)}
    saved, grads, dx = encoders.embedding_lookup, {}, {}
    for route, (lookup, want) in routes.items():
        def recording(i, w, lookup=lookup, route=route):
            x = lookup(i, w)
            if x.requires_grad:
                x.register_hook(lambda g: dx.__setitem__(route, g))
            return x

        encoders.embedding_lookup = recording
        before = emb.embedding_grad.launches
        try:
            loss, _ = tp.mlm_loss(enc, corrupted, ids, mask, selected)
            grads[route], = torch.autograd.grad(loss, [enc.embed.weight])
        finally:
            encoders.embedding_lookup = saved
        if emb.embedding_grad.launches - before != want:
            raise AssertionError(f"MLM step through the {route} lookup launched "
                                 f"the embedding kernel "
                                 f"{emb.embedding_grad.launches - before} times")
    lookup_dw = emb.embedding_grad(corrupted, dx["kernel"].contiguous(),
                                   vocab.vocab_size)
    ref = emb.embedding_grad_plain(corrupted, dx["kernel"].double(), vocab.vocab_size)
    errs = {
        "kernel vs plain lookup, tied logits on both": check_close(
            "MLM embedding gradient, kernel vs plain lookup",
            grads["kernel"].double(), grads["plain"].double(), *EMB_TOL),
        "sum vs kernel's share + product's share": check_close(
            "MLM embedding gradient, sum of the two shares",
            grads["kernel"].double(), (lookup_dw + grads["tied only"]).double(),
            *EMB_TOL),
        "kernel vs plain twin on the step's dX": check_close(
            "embedding grad at the MLM's shape", lookup_dw.double(), ref, *EMB_TOL),
    }
    if not grads["tied only"].abs().max() > 0 or not lookup_dw.abs().max() > 0:
        raise AssertionError("a share of the MLM embedding gradient is zero")
    return tuple(ids.shape), errs


def phase_corpus(torch, k1, k3, emb):
    """Phase 13: the real-corpus path. (a) the three corpora through the
    registry at AUTO (K1 on every utterance's audio, the MLM bootstrap on
    the card); (b) IEMOCAP again with a fresh cache, bit for bit; (c) joint
    training and the transfer matrix; (d) `cli --mode full --quick` on the
    corpora and `cli --raw --quick` in each layout; (e) cross-validation
    and ablation at the flagship's width."""
    import dataclasses
    import tempfile
    from pathlib import Path

    from tpu_deer_torch import cli
    from tpu_deer_torch.data import iemocap, ravdess
    from tpu_deer_torch.data.features import AudioFeatureExtractor
    from tpu_deer_torch.data.pipeline import ArrayDataset
    from tpu_deer_torch.data.registry import load_configured_datasets
    from tpu_deer_torch.eval.ablation import AblationStudy
    from tpu_deer_torch.eval.cross_validation import CrossValidationEvaluator
    from tpu_deer_torch.models.deer_model import DEERModelConfig
    from tpu_deer_torch.train.multi_dataset import MultiDatasetFramework
    from tpu_deer_torch.train.trainer import TrainingConfig
    from tpu_deer_torch.utils.config import default_config, save_yaml_config

    platform = "auto" if DEVICE == "cuda" else DEVICE
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="corpora_") as tmp:
        t0 = time.perf_counter()
        roots = write_corpora(os.path.join(tmp, "corpora"))
        print(f"corpus: fixtures in the three layouts, 192 utterances each, "
              f"written in {time.perf_counter() - t0:.2f} s")
        config = {"datasets": {"names": list(CORPUS_NAMES.values()),
                               "paths": {CORPUS_NAMES[n]: r
                                         for n, r in roots.items()}}}

        # (a) the corpora at AUTO through the registry.
        k3_fns = (k3.flash_attention_fwd, k3.flash_attention_bwd_dq,
                  k3.flash_attention_bwd_dkv)
        for fn in (k1.mfcc_signal, emb.embedding_grad, *k3_fns):
            fn.launches = 0
        t0 = time.perf_counter()
        loaded = load_configured_datasets(config, device=DEVICE)
        wall = time.perf_counter() - t0
        k1_n, emb_n = k1.mfcc_signal.launches, emb.embedding_grad.launches
        k3_n = [fn.launches for fn in k3_fns]
        if loaded is None or set(loaded["train"]) != set(CORPUS_NAMES):
            raise AssertionError("the registry did not load all three corpora")
        meta = loaded.pop("meta")
        backends = meta["text_backend"]
        if backends != {"iemocap": "mlm", "ravdess": "hashed", "meld": "mlm"}:
            raise AssertionError(f"text backends {backends}")
        for name in CORPUS_NAMES:
            t = meta["load_s"][name]
            rows = {sp: len(loaded[sp][name]) for sp in ("train", "val", "test")}
            print(f"corpus (a): {name} {rows}, text {backends[name]}: wall "
                  f"{t['total_s']:.2f} s = decode {t.get('decode_s', 0):.2f} + "
                  f"K1 front-end {t.get('audio_s', 0):.3f} + MLM "
                  f"{t.get('mlm_s', 0):.2f} + text features {t['text_s']:.3f} + "
                  f"video {t['video_s']:.3f} s")
        encoders = meta["text_encoder"]
        runs = {n: enc.history for n, enc in encoders.items()}
        if set(runs) != {"iemocap", "meld"} or None in runs.values():
            raise AssertionError(f"MLM runs {sorted(runs)}: want iemocap and meld "
                                 f"trained by this load")
        steps = sum(sum(h["steps"]) for h in runs.values())
        # The same corpora again through their loaders, K1's plain twin in
        # place of the kernel.
        plain = {n: plain_load(loader, roots[n], os.path.join(tmp, "plain", n))
                 for n, loader in (("iemocap", iemocap.load_iemocap),
                                   ("ravdess", ravdess.load_ravdess))}
        audio = AudioFeatureExtractor(device=DEVICE)
        buckets = sum(len({audio._bucket_length(len(x)) for x in sent})
                      for _, sent in plain.values())
        print(f"corpus (a): registry wall {wall:.2f} s; K1 launches {k1_n} "
              f"(one a length bucket: {buckets}); embedding-gradient launches "
              f"{emb_n} (one an MLM step: {steps}); K3a/b/c launches {k3_n} "
              f"(128 tokens, below the flash threshold)")
        if k1_n != buckets or emb_n != steps:
            raise AssertionError(f"K1 {k1_n} != {buckets} or embedding "
                                 f"{emb_n} != {steps} launches")
        for n, h in runs.items():
            loss, acc = h["mlm_loss"], h["mlm_accuracy"]
            print(f"corpus (a): MLM on {n}'s train transcripts: {len(loss)} "
                  f"epochs, {sum(h['steps'])} steps, loss {loss[0]:.4f} -> "
                  f"{loss[-1]:.4f}, accuracy {acc[0]:.4f} -> {acc[-1]:.4f}")
            if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
                raise AssertionError(f"MLM loss did not fall: {loss}")
        texts = [x["text"] for x in iemocap.parse_annotations(Path(roots["iemocap"]))
                 if x["text"]][:encoders["iemocap"].config.batch_size]
        shape, errs = mlm_grad_check(torch, emb, encoders["iemocap"], texts)
        cfg_mlm = encoders["iemocap"].config
        print(f"corpus (a): one MLM step's embedding gradient, ids {list(shape)}, "
              f"D={cfg_mlm.model_dim}, {cfg_mlm.num_layers} layers, V="
              f"{encoders['iemocap'].vocab.vocab_size}, dropout off: max abs err "
              + "; ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (bound {EMB_TOL[1]} + {EMB_TOL[0]}·|ref|)")
        for n, (ref_splits, _) in plain.items():
            got, ref = (np.concatenate([d[sp].arrays["audio"]
                                        for sp in ("train", "val", "test")])
                        for d in ({sp: loaded[sp][n] for sp in loaded}, ref_splits))
            err = check_close(f"{n} 84-d vectors, K1 vs plain",
                              torch.from_numpy(got), torch.from_numpy(ref), *FEAT_TOL)
            print(f"corpus (a): {n} {got.shape} audio vectors, K1 vs plain twin: "
                  f"max abs err {err:.3e} (bound {FEAT_TOL[1]} + "
                  f"{FEAT_TOL[0]}·|plain|)")
        for sp in ("train", "val", "test"):
            for n, ds in loaded[sp].items():
                if not all(np.isfinite(v).all() for v in ds.arrays.values()):
                    raise AssertionError(f"{n} {sp}: non-finite arrays")

        # (b) the seeded MLM run and the features, again from a fresh cache.
        t0 = time.perf_counter()
        again = iemocap.load_iemocap(roots["iemocap"], device=DEVICE,
                                     cache_dir=os.path.join(tmp, "fresh"))
        first, second = encoders["iemocap"], again["text_encoder"]
        w1, w2 = first.encoder.state_dict(), second.encoder.state_dict()
        differ = [k for k in w1 if not torch.equal(w1[k], w2[k])]
        differ += [f"{sp}.{k}" for sp in ("train", "val", "test")
                   for k, v in loaded[sp]["iemocap"].arrays.items()
                   if not np.array_equal(v, again[sp].arrays[k])]
        if differ or first.history != second.history:
            raise AssertionError(f"IEMOCAP reloaded with a fresh cache differs: "
                                 f"{differ[:8]}, histories equal: "
                                 f"{first.history == second.history}")
        print(f"corpus (b): IEMOCAP with a fresh cache in {time.perf_counter() - t0:.2f} "
              f"s: the MLM encoder ({len(w1)} tensors), its loss curve and "
              f"every feature array equal bit for bit")

        # (c) joint training and the transfer matrix.
        datasets = {n: {sp: loaded[sp][n] for sp in ("train", "val", "test")}
                    for n in CORPUS_NAMES}
        tcfg = TrainingConfig(
            learning_rate=2e-3, batch_size=CORPUS_BATCH, num_epochs=CORPUS_EPOCHS,
            warmup_epochs=0, scheduler="constant", fused_epochs=True,
            dataset_weights={"iemocap": 1.0, "ravdess": 0.8, "meld": 0.6}, seed=42)
        t0 = time.perf_counter()
        fw = MultiDatasetFramework(DEERModelConfig(), tcfg, datasets, device=DEVICE)
        res = fw.run_full_experiment(
            num_epochs=CORPUS_EPOCHS,
            report_path=os.path.join(tmp, "multi_dataset_report.json"))
        joint = {n: r["ccc_average"] for n, r in res.per_dataset.items()}
        eff = {k: v["transfer_effectiveness"] for k, v in res.transfer.items()}
        if len(eff) != 6 or not all(0.0 <= e <= 1.0 for e in eff.values()) \
                or not all(math.isfinite(c) for c in joint.values()):
            raise AssertionError(f"joint {joint}, transfer {eff}")
        print(f"corpus (c): joint training {CORPUS_EPOCHS} epochs + 3 sources, "
              f"{time.perf_counter() - t0:.2f} s; joint CCC "
              + ", ".join(f"{n} {c:.4f}" for n, c in joint.items()))
        print("corpus (c): transfer (source CCC -> target CCC, effectiveness) "
              + "; ".join(f"{k} {v['source_ccc']:.4f} -> {v['target_ccc']:.4f}, "
                          f"{v['transfer_effectiveness']:.3f}"
                          for k, v in res.transfer.items()))

        # (d) the CLI on the corpora, and --raw in each layout.
        cfg = default_config()
        cfg["datasets"]["paths"] = config["datasets"]["paths"]
        cfg_path = os.path.join(tmp, "corpora.yaml")
        save_yaml_config(cfg, cfg_path)
        out = os.path.join(tmp, "cli")
        k1.mfcc_signal.launches = emb.embedding_grad.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["--mode", "full", "--quick", "--config", cfg_path,
                       "--output_dir", out, "--experiment_name", "corpora",
                       "--platform", platform])
        wall = time.perf_counter() - t0
        with open(os.path.join(out, "corpora", "results", "pipeline_summary.json")) as f:
            summary = json.load(f)
        tested = summary["test_results"]
        if rc != 0 or set(tested) != set(CORPUS_NAMES) \
                or summary["text_backend"] != backends:
            raise AssertionError(f"cli --mode full --quick on the corpora: rc "
                                 f"{rc}, tested {sorted(tested)}, backends "
                                 f"{summary['text_backend']}")
        print(f"corpus (d): cli --mode full --quick on the corpora, {wall:.2f} s "
              f"(K1 launches {k1.mfcc_signal.launches}, embedding-gradient "
              f"{emb.embedding_grad.launches}: the quick keys reload the "
              f"features, the encoders come from their corpus-keyed cache); "
              f"test CCC " + ", ".join(f"{n} {r['ccc_average']:.4f}"
                                       for n, r in tested.items()))
        if k1.mfcc_signal.launches != buckets:
            raise AssertionError("the CLI's loaders did not take K1")
        for layout in CORPUS_NAMES:
            for fn in (k1.mfcc_signal, *k3_fns):
                fn.launches = 0
            t0 = time.perf_counter()
            rc = cli.main(["--raw", "--quick", "--raw_dataset", layout,
                           "--epochs", str(RAW_CLI_EPOCHS), "--output_dir", out,
                           "--experiment_name", f"raw_{layout}",
                           "--platform", platform])
            wall = time.perf_counter() - t0
            with open(os.path.join(out, f"raw_{layout}", "results",
                                   "raw_results.json")) as f:
                raw = json.load(f)
            n = k1.mfcc_signal.launches
            if rc != 0 or raw["raw_layout"] != layout or n == 0 \
                    or not math.isfinite(raw["test"]["ccc_average"]):
                raise AssertionError(f"cli --raw --raw_dataset {layout}: rc {rc}, "
                                     f"K1 launches {n}")
            print(f"corpus (d): cli --raw --quick --raw_dataset {layout} "
                  f"--epochs {RAW_CLI_EPOCHS}: {wall:.2f} s, K1 launches in the "
                  f"graph {n}, K3a/b/c {[fn.launches for fn in k3_fns]}, vocab "
                  f"{raw['vocab_size']}, best val CCC "
                  f"{raw['best_val_ccc']:.4f}, test CCC "
                  f"{raw['test']['ccc_average']:.4f}")

        # (e) cross-validation and ablation at the flagship's width.
        ie = datasets["iemocap"]
        whole = ArrayDataset({k: np.concatenate([ie[sp].arrays[k] for sp in
                                                  ("train", "val", "test")])
                              for k in ie["train"].arrays}, "iemocap")
        ecfg = dataclasses.replace(tcfg, num_epochs=1, fused_epochs=False,
                                   dataset_weights={"iemocap": 1.0})
        t0 = time.perf_counter()
        cv = CrossValidationEvaluator(DEERModelConfig(), ecfg, n_folds=2,
                                      device=DEVICE).run(whole, epochs_per_fold=1)
        ab = AblationStudy(DEERModelConfig(), ecfg,
                           subsets=(("audio",), ("audio", "text")),
                           device=DEVICE).run(ie["train"], ie["val"], ie["test"],
                                              num_epochs=1)
        if len(cv["folds"]) != 2 or set(ab) != {"A", "A+T"} or not all(
                math.isfinite(x) for x in (cv["ccc_mean"], ab["A"]["ccc_average"],
                                           ab["A+T"]["ccc_average"])):
            raise AssertionError(f"cv {cv['ccc_mean']}, ablation {sorted(ab)}")
        print(f"corpus (e): 2-fold CV x 1 epoch and ablation of 2 subsets x 1 "
              f"epoch on IEMOCAP at the flagship's width, "
              f"{time.perf_counter() - t0:.2f} s: CV CCC {cv['ccc_mean']:.4f} ± "
              f"{cv['ccc_std']:.4f}; ablation CCC A {ab['A']['ccc_average']:.4f}, "
              f"A+T {ab['A+T']['ccc_average']:.4f}")
    print(f"corpus: phase 13 in {time.perf_counter() - t_phase:.1f} s")


def zoo_layout(torch, name, kw, rows):
    """Phase 14 (a) for one layout: its parameter count, 4 fused steps
    graphed against 4 eager ones from one state, graphed predict against
    eager at ZOO_PREDICT rows, int8 predict against float. Returns the
    trained model and its step p50s (ms)."""
    from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
    from tpu_deer_torch.models.deer_model import (
        CompleteDEERModel,
        DEERModelConfig,
        count_parameters,
        create_complete_deer_model,
        structure,
    )
    from tpu_deer_torch.ops.quantization import dequantize_tree, quantize_tree
    from tpu_deer_torch.serve import InferenceEngine
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

    cfg = DEERModelConfig(dropout=0.1, **kw)
    n_params = count_parameters(structure(cfg))
    if n_params != ZOO_COUNTS[name]:
        raise AssertionError(f"{name}: {n_params:,} parameters, the reference "
                             f"has {ZOO_COUNTS[name]:,}")
    tcfg = TrainingConfig(learning_rate=ZOO_LR, batch_size=ZOO_BATCH,
                          num_epochs=2, warmup_epochs=0, scheduler="constant",
                          fused_epochs=True, seed=SEED,
                          dataset_weights={"zoo": 1.0})
    trainers = {fused: DEERTrainer(
        create_complete_deer_model(cfg, seed=SEED, device=DEVICE),
        dataclasses.replace(tcfg, fused_epochs=fused),
        steps_per_epoch=ZOO_STEPS, device=DEVICE) for fused in (True, False)}
    graphed, eager = trainers[True], trainers[False]
    data = ArrayDataset(rows, "zoo")
    iters = {"zoo": BatchIterator(data, ZOO_BATCH, shuffle=True,
                                  drop_last=True, seed=SEED)}
    graphed.train_epoch(iters, 0)  # the warm-up steps and the capture
    eager.load_state_dict(graphed.state_dict())
    replays = graphed.graph_replays
    times = {"graphed": [], "eager": []}
    saved = (timed_method(DEERTrainer, "_fused_step", times["graphed"], torch),
             timed_method(DEERTrainer, "_train_step", times["eager"], torch))
    try:
        got = graphed.train_epoch(iters, 1)
        ref = eager.train_epoch(iters, 1)
    finally:
        DEERTrainer._fused_step, DEERTrainer._train_step = saved
    if DEVICE == "cuda" and graphed.graph_replays - replays != ZOO_STEPS:
        raise AssertionError(f"{name}: {graphed.graph_replays - replays} of "
                             f"{ZOO_STEPS} steps replayed")
    want = eager.model.state_dict()
    err = max(check_close(f"{name} graphed vs eager {k}", v, want[k], *GRAPH_TOL)
              for k, v in graphed.model.state_dict().items())
    differ = sum(not torch.equal(v, want[k])
                 for k, v in graphed.model.state_dict().items())
    p50 = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
    print(f"zoo (a): {name}: {n_params:,} parameters (the reference's); "
          f"{ZOO_STEPS} graphed vs {ZOO_STEPS} eager steps at batch "
          f"{ZOO_BATCH}: loss {got['loss']:.7f} vs {ref['loss']:.7f}, "
          f"parameters max abs diff {err:.3e} ({differ} of {len(want)} "
          f"tensors differ in any bit); step p50 graphed "
          f"{p50['graphed']:.3f} ms, eager {p50['eager']:.3f} ms")

    model = graphed.model.eval()
    feats = tuple(rows[k][:max(ZOO_PREDICT)] for k in ("audio", "video", "text"))
    live = InferenceEngine(model, batch_buckets=ZOO_PREDICT, device=DEVICE)
    live.warmup()
    plain = InferenceEngine(model, batch_buckets=ZOO_PREDICT, device=DEVICE,
                            graphs=False)
    for n in ZOO_PREDICT:
        bits, total, _ = graph_vs_eager(torch, f"{name} predict at {n}",
                                        live.predict(*(f[:n] for f in feats)),
                                        plain.predict(*(f[:n] for f in feats)))
        if bits:
            raise AssertionError(f"{name} predict at {n}: {bits} of {total} "
                                 f"elements differ graphed vs eager")
    int8 = InferenceEngine(model, batch_buckets=ZOO_PREDICT, device=DEVICE,
                           quantize_weights=True)
    mu8 = int8.predict(*feats)["mu"]
    mu = live.predict(*feats)["mu"]
    deq = CompleteDEERModel(cfg)
    deq.load_state_dict(dequantize_tree(*quantize_tree(model.state_dict())))
    with torch.no_grad():
        mu_deq = deq.to(DEVICE).eval()(*(torch.from_numpy(f).to(DEVICE)
                                          for f in feats))["mu_all"]
    err = check_close(f"{name} int8 engine vs the dequantized weights",
                      torch.from_numpy(mu8), mu_deq.cpu(), *GRAPH_TOL)
    gap = float(np.abs(mu8 - mu).max())
    bound = INT8_MU_TOL if name not in INT8_UNNORMALIZED else None
    if not np.isfinite(mu8).all() or (bound is not None and gap >= bound):
        raise AssertionError(f"{name} int8: max |Δμ| {gap} (bound {bound})")
    print(f"zoo (a): {name}: graphed predict at {', '.join(map(str, ZOO_PREDICT))}"
          f" rows equal to eager in every bit; int8 engine vs the dequantized "
          f"weights in float max abs err {err:.3e}; int8 vs float max |Δμ| "
          f"{gap:.4f} ("
          + (f"bound {bound})" if bound is not None else
             "shown, not held: the fused features are not normalized)"))
    return model, p50


def phase_zoo(torch, k1, k3):
    """Phase 14: the model zoo and the rest of the front-end. (a) every
    fusion type and the stacked layout at the flagship's width, trained,
    served graphed and in int8, and the stacked forward on stack_params of
    the hierarchical model's weights; (b) the enhanced 84-d vectors through
    K1 against the plain twin, and the conv route; (c) the native WAV
    decoder against scipy; (d) UnifiedSequenceEncoder at 2,048 tokens
    (K3a) against flash off, and HierarchicalDEERFusionModel graphed
    against eager."""
    import tempfile

    from scipy.io import wavfile

    from tpu_deer_torch.data import audio_io, native
    from tpu_deer_torch.data.synthetic import benchmark_v2, make_synthetic_splits
    from tpu_deer_torch.graphs import GraphedCall
    from tpu_deer_torch.models.deer_model import CompleteDEERModel, DEERModelConfig
    from tpu_deer_torch.models.encoders import UnifiedSequenceEncoder
    from tpu_deer_torch.models.hierarchical_deer import create_hierarchical_deer_model
    from tpu_deer_torch.models.layers import init_flax_style_
    from tpu_deer_torch.models.stacked import stack_params
    from tpu_deer_torch.ops import audio_frontend as taf

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)

    # (a) the zoo.
    rows = make_synthetic_splits(benchmark_v2(
        n_train=ZOO_BATCH * ZOO_STEPS, n_val=8, n_test=8, seed=SEED))["train"]
    p50s, models = {}, {}
    for name, kw in ZOO_LAYOUTS.items():
        t0 = time.perf_counter()
        model, p50s[name] = zoo_layout(torch, name, kw, rows)
        if name == "hierarchical":
            models[name] = model
        print(f"zoo (a): {name} in {time.perf_counter() - t0:.1f} s")
    default = models["hierarchical"]
    stacked = CompleteDEERModel(DEERModelConfig(dropout=0.1, stacked_compute=True))
    stacked.load_state_dict(stack_params(default.state_dict()))
    stacked = stacked.to(DEVICE).eval()
    x = tuple(torch.from_numpy(rows[k][:max(ZOO_PREDICT)]).to(DEVICE)
              for k in ("audio", "video", "text"))
    with torch.no_grad():
        a, b = default(*x), stacked(*x)
    err = max(check_close(f"stacked vs default {k}", b[k], a[k], *GRAPH_TOL)
              for k in ("mu_all", "uncertainty_all", "calibrated_uncertainty",
                        "fused_features"))
    print(f"zoo (a): the stacked forward on stack_params of the trained "
          f"hierarchical weights vs the default forward at {max(ZOO_PREDICT)} "
          f"rows: max abs diff {err:.3e} (rtol, atol {GRAPH_TOL})")
    print("zoo (a): step p50 ms (graphed / eager): " + "; ".join(
        f"{n} {p['graphed']:.3f} / {p['eager']:.3f}" for n, p in p50s.items()))
    del default, stacked, models

    # (b) the enhanced vectors through K1, and the conv route.
    n = int(ENH_SECONDS * SR)
    sig = torch.from_numpy(np.stack([
        voice(rng, n, f0) for f0 in rng.uniform(90.0, 300.0, ENH_UTTERANCES)])
    ).to(DEVICE)
    k1.mfcc_signal.launches = 0
    vec = taf.extract_enhanced_utterance_features(sig)
    launches = k1.mfcc_signal.launches
    ref = taf.extract_enhanced_utterance_features(sig, plain=True)
    conv = taf.extract_enhanced_utterance_features(sig, path="conv")
    if DEVICE == "cuda" and launches != 1:
        raise AssertionError(f"enhanced features: {launches} K1 launches, want 1")
    if vec.shape != (ENH_UTTERANCES, 84) or not torch.isfinite(vec).all():
        raise AssertionError(f"enhanced features: shape {tuple(vec.shape)}")
    err_k1 = check_close("enhanced K1 vs plain", vec, ref, *FEAT_TOL)
    # The conv route is plain torch: cuDNN picks the convolution's
    # algorithm, which sums the 1,024 window taps in another order than the
    # plain twin's GEMMs. Its products are held as the reference holds its
    # own conv route against its frames route (K1_TOL); the vectors'
    # disagreement is shown (their rolloff and F0 entries are arg-max
    # functions of the spectrum, so a last-bit change can move a frame's
    # bin).
    for name, got, want, tol in zip(
            ("mfcc", "logmel", "power", "timefeats"),
            taf.mfcc_from_signal(sig, path="conv"),
            taf.mfcc_from_signal(sig, plain=True), K1_TOL):
        check_close(f"conv route {name} vs plain", got, want, *tol)
    beyond = (conv - ref).abs() > FEAT_TOL[1] + FEAT_TOL[0] * ref.abs()
    err_conv = float((conv - ref).abs().max())
    ms = {"K1": time_ms(lambda: taf.extract_enhanced_utterance_features(sig), 5, 1),
          "plain": time_ms(lambda: taf.extract_enhanced_utterance_features(
              sig, plain=True), 5, 1),
          "conv": time_ms(lambda: taf.extract_enhanced_utterance_features(
              sig, path="conv"), 5, 1)}
    print(f"zoo (b): enhanced 84-d vectors of {ENH_UTTERANCES} utterances of "
          f"{ENH_SECONDS:g} s: K1 launches {launches}; K1 vs plain twin max "
          f"abs err {err_k1:.3e} (bound {FEAT_TOL[1]} + {FEAT_TOL[0]}·|plain|); "
          f"conv route: products within K1_TOL of the plain twin's, vectors "
          f"max abs err {err_conv:.3e}, {int(beyond.sum())} of {beyond.numel()} "
          f"entries beyond that bound (columns "
          f"{sorted(set(torch.nonzero(beyond)[:, 1].tolist()))}); ms a batch "
          f"(CUDA events): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))

    # (c) the native decoder.
    t0 = time.perf_counter()
    lib = native.build()
    built = time.perf_counter() - t0
    if native.get_lib() is None or not lib.exists():
        raise AssertionError("the native decoder did not build or load")
    with tempfile.TemporaryDirectory(prefix="wavs_") as tmp:
        paths = []
        for sr in (44100, 48000):
            m = int(DECODE_SECONDS * sr)
            pcm = np.clip(rng.normal(size=(m, 2)) * 3000, -32768, 32767)
            paths.append(os.path.join(tmp, f"{sr}.wav"))
            wavfile.write(paths[-1], sr, pcm.astype(np.int16))
        for path in paths:
            got, decoder = audio_io.load_wav_with_decoder(path)
            other = audio_io.load_wav_scipy(path)
            if decoder != "native" or abs(len(got) - len(other)) > 1:
                raise AssertionError(f"{path}: decoder {decoder}, {len(got)} vs "
                                     f"{len(other)} samples")
            k = min(len(got), len(other))
            print(f"zoo (c): {os.path.basename(path)} stereo: the native "
                  f"decoder, {len(got)} samples at 16 kHz (scipy {len(other)}), "
                  f"max |native - scipy| {np.abs(got[:k] - other[:k]).max():.4f}")
        walls = {}
        for label, fn in (("native", audio_io.load_wav),
                          ("scipy", audio_io.load_wav_scipy)):
            with ThreadPoolExecutor(DECODE_THREADS) as pool:
                t0 = time.perf_counter()
                list(pool.map(fn, paths * (DECODES // len(paths))))
                walls[label] = time.perf_counter() - t0
    print(f"zoo (c): the native decoder built from native/wavio.cpp into "
          f"{os.path.relpath(lib, os.path.dirname(os.path.abspath(__file__)))} "
          f"in {built:.2f} s; {DECODES} decodes of {DECODE_SECONDS:g} s stereo "
          f"in {DECODE_THREADS} threads: native {walls['native']:.3f} s, scipy "
          f"{walls['scipy']:.3f} s ({walls['scipy'] / walls['native']:.1f}x)")

    # (d) the unified sequence encoder at 2,048 tokens, and the hierarchical
    # model graphed.
    enc = UnifiedSequenceEncoder()
    init_flax_style_(enc, torch.Generator().manual_seed(SEED))
    enc = enc.to(DEVICE).eval()
    lengths = rng.integers(UNIFIED_T // 4, UNIFIED_T + 1, UNIFIED_B)
    mask = (np.arange(UNIFIED_T)[None, :] < lengths[:, None]).astype(np.float32)
    inputs = {
        "audio_frames": torch.randn(UNIFIED_B, 188, 84, device=DEVICE),
        "video_frames": torch.rand(UNIFIED_B, 4, 32, 32, 3, device=DEVICE),
        "token_ids": torch.from_numpy(
            rng.integers(1, 30522, (UNIFIED_B, UNIFIED_T))).to(DEVICE),
        "text_mask": torch.from_numpy(mask).to(DEVICE)}
    k3.flash_attention_fwd.launches = 0
    with torch.no_grad():
        got = enc(**inputs)
        launches = k3.flash_attention_fwd.launches
        for block in enc.text.blocks:
            block.attn.use_flash = False
        ref = enc(**inputs)
    want = len(enc.text.blocks) if DEVICE == "cuda" else 0
    if launches != want or set(got) != set(ref):
        raise AssertionError(f"unified encoder: {launches} K3a launches, want "
                             f"{want}")
    err = max(check_close(f"unified {k} flash vs not", got[k], ref[k], *K3_TOL)
              for k in got)
    print(f"zoo (d): UnifiedSequenceEncoder (3 modalities, output 512) in eval "
          f"at batch {UNIFIED_B}, text {UNIFIED_T} tokens ({int(mask.sum())} "
          f"live): K3a launches {launches} (one a text layer); outputs vs "
          f"use_flash=False max abs err {err:.3e} (rtol, atol {K3_TOL})")
    hier = create_hierarchical_deer_model(seed=SEED, device=DEVICE)
    hx = tuple(rows[k][:HIER_BATCH] for k in ("audio", "video", "text"))

    def forward(a, v, t):
        return {k: o for k, o in hier(a, v, t).items() if torch.is_tensor(o)}

    with torch.inference_mode():
        eager_out = {k: o.cpu().numpy() for k, o in forward(
            *(torch.from_numpy(h).to(DEVICE) for h in hx)).items()}
    if DEVICE == "cuda":
        call = GraphedCall(forward, [(h.shape, torch.float32) for h in hx],
                           torch.device(DEVICE))
        graphed_out = call(*hx)
    else:
        graphed_out = eager_out
    bits, total, err = graph_vs_eager(torch, "HierarchicalDEERFusionModel",
                                      graphed_out, eager_out)
    gate = graphed_out["modality_gate"]
    if not np.allclose(gate.sum(-1), 1.0, atol=1e-5):
        raise AssertionError("HierarchicalDEERFusionModel: the gate is not a "
                             "softmax")
    print(f"zoo (d): HierarchicalDEERFusionModel forward at batch {HIER_BATCH} "
          f"graphed vs eager: {bits} of {total} elements differ in any bit, "
          f"max abs diff {err:.3e}")
    print(f"zoo: phase 14 in {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpu_deer_torch.kernels import build
    from tpu_deer_torch.kernels import embedding as emb
    from tpu_deer_torch.kernels import flash_attention as k3
    from tpu_deer_torch.kernels import mfcc_frames as k2
    from tpu_deer_torch.kernels import mfcc_signal as k1
    from tpu_deer_torch.kernels import quantize_int8 as k4
    from tpu_deer_torch.models.deer_model import create_complete_deer_model
    from tpu_deer_torch.ops import audio_frontend as taf

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        reports = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    print(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(KERNELS)} "
          f"(one nvcc each, in parallel)")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    record = phase_kernel(torch, taf, k1, reports["mfcc_signal"])
    record["launches"] = phase_slice(torch, k1)

    k2_record = phase_k2(torch, taf, k2, reports["mfcc_frames"])
    model = create_complete_deer_model(seed=SEED)
    detector = ood_detector(np.random.default_rng(SEED + 5))
    k2_record["launches"], rec, eager, chunks, video, text = phase_stream(
        torch, k2, model, detector)
    push_lat = phase_server(torch, model, detector)
    phase_stream_timing(torch, {"graphed": rec, "eager": eager}, chunks,
                        video, text, push_lat)

    k3_records = phase_k3(torch, build, k3)
    launches, emb_record = phase_train(torch, k1, k3, emb)
    for k3_record, n in zip(k3_records, launches[1:4]):
        k3_record["launches"] = n
    emb_record["launches"] = launches[4]

    k4_record = phase_k4(torch, k4)
    k4_record["launches"], err = phase_main(torch, k4)
    k4_record["max_abs_err"] = max(k4_record["max_abs_err"], err)
    phase_recipe(torch)
    phase_bench(torch, k1, k2)
    phase_ensemble(torch, (k1.mfcc_signal, k2.mfcc_frames, k3.flash_attention_fwd,
                           k3.flash_attention_bwd_dq, k3.flash_attention_bwd_dkv,
                           emb.embedding_grad, k4.quantize_int8_stochastic,
                           k4.quantize_int8_stochastic_bits))
    phase_corpus(torch, k1, k3, emb)
    phase_zoo(torch, k1, k3)

    print(card)
    print(json.dumps({"kernels": [record, k2_record, *k3_records, emb_record,
                                  k4_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
