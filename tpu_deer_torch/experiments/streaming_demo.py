"""Streaming capacity: concurrent real-time sessions on one card, through
the port.

    python -m tpu_deer_torch.experiments.streaming_demo
    python -m tpu_deer_torch.experiments.streaming_demo --quick --platform cpu

Twin of `experiments/streaming_demo.py`, with its flags, sizes and table:
S concurrent streams of `StreamingRecognizer` (S in 64, 256, 1,024 and
4,096; `--quick`: 2 and 4) advance by one 256 ms chunk a push, the tick a
CUDA graph on the card (K2 on every stream's frames, the incremental
features and the flagship forward). Per S: the tick's graph is captured
and warmed by one push, every stream is reset, and `--seconds` of audio
(10 chunks) are pushed and timed one push at a time: p50 and the
real-time factor RTF = S · chunk_s / p50 (S live sessions are sustained
where RTF ≥ S). After the pushes at the first S, the streams' features are
held against the offline extractor (`extract_utterance_features_batch`,
one K1 launch) on the same audio, for the first 8 streams.

Device-source capacity: K ticks (32; `--quick` 4) at the largest S chained
in one CUDA graph (`tick_chain_graph`): each tick draws its chunks on the
card from the default CUDA generator, which the capture registers with the
graph, so every replay draws new audio (no [K, S, chunk] buffer: 2.1 GiB at
S 4,096), runs `stream.py:streaming_update` (one K2 launch) and the
flagship on its features; a timing is one replay, one synchronize and the
fetch of the K per-tick mean μ. RTF = K · S · chunk_s / p50.

Differences from the reference: the model computes in bfloat16 on the card
and float32 on the CPU, as the reference's does on its TPU and CPU, with
TF32 off; `--platform` picks the card (`cuda`, the default; it raises
without one) or the CPU; results go to
`results_torch/RESULTS_stream_h100.{json,md}` (`--quick`: `..._quick`),
the platform line naming the card and its power limit. The reference wrote
Markdown only (`experiments/RESULTS_stream.md`, its pushes through a WAN
tunnel): the table keeps its columns, and no time of it is compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_deer_torch.experiments import twin

TABLE_HEADER = ("| concurrent streams S | push p50 (ms) | real-time factor "
                "| sustains S live sessions |")


def speech_like(rng: np.random.Generator, n: int, seconds: float, sr: int):
    """[n, T] synthetic speech-like signals with per-stream prosody (the
    reference's generator, draw for draw)."""
    t = np.arange(int(seconds * sr)) / sr
    out = np.empty((n, t.size), np.float32)
    for i in range(n):
        base = rng.uniform(90.0, 220.0)
        vib = rng.uniform(10.0, 60.0)
        f0 = base + vib * np.sin(2 * np.pi * rng.uniform(0.3, 1.5) * t)
        sig = np.zeros_like(t)
        for h in range(1, 5):
            sig += np.sin(2 * np.pi * h * np.cumsum(f0) / sr) / h
        sig *= 0.4 + 0.6 * np.sin(2 * np.pi * rng.uniform(0.8, 2.0) * t) ** 2
        out[i] = sig + 0.05 * rng.normal(size=t.shape)
    return out


def tick_chain(model, state, draw, ticks: int, cfg, plain: bool = False):
    """`ticks` ticks of S streams from `state`, tick k's chunks [S,
    chunk_samples] given by `draw(k)`; the model sees the audio features
    with zero video and text. Returns (the state after the ticks, features
    [K, S, 84], μ [K, S, 3])."""
    from tpu_deer_torch.stream import streaming_update

    mcfg = model.config
    feats, mus = [], []
    for k in range(ticks):
        c = draw(k)
        state, f = streaming_update(state, c, cfg, plain)
        z = lambda d: torch.zeros((c.shape[0], d), device=c.device)
        out = model(f, z(mcfg.video_dim), z(mcfg.text_dim))
        feats.append(f)
        mus.append(out["mu_all"])
    return state, torch.stack(feats), torch.stack(mus)


def drawn_chunks(n_streams: int, chunk: int, device):
    """Tick k's chunks drawn on the device, N(0, 1) float32 from the
    default generator of `device` (inside a CUDA graph the capture
    registers it, so each replay draws new ones)."""
    return lambda k: torch.randn((n_streams, chunk), device=device)


def tick_chain_graph(model, cfg, n_streams: int, ticks: int, device,
                     keep: bool = False):
    """`tick_chain` over `ticks` ticks of chunks drawn on the card, from a
    fresh (silent) state, as one CUDA graph (a `graphs.GraphedCall` with no
    inputs): a call replays it, synchronizes and returns {"mu_mean": [K]}
    (each tick's mean μ, the reference's scan output), with `keep` also the
    drawn "chunks" [K, S, chunk], "features" and "mu"."""
    from tpu_deer_torch.graphs import GraphedCall
    from tpu_deer_torch.stream import init_stream_state

    state0 = init_stream_state(cfg, n_streams, device)
    draw = drawn_chunks(n_streams, cfg.chunk_samples, device)

    def body():
        drawn = []

        def kept(k):
            drawn.append(draw(k))
            return drawn[-1]

        _, feats, mu = tick_chain(model, state0, kept if keep else draw,
                                  ticks, cfg)
        out = {"mu_mean": mu.mean(dim=(1, 2))}
        if keep:
            out.update(chunks=torch.stack(drawn), features=feats, mu=mu)
        return out

    return GraphedCall(body, [], device)


def push_timings(model, scfg, S: int, audio: np.ndarray, n_chunks: int,
                 device):
    """(recognizer, per-push seconds, the last push's outputs): the tick
    captured and warmed by one push, every stream reset, then n_chunks
    timed pushes of `audio`."""
    from tpu_deer_torch.stream import StreamingRecognizer

    chunk = scfg.chunk_samples
    rec = StreamingRecognizer(model, n_streams=S, cfg=scfg, device=device)
    rec.warmup()
    rec.push(audio[:, :chunk])
    rec.reset_streams(np.arange(S))
    times, out = [], None
    for c in range(n_chunks):
        sl = audio[:, c * chunk:(c + 1) * chunk]
        t0 = time.perf_counter()
        out = rec.push(sl)
        times.append(time.perf_counter() - t0)
    return rec, times, out


def feature_correlation(streamed: np.ndarray, used: np.ndarray, scfg,
                        device) -> float:
    """Mean over rows of the correlation between streamed features and the
    offline extractor's on the same audio `used` [n, T] (one K1 launch)."""
    from tpu_deer_torch.ops.audio_frontend import extract_utterance_features_batch

    offline = extract_utterance_features_batch(
        torch.from_numpy(np.ascontiguousarray(used)).to(device),
        scfg.frontend).cpu().numpy()
    return float(np.mean([np.corrcoef(streamed[i], offline[i])[0, 1]
                          for i in range(len(offline))]))


def main(argv=None) -> int:
    p = twin.parser(__doc__, "stream")
    p.add_argument("--seconds", type=float, default=2.56)
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "stream")

    from tpu_deer_torch.kernels import mfcc_frames as k2
    from tpu_deer_torch.kernels import mfcc_signal as k1
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        create_complete_deer_model,
    )
    from tpu_deer_torch.stream import StreamingConfig

    scfg = StreamingConfig()
    sr = scfg.frontend.sample_rate
    chunk_s = scfg.chunk_samples / sr
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    model = create_complete_deer_model(DEERModelConfig(compute_dtype=dtype),
                                       seed=0, device=device)
    sizes = [2, 4] if args.quick else [64, 256, 1024, 4096]
    rng = np.random.default_rng(0)
    n_chunks = max(2, int(args.seconds * sr) // scfg.chunk_samples)
    rows, check_corr, k1_launches = [], None, 0
    for S in sizes:
        audio = speech_like(rng, S, n_chunks * chunk_s, sr)
        rec, times, out = push_timings(model, scfg, S, audio, n_chunks, device)
        p50 = float(np.percentile(times, 50))
        rtf = S * chunk_s / p50
        rows.append({"streams": S, "push_p50_ms": p50 * 1e3, "rtf": rtf,
                     "sustains": bool(rtf >= S),
                     "capture_s": rec.capture_s})
        print(f"S={S:5d}: push p50 {p50 * 1e3:8.3f} ms  RTF {rtf:12,.0f}x "
              f"{'(sustains all S live)' if rtf >= S else ''}", flush=True)
        if check_corr is None:
            n = min(S, 8)
            before = k1.mfcc_signal.launches
            check_corr = feature_correlation(
                out["features"][:n],
                audio[:n, :n_chunks * scfg.chunk_samples], scfg, device)
            k1_launches = k1.mfcc_signal.launches - before
            print(f"  feature corr vs offline extractor: {check_corr:.6f}")
        del rec
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # Device-source capacity: K ticks chained in one graph, chunks drawn
    # on the card; a timing is one replay, one synchronize, one fetch.
    S_dev = sizes[-1]
    K = 4 if args.quick else 32
    torch.manual_seed(0)
    before = k2.mfcc_frames.launches
    if device.type == "cuda":
        chain = tick_chain_graph(model, scfg, S_dev, K, device)
        run_chain = lambda: chain()["mu_mean"]
        capture_s = chain.capture_s
    else:
        from tpu_deer_torch.stream import init_stream_state

        state0 = init_stream_state(scfg, S_dev, device)
        draw = drawn_chunks(S_dev, scfg.chunk_samples, device)
        capture_s = None

        def run_chain():
            with torch.inference_mode():
                mu = tick_chain(model, state0, draw, K, scfg)[2]
                return mu.mean(dim=(1, 2)).numpy()
    run_chain()
    wrapper_launches = k2.mfcc_frames.launches - before
    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        mus = run_chain()
        dts.append(time.perf_counter() - t0)
    if not np.isfinite(mus).all():
        raise AssertionError(f"non-finite per-tick mean μ: {mus}")
    dev_t = float(np.percentile(dts, 50))
    dev_rtf = K * S_dev * chunk_s / dev_t
    print(f"device-source capacity: {dev_rtf:,.0f}x real time ({S_dev} "
          f"streams x {K} ticks per replay, {dev_t * 1e3:.3f} ms)")

    best = max(r["rtf"] for r in rows)
    payload = {
        "platform": platform, "compute_dtype": dtype, "n_chunks": n_chunks,
        "chunk_ms": chunk_s * 1e3, "feature_corr": check_corr,
        "k1_launches_offline": k1_launches, "rows": rows,
        "peak_rtf": best,
        "device_source": {"streams": S_dev, "ticks": K,
                          "replay_ms": dev_t * 1e3, "rtf": dev_rtf,
                          "capture_s": capture_s,
                          "k2_wrapper_launches": wrapper_launches,
                          "mu_mean": mus.tolist()},
    }
    md = [
        "# Streaming real-time capacity — the port on the card",
        "",
        f"- platform: **{platform}**, {n_chunks} chunks x "
        f"{chunk_s * 1e3:.0f} ms per stream; flagship model ({dtype}) in the "
        "loop",
        "- one push = one replay of the tick's CUDA graph: K2 on every "
        "stream's frames, the incremental features and the forward for ALL "
        "streams (`tpu_deer_torch/stream.py`), numpy in and out",
        "- streaming features match the offline extractor (K1): mean "
        f"correlation **{check_corr:.6f}** over the first "
        f"{min(sizes[0], 8)} streams (the reference read 1.0000)",
        "",
        TABLE_HEADER,
        "|---|---|---|---|",
    ]
    for r in rows:
        md.append(f"| {r['streams']} | {r['push_p50_ms']:.3f} | "
                  f"{r['rtf']:,.0f}x | {'yes' if r['sustains'] else 'no'} |")
    md += [
        "",
        f"Peak end to end: **{best:,.0f}x real time** (numpy chunks in, "
        "outputs back, on one host).",
        "",
        f"Device-source capacity (chunks drawn on the card, {K} ticks x "
        f"{S_dev} streams chained in one CUDA graph, one replay, one "
        f"synchronize): {dev_t * 1e3:.3f} ms a replay, **{dev_rtf:,.0f}x "
        f"real time** — the card sustains ~{dev_rtf:,.0f} concurrent live "
        "sessions at this tick.",
        "",
        "The reference's table (`experiments/RESULTS_stream.md`) was taken "
        "on its TPU through a WAN tunnel; no time of it is compared here.",
        "",
        "Reproduce: `python -m tpu_deer_torch.experiments.streaming_demo` on "
        "the card (`--quick --platform cpu` for a CPU smoke).",
    ]
    twin.write(args.out, md, payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
