"""Server load: concurrent-client latency and throughput over HTTP, through
the port.

    python -m tpu_deer_torch.experiments.server_load
    python -m tpu_deer_torch.experiments.server_load --quick --platform cpu

Twin of `experiments/server_load.py`, with its flags, grid and payload
keys: an in-process `ThreadingHTTPServer` (`server.py:serve`) over an
`InferenceEngine` whose buckets are all captured as CUDA graphs before the
first client starts (`engine.warmup()`), hammered by N client threads
behind a barrier, each posting sequential single-row `POST /predict`
requests over real sockets with `urllib`. Clients 1, 4, 16 and 64 × 40
requests (`--quick`: 1, 4, 16 × 10 on a narrow model), serialized and then
micro-batched (`MicroBatcher`, max_batch 256, `--max_wait_ms` 2.0,
`--pipeline_depth` 2), with each cell's rows-per-dispatch delta. Every
latency is the client's: JSON, socket, validation, the bucket's replay and
the copy back. The clients are threads of the server's own process, as the
reference's are, so a cell's req/s is this harness's: the clients' JSON
and socket work shares one GIL with the server's, and the run does not
profile the host to split the two.

Differences from the reference: the flagship computes in float32 with TF32
off on the card (`--platform cuda`, the default; it raises without one) or
on the CPU (`--platform cpu`); results go to
`results_torch/RESULTS_serving_h100.{json,md}` (`--quick`: `..._quick`),
and `platform` names the card and its power limit. The reference's times
went through a WAN tunnel (about 189 ms a round trip), so only the shape
of its result is compared: micro-batching raises throughput and cuts p99 at
the largest client count.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import numpy as np

from tpu_deer_torch.experiments import twin

MODALITIES = ("audio", "video", "text")


def post(url: str, payload: dict, timeout: float = 300.0) -> dict:
    req = urllib.request.Request(
        url + "/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def make_service(micro_batch: bool, quick: bool, max_wait_ms: float,
                 pipeline_depth: int, device):
    """(PredictionService, model config): the flagship (narrow under
    `quick`) from seed 0, every bucket warmed before serving."""
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        create_complete_deer_model,
    )
    from tpu_deer_torch.serve import InferenceEngine
    from tpu_deer_torch.server import PredictionService

    cfg = (DEERModelConfig(audio_dim=16, video_dim=16, text_dim=16,
                           encoder_dim=32, fusion_dim=64, attention_heads=4,
                           encoder_layers=1)
           if quick else DEERModelConfig())
    engine = InferenceEngine(create_complete_deer_model(cfg, seed=0,
                                                        device=device),
                             device=device)
    engine.warmup()
    return PredictionService(
        engine, (cfg.audio_dim, cfg.video_dim, cfg.text_dim),
        micro_batch=micro_batch, max_batch=256, max_wait_ms=max_wait_ms,
        pipeline_depth=pipeline_depth), cfg


def client_row(dims) -> dict:
    """The single row every client posts (the reference's, seed 0)."""
    rng = np.random.default_rng(0)
    return {name: rng.standard_normal(d).astype(np.float32).tolist()
            for name, d in zip(MODALITIES, dims)}


def run_cell(url: str, row: dict, n_clients: int, reqs_per_client: int,
             responses: list | None = None) -> dict:
    """N client threads × M sequential single-row requests; the
    client-observed latency quantiles and the aggregate throughput.
    `responses`, where given, gathers every reply."""
    latencies = [[] for _ in range(n_clients)]
    barrier = threading.Barrier(n_clients + 1)
    errors: list = []

    def client(i: int):
        try:
            barrier.wait()
            for _ in range(reqs_per_client):
                t0 = time.perf_counter()
                out = post(url, row)
                latencies[i].append(time.perf_counter() - t0)
                assert len(out["mu"]) == 1
                if responses is not None:
                    responses.append(out)
        except Exception as e:  # noqa: BLE001 — raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    lat = np.concatenate([np.asarray(l) for l in latencies]) * 1e3
    return {
        "n_clients": n_clients,
        "requests": int(lat.size),
        "p50_ms": float(np.percentile(lat, 50)),
        "p95_ms": float(np.percentile(lat, 95)),
        "p99_ms": float(np.percentile(lat, 99)),
        "mean_ms": float(lat.mean()),
        "throughput_rps": float(lat.size / wall),
        "wall_s": float(wall),
    }


def serve_cells(service, dims, client_grid, reqs: int, responses=None,
                log=print) -> list[dict]:
    """Start an HTTP server on an ephemeral port for `service`, warm one
    connection, run every cell of `client_grid` (with the micro-batcher's
    per-cell dispatch deltas), and shut the server down."""
    from tpu_deer_torch.server import serve

    server = serve(service, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    row = client_row(dims)
    rows = []
    try:
        post(url, {n: [0.0] * d for n, d in zip(MODALITIES, dims)})
        for n in client_grid:
            b = service.batcher
            b0 = (b.batches_dispatched, b.rows_dispatched) if b else (0, 0)
            cell = run_cell(url, row, n, reqs, responses)
            if b is not None:
                d_batches = b.batches_dispatched - b0[0]
                cell["dispatches"] = d_batches
                cell["rows_per_dispatch"] = ((b.rows_dispatched - b0[1])
                                             / max(d_batches, 1))
            log(f"clients={n:3d} p50 {cell['p50_ms']:8.2f} ms  p99 "
                f"{cell['p99_ms']:8.2f} ms  {cell['throughput_rps']:8.1f} "
                "req/s" + (f"  {cell['rows_per_dispatch']:.1f} rows/dispatch"
                           if "rows_per_dispatch" in cell else ""))
            rows.append(cell)
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    return rows


def run(quick: bool, max_wait_ms: float, pipeline_depth: int, device,
        platform: str, client_grid=None, reqs=None, responses=None) -> dict:
    """Both modes over the client grid (the reference's unless given);
    `responses` gathers every reply where given."""
    client_grid = client_grid or ((1, 4, 16) if quick else (1, 4, 16, 64))
    reqs = reqs or (10 if quick else 40)
    results: dict[str, list] = {}
    mb_stats: dict[str, dict] = {}
    for mode, micro in (("serialized", False), ("micro_batch", True)):
        service, cfg = make_service(micro, quick, max_wait_ms, pipeline_depth,
                                    device)
        try:
            results[mode] = serve_cells(
                service, (cfg.audio_dim, cfg.video_dim, cfg.text_dim),
                client_grid, reqs, responses,
                log=lambda line, m=mode: print(f"[{m}] {line}", flush=True))
        finally:
            if service.batcher is not None:
                b = service.batcher
                mb_stats[mode] = {"batches_dispatched": b.batches_dispatched,
                                  "rows_dispatched": b.rows_dispatched}
                b.close()
    return {
        "platform": platform,
        "quick": quick,
        "max_wait_ms": max_wait_ms,
        "pipeline_depth": pipeline_depth,
        "reqs_per_client": reqs,
        "results": results,
        "micro_batch_stats": mb_stats,
    }


def report(payload: dict) -> list[str]:
    res = payload["results"]
    ref = twin.reference("serving")
    md = [
        "# Serving load study — concurrent clients over HTTP, the port",
        "",
        f"- platform: **{payload['platform']}** | single-row POST /predict | "
        f"{payload['reqs_per_client']} requests/client | micro-batch max_wait "
        f"{payload['max_wait_ms']} ms, max_batch 256, pipeline_depth "
        f"{payload['pipeline_depth']} | in-process ThreadingHTTPServer + "
        "`InferenceEngine` with every bucket a CUDA graph captured before "
        "the clients start (float32, TF32 off).",
        "- Latencies are client-observed (JSON + socket + validation + the "
        "bucket's replay + the copy back), over localhost. Generated by "
        "`python -m tpu_deer_torch.experiments.server_load`.",
        "- The clients are threads of the server's process, so req/s is "
        "this in-process harness's throughput: the clients' own JSON and "
        "socket work shares the server's GIL, and no host profile splits "
        "the two. It is not the server's capacity alone.",
        "",
        "| clients | mode | p50 ms | p95 ms | p99 ms | p99/p50 | req/s | "
        "rows/dispatch |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for i, cell in enumerate(res["serialized"]):
        for mode in ("serialized", "micro_batch"):
            c = res[mode][i]
            rpd = (f"{c['rows_per_dispatch']:.1f}"
                   if "rows_per_dispatch" in c else "—")
            md.append(
                f"| {c['n_clients']} | {mode} | {c['p50_ms']:.2f} | "
                f"{c['p95_ms']:.2f} | {c['p99_ms']:.2f} | "
                f"{c['p99_ms'] / c['p50_ms']:.2f} | "
                f"{c['throughput_rps']:.1f} | {rpd} |")
    smax, mmax = res["serialized"][-1], res["micro_batch"][-1]
    md += [
        "",
        "rows/dispatch is the per-cell coalescing delta (the dispatch "
        "counters read around each cell).",
        "",
        "## Reading",
        "",
        f"- At {smax['n_clients']} clients, micro-batching moves p99 from "
        f"{smax['p99_ms']:.2f} ms to {mmax['p99_ms']:.2f} ms and throughput "
        f"from {smax['throughput_rps']:.0f} to {mmax['throughput_rps']:.0f} "
        "req/s.",
    ]
    if ref and not payload["quick"]:
        rs, rm = ref["results"]["serialized"][-1], ref["results"]["micro_batch"][-1]
        same = ((mmax["throughput_rps"] > smax["throughput_rps"])
                == (rm["throughput_rps"] > rs["throughput_rps"])
                and (mmax["p99_ms"] < smax["p99_ms"])
                == (rm["p99_ms"] < rs["p99_ms"]))
        md.append(
            f"- The reference's run (`experiments/RESULTS_serving.json`, its "
            f"TPU through a WAN tunnel of about 189 ms a round trip, so no "
            f"time of it is compared): at {rs['n_clients']} clients "
            f"micro-batching took throughput from {rs['throughput_rps']:.0f} "
            f"to {rm['throughput_rps']:.0f} req/s and p99 from "
            f"{rs['p99_ms']:.0f} to {rm['p99_ms']:.0f} ms. The shape of this "
            f"run's result {'agrees' if same else 'does not agree'} with it.")
    md += ["", "Reproduce: `python -m tpu_deer_torch.experiments.server_load` "
               "on the card (`--quick --platform cpu` for a CPU smoke)."]
    return md


def main(argv=None) -> int:
    p = twin.parser(__doc__, "serving")
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="micro-batch dispatch waves in flight at once")
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "serving")
    payload = run(args.quick, args.max_wait_ms, args.pipeline_depth, device,
                  platform)
    twin.write(args.out, report(payload), payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
