"""Minimal HTTP serving endpoint over the port's inference engines.

Port of `tpu_deer/server.py`, with nothing beyond the standard library:

  POST /predict   {"audio": [[..84..]], "video": [[..256..]], "text": [[..768..]]}
                  -> {"mu": [[v,a,d]..], "uncertainty": ..,
                      "calibrated_uncertainty": .., "expected_abs_error": ..,
                      "serving_channel": "calibrated"|"eabs",
                      "deployable_uncertainty": ..}
                  (+ ood_score/is_ood with an OOD detector on the engine,
                   + interval_lower/interval_upper/interval_alpha with a
                   conformal spec: split conformal intervals with 1-alpha
                   marginal coverage, widths scaled per sample by the NIG
                   uncertainty)
  GET  /healthz   -> {"status": "ok", "requests_served": N, ...}

With a StreamingSessionService, live audio sessions:

  POST /stream/start {"video": [..]?, "text": [..]?} -> {"session_id": ..}
  POST /stream/push  {"session_id": .., "audio": [chunk floats]} (or
                     "pcm16_b64": base64 int16 LE PCM)
                     -> {"mu": [v,a,d], "uncertainty": ..,
                         "calibrated_uncertainty": .., "expected_abs_error":
                         .., "serving_channel": .., "deployable_uncertainty": ..}
                     (+ ood_score/is_ood, + intervals, as /predict)
  POST /stream/end   {"session_id": ..} -> {"ended": true}

Concurrent session pushes coalesce into one shared recognizer tick (the
StreamingSessionService dispatcher sets the active-slot mask), so N live
sessions cost one tick, and one K2 launch, per round.

Without micro-batching the handler serializes /predict through a lock: the
engine pads each request to a batch bucket, so one batch in flight is the
concurrency model. With `micro_batch=True`, concurrent requests are
coalesced by a dispatcher thread into waves of up to `max_batch` rows.

A service is built from a trainer's checkpoint
(`PredictionService.from_checkpoint`, with live sessions where
`stream_slots` is given) or from an exported artifact (`from_exported`,
`tpu_deer_torch.export`). `--ensemble K` serves a stacked K-member
checkpoint (`cli --ensemble K`) as one ensemble; it needs `--checkpoint`
and takes no `--stream_slots` (a session streams one parameter set). On
the card every serving bucket and the stream tick replay CUDA graphs,
captured at start-up unless `--no_warmup`:

    python -m tpu_deer_torch.server --checkpoint <models dir> [--stream_slots 64]
    python -m tpu_deer_torch.server --checkpoint <models dir> --ensemble 4
    python -m tpu_deer_torch.server --exported <export dir>
    python -m tpu_deer_torch.server --exported <export dir> --platform cpu
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from tpu_deer_torch.device import DeviceLike
from tpu_deer_torch.stream import StreamingConfig, StreamingRecognizer

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 64 * 1024 * 1024  # 64 MB request cap


def _close_dispatcher(d, reason: str) -> None:
    """Shared shutdown for the queue-dispatcher services (MicroBatcher,
    StreamingSessionService): mark closed, wake the dispatcher with the
    sentinel, join, and fail whatever is still queued.

    The drain only runs once the dispatcher thread has exited: `_carry` and
    the sentinel are dispatcher-private state, and draining while it is
    mid-dispatch would race it and could leave it parked on an empty queue
    forever. If the join times out, leftovers are the dispatcher's to
    finish; waiting callers fall back to their own result timeouts."""
    with d._close_lock:
        if d._closed:
            return
        d._closed = True
        d.queue.put(None)  # wake the dispatcher
    if d._thread is not None:
        d._thread.join(timeout=30.0)
        if d._thread.is_alive():
            logger.warning(
                "%s: dispatcher still busy after 30s; leaving queue to it",
                reason,
            )
            return
    pool = getattr(d, "_pool", None)
    if pool is not None:
        pool.shutdown(wait=True)  # in-flight dispatch waves finish first
    exc = RuntimeError(reason)
    leftovers = list(d._carry)
    d._carry.clear()
    while True:
        try:
            item = d.queue.get_nowait()
        except queue.Empty:
            break
        if item is not None:
            leftovers.append(item)
    for item in leftovers:
        fut = item[-1]
        if not fut.done():
            fut.set_exception(exc)


class MicroBatcher:
    """Coalesces concurrent predict requests into single engine calls.

    Request threads call `submit(audio, video, text)` and block on the
    returned Future. One dispatcher thread drains the queue: it takes the
    first waiting request, then keeps collecting until `max_batch` rows are
    assembled or the straggler window elapses, concatenates, and hands the
    wave to a small dispatch pool that runs `engine.predict` and scatters
    the row slices back to each Future.

    Tail-latency controls:
      * `pipeline_depth` waves may be in flight at once (default 2): while
        wave k runs on the device and its outputs come back, the dispatcher
        already assembles wave k+1.
      * the `max_wait_ms` straggler window adapts to load: when the EWMA of
        rows per dispatch reaches `adaptive_rows`, the dispatch cadence
        itself batches arrivals, so the window shrinks to zero; it re-opens
        when load drops.
    """

    def __init__(self, engine, max_batch: int = 256, max_wait_ms: float = 2.0,
                 start: bool = True, pipeline_depth: int = 2,
                 adaptive_rows: float = 8.0):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.adaptive_rows = adaptive_rows
        self.queue: "queue.Queue" = queue.Queue()
        self.batches_dispatched = 0
        self.rows_dispatched = 0
        self._rows_ewma = 0.0  # dispatcher-thread-only
        self._closed = False
        self._close_lock = threading.Lock()
        # Items deferred by the dispatcher (max_batch overshoot), processed
        # before new queue items so request order is preserved.
        # Dispatcher-thread-only: no lock.
        self._carry: list = []
        self._depth = max(1, int(pipeline_depth))
        self._pool = ThreadPoolExecutor(
            max_workers=self._depth, thread_name_prefix="microbatch-dispatch"
        )
        self._inflight = threading.Semaphore(self._depth)
        self._thread = None
        if start:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def submit(self, audio, video, text) -> Future:
        fut: Future = Future()
        # The closed-check and the put must be atomic vs close(): otherwise
        # an item can land behind the shutdown sentinel and its future would
        # never resolve.
        with self._close_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self.queue.put((audio, video, text, fut))
        return fut

    def close(self):
        _close_dispatcher(self, "MicroBatcher is closed")

    def flush(self):
        """Block until every in-flight dispatch wave has completed."""
        for _ in range(self._depth):
            self._inflight.acquire()
        for _ in range(self._depth):
            self._inflight.release()

    # -- dispatcher ------------------------------------------------------
    def _loop(self):
        while True:
            if not self._carry:
                item = self.queue.get()
                if item is None:
                    return  # close() fails any leftovers after join
                self._carry.append(item)
            if self._drain_once() < 0:
                return

    def _drain_once(self):
        """Collect one coalesced batch (carry first, then the queue) and
        dispatch it. Returns rows dispatched, or -1 after the shutdown
        sentinel."""
        if not self._carry:
            item = self.queue.get()
            if item is None:
                return -1
            self._carry.append(item)
        # The head request is taken unconditionally (a single request larger
        # than max_batch still runs; bucketed_predict chunks it). Further
        # requests are added only while the total stays within max_batch.
        batch = [self._carry.pop(0)]
        rows = len(batch[0][0])
        while self._carry and rows + len(self._carry[0][0]) <= self.max_batch:
            item = self._carry.pop(0)
            batch.append(item)
            rows += len(item[0])
        saw_sentinel = False
        wait_s = 0.0 if self._rows_ewma >= self.adaptive_rows else self.max_wait_s
        deadline = time.monotonic() + wait_s
        while rows < self.max_batch and not self._carry:
            remaining = deadline - time.monotonic()
            try:
                item = (
                    self.queue.get_nowait()
                    if remaining <= 0
                    else self.queue.get(timeout=remaining)
                )
            except queue.Empty:
                break
            if item is None:  # close() sentinel: dispatch what we have
                saw_sentinel = True
                break
            if rows + len(item[0]) > self.max_batch:
                self._carry.append(item)  # next batch, order preserved
                break
            batch.append(item)
            rows += len(item[0])
        self.batches_dispatched += 1
        self.rows_dispatched += rows
        self._rows_ewma = 0.9 * self._rows_ewma + 0.1 * rows
        # Bounded pipelining: wait for a free dispatch slot (at most
        # pipeline_depth waves in flight), then hand the wave off and go
        # back to assembling the next one.
        self._inflight.acquire()
        self._pool.submit(self._dispatch_wave, batch)
        return -1 if saw_sentinel else rows

    def _dispatch_wave(self, batch):
        try:
            a = np.concatenate([b[0] for b in batch])
            v = np.concatenate([b[1] for b in batch])
            t = np.concatenate([b[2] for b in batch])
            out = self.engine.predict(a, v, t)
            off = 0
            for ba, _, _, fut in batch:
                n = len(ba)
                fut.set_result({k: val[off : off + n] for k, val in out.items()})
                off += n
        except Exception as e:  # noqa: BLE001 — fail every waiting request
            for *_, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
        finally:
            self._inflight.release()


class StreamingSessionService:
    """Live audio sessions over HTTP, coalesced into shared recognizer ticks.

    Each session owns one slot of a `StreamingRecognizer`. Client pushes
    (one fixed-size PCM chunk per call) enqueue; a dispatcher thread drains
    them into one recognizer tick with the active-slot mask set, so N
    concurrent sessions cost one tick, not N. A slot's second push in the
    same drain is deferred a tick to keep per-session chunk order.

    Concurrency model: all recognizer-state mutations (ticks and session
    end/reset) run on the dispatcher thread, in queue order. A slot is
    freed only when its "end" request is processed, so a slot cannot be
    reassigned while chunks for its previous session are still queued, and
    an end can never race a tick. sid → slot is resolved at dispatch time.
    """

    def __init__(self, model, n_streams: int = 64,
                 stream_cfg: Optional[StreamingConfig] = None,
                 max_wait_ms: float = 10.0, start: bool = True,
                 warmup: bool = True, push_timeout_s: float = 600.0,
                 ood_detector=None, ood_fpr: float = 0.01,
                 serving_channel: str = "eabs", device: DeviceLike = None):
        """model: a CompleteDEERModel with its weights, served on `device`
        (None = the CUDA card; the tick replays a CUDA graph there).
        serving_channel is mirrored into every tick response, as /predict
        does."""
        self.serving_channel = serving_channel
        self.cfg = stream_cfg or StreamingConfig()
        self.rec = StreamingRecognizer(
            model, n_streams=n_streams, cfg=self.cfg,
            ood_detector=ood_detector, ood_fpr=ood_fpr, device=device,
        )
        self.push_timeout_s = push_timeout_s
        mcfg = model.config
        if warmup:
            # Build the kernel (nvcc at first use) and capture the tick's
            # graph before the dispatcher thread starts, as the reference
            # compiles its tick here.
            self.rec.warmup()
        self.n_streams = n_streams
        self.chunk_samples = self.cfg.chunk_samples
        self._video = np.zeros((n_streams, mcfg.video_dim), np.float32)
        self._text = np.zeros((n_streams, mcfg.text_dim), np.float32)
        self.lock = threading.Lock()
        self.sessions: dict[str, int] = {}
        self._free = list(range(n_streams - 1, -1, -1))
        self.max_wait_s = max_wait_ms / 1e3
        self.ticks = 0
        self.queue: "queue.Queue" = queue.Queue()
        self._carry: list = []  # dispatcher-thread-only deferred items
        self._closed = False
        self._close_lock = threading.Lock()
        self._thread = None
        if start:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    # -- session lifecycle ----------------------------------------------
    def start(self, video=None, text=None) -> str:
        with self.lock:
            if not self._free:
                raise ValueError(
                    f"no free stream slots (capacity {self.n_streams})"
                )
            slot = self._free.pop()
            sid = uuid.uuid4().hex[:16]
            self.sessions[sid] = slot
            if video is not None:
                self._video[slot] = video
            if text is not None:
                self._text[slot] = text
        return sid

    def end(self, sid: str) -> None:
        with self.lock:
            if sid not in self.sessions:
                raise ValueError(f"unknown session {sid!r}")
        self._enqueue(("end", sid, None, Future())).result(
            timeout=self.push_timeout_s
        )

    def set_context(self, sid: str, video=None, text=None) -> None:
        """Refresh a live session's video/text context features; takes
        effect from the next tick."""
        with self.lock:
            slot = self.sessions.get(sid)
            if slot is None:
                raise ValueError(f"unknown session {sid!r}")
            if video is not None:
                self._video[slot] = video
            if text is not None:
                self._text[slot] = text

    def push(self, sid: str, chunk: np.ndarray, video=None, text=None) -> dict:
        if video is not None or text is not None:
            self.set_context(sid, video=video, text=text)
        with self.lock:
            if sid not in self.sessions:
                raise ValueError(f"unknown session {sid!r}")
        if chunk.shape != (self.chunk_samples,):
            raise ValueError(
                f"audio chunk must be [{self.chunk_samples}] samples, "
                f"got {list(chunk.shape)}"
            )
        fut = self._enqueue(("push", sid, chunk.astype(np.float32), Future()))
        return fut.result(timeout=self.push_timeout_s)

    def _enqueue(self, item) -> Future:
        # Atomic closed-check + put (see MicroBatcher.submit).
        with self._close_lock:
            if self._closed:
                raise RuntimeError("StreamingSessionService is closed")
            self.queue.put(item)
        return item[3]

    def close(self):
        _close_dispatcher(self, "StreamingSessionService is closed")

    # -- tick dispatcher -------------------------------------------------
    def _loop(self):
        while True:
            if not self._carry:
                item = self.queue.get()
                if item is None:
                    return  # close() fails any leftovers after join
                self._carry.append(item)
            if self._tick() < 0:
                return

    def _process_end(self, sid: str, fut: Future) -> None:
        """Runs on the dispatcher: reset state, then free the slot (so a
        new session can only take it after the reset is visible)."""
        with self.lock:
            slot = self.sessions.pop(sid, None)
        if slot is None:
            fut.set_exception(ValueError(f"unknown session {sid!r}"))
            return
        try:
            self.rec.reset_streams([slot])
            with self.lock:
                self._video[slot] = 0.0
                self._text[slot] = 0.0
                self._free.append(slot)
            fut.set_result(True)
        except Exception as e:  # noqa: BLE001
            fut.set_exception(e)

    def _tick(self):
        """Process the next request: an end, or one coalesced tick of
        pushes (at most one chunk per session). Returns items handled, -1
        on the shutdown sentinel."""
        if not self._carry:
            item = self.queue.get()
            if item is None:
                return -1
            self._carry.append(item)
        head = self._carry.pop(0)
        if head[0] == "end":
            self._process_end(head[1], head[3])
            return 1
        batch = {head[1]: head}  # sid -> item
        saw_sentinel = False
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.n_streams and not self._carry:
            remaining = deadline - time.monotonic()
            try:
                item = (
                    self.queue.get_nowait()
                    if remaining <= 0
                    else self.queue.get(timeout=remaining)
                )
            except queue.Empty:
                break
            if item is None:
                saw_sentinel = True
                break
            if item[0] == "end" or item[1] in batch:
                # Ends and same-session repeats wait for the next round;
                # _carry is drained before new queue items, so per-session
                # order is preserved.
                self._carry.append(item)
                break
            batch[item[1]] = item

        chunks = np.zeros((self.n_streams, self.chunk_samples), np.float32)
        active = np.zeros(self.n_streams, bool)
        slot_of = {}
        with self.lock:
            for sid, (_, _, chunk, fut) in list(batch.items()):
                slot = self.sessions.get(sid)
                if slot is None:  # ended while queued
                    batch.pop(sid)
                    fut.set_exception(ValueError(f"unknown session {sid!r}"))
                    continue
                slot_of[sid] = slot
                chunks[slot] = chunk
                active[slot] = True
            video, text = self._video.copy(), self._text.copy()
        if batch:
            try:
                out = self.rec.push(
                    chunks, video=video, text=text, active=active
                )
                self.ticks += 1
                keys = ["mu", "uncertainty", "calibrated_uncertainty",
                        "expected_abs_error"]
                thr = self.rec.ood_threshold
                if thr is not None:
                    keys.append("ood_score")
                alias = (
                    "calibrated_uncertainty"
                    if self.serving_channel == "calibrated"
                    else "expected_abs_error"
                )
                for sid, (_, _, _, fut) in batch.items():
                    slot = slot_of[sid]
                    resp = {k: out[k][slot].tolist() for k in keys}
                    resp["serving_channel"] = self.serving_channel
                    resp["deployable_uncertainty"] = resp[alias]
                    if thr is not None:
                        resp["is_ood"] = bool(out["ood_score"][slot] > thr)
                    fut.set_result(resp)
            except Exception as e:  # noqa: BLE001
                for _, _, _, fut in batch.values():
                    if not fut.done():
                        fut.set_exception(e)
        return -1 if saw_sentinel else len(batch)


class PredictionService:
    """Engine wrapper with input validation and request accounting."""

    def __init__(self, engine, dims: tuple[int, int, int],
                 micro_batch: bool = False, max_batch: int = 256,
                 max_wait_ms: float = 2.0, pipeline_depth: int = 2,
                 streaming: Optional[StreamingSessionService] = None,
                 conformal: Optional[dict] = None):
        """engine: a `tpu_deer_torch.serve.InferenceEngine`; dims: its
        (audio, video, text) widths. conformal: {"alpha", "normalized",
        "quantiles": [3]} (see load_conformal) adds intervals."""
        self.engine = engine
        self.dims = dims
        self.lock = threading.Lock()
        self.requests_served = 0
        self.batcher = (
            MicroBatcher(engine, max_batch=max_batch, max_wait_ms=max_wait_ms,
                         pipeline_depth=pipeline_depth)
            if micro_batch
            else None
        )
        self.streaming = streaming
        self.conformal = conformal

    @staticmethod
    def load_conformal(path: str) -> dict:
        """Load an interval spec from a conformal JSON file: either a flat
        {"alpha","normalized","quantiles"} dict or the CLI's per-dataset
        report (first dataset wins)."""
        with open(path) as f:
            spec = json.load(f)
        if "quantiles" not in spec:
            if not spec:
                raise ValueError(f"{path}: empty conformal report")
            spec = next(iter(spec.values()))
        q = np.asarray(spec["quantiles"], dtype=np.float64)
        if not np.all(np.isfinite(q)):
            raise ValueError(
                f"{path}: non-finite conformal quantiles {q.tolist()} — the "
                "calibration split was too small for the requested alpha"
            )
        return {
            "alpha": float(spec.get("alpha", 0.1)),
            "normalized": bool(spec.get("normalized", True)),
            "quantiles": q,
        }

    _SERVICE_KW = ("micro_batch", "max_batch", "max_wait_ms",
                   "pipeline_depth")

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, config=None,
                        stream_slots: int = 0, stream_warmup: bool = True,
                        **kwargs) -> "PredictionService":
        """A service over `InferenceEngine.from_checkpoint(checkpoint_dir,
        config, **kwargs)` (device, graphs, quantize_weights, ood_detector,
        ood_fpr, ...; the micro-batching options go to the service). With
        `stream_slots`, live sessions on the same weights: an int8 engine
        keeps no float module, so the sessions get one with the dequantized
        weights, as the reference streams `dequantize_tree`'s."""
        from tpu_deer_torch.models.deer_model import CompleteDEERModel
        from tpu_deer_torch.ops.quantization import dequantize_tree
        from tpu_deer_torch.serve import InferenceEngine

        svc_kw = {k: kwargs.pop(k) for k in cls._SERVICE_KW if k in kwargs}
        engine = InferenceEngine.from_checkpoint(checkpoint_dir, config=config,
                                                 **kwargs)
        config = engine.model.config  # the checkpoint's layout unless given
        streaming = None
        if stream_slots:
            if engine.ensemble:
                raise ValueError(
                    "streaming sessions serve a single parameter set — pass a "
                    "single-member checkpoint (or member_params(k))")
            if config.audio_dim != 84:
                raise ValueError(
                    "streaming sessions need the 84-d audio feature model "
                    f"(audio_dim={config.audio_dim})")
            model = engine.model
            if engine.quantized:
                model = CompleteDEERModel(config)
                model.load_state_dict(dequantize_tree(*engine.quantized_weights))
            streaming = StreamingSessionService(
                model, n_streams=stream_slots, warmup=stream_warmup,
                ood_detector=kwargs.get("ood_detector"),
                ood_fpr=kwargs.get("ood_fpr", 0.01),
                serving_channel=engine.serving_channel, device=engine.device)
        return cls(engine, (config.audio_dim, config.video_dim,
                            config.text_dim), streaming=streaming, **svc_kw)

    @classmethod
    def from_exported(cls, export_dir: str, device: DeviceLike = None,
                      **kwargs) -> "PredictionService":
        """A service over `export.load_exported(export_dir)`. An artifact
        holds no model to stream with, so `stream_slots` raises."""
        from tpu_deer_torch.export import load_exported

        if kwargs.pop("stream_slots", 0):
            raise ValueError("live sessions need the model: serve a "
                             "checkpoint (from_checkpoint) to stream")
        engine = load_exported(export_dir, device=device)
        c = engine.manifest["config"]
        return cls(engine, (c["audio_dim"], c["video_dim"], c["text_dim"]),
                   **kwargs)

    def predict_json(self, payload: dict) -> dict:
        arrays = []
        for name, dim in zip(("audio", "video", "text"), self.dims):
            if name not in payload:
                raise ValueError(f"missing field {name!r}")
            arr = np.asarray(payload[name], dtype=np.float32)
            if arr.ndim == 1:
                arr = arr[None, :]
            if arr.ndim != 2 or arr.shape[1] != dim:
                raise ValueError(
                    f"{name} must be [N, {dim}], got {list(arr.shape)}"
                )
            if not np.all(np.isfinite(arr)):
                raise ValueError(f"{name} contains non-finite values")
            arrays.append(arr)
        n = {len(a) for a in arrays}
        if len(n) != 1:
            raise ValueError(f"modalities disagree on batch size: {sorted(n)}")
        if self.batcher is not None:
            out = self.batcher.submit(*arrays).result(timeout=120.0)
            with self.lock:
                self.requests_served += 1
        else:
            with self.lock:
                out = self.engine.predict(*arrays)
                self.requests_served += 1
        resp = {
            k: np.asarray(v).tolist()
            for k, v in out.items()
            if k in ("mu", "uncertainty", "calibrated_uncertainty",
                     "expected_abs_error", "ood_score", "is_ood")
        }
        # Which channel deployment should read; "deployable_uncertainty"
        # aliases it so clients need no mapping logic.
        channel, alias = self._deployable_channel(resp)
        resp["serving_channel"] = channel
        resp["deployable_uncertainty"] = resp[alias]
        return self.attach_intervals(resp)

    def _deployable_channel(self, resp: dict) -> tuple[str, str]:
        """(serving_channel, the response key it reads): the engine's
        channel, or, for an artifact whose outputs lack it, the best one
        it carries (calibrated, then E|y - mu|, then the raw variance),
        reported as what it is. An artifact with no uncertainty output at
        all raises a ValueError naming it."""
        keys = {"calibrated": "calibrated_uncertainty",
                "eabs": "expected_abs_error", "variance": "uncertainty"}
        channel = getattr(self.engine, "serving_channel", "eabs")
        for name in (channel, *keys):
            if keys[name] in resp:
                return name, keys[name]
        source = getattr(self.engine, "output_dir", type(self.engine).__name__)
        raise ValueError(f"{source}: the served artifact has no uncertainty "
                         f"output (outputs: {sorted(resp)})")

    def attach_intervals(self, resp: dict) -> dict:
        """Add conformal interval_lower/upper to a response carrying
        mu + uncertainty (either one row [3] or a batch [N, 3])."""
        if self.conformal is None or "mu" not in resp:
            return resp
        mu = np.asarray(resp["mu"], dtype=np.float64)
        q = self.conformal["quantiles"]  # [3]; broadcasts over both shapes
        if self.conformal["normalized"]:
            sig = np.sqrt(np.maximum(
                np.asarray(resp["uncertainty"], dtype=np.float64), 1e-12))
            half = sig * q
        else:
            half = np.broadcast_to(q, mu.shape)
        resp["interval_lower"] = (mu - half).tolist()
        resp["interval_upper"] = (mu + half).tolist()
        resp["interval_alpha"] = self.conformal["alpha"]
        return resp


def _require_sid(payload: dict) -> str:
    sid = payload.get("session_id")
    if not isinstance(sid, str):
        raise ValueError("missing field 'session_id'")
    return sid


def _opt_vec(payload: dict, name: str, dim: int):
    if name not in payload:
        return None
    vec = np.asarray(payload[name], np.float32).reshape(-1)
    if vec.shape != (dim,):
        raise ValueError(f"{name} must be [{dim}], got {list(vec.shape)}")
    if not np.all(np.isfinite(vec)):
        raise ValueError(f"{name} contains non-finite values")
    return vec


def _decode_chunk(payload: dict) -> np.ndarray:
    """'audio' (JSON float list) or 'pcm16_b64' (base64 int16 LE)."""
    if "pcm16_b64" in payload:
        import base64

        raw = base64.b64decode(payload["pcm16_b64"], validate=True)
        return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    if "audio" in payload:
        chunk = np.asarray(payload["audio"], np.float32).reshape(-1)
        if not np.all(np.isfinite(chunk)):
            raise ValueError("audio contains non-finite values")
        return chunk
    raise ValueError("missing field 'audio' (or 'pcm16_b64')")


def make_handler(service: PredictionService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                stats = {
                    "status": "ok",
                    "requests_served": service.requests_served,
                }
                if service.batcher is not None:
                    stats["micro_batches_dispatched"] = (
                        service.batcher.batches_dispatched
                    )
                    stats["micro_batch_rows"] = service.batcher.rows_dispatched
                if service.streaming is not None:
                    stats["stream_sessions"] = len(service.streaming.sessions)
                    stats["stream_slots"] = service.streaming.n_streams
                    stats["stream_ticks"] = service.streaming.ticks
                    stats["stream_chunk_samples"] = (
                        service.streaming.chunk_samples
                    )
                self._reply(200, stats)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            routes = {"/predict"}
            if service.streaming is not None:
                routes |= {"/stream/start", "/stream/push", "/stream/end"}
            if self.path not in routes:
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0 or length > MAX_BODY_BYTES:
                self._reply(413, {"error": "missing or oversized body"})
                return
            try:
                payload = json.loads(self.rfile.read(length))
                if self.path == "/predict":
                    result = service.predict_json(payload)
                elif self.path == "/stream/start":
                    result = {"session_id": service.streaming.start(
                        video=_opt_vec(payload, "video", service.dims[1]),
                        text=_opt_vec(payload, "text", service.dims[2]),
                    )}
                elif self.path == "/stream/push":
                    result = service.attach_intervals(service.streaming.push(
                        _require_sid(payload),
                        _decode_chunk(payload),
                        video=_opt_vec(payload, "video", service.dims[1]),
                        text=_opt_vec(payload, "text", service.dims[2]),
                    ))
                else:  # /stream/end
                    service.streaming.end(_require_sid(payload))
                    result = {"ended": True}
            except ValueError as e:  # JSONDecodeError is a ValueError too
                self._reply(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — e.g. dispatch timeout,
                # service closed mid-request: return JSON 500, never drop
                # the socket with a raw traceback.
                logger.exception("request failed")
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, result)

        def log_message(self, fmt, *args):  # route through logging, not stderr
            logger.debug("%s - %s", self.address_string(), fmt % args)

    return Handler


class _Server(ThreadingHTTPServer):
    # The socketserver default backlog (5) drops or resets connections when
    # tens of clients connect in the same instant; 128 covers the load the
    # micro-batcher is sized for.
    request_queue_size = 128


def serve(service: PredictionService, host: str = "127.0.0.1",
          port: int = 8571) -> _Server:
    """An HTTP server for `service` (port 0: an ephemeral port); the caller
    runs `serve_forever()` and later `shutdown()` and `server_close()`."""
    server = _Server((host, port), make_handler(service))
    logger.info("serving on http://%s:%d (POST /predict, GET /healthz)",
                host, port)
    return server


PLATFORMS = {"auto": None, "cuda": "cuda", "cpu": "cpu"}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve the port's engines over "
                                            "HTTP (POST /predict, GET /healthz)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", help="CheckpointManager directory")
    src.add_argument("--exported",
                     help="tpu_deer_torch.export artifact directory")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8571)
    p.add_argument("--platform", choices=sorted(PLATFORMS), default="auto",
                   help="'auto' and 'cuda': the CUDA card, raising without "
                        "one; 'cpu': the CPU")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip capturing the batch buckets' and the stream "
                        "tick's CUDA graphs at startup (each is then "
                        "captured at its first request)")
    p.add_argument("--micro_batch", action="store_true",
                   help="coalesce concurrent requests into one dispatch")
    p.add_argument("--stream_slots", type=int, default=0,
                   help="enable /stream/* live-session routes with this "
                        "many concurrent slots (checkpoint source only)")
    p.add_argument("--max_batch", type=int, default=256,
                   help="micro-batching: max coalesced rows per dispatch")
    p.add_argument("--max_wait_ms", type=float, default=2.0,
                   help="micro-batching: max straggler wait per dispatch "
                        "(auto-shrinks to 0 under sustained load)")
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="micro-batching: dispatch waves in flight at once")
    p.add_argument("--conformal",
                   help="conformal quantile JSON (the CLI evaluate stage's "
                        "results/conformal.json); /predict responses gain "
                        "interval_lower/interval_upper with 1-alpha coverage")
    p.add_argument("--ensemble", type=int, default=1, metavar="K",
                   help="serve a stacked K-member deep-ensemble checkpoint "
                        "(from cli --ensemble K): members vmapped in one "
                        "forward, combined by moment matching")
    p.add_argument("--ood",
                   help="Mahalanobis OOD detector .npz (the CLI evaluate "
                        "stage's results/ood_detector.npz); /predict "
                        "responses gain ood_score + is_ood (checkpoint "
                        "source only)")
    p.add_argument("--ood_fpr", type=float, default=0.01,
                   help="training-quantile false-positive rate for is_ood")
    return p


def main(argv=None) -> int:
    p = build_arg_parser()
    args = p.parse_args(argv)
    if args.ensemble > 1 and not args.checkpoint:
        p.error("--ensemble requires --checkpoint. Exported ensemble artifacts "
                "(cli --mode export --ensemble K) already hold the members: "
                "serve them with --exported")
    if args.ensemble > 1 and args.stream_slots:
        p.error("--stream_slots serves a single parameter set; serve one "
                "ensemble member for streaming")
    if args.ood and not args.checkpoint:
        p.error("--ood requires --checkpoint (an exported program is fixed; "
                "re-export with the detector to serve OOD scores)")
    if args.stream_slots and not args.checkpoint:
        p.error("--stream_slots requires --checkpoint (needs the model)")
    logging.basicConfig(level=logging.INFO)

    mb = dict(micro_batch=args.micro_batch, max_batch=args.max_batch,
              max_wait_ms=args.max_wait_ms,
              pipeline_depth=args.pipeline_depth)
    device = PLATFORMS[args.platform]
    if args.checkpoint:
        ood_kw = {}
        if args.ood:
            from tpu_deer_torch.eval.ood import MahalanobisOOD

            ood_kw = dict(ood_detector=MahalanobisOOD.load(args.ood),
                          ood_fpr=args.ood_fpr)
        service = PredictionService.from_checkpoint(
            args.checkpoint, stream_slots=args.stream_slots,
            stream_warmup=not args.no_warmup, device=device,
            ensemble_members=args.ensemble, **mb, **ood_kw)
    else:
        service = PredictionService.from_exported(args.exported,
                                                  device=device, **mb)
    if not args.no_warmup:
        service.engine.warmup()
    if args.conformal:
        service.conformal = PredictionService.load_conformal(args.conformal)

    server = serve(service, args.host, args.port)
    logger.info("listening on http://%s:%d", *server.server_address[:2])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if service.batcher is not None:
            service.batcher.close()
        if service.streaming is not None:
            service.streaming.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
