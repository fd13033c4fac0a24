"""CUDA graphs for the port's inference paths, the counterpart of the
reference's jit-compiled serving buckets and stream tick.

`GraphedCall` captures a function of static device buffers once and
replays it per call: numpy arrays go through pinned staging buffers into
the static inputs, the graph replays, and the static outputs come back
through pinned buffers before the call returns. `InferenceEngine` keeps one
a padded bucket, `ExportedEngine` one a bucket around its program, and
`StreamingRecognizer` one for its tick.

Threads: a call holds its graph's lock from the copy in to the copy out, so
two threads never share one graph's static buffers. `BucketGraphs` holds
one lock for its memory pool around each call: a later capture may place
its static outputs in memory an earlier graph frees after its capture, so
another graph's replay between a replay and its copy out would overwrite
those outputs. Replays go on the calling thread's current stream (the
device's default stream unless the caller set another). A capture
takes the process-wide `CAPTURE_LOCK`; warm-ups capture in the default
"global" mode, before a server starts its threads, and a capture made while
other threads may use the card (a server started without warm-up) passes
`capture_error_mode="thread_local"`. A capture that fails raises: nothing
falls back to eager launches.

`bucketed_predict` lives here too, so that an exported artifact can be
served without importing the port's model code.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

CAPTURE_LOCK = threading.Lock()
WARMUP_RUNS = 2  # eager runs on a side stream before a capture


def bucketed_predict(
    predict_padded: Callable[..., dict], buckets: Sequence[int],
    audio: np.ndarray, video: np.ndarray, text: np.ndarray,
) -> dict[str, np.ndarray]:
    """Pad requests up to the nearest bucket, chunk requests beyond the
    largest bucket, and unpad the outputs back to the request size.

    `predict_padded(audio, video, text)` runs one padded batch and returns a
    dict of arrays."""
    n = len(audio)
    max_b = buckets[-1]
    if n > max_b:
        parts = [
            bucketed_predict(
                predict_padded, buckets,
                audio[i : i + max_b], video[i : i + max_b], text[i : i + max_b],
            )
            for i in range(0, n, max_b)
        ]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    b = next((bk for bk in buckets if n <= bk), max_b)
    pad = b - n
    if pad:
        padz = lambda x: np.concatenate(
            [x, np.zeros((pad,) + x.shape[1:], x.dtype)]
        )
        audio, video, text = padz(audio), padz(video), padz(text)
    out = predict_padded(audio, video, text)
    return {k: np.asarray(v)[:n] for k, v in out.items()}


class GraphedCall:
    """`fn(*inputs) -> {name: tensor}` captured once as a CUDA graph over
    static input buffers of the given (shape, dtype)s on `device`.

    The constructor runs fn `WARMUP_RUNS` times on a side stream (fn must
    leave any state it writes unchanged on all-zero inputs), then captures
    it into `pool` (a `torch.cuda.graph_pool_handle()` shared by graphs
    that never replay at once). `capture_s` is the capture's host time."""

    def __init__(self, fn: Callable[..., dict],
                 specs: Sequence[tuple[tuple[int, ...], torch.dtype]],
                 device: torch.device, pool=None,
                 capture_error_mode: str = "global"):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.device = device
        self.inputs = tuple(torch.zeros(shape, dtype=dtype, device=device)
                            for shape, dtype in specs)
        self._staging = tuple(torch.zeros(shape, dtype=dtype, pin_memory=True)
                              for shape, dtype in specs)
        self.graph = torch.cuda.CUDAGraph()
        self.lock = threading.Lock()
        self.replays = 0
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        with torch.inference_mode():
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    fn(*self.inputs)
            current.wait_stream(side)
            with CAPTURE_LOCK:
                t0 = time.perf_counter()
                with torch.cuda.graph(self.graph, pool=pool,
                                      capture_error_mode=capture_error_mode):
                    self.outputs = fn(*self.inputs)
                self.capture_s = time.perf_counter() - t0
        self._host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                      for k, v in self.outputs.items()}

    def __call__(self, *arrays: np.ndarray) -> dict[str, np.ndarray]:
        """Copy `arrays` into the static inputs, replay, and return copies
        of the outputs."""
        if len(arrays) != len(self.inputs):
            raise ValueError(f"expected {len(self.inputs)} inputs, got "
                             f"{len(arrays)}")
        with self.lock, torch.inference_mode():
            for stage, static, a in zip(self._staging, self.inputs, arrays):
                if tuple(np.shape(a)) != tuple(static.shape):
                    raise ValueError(f"input of shape {np.shape(a)} for a "
                                     f"static buffer {tuple(static.shape)}")
                stage.numpy()[...] = a
                static.copy_(stage, non_blocking=True)
            self.graph.replay()
            for k, v in self.outputs.items():
                self._host[k].copy_(v, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            self.replays += 1
            return {k: v.numpy().copy() for k, v in self._host.items()}


class BucketGraphs:
    """How the serving engines run a padded bucket: with `graphs`, one
    `GraphedCall` a batch size over (audio, video, text) of the given
    widths, captured on demand into one memory pool and under one lock that
    all of them share; else the same function eagerly."""

    def __init__(self, forward: Callable[[int], Callable[..., dict]],
                 widths: Sequence[int], device: torch.device, graphs: bool):
        """forward(batch) → the function of device tensors to run (and
        capture) for that batch size."""
        self._forward = forward
        self._widths = tuple(widths)
        self._device = device
        self.graphs = graphs
        self._graphs: dict[int, GraphedCall] = {}
        self._pool = None
        self._lock = threading.Lock()
        self._pool_lock = threading.Lock()  # see the module docstring

    def get(self, batch: int,
            capture_error_mode: str = "thread_local") -> GraphedCall:
        """Bucket `batch`'s graph, captured first where it is missing."""
        with self._lock:
            graph = self._graphs.get(batch)
            if graph is None:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                specs = [((batch, w), torch.float32) for w in self._widths]
                graph = self._graphs[batch] = GraphedCall(
                    self._forward(batch), specs, self._device, self._pool,
                    capture_error_mode)
            return graph

    def run(self, audio, video, text) -> dict[str, np.ndarray]:
        """One padded batch, numpy in and out."""
        if self.graphs:
            graph = self.get(len(audio))
            with self._pool_lock:
                return graph(audio, video, text)
        as_t = lambda x: torch.from_numpy(
            np.ascontiguousarray(x, dtype=np.float32)).to(self._device)
        with torch.inference_mode():
            out = self._forward(len(audio))(as_t(audio), as_t(video),
                                            as_t(text))
            return {k: v.cpu().numpy() for k, v in out.items()}

    def warmup(self, buckets: Sequence[int]) -> None:
        """Capture every bucket's graph (before other threads use the
        card), or run each bucket once eagerly: the counterpart of the
        reference's pre-compilation of its buckets."""
        for b in buckets:
            if self.graphs:
                self.get(b, "global")
            else:
                self.run(*(np.zeros((b, w), np.float32) for w in self._widths))

    @property
    def capture_s(self) -> dict[int, float]:
        """Each captured bucket's capture time (host seconds)."""
        return {b: g.capture_s for b, g in sorted(self._graphs.items())}
