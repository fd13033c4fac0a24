"""What the port's twins of the reference's studies share: the flags, the
device, the output paths and the reading of the reference's result beside
this run's.

Every twin runs with TF32 off on the card (`--platform cuda`, the default,
raising without one) or on the CPU (`--platform cpu`), in float32 unless
its reference computes in bf16 (the HBM and scale studies), writes
`results_torch/RESULTS_<name>_h100.{json,md}` (`--quick`: `..._quick`,
git-ignored), and compares its quality with the reference's committed
`experiments/RESULTS_<name>.json`: a CCC gap beyond `CCC_GAP` is flagged in
the table (and logged in ROADMAP.md, not tuned). Timings are the card's and
are compared with nothing from the TPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir)
CCC_GAP = 0.02


def parser(doc: str, name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--quick", action="store_true", help="a smoke at CPU sizes")
    p.add_argument("--out", default=f"results_torch/RESULTS_{name}_h100")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    return p


def setup(args, name: str) -> tuple[torch.device, str]:
    """(device, the card's name and power limit or "cpu"); TF32 off; a
    quick run's default output goes to the `_quick` paths."""
    from tpu_deer_torch.device import resolve_device
    from tpu_deer_torch.experiments.synthetic_headline import card_name

    if args.quick and args.out == f"results_torch/RESULTS_{name}_h100":
        args.out += "_quick"
    device = resolve_device(args.platform)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device, card_name(device)


def reference(name: str) -> Optional[dict]:
    """The reference's committed result, experiments/RESULTS_<name>.json."""
    path = os.path.join(ROOT, "experiments", f"RESULTS_{name}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def gap(ours: float, ref: Optional[float]) -> str:
    """This run's CCC minus the reference's, flagged beyond CCC_GAP."""
    if ref is None:
        return "n/a"
    d = ours - ref
    return f"{d:+.3f}" + (" **(gap)**" if abs(d) > CCC_GAP else "")


def synchronize(device: torch.device) -> Callable[[], None]:
    """A function that waits for `device`'s work (nothing on the CPU)."""
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def median_ms(fn, k: int, reps: int, sync: Callable[[], None]) -> float:
    """ms a call of fn(): the median over `reps` runs of `k` calls, each
    run ending in `sync()`, after one warm-up call."""
    fn()
    sync()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        sync()
        runs.append((time.perf_counter() - t0) / k * 1e3)
    return float(np.median(runs))


def graphed(fn: Callable[[], object], device: torch.device,
            warmup: int = 3) -> Callable[[], None]:
    """fn (no host sync inside) as one CUDA graph on the card, replayed by
    the returned call, after `warmup` eager runs on a side stream (they
    build the kernels and let autograd settle its buffers); eager on the
    CPU."""
    if device.type != "cuda":
        return fn
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def profiled(fn: Callable[[], None], expect: Optional[dict] = None,
             windows: int = 3, markers: int = 64):
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


def device_kernels(fn: Callable[[], None], device: torch.device) -> Optional[int]:
    """Kernels and memory operations one call of fn puts on the card,
    counted by `profiled`; None on the CPU or when no window kept every
    event."""
    if device.type != "cuda":
        return None
    got = profiled(fn)
    return None if got is None else len(got[0])


def write(out: str, md: list[str], payload: dict) -> str:
    """Write <out>.md and <out>.json; returns the Markdown."""
    text = "\n".join(md) + "\n"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out + ".md", "w") as f:
        f.write(text)
    with open(out + ".json", "w") as f:
        json.dump(payload, f, indent=1, default=float)
    print(text)
    return text
