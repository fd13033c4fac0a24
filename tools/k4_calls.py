"""Time phase 10(c)'s 44 direct K4 calls for two trees of this repo in
turns on one card.

    python -m tools.k4_calls TREE_A TREE_B [pairs]

Each TREE is a copy of this repo inside this checkout: `.` or another
commit's `git archive` unpacked under the git-ignored `build/`. One worker
process a tree imports that tree's `tpu_deer_torch`, puts the 44 Dense
kernels of the flagship's seeded init on the card and, at each turn, runs
`chip_smoke.k4_calls_ms` (this checkout's) on them: the median host time of
20 rounds of the 44 calls, each round to a synchronize, and one round's
device time under the profiler. The turns go A, B, B, A, A, B, ... for
`pairs` pairs (default 12). Prints one JSON line a turn, then one a tree
with the median, least and greatest of its turns.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TAG = "k4_calls "  # marks the worker's answers among its other output
WORKER = r"""
import importlib.util, json, sys
import torch
tree, smoke = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)
from tpu_deer_torch.models.deer_model import create_complete_deer_model
from tpu_deer_torch.ops import quantization as quant
sd = create_complete_deer_model(seed=chip_smoke.SEED, device="cpu").state_dict()
weights = [v.to("cuda").contiguous() for k, v in sd.items()
           if quant.contraction_axis(k, v) is not None]
if len(weights) != 44:
    raise SystemExit(f"{len(weights)} Dense kernels, not 44")
print("TAG" + json.dumps({"ready": len(weights)}), flush=True)
for _ in sys.stdin:
    host, dev, events = chip_smoke.k4_calls_ms(
        torch, quant.quantize_int8_stochastic, weights)
    print("TAG" + json.dumps({"host_ms": host, "device_ms": dev,
                              "device_events": events}), flush=True)
""".replace("TAG", TAG)


def answer(worker) -> dict:
    """The worker's next tagged line; other lines go to stderr."""
    for line in worker.stdout:
        if line.startswith(TAG):
            return json.loads(line[len(TAG):])
        print(line, end="", file=sys.stderr)
    raise RuntimeError(f"worker exited with {worker.wait()}")


def spread(values) -> dict:
    return {"median": float(np.median(values)), "min": min(values),
            "max": max(values)}


def main(argv: list[str]) -> int:
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    trees = [Path(a).resolve() for a in argv[:2]]
    pairs = int(argv[2]) if len(argv) == 3 else 12
    for tree in trees:
        if not (tree == ROOT or ROOT in tree.parents) or not (
                tree / "tpu_deer_torch").is_dir():
            raise SystemExit(f"{tree}: not a tree of this repo inside {ROOT}")
    workers = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(tree), str(ROOT / "chip_smoke.py")],
        cwd=tree, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for tree in trees]
    turns: list[list[dict]] = [[], []]
    try:
        for worker in workers:
            answer(worker)
        for pair in range(pairs):
            for k in ((0, 1) if pair % 2 == 0 else (1, 0)):
                workers[k].stdin.write("go\n")
                workers[k].stdin.flush()
                got = answer(workers[k])
                turns[k].append(got)
                print(json.dumps({"pair": pair, "tree": argv[k], **got}), flush=True)
    finally:
        for worker in workers:
            worker.stdin.close()
            try:
                worker.wait(timeout=60)
            except subprocess.TimeoutExpired:
                worker.kill()
    for name, got in zip(argv[:2], turns):
        dev = [t["device_ms"] for t in got if t["device_ms"] is not None]
        print(json.dumps({"tree": name, "turns": len(got),
                          "host_ms": spread([t["host_ms"] for t in got]),
                          "device_ms": spread(dev) if dev else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
