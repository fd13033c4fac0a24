"""What the port's twins of the reference's studies share: the flags, the
device, the output paths and the reading of the reference's result beside
this run's.

Every twin runs float32 with TF32 off on the card (`--platform cuda`, the
default, raising without one) or on the CPU (`--platform cpu`), writes
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
from typing import Optional

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
