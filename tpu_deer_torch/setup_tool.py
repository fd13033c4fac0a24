"""Project setup tool: scaffolding, dependency checks, install self-test.

Port of `tpu_deer/setup_tool.py`: it creates the experiment directory
layout, checks the runtime stack, writes the default configs, and runs an
install self-test (a matmul on the device, a mini-DEER forward there, a
plot save, a config load).

Where the machine lacks a package that only one step needs (PyYAML for the
configs, matplotlib for the plot), that step reports "skipped: <package>
is not installed" and the run still succeeds, as the port's plots do
without matplotlib; a missing REQUIRED package fails the run, as in the
reference. The device is the card unless the caller asks for the CPU.

Usage:
    python -m tpu_deer_torch.setup_tool [--root DIR] [--test] [--platform {auto,cuda,cpu}]
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

from tpu_deer_torch.device import DeviceLike, resolve_device

# What the port needs to run at all.
REQUIRED = ("torch", "numpy", "scipy")
# What single steps need: a step whose package is missing is skipped.
STEP_PACKAGES = ("yaml", "matplotlib")
OPTIONAL = ("cv2", "pandas", "transformers")

DIRS = (
    "experiments",
    "checkpoints",
    "data",
    "logs",
    "configs",
)
PLATFORMS = {"auto": None, "cuda": "cuda", "cpu": "cpu"}


def _installed(module: str) -> bool:
    try:
        importlib.import_module(module)
        return True
    except ImportError:
        return False


def _skipped(package: str) -> str:
    return f"skipped: {package} is not installed"


def check_dependencies(verbose: bool = True) -> dict[str, bool]:
    status = {}
    for mod in REQUIRED + STEP_PACKAGES + OPTIONAL:
        status[mod] = _installed(mod)
        if verbose:
            tag = ("required" if mod in REQUIRED
                   else "step" if mod in STEP_PACKAGES else "optional")
            print(f"  [{'OK' if status[mod] else '--'}] {mod} ({tag})")
    return status


def setup_project_structure(root: str = ".") -> list[str]:
    created = []
    for d in DIRS:
        path = os.path.join(root, d)
        if not os.path.isdir(path):
            os.makedirs(path, exist_ok=True)
            created.append(path)
    return created


def generate_configs(root: str = ".") -> list[str]:
    """Write configs/config.yaml and configs/quick_config.yaml where they
    are missing; the paths written. Raises ImportError without PyYAML."""
    from tpu_deer_torch.utils.config import default_config, save_yaml_config

    paths = []
    full = os.path.join(root, "configs", "config.yaml")
    if not os.path.exists(full):
        save_yaml_config(default_config(), full)
        paths.append(full)
    quick = os.path.join(root, "configs", "quick_config.yaml")
    if not os.path.exists(quick):
        cfg = default_config()
        cfg["training"].update(num_epochs=5, batch_size=8, warmup_epochs=1)
        cfg["datasets"]["names"] = []
        save_yaml_config(cfg, quick)
        paths.append(quick)
    return paths


def run_install_test(device: DeviceLike = None) -> bool:
    """Install self-test on `device` (None = the card): a device matmul, a
    mini-DEER forward, a plot save, a config load. A step whose package is
    missing is skipped and does not fail the test."""
    import tempfile

    import torch

    ok = True
    try:
        dev = resolve_device(device)
        x = torch.ones((64, 64), device=dev)
        y = x @ x
        assert float(y[0, 0]) == 64.0
        print(f"  [OK] device matmul on {dev.type}")
    except Exception as e:  # noqa: BLE001 — reported as the step's failure
        print(f"  [FAIL] device matmul: {e}")
        return False

    try:
        from tpu_deer_torch.models.deer_model import (
            DEERModelConfig,
            create_complete_deer_model,
        )

        model = create_complete_deer_model(
            DEERModelConfig(encoder_dim=32, fusion_dim=64, encoder_layers=1),
            seed=0, device=dev)
        with torch.no_grad():
            out = model(torch.zeros((2, 84), device=dev),
                        torch.zeros((2, 256), device=dev),
                        torch.zeros((2, 768), device=dev))
        assert tuple(out["mu_all"].shape) == (2, 3)
        print("  [OK] mini-DEER forward")
    except Exception as e:  # noqa: BLE001
        print(f"  [FAIL] mini-DEER forward: {e}")
        ok = False

    if not _installed("matplotlib"):
        print(f"  [--] plot save: {_skipped('matplotlib')}")
    else:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots()
            ax.plot([0, 1], [0, 1])
            with tempfile.NamedTemporaryFile(suffix=".png") as f:
                fig.savefig(f.name)
            plt.close(fig)
            print("  [OK] plot save")
        except Exception as e:  # noqa: BLE001
            print(f"  [FAIL] plot save: {e}")
            ok = False

    try:
        from tpu_deer_torch.utils.config import load_yaml_config

        cfg = load_yaml_config(None)
        assert cfg["model"]["audio_dim"] == 84
        print("  [OK] config load")
    except Exception as e:  # noqa: BLE001
        print(f"  [FAIL] config load: {e}")
        ok = False
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="tpu_deer_torch project setup")
    p.add_argument("--root", default=".")
    p.add_argument("--test", action="store_true", help="run install self-test")
    p.add_argument("--platform", choices=sorted(PLATFORMS), default="auto",
                   help="the self-test's device (auto and cuda: the card)")
    args = p.parse_args(argv)

    print("Checking dependencies:")
    status = check_dependencies()
    missing = [m for m in REQUIRED if not status[m]]
    if missing:
        print(f"missing required deps: {missing}")
        return 1

    created = setup_project_structure(args.root)
    print(f"created {len(created)} directories")
    if status["yaml"]:
        configs = generate_configs(args.root)
        print(f"generated {len(configs)} config files")
    else:
        print(f"config files: {_skipped('yaml')}")

    if args.test:
        print("Install self-test:")
        if not run_install_test(PLATFORMS[args.platform]):
            return 1
    print("setup complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
