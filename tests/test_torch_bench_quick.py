"""`python -m tpu_deer_torch.bench --quick --platform cpu`: every section of
the port's bench at `bench.py`'s tiny shapes, in a fresh interpreter that
cannot import `jax`, `flax` or `tpu_deer` (the port must need none of
them), as `tests/test_bench_quick.py` runs the reference's."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = """
import runpy, sys

class Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "tpu_deer"):
            raise ImportError(f"{name} is blocked in this interpreter")
        return None

sys.meta_path.insert(0, Blocked())
sys.argv = ["tpu_deer_torch.bench", "--quick", "--platform", "cpu"]
try:
    runpy.run_module("tpu_deer_torch.bench", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "tpu_deer"))
if leaked:
    sys.exit(f"imported {leaked}")
sys.exit(rc)
"""


def test_bench_quick_runs_without_jax():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "metric": "quick_structural_smoke", "value": 1.0, "unit": "ok",
        "vs_baseline": None}
    err = proc.stderr
    assert "params=3,918,324 dtype=float32" in err
    assert "# audio frontend (3s utt)" in err and "# int8 serving" in err
