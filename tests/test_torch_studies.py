"""The twins of the HBM, scale and kernel studies
(`tpu_deer_torch/experiments/{hbm_study,scale_mfu,kernel_bench}.py`) on the
CPU at tiny sizes: the traffic floor and the matmul chain's FLOP count
equal the reference functions' exactly, and each piece of a payload has
the reference's keys (the kernel bench's plain row stands where the
reference's XLA baseline stood)."""

import numpy as np
import pytest
import torch

from experiments import hbm_study as ref_hbm
from tpu_deer_torch.experiments import hbm_study, kernel_bench, scale_mfu

CPU = torch.device("cpu")
# The reference's result keys (experiments/hbm_study.py:93-94, 143-149,
# 182-192; scale_mfu.py:101-127; kernel_bench.py:103-126).
HBM_KEYS = {"gbps", "secs", "buffer_mb", "iters"}
MATMUL_KEYS = {"dtype", "batch", "tflops", "mfu_pct", "secs_per_iter"}
STEP_KEYS = {"storage_dtype", "stacked", "batch", "params", "step_ms",
             "samples_per_sec", "mfu_pct", "flops", "xla_bytes"}
SCALE_KEYS = {"batch_size", "storage", "stacked", "params", "step_ms",
              "samples_per_sec", "mfu_pct", "roofline_pct", "intensity"}
ATTN_KEYS = {"shape"} | {f"{p}_{ph}_{u}" for p in ("flash", "xla")
                         for ph in ("fwd", "bwd") for u in ("ms", "tflops")} | {
    f"auto_{ph}_{u}" for ph in ("fwd", "bwd") for u in ("pick", "ms")}
FRONTEND_KEYS = {"name", "ms", "tflops", "us_per_frame"}


@pytest.mark.parametrize("args", [(16384, 3_918_324, 4, 1_234.5),
                                  (8192, 240_000_000, 2, 7_777.0),
                                  (1, 1, 2, 0.0)])
def test_traffic_floor_equals_reference(args):
    assert hbm_study.analytic_traffic_floor(*args) == ref_hbm.analytic_traffic_floor(*args)


@pytest.mark.parametrize("batch", [1, 256, 16384])
def test_matmul_chain_flops_equal_reference(batch, monkeypatch):
    """The reference's FLOP count read back through its own TFLOP/s, with
    its timing replaced by 1 s (nothing runs)."""
    monkeypatch.setattr(ref_hbm, "_timed_fetch", lambda fn, *a, **kw: 1.0)
    ref = ref_hbm.measure_matmul_ceiling(batch, "float32", 3)
    assert hbm_study.matmul_chain_flops(batch) * 3 / 1.0 / 1e12 == ref["tflops"]


def test_hbm_study_payload_keys():
    bw = hbm_study.measure_hbm_bandwidth(1 << 10, 2, CPU)
    assert HBM_KEYS <= set(bw) and bw["gbps"] > 0
    mm = hbm_study.measure_matmul_ceiling(8, "float32", 1, CPU)
    assert MATMUL_KEYS <= set(mm) and mm["mfu_pct"] is None  # no CPU peak
    step = hbm_study.measure_train_step(16, "bfloat16", 1, CPU)
    assert STEP_KEYS <= set(step) and step["params"] == 3_918_324
    assert step["flops"] > 0 and step["mfu_pct"] is None
    payload = {"platform": "cpu", "quick": True, "hbm_bandwidth": bw,
               "matmul_ceiling": [mm], "train_steps": [step, step],
               "analytic_floor_bytes": {"float32": 1e6, "bfloat16": 5e5},
               "activation_bytes_per_sample": 1.0, "elapsed_s": 0.0}
    step_f32 = dict(step, storage_dtype="float32")
    payload["train_steps"] = [step_f32, step]
    md = "\n".join(hbm_study.report(payload, 16))
    assert "Verdict" in md and "v5e" not in md and "MXU" not in md


def test_activation_bytes_count_the_saved_batch_tensors():
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        create_complete_deer_model,
    )

    model = create_complete_deer_model(DEERModelConfig(
        encoder_dim=32, fusion_dim=64, encoder_layers=1), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    per = [hbm_study.activation_bytes_per_sample(model, {
        k: torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
        for k, d in (("audio", 84), ("video", 256), ("text", 768))})
        for b in (24, 40)]  # no weight's leading axis is a multiple
    # At least the inputs (1,108 floats) a sample, and per sample the same
    # at either batch.
    assert per[0] >= 1108 * 4 and per[0] == pytest.approx(per[1], rel=1e-6)


def test_scale_rows_have_reference_keys():
    rows = scale_mfu.measure(1, (16,), 1, CPU)
    assert SCALE_KEYS <= set(rows[0]) and rows[0]["params"] == 3_918_324
    assert rows[0]["intensity"] > 0
    md = "\n".join(scale_mfu.report({"platform": "cpu", "iters": 1, "elapsed_s": 0.0,
                                     "plans": [{"width_mult": 1, "rows": rows}]},
                                    CPU))
    assert "| 1 | 3,918,324 | 16 | f32 | default |" in md


def test_kernel_bench_rows_have_reference_keys():
    row = kernel_bench.attention_row((1, 2, 64, 32), 1, CPU)
    assert {k.replace("xla", "plain") for k in ATTN_KEYS} <= set(row)
    assert row["auto_fwd_pick"] == "plain" and row["auto_bwd_pick"] == "plain"
    assert set(row["max_abs_err"]) == {"K3a", "K3b", "K3c"}
    for rows in (kernel_bench.frames_rows(64, 1, CPU),
                 kernel_bench.signal_rows(1, 4096, 1, CPU)):
        assert all(FRONTEND_KEYS <= set(r) for r in rows)
    payload = {"platform": "cpu", "calls_per_run": 1, "elapsed_s": 0.0,
               "attention": [row], "frames": 64, "signal_shape": [1, 4096],
               "mfcc_frames": kernel_bench.frames_rows(64, 1, CPU),
               "signal": kernel_bench.signal_rows(1, 4096, 1, CPU)}
    assert "auto picks the faster" in "\n".join(kernel_bench.report(payload))
