"""The port's `utils/profiling.py` on the CPU: every case of
`tests/test_aux.py::TestProfiling`, with the exact counts where the port
counts exactly (FlopCounterMode and the per-op bytes), the card-name
table, a train step's FLOPs against its forward's, and the trace file."""

import json
import os

import numpy as np
import pytest
import torch

from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.models.deer_model import (
    DEERModelConfig,
    create_complete_deer_model,
)
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig
from tpu_deer_torch.utils import profiling

torch.set_num_threads(1)

TINY = DEERModelConfig(audio_dim=8, video_dim=8, text_dim=8, encoder_dim=16,
                       fusion_dim=32, attention_heads=2, encoder_layers=1)


def _dataset():
    cfg = SyntheticConfig(n_train=64, n_val=8, n_test=8, audio_dim=8,
                          video_dim=8, text_dim=8)
    return ArrayDataset(make_synthetic_splits(cfg)["train"], "s")


def _trainer():
    model = create_complete_deer_model(TINY, seed=0, device="cpu")
    return DEERTrainer(model, TrainingConfig(batch_size=32, num_epochs=1),
                       steps_per_epoch=2, device="cpu")


def test_profile_step():
    stats = profiling.profile_step(lambda x: x @ x, torch.ones(64, 64),
                                   iters=5, warmup=1)
    assert stats["p50_ms"] > 0 and stats["iters"] == 5
    assert stats["mean_ms"] >= stats["min_ms"]


def test_model_flops_exact():
    # 2·n³ for a 32³ product.
    assert profiling.calculate_model_flops(lambda x: x @ x,
                                           torch.ones(32, 32)) == 65536


def test_profile_training_speed():
    trainer = _trainer()
    ds = _dataset()
    stats = profiling.profile_training_speed(trainer, ds, iters=3)
    assert stats["samples_per_sec"] > 0 and stats["batch_size"] == 32
    chain = profiling.profile_training_speed(trainer, ds, iters=3,
                                             sync_per_step=False)
    assert chain["samples_per_sec"] > 0
    assert chain["step_ms_mean"] == chain["step_ms_p50"]
    # Both modes advanced the trainer (a warm-up step + iters each).
    assert trainer.step == trainer.optimizer.state["count"] == 2 * (3 + 1)


def test_sync_on_tensor_trees():
    out = torch.arange(8.0) * 2
    profiling._sync(out)
    profiling._sync({"a": out, "b": [out, 1.0]})
    profiling._sync([])


@pytest.mark.parametrize("fn, env, value", [
    (profiling.peak_flops_per_chip, "TPU_DEER_PEAK_TFLOPS", 123e12),
    (profiling.peak_hbm_bandwidth, "TPU_DEER_PEAK_HBM_GBPS", 819e9),
])
def test_peak_env_override_and_cpu(monkeypatch, fn, env, value):
    monkeypatch.setenv(env, "123" if "TFLOPS" in env else "819")
    assert fn() == value
    monkeypatch.delenv(env)
    # The CPU has no published peak: None, not a guess.
    assert fn("cpu") is None
    # Without a card, the default device raises instead of falling back.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()


def test_card_name_table(monkeypatch):
    monkeypatch.delenv("TPU_DEER_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("TPU_DEER_PEAK_HBM_GBPS", raising=False)
    monkeypatch.setattr(profiling, "_device_name",
                        lambda device: "NVIDIA H100 80GB HBM3")
    assert profiling.peak_flops_per_chip() == 989e12
    assert profiling.peak_hbm_bandwidth() == 3.35e12
    monkeypatch.setattr(profiling, "_device_name", lambda device: "Some GPU")
    assert profiling.peak_flops_per_chip() is None
    assert profiling.peak_hbm_bandwidth() is None


def test_cost_analysis_summary_exact():
    summary = profiling.cost_analysis_summary(lambda x: x @ x,
                                              torch.ones(32, 32))
    assert summary["flops"] == 65536
    # Two 32×32 float32 operands read and the product written; the
    # transpose (a view) moves nothing.
    assert summary["bytes"] == 3 * 32 * 32 * 4
    view = profiling.cost_analysis_summary(lambda x: x.t() @ x,
                                           torch.ones(32, 32))
    assert view == summary


def test_train_step_flops_are_forward_and_backward():
    """A train step's matrix products: the forward's, the weight gradients'
    (as many) and the activation gradients' (as many, less the first
    layers', whose inputs take none)."""
    trainer = _trainer()
    ds = _dataset()
    batch = trainer._batch_from_indices(ds, np.arange(32))
    with torch.no_grad():
        fwd = profiling.cost_analysis_summary(
            trainer.model.eval(), batch["audio"], batch["video"], batch["text"])
    step = profiling.cost_analysis_summary(trainer._train_step, batch, 1.0, 1.0)
    assert trainer.step == 1
    assert 2 * fwd["flops"] < step["flops"] < 3 * fwd["flops"]
    assert step["bytes"] > fwd["bytes"] > 0


def test_roofline_seconds_two_ceilings():
    assert profiling.roofline_seconds(1e12, 1e6, 1e12, 1e9) == 1.0
    assert profiling.roofline_seconds(1e6, 1e12, 1e12, 1e9) == 1000.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(16, 16) @ torch.ones(16, 16)
    with open(os.path.join(log_dir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
