"""Fused epochs as CUDA graphs of the train step, on the card (needs a CUDA
device; marked `cuda`, skips without one). On the machine with the card:

    TPU_DEER_TEST_TPU=1 python -m pytest tests/test_torch_graph_cuda.py -q

Graphed steps against eager `_train_step`s from one state and one seed with
dropout on, at a narrow width: both run the same device work on the same
rows and draws, so parameters agree within atol 1e-5 / rtol 1e-5 (as
`chip_smoke.py` phase 10(d) at full width). A step that syncs with the host
makes the capture, and so `train`, raise: it never goes on eagerly.
"""

import numpy as np
import pytest
import torch

from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.models.deer_model import DEERModelConfig, create_complete_deer_model
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

pytestmark = pytest.mark.cuda

WIDTH = dict(encoder_dim=64, fusion_dim=128, encoder_layers=1)
BATCH, STEPS = 64, 8


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _trainer(device, fused, accum=1):
    model = create_complete_deer_model(DEERModelConfig(**WIDTH), seed=3,
                                       device=device)
    cfg = TrainingConfig(batch_size=BATCH, num_epochs=3, learning_rate=2e-3,
                         warmup_epochs=1, grad_accum_steps=accum,
                         dataset_weights={"synthetic": 1.0}, fused_epochs=fused,
                         seed=7)
    return DEERTrainer(model, cfg, steps_per_epoch=STEPS, device=device)


def _data():
    s = make_synthetic_splits(SyntheticConfig(n_train=BATCH * STEPS, n_val=64,
                                              n_test=8, seed=11))
    return ArrayDataset(s["train"], "synthetic"), ArrayDataset(s["val"], "synthetic")


@pytest.mark.parametrize("accum", [1, 2])
def test_graphed_steps_match_eager(device, accum):
    train, _ = _data()
    iters = {"synthetic": BatchIterator(train, BATCH, shuffle=True,
                                        drop_last=True, seed=7)}
    graphed = _trainer(device, True, accum)
    graphed.train_epoch(iters, 0)  # warm-up, capture, replays
    warm = max(DEERTrainer.GRAPH_WARMUP, accum)
    assert graphed._run.eager == warm and graphed.graph_replays == STEPS - warm
    eager = _trainer(device, False, accum)
    eager.load_state_dict(graphed.state_dict())
    got = graphed.train_epoch(iters, 1)  # every step a replay
    ref = eager.train_epoch(iters, 1)
    assert graphed.graph_replays == 2 * STEPS - warm
    assert graphed.step == eager.step == 2 * STEPS
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    want = eager.model.state_dict()
    for name, p in graphed.model.state_dict().items():
        torch.testing.assert_close(p, want[name], rtol=1e-5, atol=1e-5, msg=name)
    assert torch.equal(graphed.generator.get_state(), eager.generator.get_state())
    assert int(graphed.optimizer.count) == graphed.optimizer.state["count"]


def test_capture_of_a_syncing_step_raises(device, monkeypatch):
    train, val = _data()
    trainer = _trainer(device, True)
    loss_fn = trainer._loss_fn

    def syncing(batch, weight):
        loss, aux = loss_fn(batch, weight)
        loss.item()  # a host sync: illegal while a graph is captured
        return loss, aux

    monkeypatch.setattr(trainer, "_loss_fn", syncing)
    with pytest.raises(RuntimeError):
        trainer.train({"synthetic": train}, {"synthetic": val}, num_epochs=1)
    assert trainer.step == DEERTrainer.GRAPH_WARMUP  # no eager step after it
    assert trainer.graph_replays == 0
    torch.cuda.synchronize()
