"""bfloat16 compute on the card (needs a CUDA device; marked `cuda`, skips
without one). On the machine with the card:

    TPU_DEER_TEST_TPU=1 python -m pytest tests/test_torch_bf16_cuda.py -q

* The flagship's bf16 forward at full width on the card against the same
  forward on the CPU (256 standard-normal rows, seed 0), with cuBLAS's bf16
  reduced-precision reductions off, as the bench runs it. Tolerance as in
  tests/test_torch_bf16.py, from the CPU's own bf16-vs-float32 gap on the
  same inputs: max err ≤ 0.5 · max gap, mean err ≤ 0.25 · mean gap (the
  two devices round at the same places and differ where a float32 sum
  taken in another order rounds to the other bf16 neighbour).
* Graphed against eager bf16 `predict` at every bucket: the same device
  work in the same order, equal in every bit.
* The bf16 fused train step (a CUDA graph) against the eager one from one
  state and one seed with dropout on: parameters within rtol/atol 1e-5,
  as the float32 steps in tests/test_torch_graph_cuda.py.
"""

import numpy as np
import pytest
import torch

from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    create_complete_deer_model,
)
from tpu_deer_torch.serve import InferenceEngine
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

pytestmark = pytest.mark.cuda

BF16 = DEERModelConfig(compute_dtype="bfloat16")
WIDTH = dict(encoder_dim=64, fusion_dim=128, encoder_layers=1,
             compute_dtype="bfloat16")
MAX_FRAC, MEAN_FRAC = 0.5, 0.25


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


def _forward(model, inputs, device):
    with torch.no_grad():
        out = model.to(device)(*(torch.from_numpy(x).to(device) for x in inputs))
    return {k: out[k].float().cpu().numpy()
            for k in ("mu_all", "uncertainty_all", "calibrated_uncertainty")}


def test_card_bf16_forward_matches_cpu(device):
    state = create_complete_deer_model(seed=0, device="cpu").state_dict()
    rng = np.random.default_rng(0)
    inputs = [rng.standard_normal((256, d)).astype(np.float32)
              for d in (84, 256, 768)]
    outs = {}
    for name, cfg, dev in (("card", BF16, device), ("cpu", BF16, "cpu"),
                           ("cpu_f32", DEERModelConfig(), "cpu")):
        model = CompleteDEERModel(cfg)
        model.load_state_dict(state)
        outs[name] = _forward(model.eval(), inputs, dev)
    for key, ref in outs["cpu"].items():
        gap = np.abs(ref - outs["cpu_f32"][key])
        err = np.abs(outs["card"][key] - ref)
        assert err.max() <= MAX_FRAC * gap.max(), (key, err.max(), gap.max())
        assert err.mean() <= MEAN_FRAC * gap.mean(), (key, err.mean(),
                                                      gap.mean())


def test_graphed_bf16_predict_equals_eager(device):
    model = create_complete_deer_model(DEERModelConfig(**WIDTH), seed=3,
                                       device=device)
    graphed = InferenceEngine(model, device=device)
    eager = InferenceEngine(model, device=device, graphs=False)
    graphed.warmup()
    rng = np.random.default_rng(1)
    for n in (1, 8, 64, 256, 300):
        feats = [rng.standard_normal((n, d)).astype(np.float32)
                 for d in (84, 256, 768)]
        got, ref = graphed.predict(*feats), eager.predict(*feats)
        assert set(got) == set(ref)
        for key in ref:
            assert got[key].dtype == np.float32, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert all(g.replays > 0 for g in graphed.bucket_graphs._graphs.values())


def _trainer(device, fused):
    model = create_complete_deer_model(DEERModelConfig(**WIDTH), seed=3,
                                       device=device)
    cfg = TrainingConfig(batch_size=64, num_epochs=3, learning_rate=2e-3,
                         warmup_epochs=1, dataset_weights={"synthetic": 1.0},
                         fused_epochs=fused, seed=7)
    return DEERTrainer(model, cfg, steps_per_epoch=8, device=device)


def test_bf16_fused_step_matches_eager(device):
    s = make_synthetic_splits(SyntheticConfig(n_train=512, n_val=64, n_test=8,
                                              seed=11))
    iters = {"synthetic": BatchIterator(ArrayDataset(s["train"], "synthetic"),
                                        64, shuffle=True, drop_last=True,
                                        seed=7)}
    graphed = _trainer(device, True)
    graphed.train_epoch(iters, 0)  # warm-up, capture, replays
    eager = _trainer(device, False)
    eager.load_state_dict(graphed.state_dict())
    replays = graphed.graph_replays
    got = graphed.train_epoch(iters, 1)  # every step a replay
    ref = eager.train_epoch(iters, 1)
    assert graphed.graph_replays - replays == 8
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    want = eager.model.state_dict()
    for name, p in graphed.model.state_dict().items():
        assert p.dtype == torch.float32, name
        torch.testing.assert_close(p, want[name], rtol=1e-5, atol=1e-5,
                                   msg=name)
