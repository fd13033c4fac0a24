"""The port's MultiDatasetFramework against the JAX package on the CPU, and
`python -m tpu_deer_torch.train.multi_dataset --quick --platform cpu` in an
interpreter that cannot import `jax`, `flax` or `tpu_deer`.

Both sides train the reference test's narrow model (12-d inputs, encoder
24, fusion 48, one layer) with dropout off from the port's seeded init,
converted (the reference's model factory and trainer are replaced in its
module for the test, its attention dropout off as in
tests/test_torch_trainer.py), on two synthetic datasets that share a label
function, for two joint epochs under the curriculum and the dataset weights
(1.0 / 0.8). The port runs per step and with fused epochs (the staged index
matrix). Held, as the trainer comparison holds them: per-epoch train loss
rtol 1e-5, every evaluation number rtol 1e-4, atol 1e-5. The transfer
matrix trains one model a source (a reference compile each, so it is not
run on the JAX side): its dictionary's keys, and its effectiveness as the
reference's formula of its own source and target CCC.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_deer.core.metrics import cross_dataset_transfer_effectiveness
from tpu_deer.data.pipeline import ArrayDataset as JDataset
from tpu_deer.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer.models import deer_model as jdm
from tpu_deer.train import multi_dataset as jmd
from tpu_deer.train.trainer import DEERTrainer as JTrainer
from tpu_deer.train.trainer import TrainingConfig as JConfig
from tpu_deer_torch.convert import state_dict_to_flax
from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.models import deer_model as tdm
from tpu_deer_torch.train import multi_dataset as tmd
from tpu_deer_torch.train.trainer import TrainingConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(audio_dim=12, video_dim=12, text_dim=12, encoder_dim=24,
             fusion_dim=48, attention_heads=4, encoder_layers=1, dropout=0.0)
TRAIN = dict(learning_rate=5e-3, batch_size=32, num_epochs=2, warmup_epochs=0,
             scheduler="constant", early_stopping_patience=50,
             dataset_weights={"dsa": 1.0, "dsb": 0.8}, seed=0)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
SKIP = {"eval_time_s", "training_time_s"}


def _arrays(seed):
    return make_synthetic_splits(SyntheticConfig(
        n_train=96, n_val=48, n_test=48, audio_dim=12, video_dim=12, text_dim=12,
        label_noise=0.05, hard_fraction=0.0, seed=seed, label_seed=7))


class _Deterministic:
    def __init__(self, model):
        self._model = model
        self.config = model.config

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self._model.apply(variables, *args, deterministic=True, **kw)


class _JTrainer(JTrainer):
    def __init__(self, model, *args, **kwargs):
        super().__init__(model, *args, **kwargs)
        self.model = _Deterministic(model)


def _port_model(config, seed=42, device=None):
    model = tdm.create_complete_deer_model(config, seed=seed, device="cpu")
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _jax_model(config, seed=42):
    port = _port_model(tdm.DEERModelConfig(**MODEL), seed)
    return jdm.CompleteDEERModel(config), state_dict_to_flax(port.state_dict())


def _frameworks(fused):
    data = {n: _arrays(s) for n, s in (("dsa", 1), ("dsb", 2))}
    ref = jmd.MultiDatasetFramework(
        jdm.DEERModelConfig(**MODEL), JConfig(**TRAIN),
        {n: {k: JDataset(v, n) for k, v in d.items()} for n, d in data.items()},
        seed=0)
    got = tmd.MultiDatasetFramework(
        tdm.DEERModelConfig(**MODEL), TrainingConfig(**TRAIN, fused_epochs=fused),
        {n: {k: ArrayDataset(v, n) for k, v in d.items()} for n, d in data.items()},
        seed=0, device="cpu")
    return ref, got


@pytest.fixture(scope="module")
def reference():
    """The reference's joint run, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmd, "create_complete_deer_model", _jax_model)
        mp.setattr(jmd, "DEERTrainer", _JTrainer)
        fw, _ = _frameworks(False)
        return fw.run_multi_dataset_training()


def _assert_match(got, ref, label=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), label
        for k in ref:
            if k not in SKIP:
                _assert_match(got[k], ref[k], f"{label}.{k}")
    elif isinstance(ref, (str, bool)) or ref is None:
        assert got == ref, label
    elif isinstance(ref, (list, tuple)) and ref and isinstance(ref[0], str):
        assert list(got) == list(ref), label
    else:
        np.testing.assert_allclose(np.asarray(got, float), np.asarray(ref, float),
                                   err_msg=label, **METRIC_TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["per_step", "fused"])
def test_joint_training_matches_jax(reference, fused, monkeypatch):
    monkeypatch.setattr(tmd, "create_complete_deer_model", _port_model)
    ref_joint = reference
    _, fw = _frameworks(fused)
    got = fw.run_multi_dataset_training()
    np.testing.assert_allclose(got.joint["history"]["train_loss"],
                               ref_joint.joint["history"]["train_loss"], rtol=1e-5)
    _assert_match({k: v for k, v in got.joint.items() if k != "history"},
                  {k: v for k, v in ref_joint.joint.items() if k != "history"},
                  "joint")
    _assert_match(got.per_dataset, ref_joint.per_dataset, "per_dataset")
    assert set(got.per_dataset) == {"dsa", "dsb"}
    if fused:  # the steps of an epoch are the sum over the datasets
        assert fw.joint_trainer.steps_per_epoch == 2 * (96 // 32)
        return
    transfer = fw.evaluate_cross_dataset()
    assert list(transfer) == ["dsa->dsb", "dsb->dsa"]
    for pair, r in transfer.items():
        assert set(r) == {"source_ccc", "target_ccc", "target_mae",
                          "transfer_effectiveness"}
        assert r["transfer_effectiveness"] == cross_dataset_transfer_effectiveness(
            r["source_ccc"], r["target_ccc"])
    # Each source's CCC is its own single-dataset model on its test split.
    assert transfer["dsa->dsb"]["source_ccc"] != transfer["dsb->dsa"]["source_ccc"]


def test_report_matches_jax(tmp_path):
    results = dict(joint={"best_val_ccc": 0.5},
                   per_dataset={"dsa": {"ccc_average": 0.5}},
                   transfer={"dsa->dsb": {"source_ccc": 0.5, "target_ccc": 0.4,
                                          "target_mae": 0.2,
                                          "transfer_effectiveness": 0.8}},
                   training_time_s=1.0)
    ref_fw, fw = _frameworks(False)
    ref_fw.meta = fw.meta = {"text_backend": {"dsa": "hashed"}}
    paths = [str(tmp_path / f"{side}.json") for side in ("ref", "port")]
    ref_fw.generate_report(jmd.MultiDatasetResults(**results), paths[0])
    fw.generate_report(tmd.MultiDatasetResults(**results), paths[1])
    ref, got = (json.load(open(p)) for p in paths)
    assert got == ref and got["transfer_effectiveness_avg"] == pytest.approx(0.8)
    assert got["datasets"]["dsa"]["train"] == 96


RUN = """
import runpy, sys

class Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "tpu_deer"):
            raise ImportError(f"{name} is blocked in this interpreter")
        return None

sys.meta_path.insert(0, Blocked())
sys.argv = ["tpu_deer_torch.train.multi_dataset", "--quick", "--platform", "cpu",
            "--n", "64", "--epochs", "1", "--report", sys.argv[1]]
try:
    runpy.run_module("tpu_deer_torch.train.multi_dataset", run_name="__main__",
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


def test_main_quick_runs_without_jax(tmp_path):
    report = str(tmp_path / "report.json")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", RUN, report], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(report) as f:
        payload = json.load(f)
    assert set(payload["per_dataset"]) == {"iemocap", "ravdess", "meld"}
    assert len(payload["transfer"]) == 6 and payload["platform"] == "cpu"
    assert payload["meta"]["text_backend"]["meld"] == "precomputed-synthetic"
    assert os.path.exists(str(tmp_path / "report.md"))
