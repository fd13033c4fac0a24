"""The port's parallel layouts across processes: a world of 2 (mesh 2 × 1)
and one of 4 (2 × 2) on gloo, on the CPU, against the JAX package's mesh
step on the conftest's virtual devices, on the same weights and data.

Both worlds are launched once for the module, together, each with a
deadline of DEADLINE_S seconds (tests/_torch_dist_worker.py: one process
a rank, torch and the port only, one thread each, OMP_NUM_THREADS=1; a
file:// rendezvous under the test's temporary directory), and the JAX
reference runs in this process meanwhile (one mesh step of the JAX
trainer, shared by both worlds). Each rank takes two steps of
`DEERTrainer(mesh=..., runtime=...)` under 'tp', 'fsdp' and 'replicated',
computes the psum'd CCC, assembles the batch from BatchIterator's
per-process rows, and saves and restores the fsdp state in the sharded
format.

The loss is the combined DEER loss: the v2 loss's binned ECE, the
reliability calibration term, the cross-dimension consistency and the
uncertainty regularisation are functions of the whole batch, so a step
that averaged per-process losses would differ. Against the reference
dropout is off (the port's Dropout p = 0, the reference's model applied
deterministically). With the model's dropout on (p 0.1) each layout's
steps, and fsdp's under remat, are held against the port's trainer without
a mesh from the same seed: every process keeps its rows of the global
batch's masks, so a step that drew one mask a shard would differ.
Tolerances, the trainer tests': losses and gradient norms rtol 1e-5,
parameters atol 1e-4 (float32 sums in another order; Adam turns the noise
of near-zero gradients into steps of up to about lr = 1e-4). The psum'd
CCC equals the host's sum of the shards' statistics exactly.
"""

import functools
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deer.core import metrics as jmetrics
from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JConfig
from tpu_deer.parallel.mesh import MeshConfig as JMeshConfig
from tpu_deer.parallel.mesh import create_mesh as jcreate_mesh
from tpu_deer.train.trainer import DEERTrainer as JTrainer
from tpu_deer.train.trainer import TrainingConfig as JTrainingConfig
from tpu_deer_torch.convert import flax_to_state_dict, state_dict_to_flax
from tpu_deer_torch.core import losses as tlosses
from tpu_deer_torch.core.metrics import CCCStats, ccc_from_stats
from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    create_complete_deer_model,
)
from tpu_deer_torch.train.checkpoint import CheckpointManager
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
DEADLINE_S = 120
WORLDS = {2: (2, 1), 4: (2, 2)}  # world → (data, model)
MODES = ("tp", "fsdp", "replicated")
# The worker's dropout-on runs → (layout, remat).
DROPOUT_CASES = {f"{m}_dropout": (m, False) for m in MODES}
DROPOUT_CASES["fsdp_dropout_remat"] = ("fsdp", True)
# __graft_entry__.py's dryrun configuration.
MODEL = dict(audio_dim=16, video_dim=16, text_dim=16, encoder_dim=32,
             fusion_dim=64, attention_heads=4, encoder_layers=1, dropout=0.1)
TRAINING = dict(batch_size=16, num_epochs=1, warmup_epochs=0,
                scheduler="constant", learning_rate=1e-4, loss_type="combined",
                seed=3)


@functools.lru_cache(maxsize=None)
def _inputs():
    model = create_complete_deer_model(DEERModelConfig(**MODEL), seed=0,
                                       device="cpu")
    split = make_synthetic_splits(SyntheticConfig(
        n_train=TRAINING["batch_size"], n_val=0, n_test=0, audio_dim=16,
        video_dim=16, text_dim=16, seed=7))["train"]
    batch = {k: split[k] for k in ("audio", "video", "text", "labels")}
    pred = (batch["labels"] + 0.3 * np.random.default_rng(1).standard_normal(
        batch["labels"].shape)).astype(np.float32)
    return {"model": MODEL, "init": {k: v.clone() for k, v in
                                     model.state_dict().items()},
            "batch": batch, "pred": pred, "training": TRAINING, "steps": 1}


class _Deterministic:
    """The reference's model with every dropout off."""

    def __init__(self, model):
        self._model = model
        self.config = model.config

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self._model.apply(variables, *args, deterministic=True, **kw)


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """Two steps of the reference's trainer on its mesh of 2 × 2 virtual
    devices under 'fsdp' (composed with the tensor-parallel rules over
    "model"): (losses, grad norms, params). XLA's partitioning computes the
    same step under any layout; one compile (~30 s here) serves every
    layout and both worlds."""
    inputs = _inputs()
    mesh = jcreate_mesh(JMeshConfig(data=2, model=2), devices=jax.devices()[:4])
    jm = JModel(JConfig(**MODEL))
    trainer = JTrainer(jm, state_dict_to_flax(inputs["init"]),
                       JTrainingConfig(**TRAINING, param_sharding="fsdp"),
                       steps_per_epoch=1, mesh=mesh)
    trainer.model = _Deterministic(jm)
    batch = trainer._put(inputs["batch"])
    state, losses, norms = trainer.state, [], []
    for _ in range(2):
        state, aux = trainer._train_step(state, batch, jnp.asarray(1.0),
                                         jnp.asarray(1.0))
        losses.append(float(aux["loss"]))
        norms.append(float(aux["grad_norm"]))
    return losses, norms, flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params))


def _plain(dropout=False, **overrides):
    """The port's trainer without a mesh from the init, dropout off unless
    asked."""
    model = CompleteDEERModel(DEERModelConfig(**MODEL))
    model.load_state_dict(_inputs()["init"])
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout) and not dropout:
            m.p = 0.0
    return DEERTrainer(model, TrainingConfig(**{**TRAINING, **overrides}),
                       steps_per_epoch=1, device="cpu")


def _batch():
    return {k: torch.from_numpy(v) for k, v in _inputs()["batch"].items()}


@functools.lru_cache(maxsize=None)
def _port_steps(dropout=False, remat=False):
    """Two steps of the port's trainer without a mesh on the whole batch."""
    trainer = _plain(dropout, remat=remat)
    aux = [trainer._train_step(_batch(), 1.0, 1.0) for _ in range(2)]
    return ([float(a["loss"]) for a in aux], [float(a["grad_norm"]) for a in aux],
            {k: v.detach().clone() for k, v in trainer.model.state_dict().items()})


def _launch(world, root):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    data, model = WORLDS[world]
    return [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(data), str(model), root],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for r in range(world)]


def _wait(procs, deadline):
    """Every rank's exit code by `deadline` (time.monotonic()); a rank
    still running then is killed with the rest and the test fails."""
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the gloo world did not finish within {DEADLINE_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errors = [p.stderr.read() for p in procs]
    for p in procs:
        p.stderr.close()
    bad = [(r, p.returncode, errors[r][-3000:]) for r, p in enumerate(procs)
           if p.returncode != 0]
    assert not bad, bad


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both worlds, launched together at the module's first test: {world:
    (root, processes, deadline)}; a rank still running at teardown is
    killed."""
    out = {}
    for size in sorted(WORLDS):
        root = str(tmp_path_factory.mktemp(f"world{size}"))
        torch.save(_inputs(), os.path.join(root, "inputs.pt"))
        out[size] = root, _launch(size, root), time.monotonic() + DEADLINE_S
    yield out
    for _, procs, _ in out.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", params=sorted(WORLDS), ids=lambda w: f"world{w}")
def world(request, launched):
    """{"world", "ranks": every rank's results, "root"}: the worlds run
    while this process computes the references."""
    size = request.param
    root, procs, deadline = launched[size]
    try:
        _jax_steps()
        _port_steps()
        for case in DROPOUT_CASES.values():
            _port_steps(True, case[1])
    finally:
        _wait(procs, deadline)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(size)]
    return {"world": size, "ranks": ranks, "root": root}


def _close_params(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_ranks_run_without_jax_on_the_mesh(world):
    data, model = WORLDS[world["world"]]
    coords = [r["coordinate"] for r in world["ranks"]]
    assert coords == [{"data": i // model, "model": i % model}
                      for i in range(world["world"])]
    assert not any(r["jax_loaded"] for r in world["ranks"])


def test_psum_ccc_equals_host_ccc(world):
    """Exactly the CCC of the shards' statistics summed on the host (one
    "data" group's, in rank order); within 1e-6 of the JAX package's CCC
    of the whole arrays."""
    data, model = WORLDS[world["world"]]
    shards = [r["stats"] for r in world["ranks"][::model]]
    host = CCCStats(*(functools.reduce(torch.add, [s[i] for s in shards])
                      for i in range(6)))
    for r in world["ranks"]:
        assert torch.equal(r["ccc"], ccc_from_stats(host))
    inputs = _inputs()
    np.testing.assert_allclose(
        float(world["ranks"][0]["ccc"]),
        jmetrics.ccc_np(inputs["batch"]["labels"].ravel(),
                        inputs["pred"].ravel()), rtol=0, atol=1e-6)


def test_global_batch_loss_terms_are_nonzero(world):
    """The batch-level terms of the loss the steps below hold are live on
    this batch at the init."""
    inputs = _inputs()
    model = CompleteDEERModel(DEERModelConfig(**MODEL))
    model.load_state_dict(inputs["init"])
    model.eval()
    with torch.no_grad():
        out = model(*(torch.from_numpy(inputs["batch"][k])
                      for k in ("audio", "video", "text")))
    ps = [out[f"{n}_params"] for n in model.config.dim_names]
    y = torch.from_numpy(inputs["batch"]["labels"])
    terms = tlosses.combined_deer_loss(ps, y, tlosses.DEERLossConfig())
    for key in ("valence_ece_loss", "arousal_ece_loss", "dominance_ece_loss",
                "calibration_loss", "cross_dim_loss"):
        assert float(terms[key]) > 0, key
    assert len(world["ranks"]) == world["world"]


@pytest.mark.parametrize("mode", MODES)
def test_step_matches_jax_mesh_step_and_unsharded(world, mode):
    jlosses, jnorms, jparams = _jax_steps()
    plosses, pnorms, pparams = _port_steps()
    data, model = WORLDS[world["world"]]
    for r in world["ranks"]:
        got = r[mode]
        np.testing.assert_allclose(got["loss"], jlosses, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], jnorms, rtol=1e-5)
        _close_params(got["params"], jparams)
        np.testing.assert_allclose(got["loss"], plosses, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], pnorms, rtol=1e-5)
        _close_params(got["params"], pparams)
        assert r["local_rows"] == TRAINING["batch_size"] // data
    split = world["ranks"][0][mode]["split"]
    if mode == "fsdp":
        assert len(split) == 39  # every >= 2-D tensor the data size divides
    elif mode == "tp":
        assert len(split) == (11 if model > 1 else 0)
    else:
        assert split == []


@pytest.mark.parametrize("case", sorted(DROPOUT_CASES))
def test_dropout_step_matches_unsharded(world, case):
    """Dropout on: each process's rows take their masks from the global
    batch's draw, so two meshed steps equal the trainer's without a mesh
    from the same seed (the trainer tolerances); the masks are live (the
    steps differ from dropout-off ones)."""
    plosses, pnorms, pparams = _port_steps(True, DROPOUT_CASES[case][1])
    off = _port_steps()[0]
    assert all(abs(a - b) > 1e-3 * abs(b) for a, b in zip(plosses, off))
    for r in world["ranks"]:
        got = r[case]
        np.testing.assert_allclose(got["loss"], plosses, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], pnorms, rtol=1e-5)
        _close_params(got["params"], pparams)


def test_per_process_iterator_raises_under_a_mesh(world):
    """The trainer takes global batches and keeps each process's rows; a
    BatchIterator already sliced per process would train on a part of a
    part, so it raises."""
    for r in world["ranks"]:
        assert "pass iterators over the whole dataset" in r["per_process_iterator"]


def test_shard_params_pieces_make_the_whole(world):
    """`shard_params` under fsdp: each tensor's DTensor gathers back to the
    init; the tensors split over "data" are the trainer's fsdp split ones
    (data 2 here in both worlds)."""
    for r in world["ranks"]:
        assert r["shard_params"]
        assert r["shard_params_split"] == sorted(r["fsdp"]["split"])


def test_batch_not_divisible_by_data_raises(world):
    for r in world["ranks"]:
        assert "must be divisible by the mesh 'data' axis" in r["indivisible"]


def test_batch_iterator_rows_assemble_the_global_batch(world):
    assert all(r["assembled_equal"] for r in world["ranks"])


def test_fsdp_checkpoint_restores_bit_for_bit(world):
    """Onto its own placements in the world (every piece), and whole here,
    without a mesh: the model and the moments the world holds."""
    assert all(r["restored_equal"] for r in world["ranks"])
    ckpt = CheckpointManager(os.path.join(world["root"], "ckpt"))
    assert ckpt.metadata(3)["format"] == "sharded"
    assert ckpt.metadata(3)["process_count"] == world["world"]
    state = ckpt.restore(step=3)
    rank0 = world["ranks"][0]
    for k, v in rank0["fsdp"]["params"].items():
        assert torch.equal(state["model"][k], v), k
    for k, v in rank0["fsdp_mu"].items():
        assert torch.equal(state["optimizer"]["mu"][k], v), k
    assert state["step"] == 2 and state["optimizer"]["count"] == 2


def test_cross_layout_restore(world):
    """fsdp → tp in the world, and the sharded checkpoint into a trainer
    without a mesh here; both resume the same step."""
    rank0 = world["ranks"][0]
    for r in world["ranks"]:
        cross = r["cross_layout"]
        assert cross["step"] == 2
        for k, v in rank0["fsdp"]["params"].items():
            assert torch.equal(cross["params"][k], v), k
        for k, v in rank0["fsdp_mu"].items():
            assert torch.equal(cross["mu"][k], v), k
        resumed, straight = r["resumed_loss"]
        np.testing.assert_allclose(resumed, straight, rtol=1e-6)
    plain = _plain()
    plain.load_state_dict(CheckpointManager(
        os.path.join(world["root"], "ckpt")).restore(step=3))
    for k, v in rank0["fsdp"]["params"].items():
        assert torch.equal(plain.model.state_dict()[k], v), k
    aux = plain._train_step(_batch(), 1.0, 1.0)
    np.testing.assert_allclose(float(aux["loss"]), rank0["resumed_loss"][1],
                               rtol=1e-5)


def test_train_loop_and_resume_match_unsharded(world):
    """`train()` under fsdp (an epoch with validation and sharded
    checkpoints, then a new trainer resuming for a second) against the
    port's trainer without a mesh training two epochs straight."""
    data = {"s": ArrayDataset(dict(_inputs()["batch"]), "s")}
    one = _plain(num_epochs=2).train(data, data, num_epochs=1)["best_val_ccc"]
    straight = _plain(num_epochs=2)
    res = straight.train(data, data)
    for r in world["ranks"]:
        np.testing.assert_allclose(r["loop_first"], one, rtol=1e-4, atol=1e-5)
        assert r["loop"]["final_step"] == res["final_step"] == 2
        np.testing.assert_allclose(r["loop"]["best_val_ccc"],
                                   res["best_val_ccc"], rtol=1e-4, atol=1e-5)
        _close_params(r["loop"]["params"], {
            k: v.numpy() for k, v in straight.model.state_dict().items()})


def test_no_piece_is_written_twice(world):
    """Each file of a save is written by one rank: the pieces of a leaf
    replicated over an axis by the rank at coordinate 0 of it; the manifest
    lists every file."""
    for save in range(3):  # steps 1, 2 and 3
        names = [n for r in world["ranks"] for n in r["written"][save]]
        assert len(names) == len(set(names))
    path = os.path.join(world["root"], "ckpt", "step_00000003")
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    files = set(os.listdir(os.path.join(path, "arrays")))
    assert files == set(names)
    assert sum(len(m.get("chunks", [])) for m in leaves.values()) == len(files)


def test_best_and_prune(world):
    ckpt = CheckpointManager(os.path.join(world["root"], "ckpt"), keep_last=2)
    assert ckpt.all_steps() == [2, 3]
    assert ckpt.metadata("best")["metrics"]["epoch"] == 2
    best = ckpt.restore(step="best")
    assert best["step"] == 2
    assert not any(n.endswith(".partial")
                   for n in os.listdir(os.path.join(world["root"], "ckpt")))


def test_missing_leaf_raises(world):
    ckpt = CheckpointManager(os.path.join(world["root"], "ckpt"))
    template = {"model": {"not.a.parameter": torch.zeros(2)}}
    with pytest.raises(ValueError, match="lacks template leaves"):
        ckpt.restore(step=3, template=template)
