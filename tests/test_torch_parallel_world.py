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
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_reference import draw_params
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from tpu_deer.core import metrics as jmetrics
from tpu_deer.models.fusion import MoEFusion as JMoEFusion
from tpu_deer.ops.flash_attention import reference_attention
from tpu_deer.parallel.pipeline import pipeline_sharded as jpipeline_sharded
from tpu_deer.parallel.sequence import ring_attention as jring_attention
from tpu_deer.parallel.sequence import ring_attention_sharded as jring_sharded
from tpu_deer.train.ensemble import EnsembleTrainer as JEnsembleTrainer
from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JConfig
from tpu_deer.parallel.mesh import MeshConfig as JMeshConfig
from tpu_deer.parallel.mesh import create_mesh as jcreate_mesh
from tpu_deer.parallel.mesh import shard_params as jshard_params
from tpu_deer.train.trainer import DEERTrainer as JTrainer
from tpu_deer.train.trainer import TrainingConfig as JTrainingConfig
from tpu_deer_torch.convert import (
    flax_to_state_dict,
    stacked_flax_to_state_dict,
    state_dict_to_flax,
    state_dict_to_stacked_flax,
)
from tpu_deer_torch.core import losses as tlosses
from tpu_deer_torch.core.metrics import CCCStats, ccc_from_stats
from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    create_complete_deer_model,
)
from tpu_deer_torch.models.deer_model import structure
from tpu_deer_torch.models.fusion import MoEFusion
from tpu_deer_torch.models.layers import init_flax_style_
from tpu_deer_torch.parallel.dryrun import dryrun_batch, training_config
from tpu_deer_torch.train.checkpoint import CheckpointManager
from tpu_deer_torch.train.ensemble import EnsembleTrainer, create_deer_ensemble
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


# The ring's, GPipe's and MoE's inputs (the reference's tests' shapes).
RING = dict(b=3, h=4, t=64, d=16, lengths=(37, 53, 0))
PIPE = dict(d=16, b=32)
MOE = dict(args=((32, 48, 16), 64), kwargs=dict(num_experts=4, expert_hidden=32))
# The dry run's configuration at world 4 (__graft_entry__.py:139-152) with
# its model's dropout off on both sides.
DRY_WORLD = 4
DRY_MODEL = {**MODEL}


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _par_inputs():
    """The inputs of the ring, GPipe, MoE, ensemble and dry-run checks
    (numpy from seeds; the dry run's init is drawn for the reference's
    flagship tree (`_jax_reference.draw_params`: its tree from
    `jax.eval_shape`, no init compile) and converted, the ensemble's is the
    port's seed-0 stack)."""
    rng = np.random.default_rng(11)
    b, h, t, d = (RING[k] for k in "bhtd")
    ring = {x: _f32(rng, b, h, t, d) for x in "qkvw"}
    ring["mask"] = (np.arange(t)[None, :] < np.asarray(RING["lengths"])[:, None]
                    ).astype(np.float32)
    pipe = {"w": _f32(rng, 4, PIPE["d"], PIPE["d"], scale=0.1),
            "b": _f32(rng, 4, PIPE["d"], scale=0.1),
            "x": _f32(rng, PIPE["b"], PIPE["d"]),
            "y": _f32(rng, PIPE["b"], PIPE["d"]),
            "x24": _f32(rng, 24, PIPE["d"])}
    moe = MoEFusion(*MOE["args"], **MOE["kwargs"])
    init_flax_style_(moe, torch.Generator().manual_seed(5))
    mods = [_f32(rng, 8, dim) for dim in MOE["args"][0]]
    dummy = [jnp.zeros((2, 16))] * 3
    jparams = draw_params(JModel(JConfig(**DRY_MODEL)), *dummy, seed=0,
                          deterministic=True)
    _, stack = create_deer_ensemble(DEERModelConfig(**DRY_MODEL), n_members=2,
                                    seed=0, device="cpu")
    tcfg = training_config(DRY_WORLD)
    return {
        "ring": ring,
        "ring_dp": {x: _f32(rng, 4, 2, 32, 8) for x in "qkv"},
        "ring_t256": {x: _f32(rng, 1, 1, 256, 8) for x in "qkv"},
        "pipe": pipe,
        "moe": {**MOE, "init": {k: v.detach().clone()
                                for k, v in moe.state_dict().items()},
                "mods": mods},
        "dryrun_init": flax_to_state_dict(jparams),
        "ensemble": {"model": DRY_MODEL,
                     "init": stack,
                     "training": {"batch_size": tcfg.batch_size,
                                  "num_epochs": 1, "warmup_epochs": 0,
                                  "scheduler": "constant",
                                  "param_sharding": "ensemble"}},
    }


class _Deterministic:
    """The reference's model with every dropout off."""

    def __init__(self, model):
        self._model = model
        self.config = model.config

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self._model.apply(variables, *args, deterministic=True, **kw)


def _jax_two_steps(trainer, state, batch):
    """Two of the reference trainer's mesh steps from `state`: (losses,
    grad norms, the state after them). The first step's outputs come back
    with the shardings XLA chose, and a state on those would compile the
    step a second time (~17 s here); the second step takes the state put
    back on the first one's shardings (the scalars uncommitted, as the
    trainer made them), so one program serves both: the same function,
    its float sums in another order at most."""
    placed = jax.tree_util.tree_map(lambda x: x.sharding, state)
    one, losses, norms = jnp.asarray(1.0), [], []
    for i in range(2):
        if i:
            state = jax.tree_util.tree_map(
                lambda x, s: (jax.device_put(x, s) if isinstance(s, NamedSharding)
                              else jnp.asarray(np.asarray(x))), state, placed)
        state, aux = trainer._train_step(state, batch, one, one)
        losses.append(float(aux["loss"]))
        norms.append(float(aux["grad_norm"]))
    return losses, norms, state


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """Two steps of the reference's trainer on its mesh of 2 × 2 virtual
    devices under 'fsdp' (composed with the tensor-parallel rules over
    "model"): (losses, grad norms, params). XLA's partitioning computes the
    same step under any layout; one compile (~17 s here) serves every
    layout and both worlds."""
    inputs = _inputs()
    mesh = jcreate_mesh(JMeshConfig(data=2, model=2), devices=jax.devices()[:4])
    jm = JModel(JConfig(**MODEL))
    trainer = JTrainer(jm, state_dict_to_flax(inputs["init"]),
                       JTrainingConfig(**TRAINING, param_sharding="fsdp"),
                       steps_per_epoch=1, mesh=mesh)
    trainer.model = _Deterministic(jm)
    losses, norms, state = _jax_two_steps(trainer, trainer.state,
                                          trainer._put(inputs["batch"]))
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


# -- the references of the sequence, pipeline and expert checks -----------------

def _seq_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), axis_names=("seq",))


@functools.lru_cache(maxsize=None)
def _jax_ring(n, case):
    """The reference's ring on n virtual devices: (out, grads of
    sum(out · w) in q, k, v)."""
    ring = _par_inputs()["ring"]
    rows = slice(0, 2) if case == "plain" else slice(None)
    q, k, v, w = (jnp.asarray(ring[x][rows]) for x in "qkvw")
    mask = None if case == "plain" else jnp.asarray(ring["mask"])
    mesh = _seq_mesh(n)

    def loss(q, k, v):
        out = jring_sharded(mesh, q, k, v, mask)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@functools.lru_cache(maxsize=None)
def _jax_ring_dp_and_t256():
    par = _par_inputs()
    devs = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, axis_names=("data", "seq"))
    spec = P("data", None, "seq", None)
    dp = jax.jit(jax.shard_map(
        lambda q, k, v: jring_attention(q, k, v, axis_name="seq"), mesh=mesh,
        in_specs=(spec,) * 3, out_specs=spec))(
        *(jnp.asarray(par["ring_dp"][x]) for x in "qkv"))
    long = jax.jit(functools.partial(jring_sharded, _seq_mesh(4)))(
        *(jnp.asarray(par["ring_t256"][x]) for x in "qkv"))
    return np.asarray(dp), np.asarray(long)


def _stage(p, h):
    return h + jnp.tanh(h @ p["w"] + p["b"])


@functools.lru_cache(maxsize=None)
def _jax_pipe(s):
    """(the reference's GPipe on s stages, the sequential fold, the fold's
    gradients of the mean-square loss in w, b and x)."""
    pipe = _par_inputs()["pipe"]
    params = {k: jnp.asarray(pipe[k][:s]) for k in ("w", "b")}
    x, y = jnp.asarray(pipe["x"]), jnp.asarray(pipe["y"])
    mesh = Mesh(np.asarray(jax.devices()[:s]), axis_names=("stage",))
    piped = jax.jit(lambda p, x: jpipeline_sharded(
        mesh, _stage, p, x, num_microbatches=2 * s))(params, x)

    def sequential(params, x):
        return jax.lax.scan(lambda h, p: (_stage(p, h), None), x, params)[0]

    g = jax.jit(jax.grad(lambda p, x: jnp.mean((sequential(p, x) - y) ** 2),
                         argnums=(0, 1)))(params, x)
    return (np.asarray(piped), np.asarray(jax.jit(sequential)(params, x)),
            [np.asarray(g[0]["w"]), np.asarray(g[0]["b"]), np.asarray(g[1])])


@functools.lru_cache(maxsize=None)
def _jax_moe():
    """flax's MoEFusion on the port's init, converted: (out, the gradients
    of mean(out²) in the params (as a state_dict) and in the inputs)."""
    moe = _par_inputs()["moe"]
    jm = JMoEFusion(*moe["args"], **moe["kwargs"])
    params = state_dict_to_flax(moe["init"])
    mods = [jnp.asarray(m) for m in moe["mods"]]
    fn = jax.jit(lambda p, m: jm.apply({"params": p}, m))
    gp, gm = jax.jit(jax.grad(lambda p, m: jnp.mean(fn(p, m) ** 2),
                              argnums=(0, 1)))(params, mods)
    return (np.asarray(fn(params, mods)),
            flax_to_state_dict(jax.tree_util.tree_map(np.asarray, gp)),
            [np.asarray(g) for g in gm])


def _jax_mesh():
    return jcreate_mesh(JMeshConfig(data=2, model=2), devices=jax.devices()[:4])


@functools.lru_cache(maxsize=None)
def _jax_ensemble_steps():
    """The reference's EnsembleTrainer on its 2 × 2 mesh under 'ensemble',
    dropout off, with the dry run's configuration and batch: two steps from
    the converted stack ((losses, grad norms, stacked params)), and the
    first step's loss from a stack of two copies of the dry run's init
    (weights drawn for the reference's flagship tree): the member mean of
    two equal losses, the dry run's single-model loss (its dp × tp and
    fsdp steps compute the same function), from the same compiled step."""
    par = _par_inputs()
    ens = par["ensemble"]
    jm = JModel(JConfig(**ens["model"]))
    mesh = _jax_mesh()
    trainer = JEnsembleTrainer(jm, state_dict_to_stacked_flax(ens["init"]),
                               JTrainingConfig(**ens["training"]),
                               steps_per_epoch=1, mesh=mesh)
    trainer.model = _Deterministic(jm)
    batch = trainer._put(dryrun_batch(DRY_WORLD))
    one = jnp.asarray(1.0)
    twin = jshard_params(state_dict_to_stacked_flax(
        {k: torch.stack([v, v]) for k, v in par["dryrun_init"].items()}),
        mesh, mode="ensemble")
    _, aux = trainer._train_step(trainer.state.replace(
        params=twin, opt_state=trainer.optimizer.init(twin),
        step=jnp.asarray(0, dtype=jnp.int32),
        dropout_rng=jax.random.PRNGKey(0)), batch, one, one)
    dryrun_loss = float(aux["loss"])
    losses, norms, state = _jax_two_steps(trainer, trainer.state, batch)
    return (losses, norms, stacked_flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params))), dryrun_loss


@functools.lru_cache(maxsize=None)
def _port_ensemble_steps(dropout):
    """Two steps of the port's EnsembleTrainer without a mesh on the dry
    run's whole batch."""
    ens = _par_inputs()["ensemble"]
    model = structure(DEERModelConfig(**ens["model"]))
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout) and not dropout:
            m.p = 0.0
    trainer = EnsembleTrainer(model, ens["init"], TrainingConfig(**{
        **ens["training"], "param_sharding": "replicated"}),
        steps_per_epoch=1, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in dryrun_batch(DRY_WORLD).items()}
    aux = [trainer._train_step(batch, 1.0, 1.0) for _ in range(2)]
    return ([float(a["loss"]) for a in aux], [float(a["grad_norm"]) for a in aux],
            {k: v.detach().clone() for k, v in trainer.params.items()})


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
        torch.save({**_inputs(), "par": _par_inputs()},
                   os.path.join(root, "inputs.pt"))
        out[size] = root, _launch(size, root), time.monotonic() + DEADLINE_S
    yield out
    out.pop("results", None)
    for _, procs, _ in out.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", params=sorted(WORLDS), ids=lambda w: f"world{w}")
def world(request, launched):
    """{"world", "ranks": every rank's results, "root"}: the worlds run
    while this process computes the references."""
    return _world(launched, request.param)


@pytest.fixture(scope="module")
def world4(launched):
    """World 4's results (the ("data", "model") = 2 × 2 checks)."""
    return _world(launched, 4)


def _references():
    """The references of both worlds' checks, computed in this process
    while the worlds run: the two JAX mesh steps (a compile each) on
    threads beside the rest."""
    with ThreadPoolExecutor(2) as pool:
        steps = [pool.submit(f) for f in (_jax_steps, _jax_ensemble_steps)]
        _port_steps()
        for case in DROPOUT_CASES.values():
            _port_steps(True, case[1])
        for size in sorted(WORLDS):
            for case in ("plain", "masked"):
                _jax_ring(size, case)
            _jax_pipe(size)
        _jax_moe()
        _jax_ring_dp_and_t256()
        _port_ensemble_steps(False)
        _port_ensemble_steps(True)
        for f in steps:
            f.result()


def _world(launched, size):
    root, procs, deadline = launched[size]
    if "results" not in launched:
        launched["results"] = {}
    if size not in launched["results"]:
        try:
            _references()
        finally:
            _wait(procs, deadline)
        launched["results"][size] = {
            "world": size, "root": root,
            "ranks": [torch.load(os.path.join(root, f"rank{r}.pt"),
                                 weights_only=False) for r in range(size)]}
    return launched["results"][size]


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


# -- sequence, pipeline and expert parallelism, the ensemble, the dry run ---------

def _assemble_t(blocks):
    """The global [B, H, T, D] array from the ranks' T blocks in rank order."""
    return np.concatenate([b.numpy() for b in blocks], axis=2)


def _summed(ranks, key, i):
    """Σ over the ranks of their part of gradient i."""
    return sum(r[key]["grads"][i].numpy() for r in ranks)


@pytest.mark.parametrize("case", ["plain", "masked"])
def test_ring_attention_matches_jax_ring(world, case):
    """The ring over ("seq",) of every rank (n = 2, 4) against the
    reference's ring on n virtual devices: the forward at atol 1e-5 and
    the gradients (summed over the ranks' parts) at 1e-4; "masked" has key
    lengths 37 and 53, off the block edges, and an all-masked element."""
    ranks = world["ranks"]
    ref, grads = _jax_ring(world["world"], case)
    np.testing.assert_allclose(_assemble_t([r[f"ring_{case}"]["out"]
                                            for r in ranks]), ref, atol=1e-5)
    for i, g in enumerate(grads):
        np.testing.assert_allclose(_summed(ranks, f"ring_{case}", i), g,
                                   atol=1e-4, err_msg="qkv"[i])
    if case == "masked":  # the all-masked element: the mean of v, no dq/dk
        v = _par_inputs()["ring"]["v"][2]
        np.testing.assert_allclose(ref[2], np.broadcast_to(
            v.mean(axis=1, keepdims=True), v.shape), atol=1e-5)
        assert not np.any(grads[0][2]) and not np.any(grads[1][2])


def test_ring_on_data_seq_mesh_and_at_t256(world4):
    """A 2 × 2 ("data", "seq") mesh (rows over "data", time over "seq")
    against the reference's ring under shard_map on the same mesh, and the
    ring at T 256 over 4 ranks against its ring, both at atol 1e-5."""
    ranks = world4["ranks"]
    dp, long = _jax_ring_dp_and_t256()
    for r in ranks:
        d, q = r["ring_dp"]["coords"]
        np.testing.assert_allclose(r["ring_dp"]["out"].numpy(),
                                   dp[2 * d:2 * d + 2, :, 16 * q:16 * q + 16],
                                   atol=1e-5)
    np.testing.assert_allclose(_assemble_t([r["ring_t256"] for r in ranks]),
                               long, atol=1e-5)
    ref = reference_attention(*(jnp.asarray(_par_inputs()["ring_t256"][x])
                                for x in "qkv"))
    np.testing.assert_allclose(long, np.asarray(ref), atol=1e-5)


def test_pipeline_matches_jax_and_the_sequential_fold(world):
    """S = world stages, M = 2·S microbatches ((2, 4) and (4, 8)): the
    output on every rank against the reference's GPipe and the sequential
    fold, the gradients of w, b and x (summed over the ranks' parts)
    against the fold's, at atol 1e-5; the same output for M ∈ {2, 6, 12};
    a batch the microbatches do not divide raises the reference's error."""
    ranks = world["ranks"]
    piped, sequential, grads = _jax_pipe(world["world"])
    np.testing.assert_allclose(piped, sequential, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["pipe"]["out"].numpy(), piped, atol=1e-5)
        outs = [o.numpy() for o in r["pipe_micro"]]
        np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)
        np.testing.assert_allclose(outs[1], outs[2], atol=1e-5)
        assert "not divisible by microbatches 3" in r["pipe_ragged"]
    s = world["world"]
    for i, (name, g) in enumerate(zip(("w", "b", "x"), grads)):
        got = _summed(ranks, "pipe", i)
        np.testing.assert_allclose(got[:s] if name != "x" else got, g,
                                   atol=1e-5, err_msg=name)
        if name != "x":  # stages past S were never read
            assert not np.any(got[s:])


def test_moe_expert_parallel_matches_replicated_and_flax(world):
    """MoEFusion with its 4 experts split over ("expert",) of every rank:
    the output against the replicated module and flax's MoEFusion on the
    converted init (atol 1e-5); each rank's experts' gradients against
    flax's rows, the gate's and the inputs' (summed over the axis) on every
    rank against flax's; every expert's gradient is non-zero."""
    ref, gparams, gmods = _jax_moe()
    for r in world["ranks"]:
        rep, sh = r["moe_replicated"], r["moe_sharded"]
        np.testing.assert_allclose(sh["out"].numpy(), rep["out"].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(sh["out"].numpy(), ref, atol=1e-5)
        start, stop = sh["experts"]
        assert stop - start == 4 // world["world"]
        for name, g in sh["grads"].items():
            want = gparams[name].numpy()
            if name.startswith("experts."):
                want = want[start:stop]
                assert np.all(np.abs(g.numpy().reshape(len(g), -1)).sum(1) > 0)
            np.testing.assert_allclose(g.numpy(), want, atol=1e-5, err_msg=name)
        for got, want in zip(sh["mod_grads"], gmods):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        for name, g in rep["grads"].items():
            np.testing.assert_allclose(g.numpy(), gparams[name].numpy(),
                                       atol=1e-5, err_msg=name)
        # shard_moe_params: expert tensors split over "expert", the gate
        # replicated; the pieces make the whole again.
        for name, placed in r["moe_placed"].items():
            expert = name.startswith("experts.")
            assert placed["placements"] == ([0] if expert else ["R"]), name
            assert placed["whole"], name
            if expert:
                assert placed["rows"] == 4 // world["world"], name


@pytest.mark.parametrize("case", ["ensemble", "ensemble_dropout"])
def test_ensemble_mesh_steps_match(world4, case):
    """Two steps of EnsembleTrainer (K = 2) on the 2 × 2 mesh under
    'ensemble' with the dry run's configuration and batch, against the
    port's trainer without a mesh and (dropout off) the reference's
    EnsembleTrainer on its 2 × 2 mesh from the same converted stack, at the
    trainer tolerances; every one of the 95 stacked tensors is split over
    "model", and the sharded checkpoint of the state restores bit for
    bit."""
    dropout = case == "ensemble_dropout"
    plosses, pnorms, pparams = _port_ensemble_steps(dropout)
    refs = [(plosses, pnorms, pparams)]
    if not dropout:
        refs.append(_jax_ensemble_steps()[0])
    else:  # the masks are live
        off = _port_ensemble_steps(False)[0]
        assert all(abs(a - b) > 1e-3 * abs(b) for a, b in zip(plosses, off))
    for r in world4["ranks"]:
        got = r[case]
        for losses, norms, params in refs:
            np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-5)
            _close_params(got["params"], params)
        assert len(got["split"]) == 95
        assert r["ensemble_ckpt"] == {"dtensors": 95, "equal": True}


def test_dryrun_twin_at_world4(world4):
    """`dryrun_multichip(4)` from weights drawn for the reference's
    flagship tree (converted) and the port's seed-0 stack, dropout off:
    its line has every key of the reference's record
    (MULTICHIP_r05.json), the ring, GPipe and MoE diffs are below 1e-4, the
    checkpoints round-trip to step 2, and the losses equal the reference's
    steps on the same 2 × 2 mesh (rtol 1e-5). The fsdp count is the
    port's rules' 39 (the reference's record counts 41 of XLA's step
    outputs); the ensemble splits its 95 tensors."""
    import re

    with open(os.path.join(ROOT, "MULTICHIP_r05.json")) as f:
        record = json.load(f)["tail"]
    keys = re.findall(r"(\w+)=", record.split("dryrun_multichip OK:")[1])
    (ens_losses, _, _), loss = _jax_ensemble_steps()
    ens_loss = ens_losses[0]
    for r in world4["ranks"]:
        out = r["dryrun"]
        line = out["line"]
        assert line.startswith("dryrun_multichip OK: ")
        assert re.findall(r"(\w+)=", line) == keys
        assert out["mesh"] == {"data": 2, "model": 2} and out["step"] == 1
        assert max(out["sp_ring_diff"], out["pp_gpipe_diff"],
                   out["ep_moe_diff"]) < 1e-4
        assert tuple(out["ckpt_round_trip"]) == (2, 2)
        assert "ckpt_round_trip=(tp:2,fsdp:2)" in line
        np.testing.assert_allclose([out["loss"], out["fsdp_loss"]], [loss] * 2,
                                   rtol=1e-5)
        np.testing.assert_allclose(out["ens_loss"], ens_loss, rtol=1e-5)
        assert abs(out["psum_ccc"] - out["host_ccc"]) < 1e-4
        assert out["fsdp_sharded_leaves"] == 39
        assert out["ens_sharded_leaves"] == 95
