"""The reference's checkpoint formats read by the port
(`tpu_deer_torch/train/checkpoint.py`, `train/flax_msgpack.py`), on the CPU.

The JAX trainer (the dryrun's width, dropout off) takes three micro-steps
and its state is saved by the JAX package's CheckpointManager twice: as
`state.msgpack`, and in the sharded format with every array placed on a
4 × 2 mesh of the conftest's virtual devices by the 'fsdp' rules. The port
restores each: the model's state_dict and the optimizer's moments, EMA and
accumulated gradient equal `convert.py`'s conversion of the JAX state
exactly, and so do the count and the step; a port trainer loaded from it
takes the next step, which equals the JAX trainer's own resumed step
(losses rtol 1e-5, parameters atol 1e-4, the trainer tests' tolerances).
Two optimizer layouts: plain AdamW, and gradient accumulation over 2 with
an EMA and a frozen prefix (optax.MultiSteps, the EMA stage, set_to_zero).

The port's msgpack reader equals `flax.serialization.msgpack_restore` on
the same bytes: the trainer state, and a tree of every type flax writes
(chunked arrays, numpy scalars, bfloat16, complex numbers).
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JConfig
from tpu_deer.parallel import mesh as jmesh
from tpu_deer.train.checkpoint import CheckpointManager as JCheckpoints
from tpu_deer.train.trainer import DEERTrainer as JTrainer
from tpu_deer.train.trainer import TrainingConfig as JTrainingConfig
from tpu_deer_torch.convert import flax_to_state_dict, state_dict_to_flax
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    create_complete_deer_model,
)
from tpu_deer_torch.train import flax_msgpack
from tpu_deer_torch.train.checkpoint import CheckpointManager
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

torch.set_num_threads(1)

MODEL = dict(audio_dim=16, video_dim=16, text_dim=16, encoder_dim=32,
             fusion_dim=64, attention_heads=4, encoder_layers=1, dropout=0.1)
BASE = dict(batch_size=16, num_epochs=1, warmup_epochs=0, scheduler="constant",
            learning_rate=1e-4, seed=3)
CONFIGS = {"adamw": {},
           "accum_ema_frozen": dict(grad_accum_steps=2, ema_decay=0.9,
                                    frozen_prefixes=("audio_encoder",))}
FORMATS = ("msgpack", "sharded")


class _Deterministic:
    """The reference's model with every dropout off."""

    def __init__(self, model):
        self._model = model
        self.config = model.config

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self._model.apply(variables, *args, deterministic=True, **kw)


@functools.lru_cache(maxsize=None)
def _init():
    model = create_complete_deer_model(DEERModelConfig(**MODEL), seed=0,
                                       device="cpu")
    split = make_synthetic_splits(SyntheticConfig(
        n_train=BASE["batch_size"], n_val=0, n_test=0, audio_dim=16,
        video_dim=16, text_dim=16, seed=7))["train"]
    batch = {k: split[k] for k in ("audio", "video", "text", "labels")}
    return {k: v.clone() for k, v in model.state_dict().items()}, batch


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_saved(name, dirs):
    """Config `name`'s JAX trainer state after three micro-steps, saved in
    both formats under `dirs`, and its next step."""
    init, batch = _init()
    jm = JModel(JConfig(**MODEL))
    config = JTrainingConfig(**BASE, **CONFIGS[name])
    trainer = JTrainer(jm, state_dict_to_flax(init), config, steps_per_epoch=4)
    trainer.model = _Deterministic(jm)
    one = jnp.asarray(1.0)
    state = trainer.state
    for _ in range(3):
        state, _ = trainer._train_step(state, trainer._put(batch), one, one)
    tree = _host(flax.serialization.to_state_dict(state))
    JCheckpoints(dirs["msgpack"]).save(state, step=3)
    mesh = jmesh.create_mesh(jmesh.MeshConfig(data=4, model=2))
    placed = jax.tree_util.tree_map_with_path(
        lambda p, x: jax.device_put(x, NamedSharding(
            mesh, jmesh.param_spec(p, x, "fsdp", 4, 2))) if np.ndim(x) else x,
        tree)
    JCheckpoints(dirs["sharded"]).save(placed, step=3)
    with open(os.path.join(dirs["msgpack"], "step_00000003", "state.msgpack"),
              "rb") as f:
        raw = f.read()
    state, aux = trainer._train_step(state, trainer._put(batch), one, one)
    return {"config": name, "state": tree, "dirs": dirs, "bytes": raw,
            "next": (float(aux["loss"]), flax_to_state_dict(_host(state.params)))}


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """{config: _jax_saved's record}, both configs on threads of their own
    (XLA compiles and runs with the GIL released)."""
    _init()
    dirs = {name: {f: str(tmp_path_factory.mktemp(f"{name}_{f}"))
                   for f in FORMATS} for name in CONFIGS}
    with ThreadPoolExecutor(len(CONFIGS)) as pool:
        return dict(zip(CONFIGS, pool.map(_jax_saved, CONFIGS,
                                          [dirs[n] for n in CONFIGS])))


@pytest.fixture(params=sorted(CONFIGS))
def saved(request, jax_saved):
    """The JAX trainer's state after three micro-steps, saved in both
    formats, and its next step: {"config", "state" (flax state dict, numpy),
    "dirs": {format: checkpoint dir}, "next": (loss, params), "bytes"}."""
    return jax_saved[request.param]


def _converted(tree):
    """The port's optimizer state as convert.py gives it from the flax one."""
    opt = tree["opt_state"]
    out = {}
    if "mini_step" in opt:
        out.update(mini_step=int(opt["mini_step"]),
                   acc=flax_to_state_dict(opt["acc_grads"]))
        opt = opt["inner_opt_state"]
    groups = opt["1"]["inner_states"]
    adam = [g["inner_state"]["0"] for g in groups.values()
            if isinstance(g["inner_state"], dict) and "0" in g["inner_state"]]
    merged = lambda key: flax_to_state_dict(_merge([a[key] for a in adam]))
    out.update(count=int(adam[0]["count"]), mu=merged("mu"), nu=merged("nu"))
    if "2" in opt and opt["2"]:
        out["ema"] = flax_to_state_dict(opt["2"]["ema"])
    return out


def _merge(trees):
    """The groups' masked trees as one (a masked leaf is an empty dict)."""
    out = {}
    for tree in trees:
        for k, v in tree.items():
            if isinstance(v, dict):
                if v:
                    out[k] = _merge([out.get(k, {}), v])
            else:
                out[k] = v
    return out


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v if torch.is_tensor(v)
                           else torch.from_numpy(np.asarray(v))), k


@pytest.mark.parametrize("fmt", FORMATS)
def test_restore_equals_the_conversion(saved, fmt):
    ckpt = CheckpointManager(saved["dirs"][fmt])
    state = ckpt.restore()
    tree = saved["state"]
    _equal(state["model"], flax_to_state_dict(tree["params"]))
    _equal(ckpt.restore_params(), flax_to_state_dict(tree["params"]))
    want = _converted(tree)
    assert sorted(state["optimizer"]) == sorted(want)
    for key, value in want.items():
        if isinstance(value, dict):
            _equal(state["optimizer"][key], value)
        else:
            assert state["optimizer"][key] == value, key
    assert state["step"] == int(tree["step"]) == 3
    if saved["config"] == "accum_ema_frozen":
        assert not any(k.startswith("audio_encoder") for k in want["mu"])
        assert state["optimizer"]["mini_step"] == 1


@pytest.mark.parametrize("fmt", FORMATS)
def test_resumed_step_equals_jax(saved, fmt):
    init, batch = _init()
    model = CompleteDEERModel(DEERModelConfig(**MODEL))
    model.load_state_dict(init)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    trainer = DEERTrainer(model, TrainingConfig(**BASE, **CONFIGS[saved["config"]]),
                          steps_per_epoch=4, device="cpu")
    trainer.load_state_dict(CheckpointManager(saved["dirs"][fmt]).restore())
    aux = trainer._train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                              1.0, 1.0)
    loss, params = saved["next"]
    np.testing.assert_allclose(float(aux["loss"]), loss, rtol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-4, err_msg=k)
    assert trainer.step == 4


def _same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert list(map(type, got)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) and not isinstance(
            want, (np.bool_,)):
        w = np.asarray(want)
        g = np.asarray(got)
        if w.dtype == jnp.bfloat16:  # numpy has no bfloat16: float32 values
            assert g.dtype == np.float32, path
            w = w.astype(np.float32)
        else:
            assert g.dtype == w.dtype, path
        assert g.shape == w.shape and np.array_equal(g, w), path
        assert isinstance(got, np.ndarray) == isinstance(want, np.ndarray), path
    else:
        assert type(got) is type(want) and got == want, path


def test_msgpack_reader_equals_flax_on_a_trainer_state(saved):
    _same_tree(flax_msgpack.msgpack_restore(saved["bytes"]),
               flax.serialization.msgpack_restore(saved["bytes"]))


def test_msgpack_reader_equals_flax_on_every_type(monkeypatch):
    """Chunked arrays (flax's chunk size made 64 bytes), numpy scalars,
    bfloat16, complex numbers, nested lists, every msgpack integer width,
    floats, strings, bytes, booleans and None."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {
        "big": rng.standard_normal((7, 9)).astype(np.float32),
        "ints": np.arange(40, dtype=np.int64).reshape(4, 10),
        "u8": np.arange(5, dtype=np.uint8),
        "bf16": jnp.asarray(rng.standard_normal(5), jnp.bfloat16),
        "scalar": np.float32(1.5), "i32": np.int32(-7), "empty": {},
        "nested": {"list": [1, -1, 200, -200, 70000, -70000, 2**40, -2**40,
                            0.25, "s" * 40, "", True, False, None],
                   "bytes": b"\x00\x01", "c": 1 + 2j},
        "long": "x" * 70000,
        "many": {str(i): i for i in range(20)},
    }
    raw = flax.serialization.msgpack_serialize(tree)
    want = flax.serialization.msgpack_restore(raw)
    assert "__msgpack_chunked_array__" not in want["big"]  # rejoined
    _same_tree(flax_msgpack.msgpack_restore(raw), want)
    with pytest.raises(ValueError):
        flax_msgpack.msgpack_restore(raw[:-3])
