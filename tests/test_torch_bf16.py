"""bfloat16 compute (`DEERModelConfig.compute_dtype="bfloat16"`) in the port
against the JAX package's flax `dtype=jnp.bfloat16` on the CPU, on the
same converted weights and seeded numpy inputs.

Tolerance, derived from JAX's own bf16-vs-float32 gap on the same inputs
(`gap` = |JAX bf16 − JAX float32|, `err` = |port bf16 − JAX bf16|):
max err ≤ MAX_FRAC · max gap and mean err ≤ MEAN_FRAC · mean gap, for
every output of each module and of the flagship. The two packages round
at the same places (flax's casts, XLA's op-by-op sigmoid and softmax, the
sigmoid's derivative rule), so they differ only where a float32 sum taken
in another order rounds to the other bf16 neighbour; those rare one-ulp flips grow a little through the
layers (at full width, 256 rows: mean err ~6% of the mean gap, max err
22-30%). A port that computed in float32 would show err = gap and fail the
mean bound. The gradients of one dropout-off train step are held the same
way (their mean err is ~11% of the mean gap), the loss to rtol 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deer.data.synthetic import SyntheticConfig as JSyntheticConfig
from tpu_deer.data.synthetic import make_synthetic_splits as j_splits
from tpu_deer.models.attention import MultiHeadAttention as JMHA
from tpu_deer.models.attention import UncertaintyAwareAttention as JUA
from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JConfig
from tpu_deer.models.encoders import ModalityEncoder as JEncoder
from tpu_deer.models.fusion import HierarchicalFusion as JFusion
from tpu_deer.models.heads import DEERPredictionHead as JHead
from tpu_deer.train.trainer import DEERTrainer as JTrainer
from tpu_deer.train.trainer import TrainingConfig as JTrainingConfig
from tpu_deer_torch.convert import flax_to_state_dict, state_dict_to_flax
from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.eval.ood import MahalanobisOOD
from tpu_deer_torch.export import ExportedEngine, export_inference
from tpu_deer_torch.models.attention import MultiHeadAttention
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    create_complete_deer_model,
)
from tpu_deer_torch.models.layers import sigmoid, softmax, torch_dtype
from tpu_deer_torch.serve import InferenceEngine
from tpu_deer_torch.server import PredictionService
from tpu_deer_torch.stream import StreamingRecognizer
from tpu_deer_torch.train.checkpoint import CheckpointManager
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

torch.set_num_threads(1)

MAX_FRAC, MEAN_FRAC = 0.5, 0.25
NARROW = dict(encoder_dim=32, fusion_dim=64, attention_heads=4, encoder_layers=1)
BF16 = jnp.bfloat16


def assert_bf16_close(name, got, ref_bf16, ref_f32):
    """The module docstring's bound; `got` is the port's bf16 output."""
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    ref_bf16 = np.asarray(ref_bf16).astype(np.float32)
    gap = np.abs(ref_bf16 - np.asarray(ref_f32, np.float32))
    err = np.abs(got - ref_bf16)
    assert got.shape == ref_bf16.shape, name
    assert gap.max() > 0, f"{name}: bf16 and float32 agree, nothing to bound"
    assert err.max() <= MAX_FRAC * gap.max(), (
        f"{name}: max err {err.max():.3g} > {MAX_FRAC} × gap {gap.max():.3g}")
    assert err.mean() <= MEAN_FRAC * gap.mean(), (
        f"{name}: mean err {err.mean():.3g} > {MEAN_FRAC} × gap "
        f"{gap.mean():.3g}")


@functools.lru_cache(maxsize=None)
def _weights(width: tuple):
    """The port's seeded init at `width` (a sorted item tuple) as a
    state_dict and as flax params."""
    model = create_complete_deer_model(DEERModelConfig(**dict(width)), seed=0,
                                       device="cpu")
    return model.state_dict(), state_dict_to_flax(model.state_dict())


def _port(width: dict, dtype="bfloat16"):
    state, _ = _weights(tuple(sorted(width.items())))
    model = CompleteDEERModel(DEERModelConfig(compute_dtype=dtype, **width))
    model.load_state_dict(state)
    return model.eval()


def _inputs(rng, shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_both(module_fn, params, *xs):
    """A flax module (built by module_fn(dtype)) applied in bf16 and in
    float32 to the same inputs (bf16 inputs cast as the model casts them)."""
    out = {}
    for name, dt in (("bf16", BF16), ("f32", jnp.float32)):
        out[name] = module_fn(dt).apply(
            {"params": params}, *(jnp.asarray(x, dt) for x in xs))
    return out["bf16"], out["f32"]


def _to_bf16(*xs):
    return [torch.from_numpy(x).to(torch.bfloat16) for x in xs]


def test_sigmoid_and_softmax_match_jax_and_their_gradients(rng):
    """`models/layers.py`'s bf16 sigmoid equals jax.nn.sigmoid in value
    and gradient bit for bit, also where exp(−x) overflows (autograd
    through 1 / (1 + exp(−x)) gives NaN there; JAX's rule gives 0). The
    softmax equals jax.nn.softmax in value; its gradient, g·y − y·Σ g·y, is
    a difference of two rounded terms, and JAX's VJP runs fused with fewer
    roundings (it differs from JAX's own op-by-op evaluation), so it is
    held within two bf16 ulps of the largest cotangent: 2⁻⁷ · max |g|."""
    x = np.concatenate([4 * rng.standard_normal(509),
                        [-100.0, 100.0, -89.0]]).astype(np.float32)
    g = rng.standard_normal(512).astype(np.float32)
    for name, jfn, tfn, shape in (
            ("sigmoid", jax.nn.sigmoid, sigmoid, (512,)),
            ("softmax", lambda a: jax.nn.softmax(a, axis=-1),
             lambda a: softmax(a, dim=-1), (128, 4))):
        xs, gs = x.reshape(shape), g.reshape(shape)
        out = {}
        for dt in (BF16, jnp.float32):
            y, vjp = jax.vjp(jfn, jnp.asarray(xs, dt))
            out[dt] = y, vjp(jnp.asarray(gs, dt))[0]
        xt = torch.from_numpy(xs).to(torch.bfloat16).requires_grad_()
        yt = tfn(xt)
        (gt,) = torch.autograd.grad(yt, xt, torch.from_numpy(gs).to(torch.bfloat16))
        assert torch.isfinite(gt).all(), name
        np.testing.assert_array_equal(yt.detach().float().numpy(),
                                      np.asarray(out[BF16][0], np.float32))
        if name == "sigmoid":
            np.testing.assert_array_equal(gt.float().numpy(),
                                          np.asarray(out[BF16][1], np.float32))
        else:
            err = np.abs(gt.float().numpy() - np.asarray(out[BF16][1], np.float32))
            assert err.max() <= 2.0 ** -7 * np.abs(gs).max(), err.max()


def test_modality_encoder(rng):
    _, params = _weights(tuple(sorted(NARROW.items())))
    (x,) = _inputs(rng, [(64, 256)])
    jb, jf = _jax_both(lambda dt: JEncoder(32, 1, 0.3, dt),
                       params["video_encoder"], x)
    with torch.no_grad():
        got = _port(NARROW).video_encoder(*_to_bf16(x))
    assert got.dtype == torch.bfloat16
    assert_bf16_close("video_encoder", got, jb, jf)


def test_multi_head_attention_dense_branch_at_t_above_one(rng):
    """The scores, the softmax and attn·v in bf16 at T = 5 (the flagship
    attends at T = 1, where the softmax is exactly 1)."""
    mha = MultiHeadAttention(32, 4, dropout=0.0, use_flash=False,
                             dtype=torch.bfloat16).eval()
    generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in mha.parameters():
            p.normal_(0.0, 0.3, generator=generator)
    params = state_dict_to_flax(mha.state_dict())
    q, k = _inputs(rng, [(8, 3, 32), (8, 5, 32)])
    jb, jf = _jax_both(lambda dt: JMHA(32, 4, 0.0, dt, use_flash=False),
                       params, q, k, k)
    with torch.no_grad():
        got = mha(*_to_bf16(q, k, k))
    assert got.dtype == torch.bfloat16
    assert_bf16_close("mha", got, jb, jf)


def test_uncertainty_aware_attention(rng):
    _, params = _weights(tuple(sorted(NARROW.items())))
    xs = _inputs(rng, [(64, 32)] * 3)
    jb, jf = _jax_both(lambda dt: JUA(32, 4, 0.1, dt),
                       params["uncertainty_attention"], *xs)
    with torch.no_grad():
        got = _port(NARROW).uncertainty_attention(*_to_bf16(*xs))
    assert set(got) == set(jb)
    for key in jb:
        assert got[key].dtype == torch.bfloat16, key
        assert_bf16_close(f"attention {key}", got[key], jb[key], jf[key])


def test_hierarchical_fusion(rng):
    _, params = _weights(tuple(sorted(NARROW.items())))
    xs = _inputs(rng, [(64, 32)] * 3)
    jb, jf = _jax_both(lambda dt: JFusion(32, 64, 0.3, dt), params["fusion"],
                       *xs)
    with torch.no_grad():
        got = _port(NARROW).fusion(*_to_bf16(*xs))
    assert got.dtype == torch.bfloat16
    assert_bf16_close("fusion", got, jb, jf)


def test_prediction_head_evidence_in_bf16_nig_in_float32(rng):
    _, params = _weights(tuple(sorted(NARROW.items())))
    (x,) = _inputs(rng, [(64, 64)])
    jb, jf = _jax_both(lambda dt: JHead(32, 0.3, 1, dt),
                       params["deer_head_arousal"], x)
    with torch.no_grad():
        got = _port(NARROW).heads["arousal"](*_to_bf16(x))
    for key in ("mu", "nu", "alpha", "beta", "aleatoric_uncertainty",
                "epistemic_uncertainty", "uncertainty"):
        assert got[key].dtype == torch.float32, key
        assert_bf16_close(f"head {key}", got[key], jb[key], jf[key])


def test_flagship_full_width_matches_jax_bf16():
    """256 standard-normal rows at seed 0 through the flagship at full
    width (3,918,324 params, float32 parameters)."""
    model = _port({})
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _, params = _weights(())
    rng = np.random.default_rng(0)
    a, v, t = _inputs(rng, [(256, 84), (256, 256), (256, 768)])
    ref = {dt: JModel(JConfig(compute_dtype=dt)).apply(
        {"params": params}, a, v, t, deterministic=True)
        for dt in ("bfloat16", "float32")}
    with torch.no_grad():
        out = model(*(torch.from_numpy(x) for x in (a, v, t)))
    for key in ("mu_all", "uncertainty_all", "calibrated_uncertainty"):
        assert out[key].dtype == torch.float32
        assert_bf16_close(key, out[key], ref["bfloat16"][key],
                          ref["float32"][key])
    assert out["fused_features"].dtype == torch.bfloat16
    assert ref["bfloat16"]["fused_features"].dtype == jnp.bfloat16


def test_compute_dtype_names():
    """The names jnp.dtype reads as floats are accepted; others raise."""
    assert torch_dtype("bfloat16") is torch.bfloat16
    assert torch_dtype("float32") is torch.float32
    assert torch_dtype("f4") is torch.float32
    assert torch_dtype("half") is torch.float16
    for bad in ("int8", "bool", "not_a_dtype"):
        with pytest.raises(ValueError):
            torch_dtype(bad)
    with pytest.raises(ValueError):
        CompleteDEERModel(DEERModelConfig(compute_dtype="int8"))
    assert CompleteDEERModel(DEERModelConfig(
        compute_dtype="float16", **NARROW)).dtype is torch.float16


# tests/test_trainer.py's SMALL_MODEL and SMALL_DATA.
SMALL_MODEL = DEERModelConfig(
    audio_dim=16, video_dim=16, text_dim=16, encoder_dim=32, fusion_dim=64,
    attention_heads=4, encoder_layers=1, dropout=0.1)
SMALL_DATA = SyntheticConfig(
    n_train=256, n_val=128, n_test=128, audio_dim=16, video_dim=16,
    text_dim=16, label_noise=0.02, hard_fraction=0.0)


@pytest.fixture(scope="module")
def trained_bf16(tmp_path_factory):
    """tests/test_trainer.py::TestBF16::test_bf16_compute_trains on the
    port, with checkpoints: (trainer, results, checkpoint dir, splits)."""
    splits = make_synthetic_splits(SMALL_DATA)
    cfg = dataclasses.replace(SMALL_MODEL, compute_dtype="bfloat16")
    model = create_complete_deer_model(cfg, seed=0, device="cpu")
    trainer = DEERTrainer(
        model, TrainingConfig(learning_rate=5e-3, batch_size=64, num_epochs=3,
                              warmup_epochs=0, scheduler="constant", seed=0),
        steps_per_epoch=4, device="cpu")
    root = str(tmp_path_factory.mktemp("bf16_ckpt"))
    results = trainer.train(
        {"synthetic": ArrayDataset(splits["train"], "synthetic")},
        {"synthetic": ArrayDataset(splits["val"], "synthetic")},
        checkpoints=CheckpointManager(root))
    return trainer, results, root, splits


def test_bf16_compute_trains(trained_bf16):
    """bfloat16 dense path + float32 NIG math trains stably; the
    parameters stay float32."""
    trainer, results, _, _ = trained_bf16
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert all(v.dtype == torch.float32
               for v in trainer.optimizer.state_dict()["mu"].values())
    assert all(v.dtype == torch.float32
               for v in trainer.optimizer.state_dict()["nu"].values())
    assert np.isfinite(results["history"]["train_loss"][-1])
    assert results["best_val_ccc"] > -0.5


class _Deterministic:
    """The reference's model with every dropout off."""

    def __init__(self, model):
        self._model = model
        self.config = model.config

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self._model.apply(variables, *args, deterministic=True, **kw)


def test_train_step_matches_jax_bf16():
    """One dropout-off train step's loss and gradients (the DEER loss and
    the calibration term, float32, through the bf16 model) against the
    JAX trainer's `_loss_fn` under jax.value_and_grad."""
    width = NARROW
    state, params = _weights(tuple(sorted(width.items())))
    split = j_splits(JSyntheticConfig(n_train=64, n_val=8, n_test=8, seed=5))
    batch = {k: split["train"][k] for k in ("audio", "video", "text", "labels")}
    tcfg = dict(learning_rate=1e-3, batch_size=64, num_epochs=1,
                scheduler="constant", warmup_epochs=0, seed=0)
    ref = {}
    for dt in ("bfloat16", "float32"):
        jm = JModel(JConfig(compute_dtype=dt, **width))
        jt = JTrainer(jm, params, JTrainingConfig(**tcfg), steps_per_epoch=1)
        jt.model = _Deterministic(jm)
        (loss, _), grads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
            params, batch, jax.random.PRNGKey(0), 1.0)
        ref[dt] = float(loss), flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, grads))
    model = CompleteDEERModel(DEERModelConfig(compute_dtype="bfloat16", **width))
    model.load_state_dict(state)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    trainer = DEERTrainer(model, TrainingConfig(**tcfg), steps_per_epoch=1,
                          device="cpu")
    model.train()
    loss, _ = trainer._loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                               1.0)
    names = list(trainer._params)
    grads = torch.autograd.grad(loss, list(trainer._params.values()),
                                allow_unused=True)
    got = {n: g for n, g in zip(names, grads) if g is not None}
    assert all(g.dtype == torch.float32 for g in got.values())
    # One scalar, a mean over 64 rows: held to rtol 1e-4 (JAX's own bf16
    # loss is 4e-5 from its float32 one here); the gradients carry the bound.
    np.testing.assert_allclose(loss.item(), ref["bfloat16"][0], rtol=1e-4)
    flat = lambda d: np.concatenate([np.asarray(d[n]).ravel() for n in got])
    assert_bf16_close("gradients", flat(got), flat(ref["bfloat16"][1]),
                      flat(ref["float32"][1]))


def test_bf16_serves_through_every_entry_point(trained_bf16, tmp_path):
    """The bf16 model behind the eager engine (the CPU's; the card's graphs
    are held against it in tests/test_torch_bf16_cuda.py), int8,
    `from_checkpoint`, the server's service, export and `ExportedEngine`,
    a fused-space OOD detector and the stream tick: float32 numpy out
    (numpy has no bfloat16), the engine's μ that of the model."""
    trainer, _, root, splits = trained_bf16
    cfg = trainer.model.config
    test = ArrayDataset(splits["test"], "synthetic")
    a, v, t = (splits["test"][k][:10] for k in ("audio", "video", "text"))
    with torch.no_grad():
        direct = trainer.model.eval()(*(torch.from_numpy(x) for x in (a, v, t)))
    fused = trainer.predict(test, return_fused=True)["fused"]
    assert fused.dtype == np.float32 and np.isfinite(fused).all()
    detector = MahalanobisOOD(space="fused").fit(fused)

    engine = InferenceEngine(trainer.model, ood_detector=detector,
                             batch_buckets=(1, 8), device="cpu")
    out = engine.predict(a, v, t)
    for key, arr in out.items():
        assert arr.dtype in (np.float32, np.bool_), key
        assert np.isfinite(arr).all(), key
    np.testing.assert_array_equal(out["mu"], direct["mu_all"].numpy())
    np.testing.assert_array_equal(out["attention_weights"],
                                  direct["attention_weights"].float().numpy())

    q = InferenceEngine(trainer.model, quantize_weights=True,
                        batch_buckets=(1, 8), device="cpu").predict(a, v, t)
    assert np.abs(q["mu"] - out["mu"]).max() < 0.05

    ckpt = InferenceEngine.from_checkpoint(root, config=cfg,
                                           batch_buckets=(1, 8), device="cpu")
    assert ckpt.model.dtype is torch.bfloat16
    assert np.isfinite(ckpt.predict(a, v, t)["mu"]).all()
    svc = PredictionService.from_checkpoint(root, config=cfg, device="cpu")
    reply = svc.predict_json({"audio": a[0].tolist(), "video": v[0].tolist(),
                              "text": t[0].tolist()})
    assert np.isfinite(np.asarray(reply["mu"])).all()

    export_inference(trainer.model, str(tmp_path / "exp"), batch_buckets=(8,),
                     platforms=("cpu",))
    exported = ExportedEngine(str(tmp_path / "exp"), device="cpu").predict(a, v, t)
    np.testing.assert_array_equal(exported["mu"], out["mu"])

    rec = StreamingRecognizer(
        CompleteDEERModel(dataclasses.replace(cfg, audio_dim=84)).eval(),
        n_streams=2, device="cpu")
    pushed = rec.push(np.random.default_rng(1).standard_normal(
        (2, rec.cfg.chunk_samples)).astype(np.float32),
        video=np.zeros((2, 16), np.float32), text=np.zeros((2, 16), np.float32))
    assert all(arr.dtype == np.float32 and np.isfinite(arr).all()
               for arr in pushed.values())
