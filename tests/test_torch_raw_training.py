"""The port's raw-media training path against the JAX reference on the CPU:
fixture corpus and loader, the frame-feature front-end, three training
steps of RawSequenceTrainer, predict, and the text path at the length where
training takes the flash kernels (K3).

The training comparison runs both sides with dropout off: the reference
through its trainer's own forward, loss and optimizer (value_and_grad with
deterministic=True, then `trainer.optimizer.update`), the port through
`RawSequenceTrainer.train` with every dropout at p = 0 in train mode.
"""

import functools
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_deer.core import losses as jlosses
from tpu_deer.data import raw_corpus as jrc
from tpu_deer.models.encoders import TextSequenceEncoder as JText
from tpu_deer.models.hierarchical_deer import RawSequenceDEERModel as JRaw
from tpu_deer.ops import audio_frontend as jaf
from tpu_deer.train.raw_trainer import RawSequenceTrainer as JTrainer
from tpu_deer.train.raw_trainer import RawTrainingConfig as JConfig
from tpu_deer_torch.convert import flax_to_state_dict, state_dict_to_flax
from tpu_deer_torch.data import raw_corpus as trc
from tpu_deer_torch.data.audio_io import load_wav
from tpu_deer_torch.kernels import flash_attention as tfa
from tpu_deer_torch.models.encoders import TextSequenceEncoder
from tpu_deer_torch.models.hierarchical_deer import RawSequenceDEERModel
from tpu_deer_torch.ops import audio_frontend as taf
from tpu_deer_torch.train.raw_trainer import RawSequenceTrainer, RawTrainingConfig

torch.set_num_threads(1)

FIXTURE = dict(n_train=12, n_val=4, n_test=5, duration_s=0.3, n_frames=2,
               seed=3)
LOAD = dict(max_audio_s=0.3, max_video_frames=2)
TRAIN = dict(learning_rate=1e-3, batch_size=4, num_epochs=1)  # 3 steps
WIDTH = dict(encoder_dim=24, fusion_dim=48, num_heads=4)


@functools.lru_cache(maxsize=None)
def _corpora():
    """The same fixture written by the reference and by the port, each
    loaded by its own package."""
    roots = [tempfile.mkdtemp(prefix="raw_fixture_") for _ in range(2)]
    jrc.generate_raw_fixture(roots[0], **FIXTURE)
    trc.generate_raw_fixture(roots[1], **FIXTURE)
    return (roots, jrc.load_raw_corpus(roots[0], **LOAD),
            trc.load_raw_corpus(roots[1], **LOAD))


def test_fixture_and_loader_bit_identical():
    roots, (jsplits, jvocab), (tsplits, tvocab) = _corpora()
    assert tvocab.itos == jvocab.itos and tvocab.max_length == jvocab.max_length
    # The port's loader on the reference's files, too.
    for splits in (tsplits, trc.load_raw_corpus(roots[0], **LOAD)[0]):
        assert sorted(splits) == sorted(jsplits) == ["test", "train", "val"]
        for split, arrays in jsplits.items():
            assert sorted(splits[split]) == sorted(arrays)
            for key, ref in arrays.items():
                got = splits[split][key]
                assert got.dtype == ref.dtype and np.array_equal(got, ref), (
                    split, key)
    samples = trc.parse_annotations(Path(roots[1]))
    assert len(samples) == 12 + 4 + 5
    assert {s["session"] for s in samples} == {1, 2, 4, 5}
    wav = load_wav(samples[0]["wav"])
    assert wav.dtype == np.float32 and np.abs(wav).max() <= 1.0


# Frame-feature columns and their (rtol, atol), from the front-end
# tolerances of tests/test_torch_audio_frontend.py: mfcc and its deltas
# after the DCT mixes 40 log-mel bands; F0, centroid, rolloff and
# bandwidth in Hz; RMS and ZCR; log-mel; the voicing flag exact.
FRAME_COLUMNS = {
    "mfcc+deltas": (slice(0, 39), (2e-3, 5e-3)),
    "f0": (slice(39, 40), (1e-4, 1e-3)),
    "voiced": (slice(40, 41), (0, 0)),
    "rms, zcr": (slice(41, 43), (1e-4, 1e-5)),
    "centroid, rolloff, bandwidth": (slice(43, 46), (1e-4, 1e-3)),
    "logmel": (slice(46, 84), (2e-4, 1e-3)),
}


def test_frame_features_batch_matches_jax():
    """[B, L] through one front-end call against the reference's
    per-utterance audio_frame_features on its CPU ("conv") path."""
    _, (jsplits, _), _ = _corpora()
    signals = jsplits["train"]["signal"][:6]
    cfg = jaf.AudioFrontendConfig()
    ref = np.asarray(jax.vmap(lambda s: jaf.audio_frame_features(s, cfg))(
        jnp.asarray(signals)))
    got = taf.audio_frame_features_batch(torch.from_numpy(signals)).numpy()
    assert got.shape == ref.shape == (6, 19, 84)
    for name, (cols, (rtol, atol)) in FRAME_COLUMNS.items():
        np.testing.assert_allclose(got[..., cols], ref[..., cols], rtol=rtol,
                                   atol=atol, err_msg=name)
    one = taf.audio_frame_features(torch.from_numpy(signals[2])).numpy()
    np.testing.assert_allclose(one, got[2], rtol=1e-6, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _trained():
    """3 dropout-off steps on each side from the same converted init;
    returns (per-step losses and params, port then reference) and the
    two trainers."""
    _, (splits, vocab), _ = _corpora()
    train = splits["train"]
    jm = JRaw(vocab_size=vocab.vocab_size, **WIDTH)
    frames = np.zeros((2, 19, 84), np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), frames, train["video_frames"][:2],
        train["token_ids"][:2], train["token_mask"][:2])["params"])

    jt = JTrainer(jm, params, JConfig(**TRAIN))

    @jax.jit
    def step(p, opt_state, batch):
        def loss_fn(pp):
            out = jt._forward(pp, batch, deterministic=True)
            return jlosses.multi_task_deer_loss(
                [out[f"{n}_params"] for n in jm.dim_names], batch["labels"],
                jlosses.DEERLossConfig(variant="v2"))["total_loss"]

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = jt.optimizer.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    order = np.random.default_rng(JConfig().seed).permutation(12)
    staged = jt._stage(train)
    p, opt_state, jl = jt.params, jt.opt_state, []
    for start in range(0, 12, 4):
        p, opt_state, loss = step(p, opt_state, jt._gather(
            staged, jnp.asarray(order[start:start + 4])))
        jl.append(float(loss))
    jt.params = p

    tm = RawSequenceDEERModel(vocab_size=vocab.vocab_size, **WIDTH)
    tm.load_state_dict(flax_to_state_dict(params))
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    tt = RawSequenceTrainer(tm, RawTrainingConfig(**TRAIN), device="cpu")
    tl, step_fn = [], tt._train_step
    tt._train_step = lambda batch: tl.append(step_fn(batch)) or tl[-1]
    result = tt.train(train)
    assert len(result["history"]["train_loss"]) == 1
    return tl, jl, tt, jt


def test_three_train_steps_match_jax():
    """Losses within rtol 1e-5 (float32 forward over ~40 layers in another
    summation order). Parameters within atol 1e-4, 1/30 of the 3e-3 the
    three AdamW steps move them: parameters whose exact gradient is 0 (the
    attention key bias and the pooling score bias, which a softmax cancels)
    get float-noise gradients on both sides, which Adam scales up."""
    tl, jl, tt, jt = _trained()
    np.testing.assert_allclose([float(x) for x in tl], jl, rtol=1e-5)
    np.testing.assert_allclose(tt.history["train_loss"][0], np.mean(jl),
                               rtol=1e-5)
    got = dict(jax.tree_util.tree_flatten_with_path(
        state_dict_to_flax(tt.model.state_dict()))[0])
    for path, ref in jax.tree_util.tree_flatten_with_path(jt.params)[0]:
        np.testing.assert_allclose(got[path], np.asarray(ref), rtol=0,
                                   atol=1e-4, err_msg=jax.tree_util.keystr(path))


def test_predict_matches_jax():
    """predict after the three steps: tail padding (5 rows in batches of
    4), eval mode; atol 1e-5 as the model's own outputs."""
    _, _, tt, jt = _trained()
    _, (splits, _), _ = _corpora()
    ref = jt.predict(splits["test"])
    got = tt.predict(splits["test"])
    for key in ("mu", "uncertainty"):
        assert got[key].shape == ref[key].shape == (5, 3)
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-5)


def test_frozen_prefixes_and_clip():
    """Frozen parameters keep their values (no Adam step, no decay) but
    their gradients count in the clip's global norm, as in the reference,
    where the clip comes before the frozen/trained split."""
    _, (splits, vocab), _ = _corpora()
    torch.manual_seed(0)
    tm = RawSequenceDEERModel(vocab_size=vocab.vocab_size, **WIDTH)
    cfg = RawTrainingConfig(frozen_prefixes=("text_encoder.embed",
                                             "audio_encoder"),
                            gradient_clip=1e-3, **TRAIN)
    tt = RawSequenceTrainer(tm, cfg, device="cpu")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    norms = []
    clip = tt.optimizer.clip

    def spy(grads):
        norms.append(float(torch.linalg.vector_norm(
            torch.stack([g.norm() for g in grads]))))
        clip(grads)
        norms.append(float(torch.linalg.vector_norm(
            torch.stack([g.norm() for g in grads]))))
        return grads

    tt.optimizer.clip = spy
    tt.train(splits["train"])
    after = tm.state_dict()
    for key, old in before.items():
        if key.startswith(cfg.frozen_prefixes) or "bias_ih" in key:
            assert torch.equal(after[key], old), key
    for key in ("fusion.av_fusion_in.weight", "text_encoder.blocks.0.attn."
                "q_proj.weight", "video_encoder.convs.0.conv1.weight"):
        assert not torch.equal(after[key], before[key]), key
    assert all(n > 1e-3 for n in norms[0::2])
    np.testing.assert_allclose(norms[1::2], 1e-3, rtol=1e-4)


def test_text_path_at_1024_takes_flash_and_matches_sdpa():
    """The text encoder at Tt = 1024 in train mode (dropout off) dispatches
    to K3's path in the port, where the reference's deterministic forward
    takes its SDPA branch: the same function, values and parameter
    gradients. Tolerances rtol 1e-4, atol 1e-5 on values and 1e-4 on
    gradients: attention over 1024 keys and sums over 2048 token rows in
    another order."""
    rng = np.random.default_rng(0)
    t = 1024
    ids = rng.integers(5, 60, size=(2, t)).astype(np.int32)
    mask = np.zeros((2, t), np.int32)
    mask[0, :700] = 1
    mask[1, :15] = 1
    jm = JText(60, 24, model_dim=32, num_layers=2, num_heads=4)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(2), ids, mask)["params"])
    gy = rng.normal(size=(2, 24)).astype(np.float32)
    fwd = jax.jit(lambda p: jm.apply({"params": p}, ids, mask,
                                     deterministic=True))
    ref = fwd(params)
    ref_grads = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p: jnp.sum(fwd(p)[0] * gy))(params)))

    tm = TextSequenceEncoder(60, 24, model_dim=32, num_layers=2, num_heads=4)
    tm.load_state_dict(flax_to_state_dict(params))
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    tm.train()
    calls = {"fwd": 0, "dq": 0}
    fwd_fn, dq_fn = tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq
    mp = pytest.MonkeyPatch()
    mp.setattr(tfa, "flash_attention_fwd", lambda *a: calls.__setitem__(
        "fwd", calls["fwd"] + 1) or fwd_fn(*a))
    mp.setattr(tfa, "flash_attention_bwd_dq", lambda *a: calls.__setitem__(
        "dq", calls["dq"] + 1) or dq_fn(*a))
    try:
        out, attn = tm(torch.from_numpy(ids), torch.from_numpy(mask))
        (out * torch.from_numpy(gy)).sum().backward()
    finally:
        mp.undo()
    assert calls == {"fwd": 2, "dq": 2}  # one per transformer block
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref[0]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(ref[1]),
                               rtol=1e-4, atol=1e-5)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_dropout_draws_follow_the_trainer_seed():
    """Dropout on (the model's 0.1): two runs with one trainer seed give
    identical parameters after 2 steps whatever the global RNG holds;
    another trainer seed gives others."""
    _, (splits, vocab), _ = _corpora()
    torch.manual_seed(0)
    init = RawSequenceDEERModel(vocab_size=vocab.vocab_size, **WIDTH).state_dict()
    params = []
    for seed, global_seed in ((0, 1), (0, 2), (1, 1)):
        torch.manual_seed(global_seed)
        tm = RawSequenceDEERModel(vocab_size=vocab.vocab_size, **WIDTH)
        tm.load_state_dict(init)
        tt = RawSequenceTrainer(tm, RawTrainingConfig(**TRAIN, seed=seed),
                                device="cpu")
        staged = tt._stage(splits["train"])
        for step in range(2):
            tt._train_step(tt._gather(staged, np.arange(4 * step, 4 * step + 4)))
        params.append(tm.state_dict())
    assert all(torch.equal(params[0][k], params[1][k]) for k in init)
    assert not all(torch.equal(params[0][k], params[2][k]) for k in init)


def test_train_step_takes_deterministic_convolutions():
    """A step's convolutions, forward and backward, run with cuDNN's
    deterministic algorithms (its default backward varies by run on the
    card), and the setting is restored after the step."""
    _, (splits, vocab), _ = _corpora()
    torch.manual_seed(0)
    tm = RawSequenceDEERModel(vocab_size=vocab.vocab_size, **WIDTH)
    tt = RawSequenceTrainer(tm, RawTrainingConfig(**TRAIN), device="cpu")
    seen = []
    conv = tm.video_encoder.convs[0].conv1
    conv.register_forward_hook(
        lambda *_: seen.append(torch.backends.cudnn.deterministic))
    conv.register_full_backward_hook(
        lambda *_: seen.append(torch.backends.cudnn.deterministic))
    batch = tt._gather(tt._stage(splits["train"]), np.arange(4))
    before = torch.backends.cudnn.deterministic
    tt._train_step(batch)
    assert seen == [True, True]
    assert torch.backends.cudnn.deterministic == before


def test_trainer_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RawSequenceTrainer(RawSequenceDEERModel(**WIDTH, vocab_size=20))
