"""The port's MLM text bootstrap (tpu_deer_torch/train/text_pretrain.py) and
the text encoder's tied logits against the JAX package on the CPU.

The mask draws cannot match (the reference draws from `jax.random` keys),
so the masking is held given the reference's own draws, exactly; one MLM
step from the same converted weights and corrupted ids with dropout off is
held within float32 summation order: loss rtol 1e-5, gradients and the
parameters after one AdamW update (optax.adamw's defaults; where the
gradient is at least GRAD_FLOOR) atol 1e-6 plus rtol 1e-4 (the embedding's gradient sums the lookup's, through the port's
deterministic kernel's plain twin, and the tied logits' matmul). The
featurizer from converted weights within rtol 1e-5, atol 1e-6. A whole run
agrees only in distribution, so it is held as the reference's own tests
hold it: the loss falls and the accuracy rises, and a ridge probe on the
pretrained features beats hashed features on words never seen with a
label (over three seeds: a single run's probe swings with its seed).
Sizes: a 32-d, one-layer encoder.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_deer.data.vocab import CorpusVocab as JVocab
from tpu_deer.models.encoders import TextSequenceEncoder as JEncoder
from tpu_deer.train import text_pretrain as jtp
from tpu_deer_torch.convert import flax_to_state_dict, state_dict_to_flax
from tpu_deer_torch.core.metrics import ccc_np
from tpu_deer_torch.data.features import TEXT_DIM, TextFeatureExtractor
from tpu_deer_torch.data.vocab import CLS_ID, PAD_ID, SEP_ID, CorpusVocab
from tpu_deer_torch.models.layers import init_flax_style_
from tpu_deer_torch.train import text_pretrain as ttp
from tpu_deer_torch.train.optim import AdamW

torch.set_num_threads(1)

CFG = ttp.TextPretrainConfig(model_dim=32, num_layers=1, num_heads=4,
                             output_dim=48, batch_size=8, num_epochs=2,
                             learning_rate=2e-3, seed=0)
CATEGORIES = {
    "joy": ["glad", "cheerful", "delighted", "merry", "joyful", "elated"],
    "sad": ["gloomy", "mournful", "downcast", "sorrowful", "dejected", "blue"],
    "anger": ["furious", "irate", "enraged", "livid", "seething", "cross"],
}
LABELS = {"joy": [0.8, 0.5, 0.4], "sad": [-0.7, -0.4, -0.5],
          "anger": [-0.6, 0.7, 0.3]}
GRAD_FLOOR = 1e-5  # gradients held after the update (atol 1e-6 is 10% of it)
# Seeds of the held-out-words probe: one MLM run's probe CCC swings by
# ±0.3 with the seed (the masks, the batches and the init), in the
# reference as in the port, so the claim is held over these.
PROBE_SEEDS = (0, 1, 2)
TEMPLATES = ["i felt {a} and {b} about it", "she seemed so {a} almost {b} today",
             "that made him {a} truly {b}", "everyone was {a} and a little {b}"]


def make_sentences(word_slice, rng, n_per_cat=40):
    """The reference's probe corpus: two same-category words a sentence."""
    sents, labels = [], []
    for cat, words in CATEGORIES.items():
        pool = words[word_slice]
        for _ in range(n_per_cat):
            a, b = rng.choice(pool, size=2, replace=len(pool) < 2)
            sents.append(TEMPLATES[rng.integers(len(TEMPLATES))].format(a=a, b=b))
            labels.append(LABELS[cat])
    return sents, np.asarray(labels, np.float32)


def ridge_probe_ccc(train_x, train_y, test_x, test_y, lam=1e-1):
    x = np.concatenate([train_x, np.ones((len(train_x), 1))], axis=1)
    xt = np.concatenate([test_x, np.ones((len(test_x), 1))], axis=1)
    w = np.linalg.solve(x.T @ x + lam * np.eye(x.shape[1]), x.T @ train_y)
    pred = xt @ w
    return float(np.mean([ccc_np(test_y[:, i], pred[:, i])
                          for i in range(test_y.shape[1])]))


@functools.lru_cache(maxsize=None)
def _corpus():
    sents, _ = make_sentences(slice(None), np.random.default_rng(0), n_per_cat=8)
    return tuple(sents), CorpusVocab.build(sents, max_length=12)


def _port_encoder(vocab_size, seed=0):
    enc = ttp._build_encoder(vocab_size, CFG)
    init_flax_style_(enc, torch.Generator().manual_seed(seed))
    return enc


def test_mlm_mask_matches_jax_given_its_draws():
    sents, vocab = _corpus()
    ids, mask = vocab.encode_batch(sents[:16])
    key = jax.random.PRNGKey(3)
    ref = jtp._apply_mlm_mask(key, jnp.asarray(ids), jnp.asarray(mask),
                              vocab.vocab_size, 0.5)
    r_select, r_kind, r_rand = jax.random.split(key, 3)
    draws = (jax.random.uniform(r_select, ids.shape),
             jax.random.uniform(r_kind, ids.shape),
             jax.random.randint(r_rand, ids.shape, ttp.N_SPECIAL, vocab.vocab_size))
    got = ttp._apply_mlm_mask(torch.from_numpy(ids), torch.from_numpy(mask), 0.5,
                              *(torch.from_numpy(np.array(d)) for d in draws))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    selected = got[1].numpy()
    assert selected.any() and not selected[(ids == CLS_ID) | (ids == SEP_ID)
                                           | (ids == PAD_ID)].any()


def test_port_draws_select_every_real_token_at_probability_one():
    ids = torch.tensor([[CLS_ID, 10, 11, 12, SEP_ID, PAD_ID, PAD_ID, PAD_ID]])
    valid = torch.tensor([[1, 1, 1, 1, 1, 0, 0, 0]])
    corrupted, selected = ttp._apply_mlm_mask(
        ids, valid, 1.0, *ttp.mlm_draws(torch.Generator().manual_seed(0),
                                        ids.shape, 50, torch.device("cpu")))
    assert selected[0].tolist() == [False, True, True, True, False, False,
                                    False, False]
    assert corrupted[0, 0] == CLS_ID and corrupted[0, 4] == SEP_ID


def test_one_mlm_step_matches_jax():
    """Loss, every gradient and one optax.adamw update from the same
    converted weights and corrupted ids, dropout off."""
    sents, vocab = _corpus()
    ids, mask = vocab.encode_batch(sents[:8])
    enc = _port_encoder(vocab.vocab_size).eval()
    params = state_dict_to_flax(enc.state_dict())
    corrupted, selected = ttp._apply_mlm_mask(
        torch.from_numpy(ids), torch.from_numpy(mask), 0.3,
        *ttp.mlm_draws(torch.Generator().manual_seed(1), ids.shape,
                       vocab.vocab_size, torch.device("cpu")))
    model = JEncoder(vocab_size=vocab.vocab_size, output_dim=CFG.output_dim,
                     model_dim=CFG.model_dim, num_layers=CFG.num_layers,
                     num_heads=CFG.num_heads, dropout=CFG.dropout)

    def jloss(p):
        _, _, _, logits = model.apply({"params": p}, jnp.asarray(corrupted.numpy()),
                                      jnp.asarray(mask), deterministic=True,
                                      mlm_logits=True)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(ids))
        sel = jnp.asarray(selected.numpy())
        return jnp.sum(jnp.where(sel, ce, 0.0)) / jnp.maximum(sel.sum(), 1)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    tparams = dict(enc.named_parameters())
    loss, _ = ttp.mlm_loss(enc, corrupted, torch.from_numpy(ids),
                           torch.from_numpy(mask), selected)
    grads = torch.autograd.grad(loss, list(tparams.values()), allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    ref_g = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, ref_grads))
    for (name, p), g in zip(tparams.items(), grads):
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), ref_g[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)

    tx = optax.adamw(CFG.learning_rate, weight_decay=CFG.weight_decay)
    updates, _ = tx.update(ref_grads, tx.init(params), params)
    ref_after = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, updates)))
    opt = AdamW(tparams, {"all": (1.0, list(tparams))},
                lambda count: CFG.learning_rate, CFG.weight_decay,
                max_norm=float("inf"))
    before = {k: v.detach().clone() for k, v in tparams.items()}
    opt.step(list(grads))
    for name, p in tparams.items():
        # Adam steps by about g/|g|: where the exact gradient is ~0 (a key
        # bias: softmax ignores it) float noise steps either way by up to lr.
        held = np.abs(ref_g[name].numpy()) >= GRAD_FLOOR
        after = p.detach().numpy()
        np.testing.assert_allclose(after[held], ref_after[name].numpy()[held],
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        assert np.all(np.abs(after - before[name].numpy())
                      <= 1.01 * CFG.learning_rate), name


def test_featurizer_matches_jax_and_round_trips(tmp_path):
    sents, vocab = _corpus()
    enc = _port_encoder(vocab.vocab_size, seed=4)
    feat = ttp.TextEncoderFeaturizer(enc.state_dict(), vocab, CFG, device="cpu")
    jvocab = JVocab(vocab.itos[ttp.N_SPECIAL:], max_length=vocab.max_length)
    ref = jtp.TextEncoderFeaturizer(state_dict_to_flax(enc.state_dict()), jvocab,
                                    jtp.TextPretrainConfig(**CFG.__dict__))
    texts = list(sents[:6]) + ["never seen words here", ""]
    got = feat.extract_batch(texts)
    assert got.shape == (len(texts), CFG.model_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref.extract_batch(texts), rtol=1e-5, atol=1e-6)

    d = str(tmp_path / "enc")
    feat.save(d)
    assert sorted(os.listdir(d)) == ["config.json", "encoder.pt", "vocab.json"]
    back = ttp.TextEncoderFeaturizer.load(d, device="cpu")
    np.testing.assert_array_equal(back.extract_batch(texts), got)
    # The extractor takes the saved encoder and pads its width to 768;
    # empty text stays zeros.
    ext = TextFeatureExtractor(encoder_dir=d, device="cpu")
    assert ext.backend == "mlm"
    rows = ext.extract_batch(["that made him glad", ""])
    assert rows.shape == (2, TEXT_DIM)
    np.testing.assert_allclose(rows[0, :CFG.model_dim],
                               feat.extract("that made him glad"), rtol=1e-6,
                               atol=1e-7)
    assert not rows[0, CFG.model_dim:].any() and not rows[1].any()


def test_pretraining_learns():
    sents, _ = make_sentences(slice(None), np.random.default_rng(0), n_per_cat=30)
    cfg = ttp.TextPretrainConfig(model_dim=32, num_layers=2, num_heads=4,
                                 output_dim=64, batch_size=32, num_epochs=15,
                                 learning_rate=2e-3, seed=0)
    _, _, history = ttp.pretrain_text_encoder(
        sents, vocab=CorpusVocab.build(sents, max_length=16), config=cfg,
        device="cpu")
    assert len(history["mlm_loss"]) == 15
    assert history["mlm_loss"][-1] < history["mlm_loss"][0] * 0.8
    assert history["mlm_accuracy"][-1] > history["mlm_accuracy"][0]


def test_pretrained_features_beat_hashed_on_held_out_words():
    """The reference's headline test on the port: a probe on MLM features
    transfers to same-category words never seen with a label, where hashed
    features cannot. One seed's run is not the claim (PROBE_SEEDS), so over
    three seeds the mean probe CCC beats hashed features by 0.15 and at
    least one seed meets the reference's thresholds (0.2 over hashed, and
    0.3)."""
    rng = np.random.default_rng(1)
    corpus, _ = make_sentences(slice(None), rng, n_per_cat=60)
    train_sents, train_y = make_sentences(slice(0, 3), rng, n_per_cat=40)
    test_sents, test_y = make_sentences(slice(3, 6), rng, n_per_cat=40)
    hashed = TextFeatureExtractor()
    hashed_ccc = ridge_probe_ccc(hashed.extract_batch(train_sents), train_y,
                                 hashed.extract_batch(test_sents), test_y)
    mlm_ccc = []
    for seed in PROBE_SEEDS:
        cfg = ttp.TextPretrainConfig(model_dim=48, num_layers=2, num_heads=4,
                                     output_dim=96, batch_size=64, num_epochs=40,
                                     learning_rate=2e-3, seed=seed)
        state, vocab, _ = ttp.pretrain_text_encoder(
            corpus, vocab=CorpusVocab.build(corpus, max_length=16), config=cfg,
            device="cpu")
        feat = ttp.TextEncoderFeaturizer(state, vocab, cfg, device="cpu")
        mlm_ccc.append(ridge_probe_ccc(feat.extract_batch(train_sents), train_y,
                                       feat.extract_batch(test_sents), test_y))
    assert np.mean(mlm_ccc) > hashed_ccc + 0.15, (mlm_ccc, hashed_ccc)
    assert max(mlm_ccc) > max(hashed_ccc + 0.2, 0.3), (mlm_ccc, hashed_ccc)


def test_seeded_run_repeats_and_cache_is_keyed_by_corpus(tmp_path, monkeypatch):
    sents, vocab = _corpus()
    runs = [ttp.pretrain_text_encoder(list(sents), vocab=vocab, config=CFG,
                                      device="cpu") for _ in range(2)]
    assert runs[0][2] == runs[1][2]
    for k, v in runs[0][0].items():
        assert torch.equal(v, runs[1][0][k]), k

    full = [f"utterance number {i}" for i in range(50)]
    for texts in (full, full[:10], full[:-1] + ["a brand new transcript"]):
        assert os.path.basename(ttp._encoder_cache_dir(tmp_path, texts)) == \
            os.path.basename(jtp._encoder_cache_dir(tmp_path, texts))
    assert ttp._encoder_cache_dir(tmp_path, full) != \
        ttp._encoder_cache_dir(tmp_path, full[:10])

    # The bootstrap trains once, then loads its corpus-keyed entry; an
    # encoder.msgpack the reference left there is never read.
    small = functools.partial(ttp.TextPretrainConfig, model_dim=16, num_layers=1,
                              num_heads=2, output_dim=16)
    monkeypatch.setattr(ttp, "TextPretrainConfig", small)
    texts = list(sents[:20])
    first = ttp.corpus_text_featurizer(texts, tmp_path, device="cpu")
    enc_dir = ttp._encoder_cache_dir(tmp_path, texts)
    assert sorted(os.listdir(enc_dir)) == ["config.json", "encoder.pt",
                                           "vocab.json"]
    assert len(first.history["mlm_loss"]) == 60  # clip(40000 // 20, 5, 60)
    assert first.history["steps"] == [1] * 60  # 20 transcripts, one batch
    with open(os.path.join(enc_dir, "encoder.msgpack"), "wb") as f:
        f.write(b"not a port encoder")
    monkeypatch.setattr(ttp, "pretrain_text_encoder", None)  # no retraining
    again = ttp.corpus_text_featurizer(texts, tmp_path, device="cpu")
    np.testing.assert_array_equal(again.extract_batch(texts),
                                  first.extract_batch(texts))
    with pytest.raises(ValueError):
        ttp.corpus_text_featurizer([], tmp_path, device="cpu")
