"""Masked-token pretraining of the text encoder on a corpus's own
transcripts, and the text featurizer it yields.

Port of `tpu_deer/train/text_pretrain.py`. With no BERT weights at hand, a
`TextSequenceEncoder` learns the corpus's semantics from BERT's objective:
15% of the real tokens are selected, 80% of those become [MASK], 10% a
random non-special id and 10% stay; the loss is the cross-entropy of the
tied logits (token states @ embeddingᵀ) at the selected positions. The
pooled featurizer then stands in for BERT's features behind the
`data/features.py:TextFeatureExtractor` interface.

On the card a step runs there whole: the corpus's ids are staged once, the
batch is gathered from its host permutation, the mask draws come from a
device `torch.Generator` seeded from `config.seed` and dropout from the
pretrainer's own CPU generator (`train/rng.py:seeded_dropout`), so a seed
repeats bit for bit; the token embedding's gradient is the port's
deterministic kernel (`kernels/embedding.py`) plus the logits' matmul
gradient, which autograd adds. The optimizer is `train/optim.py:AdamW` at
`optax.adamw`'s defaults (b1 0.9, b2 0.999, eps 1e-8, decoupled weight
decay on every parameter, a constant rate, no clip). The epoch drops the
tail that does not fill a batch, as the reference's loop does.

The reference draws its masks from `jax.random` keys, which the port cannot
reproduce: its draws agree only in distribution. `_apply_mlm_mask` takes
the three draws as arguments, so the masking itself is held against the
reference's given the same draws.

A trained featurizer saves `vocab.json`, `config.json` and `encoder.pt` (a
state_dict); it never reads the reference's `encoder.msgpack`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tpu_deer_torch.data.vocab import (
    CLS_ID,
    MASK_ID,
    N_SPECIAL,
    PAD_ID,
    SEP_ID,
    CorpusVocab,
)
from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.models.encoders import TextSequenceEncoder
from tpu_deer_torch.models.layers import init_flax_style_
from tpu_deer_torch.train.optim import AdamW
from tpu_deer_torch.train.rng import seeded_dropout

logger = logging.getLogger(__name__)

ENCODER_FILE = "encoder.pt"
# Rows a featurizer forward takes at once.
FEATURIZE_ROWS = 512


@dataclasses.dataclass(frozen=True)
class TextPretrainConfig:
    model_dim: int = 256
    num_layers: int = 4
    num_heads: int = 8
    output_dim: int = 768  # the model's text feature width (TEXT_DIM)
    dropout: float = 0.1
    mask_prob: float = 0.15
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    batch_size: int = 64
    num_epochs: int = 10
    seed: int = 0


def _build_encoder(vocab_size: int, config: TextPretrainConfig) -> TextSequenceEncoder:
    return TextSequenceEncoder(
        vocab_size=vocab_size, output_dim=config.output_dim,
        model_dim=config.model_dim, num_layers=config.num_layers,
        num_heads=config.num_heads, dropout=config.dropout)


def mlm_draws(generator: torch.Generator, shape, vocab_size: int,
              device: torch.device):
    """The three draws a masking takes: the selection and kind uniforms in
    [0, 1) and the replacement ids in [N_SPECIAL, vocab_size)."""
    u_select = torch.rand(shape, generator=generator, device=device)
    u_kind = torch.rand(shape, generator=generator, device=device)
    random_ids = torch.randint(N_SPECIAL, vocab_size, shape,
                               generator=generator, device=device)
    return u_select, u_kind, random_ids


def _apply_mlm_mask(token_ids: torch.Tensor, valid_mask: torch.Tensor,
                    mask_prob: float, u_select: torch.Tensor,
                    u_kind: torch.Tensor, random_ids: torch.Tensor):
    """BERT masking from the given draws: (corrupted ids, selected). [CLS],
    [SEP] and [PAD] are never selected; a selected position becomes [MASK]
    where its kind draw is below 0.8, its random id at 0.9 or above, and
    stays otherwise."""
    maskable = (valid_mask.bool() & (token_ids != CLS_ID)
                & (token_ids != SEP_ID) & (token_ids != PAD_ID))
    selected = (u_select < mask_prob) & maskable
    corrupted = torch.where(
        selected & (u_kind < 0.8), torch.full_like(token_ids, MASK_ID),
        torch.where(selected & (u_kind >= 0.9), random_ids.to(token_ids.dtype),
                    token_ids))
    return corrupted, selected


def mlm_loss(encoder: TextSequenceEncoder, corrupted: torch.Tensor,
             token_ids: torch.Tensor, valid_mask: torch.Tensor,
             selected: torch.Tensor):
    """(loss, accuracy) at the selected positions: the mean cross-entropy of
    the tied logits against the original ids, and the share whose argmax is
    the original id (each over max(selected, 1))."""
    _, _, _, logits = encoder(corrupted, valid_mask, mlm_logits=True)
    target = token_ids.long()
    ce = F.cross_entropy(logits.transpose(1, 2), target, reduction="none")
    n = torch.clamp(selected.sum(), min=1)
    loss = torch.where(selected, ce, torch.zeros_like(ce)).sum() / n
    acc = (selected & (logits.argmax(-1) == target)).sum() / n
    return loss, acc


def pretrain_text_encoder(
    texts: Sequence[str],
    vocab: Optional[CorpusVocab] = None,
    config: TextPretrainConfig = TextPretrainConfig(),
    max_vocab: int = 30000,
    device: DeviceLike = None,
) -> tuple[dict, CorpusVocab, dict]:
    """MLM-pretrain a TextSequenceEncoder on `texts` on `device` (None = the
    CUDA card). Returns (the encoder's state_dict, vocab, history with the
    per-epoch "mlm_loss", "mlm_accuracy" and "steps"); the logits are tied
    to the embedding, so there is no separate head."""
    device = resolve_device(device)
    vocab = vocab or CorpusVocab.build(texts, max_size=max_vocab)
    ids, mask = vocab.encode_batch(texts)
    encoder = _build_encoder(vocab.vocab_size, config)
    init_flax_style_(encoder, torch.Generator().manual_seed(config.seed))
    encoder.to(device).train()
    params = dict(encoder.named_parameters())
    optimizer = AdamW(params, {"all": (1.0, list(params))},
                      lambda count: config.learning_rate, config.weight_decay,
                      max_norm=float("inf"))
    staged_ids = torch.from_numpy(ids.astype(np.int64)).to(device)
    staged_mask = torch.from_numpy(mask.astype(np.int32)).to(device)
    mask_generator = torch.Generator(device=device).manual_seed(config.seed)
    dropout_generator = torch.Generator().manual_seed(config.seed)

    n = len(texts)
    bs = min(config.batch_size, n)
    steps = n // bs
    history: dict[str, list] = {"mlm_loss": [], "mlm_accuracy": [], "steps": []}
    host_rng = np.random.default_rng(config.seed)
    for _ in range(config.num_epochs):
        order = host_rng.permutation(n)
        sums = torch.zeros(2, device=device)
        for start in range(0, n - bs + 1, bs):
            index = torch.from_numpy(order[start: start + bs]).to(device)
            batch_ids = staged_ids.index_select(0, index)
            batch_mask = staged_mask.index_select(0, index)
            corrupted, selected = _apply_mlm_mask(
                batch_ids, batch_mask, config.mask_prob,
                *mlm_draws(mask_generator, batch_ids.shape, vocab.vocab_size,
                           device))
            with seeded_dropout(dropout_generator, device):
                loss, acc = mlm_loss(encoder, corrupted, batch_ids, batch_mask,
                                     selected)
            # The pooling head takes no MLM gradient: a zero one, as in optax.
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            optimizer.step(list(grads))
            sums += torch.stack([loss.detach(), acc.detach().float()])
        loss_sum, acc_sum = (sums / max(steps, 1)).tolist()
        history["mlm_loss"].append(loss_sum)
        history["mlm_accuracy"].append(acc_sum)
        history["steps"].append(steps)
    return encoder.state_dict(), vocab, history


def _encoder_cache_dir(cache_dir, train_texts: Sequence[str]) -> str:
    """Cache dir for a corpus-trained encoder, keyed by the training corpus
    (count and content hash), so distinct corpora never share an entry."""
    digest = hashlib.sha1(
        "\x1f".join(train_texts).encode("utf-8", "replace")).hexdigest()[:10]
    return os.path.join(str(cache_dir),
                        f"text_encoder_{len(train_texts)}_{digest}")


def corpus_text_featurizer(train_texts: Sequence[str], cache_dir,
                           device: DeviceLike = None) -> "TextEncoderFeaturizer":
    """A text featurizer MLM-pretrained on a corpus's own train-split
    transcripts, or loaded from the corpus-keyed cache under `cache_dir`.
    The epochs scale inversely with the corpus: clip(40000 // n, 5, 60)."""
    if not train_texts:
        raise ValueError("text bootstrap requested but the corpus has no train text")
    enc_dir = _encoder_cache_dir(cache_dir, train_texts)
    if os.path.exists(os.path.join(enc_dir, ENCODER_FILE)):
        logger.info(f"text features: cached MLM encoder from {enc_dir}")
        return TextEncoderFeaturizer.load(enc_dir, device=device)
    epochs = int(np.clip(40000 // max(len(train_texts), 1), 5, 60))
    logger.info(f"text features: MLM-pretraining on {len(train_texts)} "
                f"transcripts ({epochs} epochs)…")
    config = TextPretrainConfig(num_epochs=epochs)
    state, vocab, history = pretrain_text_encoder(list(train_texts),
                                                  config=config, device=device)
    logger.info(f"MLM pretraining done: loss {history['mlm_loss'][0]:.3f} → "
                f"{history['mlm_loss'][-1]:.3f}, acc "
                f"{history['mlm_accuracy'][-1]:.3f}")
    featurizer = TextEncoderFeaturizer(state, vocab, config, device=device)
    featurizer.history = history
    featurizer.save(enc_dir)
    return featurizer


class TextEncoderFeaturizer:
    """Text featurizer backed by a pretrained TextSequenceEncoder:
    extract(text) / extract_batch(texts) → float32 [model_dim] features, the
    masked mean of the token states (what the MLM objective trains; the
    pooling head gets no MLM gradient). Ids come from the corpus
    vocabulary on the host; the forward runs on `device` (None = the CUDA
    card) in eval mode."""

    def __init__(self, encoder_state: dict, vocab: CorpusVocab,
                 config: TextPretrainConfig = TextPretrainConfig(),
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.vocab = vocab
        self.config = config
        self.encoder = _build_encoder(vocab.vocab_size, config)
        self.encoder.load_state_dict(encoder_state)
        self.encoder.to(self.device).eval()
        self.history: Optional[dict] = None  # set where this process trained it

    def extract_batch(self, texts: Sequence[str]) -> np.ndarray:
        ids, mask = self.vocab.encode_batch(texts)
        out = []
        with torch.no_grad():
            for start in range(0, len(ids), FEATURIZE_ROWS):
                i = torch.from_numpy(ids[start: start + FEATURIZE_ROWS]
                                     .astype(np.int64)).to(self.device)
                m = torch.from_numpy(mask[start: start + FEATURIZE_ROWS]).to(
                    self.device)
                _, _, seq = self.encoder(i, m, return_sequence=True)
                w = m.to(seq.dtype)[..., None]
                out.append((seq * w).sum(1) / torch.clamp(w.sum(1), min=1.0))
        return torch.cat(out).cpu().numpy().astype(np.float32)

    def extract(self, text: str) -> np.ndarray:
        return self.extract_batch([text])[0]

    # -- persistence --------------------------------------------------------
    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        self.vocab.save(os.path.join(directory, "vocab.json"))
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(self.config), f)
        torch.save({k: v.cpu() for k, v in self.encoder.state_dict().items()},
                   os.path.join(directory, ENCODER_FILE))

    @classmethod
    def load(cls, directory: str, device: DeviceLike = None) -> "TextEncoderFeaturizer":
        vocab = CorpusVocab.load(os.path.join(directory, "vocab.json"))
        with open(os.path.join(directory, "config.json")) as f:
            config = TextPretrainConfig(**json.load(f))
        state = torch.load(os.path.join(directory, ENCODER_FILE),
                           map_location="cpu", weights_only=True)
        return cls(state, vocab, config, device=device)
