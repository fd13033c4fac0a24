"""Modality encoders.

Port of `tpu_deer/models/encoders.py`:

  * `ModalityEncoder` — the flagship model's feature-vector encoder.
  * The raw-sequence encoders of `RawSequenceDEERModel`:
    `AudioSequenceEncoder` (frame features [B, T, 84] → BiLSTM → attention
    pooling → MLP + LayerNorm), `VideoSequenceEncoder` (frames
    [B, T, H, W, C], channels last as in the reference → conv blocks →
    global average pool → two temporal convs → attention pooling) and
    `TextSequenceEncoder` (token ids → embedding, whose gradient repeats bit
    for bit on the card (`kernels/embedding.py`), + sinusoidal positions →
    pre-norm transformer blocks, whose attention takes kernel K3 from a key
    length of 1024 in training and 2048 at inference → attention pooling).

Numerics follow flax: LayerNorm and GroupNorm eps 1e-6, GroupNorm groups
min(8, channels), "SAME" padding (asymmetric, (0, 1), for the stride-2 conv
on an even size), the LSTM's backward direction over the full padded
length. `UnifiedSequenceEncoder` and the text encoder's MLM logits are not
ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from tpu_deer_torch.kernels.embedding import embedding_lookup
from tpu_deer_torch.models.attention import MultiHeadAttention
from tpu_deer_torch.models.layers import (
    LN_EPS,
    MLP,
    ResidualBlock,
    dense,
    layer_norm,
)


class ModalityEncoder(nn.Module):
    """Feature-vector encoder: input proj → ReLU → LayerNorm → N residual
    blocks → output proj, computed in `dtype` (flax's `dtype=`)."""

    def __init__(self, input_dim: int, output_dim: int = 256,
                 num_layers: int = 3, dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_proj = nn.Linear(input_dim, output_dim)
        self.input_norm = nn.LayerNorm(output_dim, eps=LN_EPS)
        self.blocks = nn.ModuleList(
            ResidualBlock(output_dim, dropout, dtype) for _ in range(num_layers)
        )
        self.output_proj = nn.Linear(output_dim, output_dim)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(dense(self.input_proj, x, self.dtype))
        h = layer_norm(self.input_norm, h, self.dtype)
        for block in self.blocks:
            h = block(h)
        return dense(self.output_proj, h, self.dtype)


class AttentionPooling(nn.Module):
    """scores = score(tanh(proj(x))); weights = softmax over T (masked
    positions filled with finfo.min); pooled = Σ_T weights · x.
    Returns (pooled [B, D], weights [B, T])."""

    def __init__(self, in_features: int, hidden_dim: int = 128):
        super().__init__()
        self.proj = nn.Linear(in_features, hidden_dim)
        self.score = nn.Linear(hidden_dim, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        scores = self.score(torch.tanh(self.proj(x)))[..., 0]
        if mask is not None:
            scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores, dim=-1)
        return torch.einsum("bt,btd->bd", weights, x), weights


class BiLSTM(nn.Module):
    """Stacked bidirectional LSTM, [B, T, F] → [B, T, 2·hidden].

    One `nn.LSTM` (gates i, f, g, o, as flax's OptimizedLSTMCell). flax's
    input kernels carry no bias, so `bias_ih_*` stay zero and take no
    gradient; `bias_hh_*` hold flax's hidden-kernel biases."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(input_dim, hidden_dim, num_layers,
                            batch_first=True, bidirectional=True)
        for name, p in self.lstm.named_parameters():
            if name.startswith("bias_ih"):
                nn.init.zeros_(p)
                p.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lstm(x)[0]


class AudioSequenceEncoder(nn.Module):
    """Frame features [B, T, F] → (utterance embedding [B, output_dim],
    pooling weights [B, T])."""

    def __init__(self, input_dim: int = 84, output_dim: int = 512,
                 lstm_hidden: int = 256, lstm_layers: int = 2,
                 dropout: float = 0.3):
        super().__init__()
        self.bilstm = BiLSTM(input_dim, lstm_hidden, lstm_layers)
        self.pool = AttentionPooling(2 * lstm_hidden, lstm_hidden)
        self.head = MLP(2 * lstm_hidden, [output_dim, output_dim],
                        dropout=dropout)
        self.head_norm = nn.LayerNorm(output_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        pooled, attn = self.pool(self.bilstm(x), mask)
        return self.head_norm(self.head(pooled)), attn


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pad the trailing two (spatial) axes as flax's padding="SAME": total
    max((⌈n/s⌉ - 1)·s + k - n, 0), the smaller half before."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ConvBlock(nn.Module):
    """Conv 3×3 → GroupNorm → ReLU → conv 3×3 stride 2 → ReLU, on NCHW."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 3)
        self.group_norm = nn.GroupNorm(min(8, features), features, eps=LN_EPS)
        self.conv2 = nn.Conv2d(features, features, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.group_norm(self.conv1(_same_pad(x, 3, 1))))
        return torch.relu(self.conv2(_same_pad(x, 3, 2)))


class VideoSequenceEncoder(nn.Module):
    """Frames [B, T, H, W, C] (channels last) → (utterance embedding
    [B, output_dim], pooling weights [B, T])."""

    def __init__(self, in_channels: int = 3, output_dim: int = 512,
                 conv_features: Sequence[int] = (32, 64, 128, 256),
                 dropout: float = 0.3):
        super().__init__()
        chans = [in_channels, *conv_features]
        self.convs = nn.ModuleList(
            ConvBlock(a, b) for a, b in zip(chans[:-1], chans[1:]))
        self.proj = nn.Linear(chans[-1], output_dim)
        self.tconv1 = nn.Conv1d(output_dim, output_dim, 3, padding=1)
        self.tconv2 = nn.Conv1d(output_dim, output_dim, 3, padding=1)
        self.pool = AttentionPooling(output_dim, output_dim)
        self.dropout = nn.Dropout(dropout)
        self.norm = nn.LayerNorm(output_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        b, t = x.shape[:2]
        frames = x.reshape(b * t, *x.shape[2:]).permute(0, 3, 1, 2)
        for block in self.convs:
            frames = block(frames)
        seq = self.proj(frames.mean(dim=(2, 3)).reshape(b, t, -1))
        seq = torch.relu(self.tconv1(seq.transpose(1, 2)))
        seq = torch.relu(self.tconv2(seq)).transpose(1, 2)
        pooled, attn = self.pool(seq, mask)
        return self.norm(self.dropout(pooled)), attn


class TransformerBlock(nn.Module):
    """Pre-norm transformer encoder block: x + Dropout(MHA(LN(x))), then
    x + Dropout(MLP(LN(x)))."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: int = 4,
                 dropout: float = 0.1, use_flash: Union[bool, str] = "auto"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(dim, num_heads, dropout, use_flash)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLP(dim, [dim * mlp_ratio, dim], dropout=dropout)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.norm1(x)
        attn_mask = mask[:, None, None, :] if mask is not None else None
        x = x + self.dropout(self.attn(h, h, h, attn_mask))
        return x + self.dropout(self.mlp(self.norm2(x)))


def sinusoidal_positions(t: int, dim: int,
                         device: Optional[torch.device] = None) -> torch.Tensor:
    """Sinusoidal positional encoding [T, dim]: sin then cos of
    pos / 10000^(2i / dim), float32."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2.0 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


class TextSequenceEncoder(nn.Module):
    """Token ids [B, T] → (utterance embedding [B, output_dim], pooling
    weights [B, T][, token states [B, T, model_dim] with
    return_sequence=True][, the tied masked-token logits token states @
    embedding.T [B, T, vocab] with mlm_logits=True, after the states])."""

    def __init__(self, vocab_size: int = 30522, output_dim: int = 512,
                 model_dim: int = 256, num_layers: int = 4,
                 num_heads: int = 8, dropout: float = 0.1,
                 use_flash: Union[bool, str] = "auto"):
        super().__init__()
        self.model_dim = model_dim
        self.embed = nn.Embedding(vocab_size, model_dim)
        self.blocks = nn.ModuleList(
            TransformerBlock(model_dim, num_heads, dropout=dropout,
                             use_flash=use_flash)
            for _ in range(num_layers))
        self.pool = AttentionPooling(model_dim, model_dim)
        self.out_proj = nn.Linear(model_dim, output_dim)
        self.norm = nn.LayerNorm(output_dim, eps=LN_EPS)

    def forward(self, token_ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                return_sequence: bool = False, mlm_logits: bool = False):
        x = embedding_lookup(token_ids.long(), self.embed.weight)
        x = x + sinusoidal_positions(token_ids.shape[1], self.model_dim,
                                     x.device)[None]
        bool_mask = mask.to(torch.bool) if mask is not None else None
        for block in self.blocks:
            x = block(x, bool_mask)
        pooled, attn = self.pool(x, bool_mask)
        out = self.norm(self.out_proj(pooled))
        if mlm_logits:
            # The embedding takes a gradient from the lookup (its kernel)
            # and one from this product; autograd adds them.
            return out, attn, x, x @ self.embed.weight.T
        if return_sequence:
            return out, attn, x
        return out, attn
