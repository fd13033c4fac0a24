"""Attention modules: MHA, per-modality uncertainty, uncertainty-aware attention.

Port of `tpu_deer/models/attention.py` (MultiHeadAttention with its plain
scaled-dot-product branch and its flash branch, kernels K3a-c;
UncertaintyEstimator; UncertaintyAwareAttention). The flagship model
attends over sequences of length 1, so its attention is a handful of dense
matmuls; the raw model's text encoder takes the flash branch on long
transcripts.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from tpu_deer_torch.kernels.flash_attention import flash_attention
from tpu_deer_torch.models.layers import MLP, dense, sigmoid, softmax

# Key lengths at which use_flash="auto" picks the flash kernels, kept equal
# to the reference's so that both packages dispatch alike. The flash branch
# skips attention-probability dropout (as the reference's does), so a lower
# threshold would drop that dropout at lengths where the reference keeps it;
# chip_smoke.py prints the H100 crossover against PyTorch's SDPA beside.
FLASH_AUTO_INFER_T = 2048
FLASH_AUTO_TRAIN_T = 1024


def resolve_use_flash(use_flash: Union[bool, str], t_k: int,
                      training: bool = False) -> bool:
    """Resolve a bool | "auto" flag to a concrete choice: "auto" takes the
    flash kernels from a key length of FLASH_AUTO_TRAIN_T in training (a
    gradient will flow) and FLASH_AUTO_INFER_T otherwise."""
    if use_flash == "auto":
        return t_k >= (FLASH_AUTO_TRAIN_T if training else FLASH_AUTO_INFER_T)
    return bool(use_flash)


class MultiHeadAttention(nn.Module):
    """Scaled-dot-product multi-head attention over [B, T, D], optional mask
    (True = attend; [B, 1, 1, Tk] or anything that broadcasts to the scores).

    The flash branch (`resolve_use_flash`) hands the heads to kernels K3a-c
    with the key mask as the reference builds it, and skips attention-prob
    dropout, as the reference's flash branch does. In `dtype` the
    projections, scores, softmax and attn·v run in it (the scale rounded to
    it, as `jnp.sqrt` of a head dim in that dtype); the flash branch casts
    the heads to float32 for K3 and its output back."""

    def __init__(self, feature_dim: int, num_heads: int = 8,
                 dropout: float = 0.1, use_flash: Union[bool, str] = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if feature_dim % num_heads != 0:
            raise ValueError(f"feature_dim {feature_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.feature_dim = feature_dim
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.q_proj = nn.Linear(feature_dim, feature_dim)
        self.k_proj = nn.Linear(feature_dim, feature_dim)
        self.v_proj = nn.Linear(feature_dim, feature_dim)
        self.out_proj = nn.Linear(feature_dim, feature_dim)
        self.dropout = nn.Dropout(dropout)
        self.dtype = dtype
        # sqrt(head_dim) rounded to the compute dtype.
        self.scale = float(torch.tensor(math.sqrt(feature_dim // num_heads),
                                        dtype=dtype, device="cpu"))

    def forward(self, query, key, value,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        head_dim = self.feature_dim // self.num_heads
        b, tq, _ = query.shape
        tk = key.shape[1]

        def split_heads(x, t):
            return x.reshape(b, t, self.num_heads, head_dim).transpose(1, 2)

        dt = self.dtype
        q = split_heads(dense(self.q_proj, query, dt), tq)
        k = split_heads(dense(self.k_proj, key, dt), tk)
        v = split_heads(dense(self.v_proj, value, dt), tk)
        if resolve_use_flash(self.use_flash, tk, training=self.training):
            kv_mask = None
            if mask is not None:
                kv_mask = mask.reshape(b, -1, tk)[:, -1, :].to(torch.float32)
            f32 = lambda x: x.to(torch.float32).contiguous()
            out = flash_attention(f32(q), f32(k), f32(v), kv_mask).to(dt)
        else:
            scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / self.scale
            if mask is not None:
                scores = torch.where(mask, scores,
                                     torch.finfo(scores.dtype).min)
            attn = self.dropout(softmax(scores, dim=-1))
            out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        out = out.transpose(1, 2).reshape(b, tq, self.feature_dim)
        return dense(self.out_proj, out, dt)


class UncertaintyEstimator(nn.Module):
    """Per-modality scalar uncertainty in [0, 1]: Linear → ReLU → Dropout →
    Linear → ReLU → Linear → sigmoid, in `dtype`."""

    def __init__(self, feature_dim: int, dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.Linear(feature_dim, feature_dim // 2),
            nn.Linear(feature_dim // 2, feature_dim // 4),
            nn.Linear(feature_dim // 4, 1),
        ])
        self.dropout = nn.Dropout(dropout)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = self.dropout(torch.relu(dense(self.layers[0], x, dt)))
        h = torch.relu(dense(self.layers[1], h, dt))
        return sigmoid(dense(self.layers[2], h, dt))


class UncertaintyAwareAttention(nn.Module):
    """Uncertainty-aware cross-modal attention.

    Per modality m with features f_m [B, D]:
      u_m     = UncertaintyEstimator(f_m)   (one estimator for all three)
      self_m  = SelfAttn(f_m)               (one self-attention for all three)
      cross_m = CrossAttn(text → f_m)       (text is the query; t_cross is
                                             cross(t, t, t))
      w       = softmax(WeightNet(cat[self_a, self_v, self_t, u_a, u_v, u_t]))
      out_m   = w_m * self_m + (1 - u_m) * cross_m
    all in `dtype`.
    """

    def __init__(self, feature_dim: int, num_heads: int = 8,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        mha = lambda: MultiHeadAttention(feature_dim, num_heads, dropout,
                                         dtype=dtype)
        self.self_attention = mha()
        self.cross_attention = mha()
        self.uncertainty_estimator = UncertaintyEstimator(feature_dim,
                                                          dtype=dtype)
        self.weight_network = MLP(3 * feature_dim + 3, [feature_dim, 3],
                                  dropout=dropout, final_activation="softmax",
                                  dtype=dtype)

    def forward(self, audio, video, text) -> dict[str, torch.Tensor]:
        a1, v1, t1 = (x[:, None, :] for x in (audio, video, text))
        unc = self.uncertainty_estimator
        u_a, u_v, u_t = unc(audio), unc(video), unc(text)

        sa = self.self_attention
        a_self = sa(a1, a1, a1)[:, 0]
        v_self = sa(v1, v1, v1)[:, 0]
        t_self = sa(t1, t1, t1)[:, 0]

        ca = self.cross_attention
        a_cross = ca(t1, a1, a1)[:, 0]
        v_cross = ca(t1, v1, v1)[:, 0]
        t_cross = ca(t1, t1, t1)[:, 0]

        weights = self.weight_network(
            torch.cat([a_self, v_self, t_self, u_a, u_v, u_t], dim=1)
        )
        return {
            "audio": weights[:, 0:1] * a_self + (1.0 - u_a) * a_cross,
            "video": weights[:, 1:2] * v_self + (1.0 - u_v) * v_cross,
            "text": weights[:, 2:3] * t_self + (1.0 - u_t) * t_cross,
            "attention_weights": weights,
            "modality_uncertainties": torch.cat([u_a, u_v, u_t], dim=1),
        }
