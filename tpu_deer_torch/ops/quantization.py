"""Int8 weight quantization for serving.

Port of `tpu_deer/ops/quantization.py` over a `state_dict`. Symmetric
per-output-channel int8 of the Dense kernels (everything else stays float32)
for a ~4× smaller serving copy of the weights, and the stochastic-rounding
quantizer K4 (`kernels/quantize_int8.py`), which the reference wrote as a
Pallas kernel.

The leaves quantized are exactly the reference's: flax's 2-D `*kernel`
leaves whose contraction (input) width is at least 8. Kernels of other
ranks pass through in float: BilinearFusion's [in_a, in_b, out] kernel and
the member-stacked [E, ...] kernels of MoEFusion's experts and of the
stacked layout's trunk and heads (a member-stacked norm scale [E, D] is a
norm's, not a kernel). In the state_dict an
nn.Linear weight is [out, in], so its scale reduces over the last axis; a
raw `*_kernel` parameter (the calibration layer's) keeps flax's [in, out]
and reduces over the one before. A deep ensemble's entries carry a leading
member axis, and its scales are [K, out]. Embeddings, norms and biases pass
through. Rounding is
half to even (`torch.round`, as `np.round`), computed on the host in
float32 as the reference computes it in numpy.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_deer_torch.convert import flax_leaf
from tpu_deer_torch.kernels.quantize_int8 import (  # noqa: F401 — the API
    quantize_int8_stochastic,
    quantize_int8_stochastic_bits,
    quantize_int8_stochastic_bits_plain,
    quantize_int8_stochastic_plain,
)


def contraction_axis(key: str, tensor: torch.Tensor,
                     member_stacked: bool = False) -> Optional[int]:
    """The (negative) axis state_dict entry `key` contracts over when it is
    a quantizable Dense kernel, else None. `member_stacked`: every entry
    carries a leading member axis, so a kernel is 3-D."""
    ndim = tensor.dim() - member_stacked
    if ndim != 2 or not flax_leaf(key, ndim).endswith("kernel"):
        return None
    axis = -1 if key.endswith(".weight") else -2
    return axis if tensor.shape[axis] >= 8 else None


def _out_view(key: str, scale: torch.Tensor) -> torch.Tensor:
    """A [..., out] scale shaped to broadcast against its kernel."""
    return scale.unsqueeze(-1) if key.endswith(".weight") else scale.unsqueeze(-2)


def quantize_tree(state_dict: dict, member_stacked: bool = False
                  ) -> tuple[dict, dict]:
    """state_dict → (q, scales): quantizable kernels become int8 with a
    float32 [out] scale; other entries pass through (scale: an empty
    tensor). `member_stacked=True` declares a deep ensemble's state_dict,
    every entry [K, ...] (`train/ensemble.py`): its [K, out, in] kernels
    take per-member, per-channel [K, out] scales. Results are on the CPU."""
    q, scales = {}, {}
    for key, tensor in state_dict.items():
        t = tensor.detach().cpu()
        axis = contraction_axis(key, t, member_stacked)
        if axis is None:
            q[key], scales[key] = t, torch.zeros(0)
            continue
        w = t.to(torch.float32)
        scale = torch.clamp(w.abs().amax(dim=axis), min=1e-8) / 127.0
        q[key] = torch.clamp(torch.round(w / _out_view(key, scale)),
                             -127, 127).to(torch.int8)
        scales[key] = scale
    return q, scales


def dequantize_tree_device(q: dict, scales: dict, dtype=None) -> dict:
    """(q, scales) → float weights where they lie: q · scale on each
    quantized kernel, plain or member-stacked (the forward of the int8
    engine runs this)."""
    dtype = dtype or torch.float32
    return {key: (v if scales[key].numel() == 0
                  else v.to(dtype) * _out_view(key, scales[key]).to(dtype))
            for key, v in q.items()}


def dequantize_tree(q: dict, scales: dict) -> dict:
    """Inverse of quantize_tree → float32 weights on the CPU."""
    return dequantize_tree_device({k: v.cpu() for k, v in q.items()},
                                  {k: v.cpu() for k, v in scales.items()})


def quantized_size_bytes(q: dict) -> int:
    return sum(t.numel() * t.element_size() for t in q.values())
