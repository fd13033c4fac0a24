"""Run the headline twin with the flagship's bf16 rounded another way, or
in float32, to compare its training with the shipped bf16 run's.

    python -m tools.bf16_rounding {fused,evidence32,float32} \
        [synthetic_headline flags]

`fused` rounds once where a TPU fusion does: `torch.sigmoid` and
`torch.softmax` (one rounding each, where the port follows XLA's CPU
expansion op by op) and the bias added inside the product (one rounding,
where the port rounds the product, then the sum). `evidence32` keeps the
evidence heads' last product in float32 (bf16 operands, float32 sum and
bias, not rounded), as XLA may fold the cast to float32 that follows it
into the product. `float32` runs the model in float32 (the twin picks bf16
on the card). Everything else is
`python -m tpu_deer_torch.experiments.synthetic_headline` with the given
flags; its per-epoch train loss is in the `_predictions.npz` it writes
(`history_train_loss`).
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from tpu_deer_torch.experiments import synthetic_headline
from tpu_deer_torch.models import (
    attention,
    deer_model,
    encoders,
    fusion,
    heads,
    layers,
)


def _fused_dense(layer, x, dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _fused_softmax(x, dim=-1):
    return torch.softmax(x, dim=dim)


def _evidence32(mlp, x):
    """`layers.MLP.forward` with the last layer's product kept in float32."""
    dt = mlp.dtype
    for layer in mlp.layers[:-1]:
        x = mlp.dropout(torch.relu(layers.dense(layer, x, dt)))
    last = mlp.layers[-1]
    return F.linear(x.to(dt).float(), last.weight.to(dt).float(),
                    last.bias.to(dt).float())


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    variant, rest = argv[0], argv[1:]
    if variant == "fused":
        swaps = {"dense": _fused_dense, "sigmoid": torch.sigmoid,
                 "softmax": _fused_softmax}
        for module in (layers, attention, fusion, encoders):
            for name, fn in swaps.items():
                if hasattr(module, name):
                    setattr(module, name, fn)
    elif variant == "evidence32":
        forward = heads.DEERPredictionHead.forward

        def head_forward(self, x):
            mlp = self.evidence_network
            saved = mlp.forward
            mlp.forward = lambda h: _evidence32(mlp, h)
            try:
                return forward(self, x)
            finally:
                mlp.forward = saved

        heads.DEERPredictionHead.forward = head_forward
    elif variant == "float32":
        config = deer_model.DEERModelConfig
        deer_model.DEERModelConfig = lambda **kw: config(
            **{**kw, "compute_dtype": "float32"})
    else:
        raise SystemExit(f"variant {variant!r}: fused, evidence32 or float32")
    return synthetic_headline.main(rest)


if __name__ == "__main__":
    raise SystemExit(main())
