"""The flagship under every fusion type and the stacked layout against the
JAX package on the CPU: outputs, conversions, parameter counts and the
int8 quantizer's leaves.

The port's seeded init is carried to a flax tree by tpu_deer_torch.convert
(checked against the paths and shapes of the reference's own init, traced
with jax.eval_shape, and for an exact way back); both sides run the same
inputs from a numpy seed at a narrow width (encoder 16, fusion 32, one
layer, 4 heads), the reference's apply jitted. Outputs rtol 1e-4, atol
1e-5. The parameter counts at full width are the reference's
(experiments/RESULTS_fusion.md). tests/test_torch_stacked.py trains the
stacked MoE flagship against the reference's trainer, and
tests/test_torch_zoo_serving.py serves every layout.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JModelConfig
from tpu_deer.ops.quantization import quantize_tree as jquantize_tree
from tpu_deer_torch.convert import (
    flax_quantized_to_state_dict,
    flax_to_state_dict,
    state_dict_to_flax,
)
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    count_parameters,
    create_complete_deer_model,
)
from tpu_deer_torch.ops.quantization import quantize_tree

torch.set_num_threads(1)

NARROW = dict(encoder_dim=16, fusion_dim=32, encoder_layers=1,
              attention_heads=4)
KINDS = {f: dict(fusion_type=f) for f in
         ("hierarchical", "attention", "bilinear", "concat", "adaptive", "moe")}
KINDS["stacked"] = dict(stacked_compute=True)
KINDS["stacked_moe"] = dict(stacked_compute=True, fusion_type="moe",
                            moe_experts=3)
FULL_WIDTH_COUNTS = {"hierarchical": 3_918_324, "attention": 2_736_117,
                     "bilinear": 36_027_380, "concat": 2_997_236,
                     "adaptive": 37_081_336, "moe": 3_657_720,
                     "stacked": 3_918_324}
TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(rng, b=6):
    return tuple(rng.normal(size=(b, d)).astype(np.float32)
                 for d in (84, 256, 768))


@functools.lru_cache(maxsize=None)
def _pair(kind):
    """(reference module, the port's seeded init as flax params), the tree
    checked against the reference's init's paths and shapes."""
    cfg = {**NARROW, **KINDS[kind]}
    model = create_complete_deer_model(DEERModelConfig(**cfg), seed=3,
                                       device="cpu")
    params = state_dict_to_flax(model.state_dict())
    jm = JModel(JModelConfig(**cfg))
    x = tuple(np.zeros((2, d), np.float32) for d in (84, 256, 768))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *x))["params"]
    ref = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in got] == [p for p, _ in ref]
    assert all(a.shape == b.shape for (_, a), (_, b) in zip(ref, got))
    return jm, params


def _port(kind, params):
    model = CompleteDEERModel(DEERModelConfig(**NARROW, **KINDS[kind]))
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("kind", sorted(FULL_WIDTH_COUNTS))
def test_full_width_parameter_count(kind):
    with torch.device("meta"):
        model = CompleteDEERModel(DEERModelConfig(**KINDS[kind]))
    assert count_parameters(model) == FULL_WIDTH_COUNTS[kind]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_flagship_matches_jax(kind, rng):
    jm, params = _pair(kind)
    model = _port(kind, params)
    back = state_dict_to_flax(model.state_dict())
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                 jax.tree_util.tree_flatten_with_path(back)[0]):
        assert np.array_equal(a, b), jax.tree_util.keystr(path)
    a, v, t = _inputs(rng)
    ref = jax.jit(lambda p, *x: jm.apply({"params": p}, *x))(params, a, v, t)
    with torch.no_grad():
        out = model(*(torch.from_numpy(x) for x in (a, v, t)))
    assert set(out) == set(ref)
    for key, r in ref.items():
        pairs = (zip(r, out[key]) if key.endswith("_params")
                 else [(r, out[key])])
        for rr, oo in pairs:
            assert tuple(oo.shape) == rr.shape, key
            np.testing.assert_allclose(oo.numpy(), np.asarray(rr),
                                       err_msg=key, **TOL)


@pytest.mark.parametrize("kind", ["bilinear", "moe", "stacked"])
def test_quantized_leaves_are_the_references(kind):
    """quantize_tree quantizes exactly the reference's leaves: the 3-D
    bilinear kernel, the [E, ...] experts and the stacked trunk and heads
    pass through in float; q and scales are equal."""
    _, params = _pair(kind)
    jq, js = jquantize_tree(params)
    want_q, want_s = flax_quantized_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jq),
        jax.tree_util.tree_map(np.asarray, js))
    got_q, got_s = quantize_tree(_port(kind, params).state_dict())
    quantized = {k for k, s in got_s.items() if s.numel()}
    assert quantized == {k for k, s in want_s.items() if s.numel()}
    passed = {"bilinear": "fusion.bilinear_kernel",
              "moe": "fusion.experts.mlp.layers.0.weight",
              "stacked": "stacked_encoders.trunk.blocks.0.dense.weight"}[kind]
    assert passed not in quantized and got_q[passed].dtype == torch.float32
    for key in got_q:
        assert torch.equal(got_q[key], want_q[key]), key
        assert torch.equal(got_s[key], want_s[key]), key
