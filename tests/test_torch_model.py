"""The port's flagship model (tpu_deer_torch.models) against the JAX reference
on the CPU, with the reference's weights carried over by
tpu_deer_torch.convert.

Output tolerance rtol 1e-4, atol 1e-5: both sides run float32, but sums are
taken in another order (XLA vs ATen GEMMs) and flax's LayerNorm computes
the variance as E[x²] - E[x]² where torch subtracts the mean first, so
results differ in the last bits and grow a little through ~15 layers.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from _jax_reference import create_complete_deer_model as jax_create
from tpu_deer.core import nig as jnig
from tpu_deer.models.deer_model import DEERModelConfig as JConfig
from tpu_deer_torch.convert import flax_to_state_dict, state_dict_to_flax
from tpu_deer_torch.core import nig as tnig
from tpu_deer_torch.models.attention import resolve_use_flash
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    count_parameters,
    create_complete_deer_model,
)

torch.set_num_threads(1)

CONFIGS = {
    "default": {},
    "narrow": dict(encoder_dim=32, fusion_dim=64, attention_heads=4,
                   encoder_layers=1),
}


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    model, params = jax_create(JConfig(**CONFIGS[name]), seed=0)
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(kw, params):
    model = CompleteDEERModel(DEERModelConfig(**kw))
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model.eval()


def _inputs(rng, b=6):
    return tuple(rng.normal(size=(b, d)).astype(np.float32)
                 for d in (84, 256, 768))


def test_convert_round_trip_exact():
    _, params = _jax_model("default")
    model = _port_model({}, params)
    back = state_dict_to_flax(model.state_dict())
    ref = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (path, a), (_, b) in zip(ref, got):
        assert a.shape == b.shape and np.array_equal(a, b), path


def test_default_model_has_reference_param_count():
    model = create_complete_deer_model(seed=0, device="cpu")
    assert count_parameters(model) == 3_918_324
    assert not model.training


def test_seeded_init_is_deterministic():
    a = create_complete_deer_model(seed=3, device="cpu").state_dict()
    b = create_complete_deer_model(seed=3, device="cpu").state_dict()
    c = create_complete_deer_model(seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fusion.fusion_gate.weight"],
                           c["fusion.fusion_gate.weight"])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_outputs_match_jax(config, rng):
    jmodel, params = _jax_model(config)
    model = _port_model(CONFIGS[config], params)
    a, v, t = _inputs(rng)
    ref = jmodel.apply({"params": params}, a, v, t, deterministic=True)
    with torch.no_grad():
        out = model(*(torch.from_numpy(x) for x in (a, v, t)))
    assert set(out) == set(ref)
    for key, r in ref.items():
        pairs = (zip(r, out[key]) if key.endswith("_params")
                 else [(r, out[key])])
        for rr, oo in pairs:
            assert tuple(oo.shape) == rr.shape, key
            np.testing.assert_allclose(oo.numpy(), np.asarray(rr), rtol=1e-4,
                                       atol=1e-5, err_msg=key)


def test_nig_functions_match_jax(rng):
    """Constraints, uncertainties and E|y-mu| on the same raw evidence;
    rtol 1e-5 (softplus and lgamma in float32 from two libraries)."""
    ev = (3.0 * rng.normal(size=(64, 3, 4))).astype(np.float32)
    jp = jnig.nig_params_from_evidence(ev)
    tp = tnig.nig_params_from_evidence(torch.from_numpy(ev))
    for r, o in zip(jp, tp):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    ju, tu = jnig.nig_uncertainties(jp), tnig.nig_uncertainties(tp)
    for k in ("aleatoric", "epistemic", "total"):
        np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-5)
    np.testing.assert_allclose(tnig.nig_expected_abs_error(tp).numpy(),
                               np.asarray(jnig.nig_expected_abs_error(jp)),
                               rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(fusion_type="moe"),
                                dict(stacked_compute=True),
                                dict(fusion_type="attention")])
def test_unported_config_raises(kw):
    """These configs were refused before the fusion zoo and the stacked
    layout were ported; now each builds, with the reference's parameter
    count at the default widths (tests/test_torch_model_zoo.py holds their
    outputs against the reference). compute_dtype="bfloat16" is ported:
    tests/test_torch_bf16.py holds it against the reference."""
    counts = {"moe": 3_657_720, "hierarchical": 3_918_324,
              "attention": 2_736_117}
    with torch.device("meta"):
        model = CompleteDEERModel(DEERModelConfig(**kw))
    assert count_parameters(model) == counts[kw.get("fusion_type",
                                                    "hierarchical")]


def test_resolve_use_flash_dispatch():
    """The flagship's length-1 attention stays on the dense branch; a long
    key length or an explicit True takes the flash kernels (K3a-c)."""
    assert resolve_use_flash("auto", 1) is False
    assert resolve_use_flash("auto", 4096) is True
    assert resolve_use_flash(True, 1) is True
