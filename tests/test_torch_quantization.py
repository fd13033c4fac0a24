"""Int8 quantization in the port against the JAX package on the CPU: kernel
K4's plain twins, `quantize_tree` and friends on the converted flagship,
and the int8 InferenceEngine.

K4 is held exactly: the reference's Pallas kernel runs in interpret mode on
`jax.random.bits(PRNGKey(seed), shape, uint32)`, and the port's bits variant
gets the same words; int8 values and the scale's bits must be equal. The
Philox words are pinned by Random123's known-answer vectors. The int8
engines compare within rtol 1e-4, atol 1e-5, as the float engines do
(`test_torch_serve.py`): the dequantized weights are equal, the forward is
float32 in another summation order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JModelConfig
from tpu_deer.ops import quantization as jq
from tpu_deer.serve import InferenceEngine as JEngine
from tpu_deer_torch.convert import (
    flax_quantized_to_state_dict,
    flax_to_state_dict,
    state_dict_to_flax,
)
from tpu_deer_torch.kernels import quantize_int8 as k4
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    create_complete_deer_model,
)
from tpu_deer_torch.ops import quantization as tq
from tpu_deer_torch.serve import InferenceEngine
from tpu_deer_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)


@pytest.mark.parametrize("shape,seed,zero", [
    ((1, 1), 0, False), ((7, 13), 1, False), ((64, 128), 2, False),
    ((5,), 3, False), ((3, 3, 3), 4, False), ((300, 77), 5, False),
    ((6, 9), 6, True)])
def test_k4_bits_variant_equals_jax_kernel(shape, seed, zero):
    """Odd sizes (no multiple of 4), ranks 1-3, and an all-zero w, whose
    scale is 1e-8/127 and values 0 or 1 by the noise."""
    rng = np.random.default_rng(seed)
    w = (np.zeros(shape) if zero else rng.normal(size=shape)
         * rng.uniform(0.01, 5.0)).astype(np.float32)
    ref_q, ref_s = jq.quantize_int8_stochastic(jnp.asarray(w), seed=seed)
    bits = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                      jnp.uint32)).view(np.int32)
    q, s = k4.quantize_int8_stochastic_bits(torch.from_numpy(w),
                                            torch.from_numpy(bits.copy()))
    assert q.dtype == torch.int8 and q.shape == shape and s.shape == (1, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(ref_s).view(np.uint32))


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for counter, key, want in cases:
        got = k4.philox4x32_10(torch.tensor(counter, dtype=torch.int64), key)
        assert got.dtype == torch.int64 and tuple(int(x) for x in got) == want
    # Element e takes word e % 4 of the call at counter e // 4 (64-bit);
    # philox_bits gives the words as int32 with the same bits.
    seed = 2**40 + 7
    bits = k4.philox_bits(10, seed)
    third = k4.philox4x32_10(torch.tensor([2, 0, 0, 0]),
                             (seed & 0xFFFFFFFF, seed >> 32))
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits[8:].numpy().view(np.uint32),
                                  third[:2].numpy().astype(np.uint32))
    assert (bits < 0).any()  # words past 2^31 wrap to negative int32


def test_k4_philox_plain_twin_properties():
    """The JAX test's bounds (values in [-127, 127], |q·s - w| <= 1.01 s,
    |mean(q·s - w)| < 0.05 s at 64 × 128), a seed repeats, another differs."""
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 128))
                         .astype(np.float32))
    q, s = k4.quantize_int8_stochastic(w, seed=1)
    err = q.float() * s - w
    assert q.min() >= -127 and q.max() <= 127
    assert err.abs().max() <= 1.01 * s and err.mean().abs() < 0.05 * s
    assert torch.equal(k4.quantize_int8_stochastic(w, seed=1)[0], q)
    assert not torch.equal(k4.quantize_int8_stochastic(w, seed=2)[0], q)
    before = k4.quantize_int8_stochastic.launches
    k4.quantize_int8_stochastic(w, seed=1)
    assert k4.quantize_int8_stochastic.launches == before  # CPU: the twin


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "empty",
                                 "bits_dtype", "seed"])
def test_k4_wrappers_raise(bad):
    w = torch.randn(8, 6)
    bits = torch.zeros(8, 6, dtype=torch.int32)
    call = {
        "float64": lambda: k4.quantize_int8_stochastic(w.double()),
        "non_contiguous": lambda: k4.quantize_int8_stochastic(w.t()),
        "empty": lambda: k4.quantize_int8_stochastic(torch.zeros(0)),
        "bits_dtype": lambda: k4.quantize_int8_stochastic_bits(w, bits.long()),
        "seed": lambda: k4.quantize_int8_stochastic(w, seed=-1),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        call()


_SPLIT_SIZES = sorted({1, 2, 3, 4, 5, 15, 16, 17, 1001, 16383, 16384, 16385,
                       393216, 3899984, 2**20 + 3, 4096 * 4096, 2**26 + 3}
                      | {k * 58080 + d for k in (1, 2, 132, 264)
                         for d in (-17, -1, 0, 1, 3, 16)})


@pytest.mark.parametrize("sms", [1, 2, 7, 78, 114, 132, 144, 264])
@pytest.mark.parametrize("stage_bytes", [4 * k4.MIN_SHARE, 100_000, 232_320,
                                         232_448])
def test_k4_split_covers_w(sms, stage_bytes):
    """K4's cut of w into shares, for SM counts (one resident block a SM)
    and stage sizes up to the 227 KB a block may have: each element in
    exactly one share, share starts 16-byte aligned, at most the resident
    blocks, staged bytes within the stage, and every element staged exactly
    when n <= capacity."""
    cap = k4.capacity(sms, stage_bytes)
    for n in _SPLIT_SIZES:
        grid, share, staged = k4.split(n, sms, stage_bytes)
        assert 1 <= grid <= sms and share % k4.GROUP == 0
        bounds = [min(n, b * share) for b in range(grid + 1)]
        assert bounds[0] == 0 and bounds[-1] == n
        assert all(hi > lo for lo, hi in zip(bounds, bounds[1:]))  # none empty
        assert all(4 * lo % 16 == 0 for lo in bounds[:-1])
        assert staged % k4.GROUP == 0 and 0 < staged <= share
        assert 4 * staged <= stage_bytes <= 232_448
        assert (staged == share) == (n <= cap)


def test_k4_split_refuses():
    for args in [(0, 132, 232_320), (5, 0, 232_320),
                 (5, 132, 4 * k4.MIN_SHARE - 64)]:
        with pytest.raises(ValueError):
            k4.split(*args)


@functools.lru_cache(maxsize=None)
def _flagship():
    """The reference's flagship module and the port's seeded weights as
    flax params (converted; spares JAX an init compile)."""
    model = create_complete_deer_model(seed=0, device="cpu")
    return JModel(JModelConfig()), state_dict_to_flax(model.state_dict())


def test_quantize_tree_equals_jax_on_the_flagship():
    """44 Dense kernels (3,899,984 entries) in both packages, the int8
    values, scales, dequantized weights and sizes equal."""
    _, params = _flagship()
    ref_q, ref_s = jq.quantize_tree(params)
    want_q, want_s = flax_quantized_to_state_dict(ref_q, ref_s)
    q, s = tq.quantize_tree(flax_to_state_dict(params))
    assert sorted(q) == sorted(want_q) and sorted(s) == sorted(want_s)
    for key in q:
        assert q[key].dtype == want_q[key].dtype and torch.equal(q[key], want_q[key]), key
        assert torch.equal(s[key], want_s[key]), key
    kernels = [k for k in q if s[k].numel()]
    assert len(kernels) == 44
    assert sum(q[k].numel() for k in kernels) == 3_899_984
    assert all(q[k].dtype == torch.int8 for k in kernels)
    assert "calibration.cal2_kernel" in kernels  # flax layout, [in, out]
    assert tq.quantized_size_bytes(q) == jq.quantized_size_bytes(ref_q)
    ref_deq = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jq.dequantize_tree(ref_q, ref_s)))
    deq = tq.dequantize_tree(q, s)
    for key, ref in ref_deq.items():
        assert torch.equal(deq[key], ref), key


@functools.lru_cache(maxsize=None)
def _int8_engines():
    jmodel, params = _flagship()
    model = CompleteDEERModel()
    model.load_state_dict(flax_to_state_dict(params))
    # One bucket, so each engine builds one forward for both request sizes.
    return (JEngine(jmodel, params, batch_buckets=(80,), quantize_weights=True),
            InferenceEngine(model, batch_buckets=(80,), quantize_weights=True,
                            device="cpu"), model)


@pytest.mark.parametrize("n", [3, 70])
def test_int8_engine_matches_jax(n):
    jengine, engine, _ = _int8_engines()
    feats = [np.random.default_rng(n).normal(size=(n, d)).astype(np.float32)
             for d in (84, 256, 768)]
    ref, got = jengine.predict(*feats), engine.predict(*feats)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def test_int8_engine_keeps_int8_and_no_float_copy():
    _, engine, model = _int8_engines()
    q, s = engine.quantized_weights
    assert sum(v.dtype == torch.int8 for v in q.values()) == 44
    assert all(p.device.type == "meta" for p in engine.model.parameters())
    assert next(model.parameters()).device.type == "cpu"  # caller's untouched
    feats = [np.zeros((2, d), np.float32) for d in (84, 256, 768)]
    float_engine = InferenceEngine(CompleteDEERModel(), device="cpu")
    float_engine.model.load_state_dict(tq.dequantize_tree(q, s))
    ref, got = float_engine.predict(*feats), engine.predict(*feats)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-6)


def test_from_checkpoint_serves_the_recorded_channel(tmp_path):
    _, params = _flagship()
    sd = flax_to_state_dict(params)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save({"model": sd, "step": 7}, step=7,
              metrics={"serving_channel": "calibrated"}, is_best=True)
    for quantize in (False, True):
        engine = InferenceEngine.from_checkpoint(
            str(tmp_path), device="cpu", quantize_weights=quantize)
        assert engine.serving_channel == "calibrated"
        assert engine.quantized == quantize
    engine = InferenceEngine.from_checkpoint(str(tmp_path), device="cpu",
                                             serving_channel="eabs")
    assert engine.serving_channel == "eabs"
    for key, v in engine.model.state_dict().items():
        assert torch.equal(v, sd[key]), key
    # A single model's checkpoint is not a 2-member ensemble's.
    with pytest.raises(ValueError, match="member"):
        InferenceEngine.from_checkpoint(str(tmp_path), device="cpu",
                                        ensemble_members=2)
