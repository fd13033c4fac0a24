"""The port's raw-sequence encoders and RawSequenceDEERModel against the JAX
reference on the CPU, with the reference's weights carried over by
tpu_deer_torch.convert.

Tolerance rtol 1e-4, atol 1e-5 as for the flagship model
(tests/test_torch_model.py): float32 on both sides, sums in another order
(XLA vs ATen GEMMs, convolutions and the LSTM's recurrence), LayerNorm and
GroupNorm variances computed another way.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deer.models import encoders as jenc
from tpu_deer.models.heads import MultiDimensionalDEER as JMultiDEER
from tpu_deer.models.hierarchical_deer import RawSequenceDEERModel as JRaw
from tpu_deer_torch.convert import flax_to_state_dict, state_dict_to_flax
from tpu_deer_torch.models import encoders as tenc
from tpu_deer_torch.models.heads import MultiDimensionalDEER
from tpu_deer_torch.models.hierarchical_deer import (
    RawSequenceDEERModel,
    create_raw_sequence_model,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
WIDTHS = {  # (encoder_dim, fusion_dim, heads)
    "narrow": (24, 48, 4),  # tests/test_raw_training.py
    "cli": (128, 256, 4),   # cli.py --raw, non-quick
}


def _np_params(jmodule, *args):
    variables = jax.jit(jmodule.init)(jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _apply(jmodule, params, *args, **kw):
    """The reference's forward, jitted (eager flax runs op by op)."""
    fn = jax.jit(lambda p, *a: jmodule.apply({"params": p}, *a, **kw))
    return fn(params, *args)


def _load(tmodule, params):
    tmodule.load_state_dict(flax_to_state_dict(params), strict=True)
    return tmodule.eval()


def _close(got, want, name=""):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{name}[{i}]")
        return
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert g.shape == np.asarray(want).shape, name
    np.testing.assert_allclose(g, np.asarray(want), err_msg=name, **TOL)


def _inputs(rng, b=3, ta=9, tv=3, size=16, tt=12, vocab=50):
    audio = rng.normal(size=(b, ta, 84)).astype(np.float32)
    video = rng.uniform(size=(b, tv, size, size, 3)).astype(np.float32)
    ids = rng.integers(5, vocab, size=(b, tt)).astype(np.int32)
    mask = np.ones((b, tt), np.int32)
    mask[1, tt // 2:] = 0
    mask[2, 3:] = 0
    return audio, video, ids, mask


def test_attention_pooling(rng):
    x = rng.normal(size=(3, 7, 20)).astype(np.float32)
    mask = np.ones((3, 7), bool)
    mask[1, 4:] = False
    jm = jenc.AttentionPooling(hidden_dim=11)
    params = _np_params(jm, x, mask)
    tm = _load(tenc.AttentionPooling(20, 11), params)
    for m in (None, mask):
        ref = _apply(jm, params, x, m)
        got = tm(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
        _close(got, ref)


def test_bilstm(rng):
    """Two layers, both directions; the backward direction runs over the
    full padded length as in flax's RNN(reverse=True, keep_order=True)."""
    x = rng.normal(size=(2, 11, 84)).astype(np.float32)
    jm = jenc.BiLSTM(hidden_dim=12, num_layers=2)
    params = _np_params(jm, x)
    tm = _load(tenc.BiLSTM(84, 12, 2), params)
    _close(tm(torch.from_numpy(x)), _apply(jm, params, x))
    assert all(not p.requires_grad for n, p in tm.named_parameters()
               if n.startswith("lstm.bias_ih"))


def test_audio_sequence_encoder(rng):
    x = rng.normal(size=(3, 9, 84)).astype(np.float32)
    jm = jenc.AudioSequenceEncoder(output_dim=32, lstm_hidden=16)
    params = _np_params(jm, x)
    tm = _load(tenc.AudioSequenceEncoder(84, 32, lstm_hidden=16), params)
    _close(tm(torch.from_numpy(x)), _apply(jm, params, x))


@pytest.mark.parametrize("size", [16, 15])
def test_conv_block_same_padding(size, rng):
    """flax "SAME" pads (0, 1) for the 3×3 stride-2 conv on an even size
    and (1, 1) on an odd one; channels last at the boundary."""
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    jm = jenc.ConvBlock(features=8)
    params = _np_params(jm, x)
    tm = _load(tenc.ConvBlock(3, 8), params)
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, _apply(jm, params, x))


def test_video_sequence_encoder(rng):
    x = rng.uniform(size=(2, 3, 16, 16, 3)).astype(np.float32)
    jm = jenc.VideoSequenceEncoder(output_dim=24, conv_features=(16, 32, 64))
    params = _np_params(jm, x)
    tm = _load(tenc.VideoSequenceEncoder(3, 24, (16, 32, 64)), params)
    _close(tm(torch.from_numpy(x)), _apply(jm, params, x))


def test_transformer_block_and_positions(rng):
    x = rng.normal(size=(2, 10, 32)).astype(np.float32)
    mask = np.ones((2, 10), bool)
    mask[1, 6:] = False
    jm = jenc.TransformerBlock(32, num_heads=4)
    params = _np_params(jm, x, mask)
    tm = _load(tenc.TransformerBlock(32, 4), params)
    _close(tm(torch.from_numpy(x), torch.from_numpy(mask)),
           _apply(jm, params, x, mask))
    np.testing.assert_allclose(tenc.sinusoidal_positions(50, 32).numpy(),
                               np.asarray(jenc.sinusoidal_positions(50, 32)),
                               rtol=1e-5, atol=1e-5)


def test_text_sequence_encoder(rng):
    _, _, ids, mask = _inputs(rng)
    jm = jenc.TextSequenceEncoder(50, output_dim=24, model_dim=32,
                                  num_layers=2, num_heads=4)
    params = _np_params(jm, ids, mask)
    tm = _load(tenc.TextSequenceEncoder(50, 24, model_dim=32, num_layers=2,
                                        num_heads=4), params)
    ref = _apply(jm, params, ids, mask, return_sequence=True)
    _close(tm(torch.from_numpy(ids), torch.from_numpy(mask),
              return_sequence=True), ref)
    _close(tm(torch.from_numpy(ids), torch.from_numpy(mask)), ref[:2])


def test_multi_dimensional_deer(rng):
    x = rng.normal(size=(4, 48)).astype(np.float32)
    jm = JMultiDEER(48, 24)
    params = _np_params(jm, x)
    tm = _load(MultiDimensionalDEER(48, 24), params)
    ref = _apply(jm, params, x)
    got = tm(torch.from_numpy(x))
    assert set(got) == set(ref)
    for key in ref:
        _close(got[key], ref[key], key)


@functools.lru_cache(maxsize=None)
def _raw_models(width):
    enc, fus, heads = WIDTHS[width]
    rng = np.random.default_rng(7)
    inputs = _inputs(rng)
    jm = JRaw(encoder_dim=enc, fusion_dim=fus, vocab_size=50, num_heads=heads)
    params = _np_params(jm, *inputs)
    tm = _load(RawSequenceDEERModel(enc, fus, vocab_size=50, num_heads=heads),
               params)
    return jm, params, tm, inputs


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_raw_model_every_output(width):
    jm, params, tm, inputs = _raw_models(width)
    ref = _apply(jm, params, *inputs)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(x) for x in inputs))
    assert set(got) == set(ref)
    for key, want in ref.items():
        if key == "temporal_attention":
            assert set(got[key]) == {"audio", "video", "text"}
            for m in want:
                _close(got[key][m], want[m], f"{key}/{m}")
        else:
            _close(got[key], want, key)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_convert_round_trip_raw_model(width):
    _, params, tm, _ = _raw_models(width)
    back = state_dict_to_flax(tm.state_dict())
    ref = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (path, a), (_, b) in zip(ref, got):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_convert_lstm_round_trip_and_bias_check(rng):
    """A BiLSTM's state_dict alone (no prefix) goes to flax cells and back;
    a nonzero input bias has no flax leaf and raises. (The flagship tree's
    round trip is tests/test_torch_model.py::test_convert_round_trip_exact.)"""
    lstm = tenc.BiLSTM(8, 4, 2)
    for name, p in lstm.named_parameters():
        if not name.startswith("lstm.bias_ih"):
            p.data = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
    tree = state_dict_to_flax(lstm.state_dict())
    assert sorted(tree) == ["bwd_0", "bwd_1", "fwd_0", "fwd_1"]
    assert tree["fwd_1"]["ii"]["kernel"].shape == (8, 4)
    back = flax_to_state_dict(tree)
    assert all(torch.equal(back[k], v) for k, v in lstm.state_dict().items())
    sd = lstm.state_dict()
    sd["lstm.bias_ih_l0"] = torch.ones(16)
    with pytest.raises(ValueError, match="input bias"):
        state_dict_to_flax(sd)


def test_seeded_init_is_deterministic():
    kw = dict(encoder_dim=24, fusion_dim=48, vocab_size=50, num_heads=4)
    a = create_raw_sequence_model(seed=3, device="cpu", **kw).state_dict()
    b = create_raw_sequence_model(seed=3, device="cpu", **kw).state_dict()
    c = create_raw_sequence_model(seed=4, device="cpu", **kw).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert not any(a[k].any() for k in a if "bias_ih" in k)
