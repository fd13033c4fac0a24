"""The port's UnifiedSequenceEncoder, create_encoders_from_config and
get_encoder_output_dims against the JAX package on the CPU.

The port's seeded init is carried to a flax tree by tpu_deer_torch.convert,
checked against the paths and shapes of the reference's own init (traced
with jax.eval_shape) and for an exact way back; both sides then run the
same inputs from a numpy seed at width 32, the reference's apply jitted.
Outputs rtol 1e-4, atol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_deer.models import encoders as jenc
from tpu_deer.models.deer_model import DEERModelConfig as JConfig
from tpu_deer_torch.convert import flax_to_state_dict, state_dict_to_flax
from tpu_deer_torch.models import encoders as tenc
from tpu_deer_torch.models.deer_model import DEERModelConfig
from tpu_deer_torch.models.layers import init_flax_style_

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
INPUT = {"audio": "audio_frames", "video": "video_frames", "text": "token_ids"}


def _ported(jm, model, **kwargs):
    """The port's seeded init as a flax tree, checked against the
    reference's init's paths and shapes and for an exact way back."""
    init_flax_style_(model, torch.Generator().manual_seed(0))
    params = state_dict_to_flax(model.state_dict())
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), **kwargs))["params"]
    ref = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in got] == [p for p, _ in ref]
    assert all(a.shape == b.shape for (_, a), (_, b) in zip(ref, got))
    back = flax_to_state_dict(params)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    return params


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    args = {"audio_frames": rng.normal(size=(2, 12, 84)).astype(np.float32),
            "video_frames": rng.random((2, 3, 16, 16, 3)).astype(np.float32),
            "token_ids": rng.integers(0, 50, (2, 10)).astype(np.int32),
            "text_mask": np.ones((2, 10), np.float32)}
    args["text_mask"][1, 6:] = 0
    return args


@pytest.mark.parametrize("modalities", [("audio", "video", "text"),
                                        ("text",), ("audio", "video")])
def test_unified_sequence_encoder_matches_jax(inputs, modalities):
    """All modalities and subsets: a modality not asked for is neither built
    nor computed, as in the reference."""
    given = {k: v for k, v in inputs.items()
             if k == "text_mask" or k in [INPUT[m] for m in modalities]}
    jm = jenc.UnifiedSequenceEncoder(output_dim=32, modalities=modalities,
                                     vocab_size=50)
    model = tenc.UnifiedSequenceEncoder(32, modalities, vocab_size=50).eval()
    params = _ported(jm, model, **given)
    assert set(params) == set(modalities)
    ref = jax.jit(lambda p, a: jm.apply({"params": p}, **a))(params, given)
    with torch.no_grad():
        out = model(**{k: torch.from_numpy(v) for k, v in given.items()})
    assert set(out) == set(ref) == {k for m in modalities
                                    for k in (m, f"{m}_attention")}
    for key, r in ref.items():
        np.testing.assert_allclose(out[key].numpy(), np.asarray(r),
                                   err_msg=key, **TOL)


def test_missing_input_skips_its_modality(inputs):
    """A modality whose input is None is skipped, as in the reference
    (statically: nothing runs for it)."""
    model = tenc.UnifiedSequenceEncoder(16, vocab_size=50).eval()
    with torch.no_grad():
        out = model(token_ids=torch.from_numpy(inputs["token_ids"]))
        both = model(audio_frames=torch.from_numpy(inputs["audio_frames"]),
                     video_frames=torch.from_numpy(inputs["video_frames"]))
    assert set(out) == {"text", "text_attention"}
    assert set(both) == {"audio", "audio_attention", "video", "video_attention"}
    assert out["text"].shape == (2, 16)


def test_encoder_config_helpers():
    rng = np.random.default_rng(3)
    kw = dict(encoder_dim=16, encoder_layers=1)
    assert (tenc.get_encoder_output_dims(DEERModelConfig(**kw))
            == jenc.get_encoder_output_dims(JConfig(**kw)))
    encoders = tenc.create_encoders_from_config(DEERModelConfig(**kw))
    jencoders = jenc.create_encoders_from_config(JConfig(**kw))
    assert set(encoders) == set(jencoders) == {"audio", "video", "text"}
    for name, width in (("audio", 84), ("video", 256), ("text", 768)):
        x = rng.normal(size=(3, width)).astype(np.float32)
        jm, model = jencoders[name], encoders[name].eval()
        init_flax_style_(model, torch.Generator().manual_seed(1))
        params = state_dict_to_flax(model.state_dict())
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(
            jm.apply({"params": params}, x)), err_msg=name, **TOL)
