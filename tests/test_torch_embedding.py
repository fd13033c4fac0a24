"""The port's token-embedding lookup (tpu_deer_torch.kernels.embedding)
against flax `nn.Embed` on the CPU, as the reference's text encoder uses it
(tpu_deer/models/encoders.py:328-331).

On the CPU the lookup's backward runs the gradient kernel's plain twin (an
index_add_ into zeros); the reference's gradient is XLA's scatter-add. The
same numpy-seeded ids and upstream gradient go to both. Tolerance rtol
1e-6, atol 1e-6: each row of the gradient is a float32 sum of the same
terms, perhaps in another order. The whole text encoder's gradient is held
at the model's rtol 1e-4, atol 1e-5 (tests/test_torch_sequence_models.py).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deer.models.encoders import TextSequenceEncoder as JText
from tpu_deer_torch.convert import flax_to_state_dict
from tpu_deer_torch.data.vocab import PAD_ID
from tpu_deer_torch.kernels import embedding as emb
from tpu_deer_torch.models.encoders import TextSequenceEncoder

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def _case(kind, seed=0):
    """(ids [B, T] int64, weight [V, D], upstream gradient [B, T, D]), numpy
    float32 from a seed; every case leaves an id unused (the last)."""
    rng = np.random.default_rng(seed)
    if kind == "padding":  # a few real tokens a row, the rest PAD_ID
        b, t, v, d = 8, 128, 40, 16
        ids = np.full((b, t), PAD_ID, np.int64)
        for row in ids:
            n = rng.integers(2, 9)
            row[:n] = rng.integers(1, v - 1, size=n)
    elif kind == "repeats":  # a small vocabulary, every id many times
        b, t, v, d = 3, 200, 6, 8
        ids = rng.integers(0, v - 1, size=(b, t))
    else:  # ids spread over a larger table
        b, t, v, d = 4, 33, 300, 32
        ids = rng.integers(0, v - 1, size=(b, t))
    weight = rng.normal(size=(v, d)).astype(np.float32)
    grad = rng.normal(size=(b, t, d)).astype(np.float32)
    return ids.astype(np.int64), weight, grad


@pytest.mark.parametrize("kind", ["padding", "repeats", "spread"])
def test_lookup_and_gradient_match_flax_embed(kind):
    ids, weight, grad = _case(kind)
    v, d = weight.shape
    module = nn.Embed(v, d)
    params = {"embedding": jnp.asarray(weight)}
    ref_out = module.apply({"params": params}, jnp.asarray(ids))
    ref_grad = jax.grad(lambda p: jnp.sum(
        module.apply({"params": p}, jnp.asarray(ids)) * grad))(params)["embedding"]

    w = torch.from_numpy(weight).requires_grad_()
    out = emb.embedding_lookup(torch.from_numpy(ids), w)
    (out * torch.from_numpy(grad)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref_out))
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(ref_grad), **TOL)
    assert not w.grad[v - 1].any()  # the unused id
    direct = emb.embedding_grad(torch.from_numpy(ids), torch.from_numpy(grad), v)
    assert torch.equal(direct, w.grad)


def test_text_encoder_keys_and_embed_gradient_match_jax():
    """TextSequenceEncoder keeps its state_dict keys (`embed.weight` among
    them, loaded strictly from the reference's converted params), and the
    gradient of the loss through the whole encoder reaches the table as in
    the reference."""
    ids, _, _ = _case("padding", seed=1)
    ids = ids[:, :24]
    mask = (ids != PAD_ID).astype(np.int32)
    jm = JText(40, output_dim=8, model_dim=16, num_layers=1, num_heads=2)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), ids, mask)["params"])
    tm = TextSequenceEncoder(40, 8, model_dim=16, num_layers=1, num_heads=2)
    state = flax_to_state_dict(params)
    assert set(tm.state_dict()) == set(state)
    assert "embed.weight" in state
    tm.load_state_dict(state, strict=True)
    tm.eval()
    g = np.random.default_rng(2).normal(size=(ids.shape[0], 8)).astype(np.float32)

    ref = jax.jit(jax.grad(lambda p: jnp.sum(
        jm.apply({"params": p}, ids, mask)[0] * g)))(params)["embed"]["embedding"]
    out = tm(torch.from_numpy(ids), torch.from_numpy(mask))[0]
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tm.embed.weight.grad.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_frozen_weight_computes_no_gradient(monkeypatch):
    """A table that takes no gradient (a frozen prefix) never reaches the
    gradient function; one that does reaches it once a backward."""
    calls = []
    real = emb.embedding_grad
    monkeypatch.setattr(emb, "embedding_grad",
                        lambda *a: calls.append(1) or real(*a))
    ids, weight, _ = _case("spread")
    scale = torch.ones((), requires_grad=True)
    w = torch.from_numpy(weight)
    (emb.embedding_lookup(torch.from_numpy(ids), w) * scale).sum().backward()
    assert calls == [] and w.grad is None and scale.grad is not None
    w.requires_grad_()
    (emb.embedding_lookup(torch.from_numpy(ids), w) * scale).sum().backward()
    assert calls == [1] and w.grad is not None


@pytest.mark.parametrize("bad", ["int32_ids", "float64_grad", "shape",
                                 "non_contiguous"])
def test_gradient_wrapper_raises(bad):
    ids, _, grad = _case("spread")
    ids, grad = torch.from_numpy(ids), torch.from_numpy(grad)
    if bad == "int32_ids":
        ids = ids.int()
    elif bad == "float64_grad":
        grad = grad.double()
    elif bad == "shape":
        grad = grad[:, 1:]
    else:
        grad = grad.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        emb.embedding_grad(ids, grad, 300)
