"""Flash attention in the port (tpu_deer_torch.kernels.flash_attention, K3a-c)
against the JAX reference on the CPU.

On the CPU the port's autograd function runs the three kernels' plain
twins; the reference runs its Pallas kernels in interpret mode. Tolerance
rtol 1e-4, atol 2e-5 for values and grads: float32 sums over up to 200
keys and 32-64 head dims taken in another order (blocked online softmax
on the reference's side, whole-matrix einsums on the port's).

A batch element whose whole key mask is 0 is held to the reference's
`reference_attention` instead: the reference kernel pads keys to its block
and scores the padding, so it returns Σv / Tk_padded there (checked below so
that the difference stays visible).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_reference import draw_params
from tpu_deer.models.attention import MultiHeadAttention as JMHA
from tpu_deer.models.encoders import TextSequenceEncoder as JText
from tpu_deer.ops.flash_attention import flash_attention as jflash
from tpu_deer.ops.flash_attention import reference_attention
from tpu_deer_torch.convert import flax_to_state_dict
from tpu_deer_torch.kernels import flash_attention as tfa
from tpu_deer_torch.models.attention import (
    MultiHeadAttention,
    resolve_use_flash,
)
from tpu_deer_torch.models.encoders import TextSequenceEncoder

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)


def _case(rng, b=2, h=2, tq=100, tk=100, d=32, masked=(), hole=None):
    q, do = (rng.normal(size=(b, h, tq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, h, tk, d)).astype(np.float32) for _ in range(2))
    mask = np.ones((b, tk), np.float32)
    mask[0, (2 * tk) // 3:] = 0.0  # a partial mask on element 0
    if hole is not None:  # masked keys [start, stop) of element 1
        mask[1, slice(*hole)] = 0.0
    for i in masked:
        mask[i] = 0.0
    return q, k, v, mask, do


def _jax(fn, q, k, v, mask, do):
    """(out, (dq, dk, dv)) of fn(q, k, v, mask) with cotangent do."""
    loss = lambda q, k, v: jnp.sum(fn(q, k, v, jnp.asarray(mask)) * do)
    out = fn(q, k, v, jnp.asarray(mask))
    return np.asarray(out), [np.asarray(g) for g in
                             jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def _torch(fn, q, k, v, mask, do):
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*t, torch.from_numpy(mask))
    (out * torch.from_numpy(do)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in t]


def _jax_flash(q, k, v, mask):
    return jflash(q, k, v, mask, interpret=True)


PORT = {"autograd": tfa.flash_attention, "plain": tfa.flash_attention_plain}


@pytest.mark.parametrize("impl", sorted(PORT))
@pytest.mark.parametrize("shape", [
    dict(tq=100, tk=100, d=32),   # not a block multiple
    dict(tq=200, tk=200, d=64),
    dict(tq=70, tk=130, d=32),    # Tq != Tk
    dict(tq=130, tk=60, d=64),
    dict(tq=150, tk=320, d=32, hole=(64, 192)),  # whole 64-key tiles masked
])
def test_matches_jax_flash(impl, shape, rng):
    case = _case(rng, **shape)
    ref_out, ref_grads = _jax(_jax_flash, *case)
    out, grads = _torch(PORT[impl], *case)
    np.testing.assert_allclose(out, ref_out, **TOL)
    for g, r, name in zip(grads, ref_grads, "qkv"):
        np.testing.assert_allclose(g, r, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("impl", sorted(PORT))
def test_all_masked_element_is_reference_attention(impl, rng):
    """Element 1 has no valid key: O = mean of v, dq = dk = 0,
    dv = Σ_q dO / Tk. Element 0 (partial mask) still matches the kernel."""
    q, k, v, mask, do = _case(rng, tq=200, tk=200, masked=(1,))
    out, (dq, dk, dv) = _torch(PORT[impl], q, k, v, mask, do)
    ref_out, ref_grads = _jax(reference_attention, q, k, v, mask, do)
    np.testing.assert_allclose(out[1], v[1].mean(axis=1, keepdims=True)
                               .repeat(200, axis=1), **TOL)
    np.testing.assert_allclose(out, ref_out, **TOL)
    assert not dq[1].any() and not dk[1].any()
    np.testing.assert_allclose(dv[1], np.broadcast_to(
        do[1].sum(axis=1, keepdims=True) / 200, dv[1].shape), **TOL)
    for g, r in zip((dq, dk, dv), ref_grads):
        np.testing.assert_allclose(g, r, **TOL)

    # The reference kernel's deviation on that element (keys padded to its
    # 256-block and scored): its output is Σv / 256, 200/256 of the mean,
    # and its dv is 200x the reference's.
    kern_out, (_, _, kern_dv) = _jax(_jax_flash, q, k, v, mask, do)
    np.testing.assert_allclose(kern_out[1], out[1] * 200 / 256, **TOL)
    np.testing.assert_allclose(kern_dv[1], dv[1] * 200, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(kern_out[0], out[0], **TOL)


_reference_attention = jax.jit(reference_attention)


@pytest.mark.parametrize("n_blocks,d", [(1, 16), (2, 16), (4, 16), (4, 32)])
def test_ring_hops_folded_match_the_reference(n_blocks, d, rng):
    """The ring's hops (`parallel/sequence.py`: K3a's tile and the merge
    forward, K3b/K3c against the global lse backward) folded over n key
    blocks in one process, against the reference's attention over the
    whole sequence (which its ring equals: tests/test_sequence_parallel.py;
    tests/test_torch_parallel_world.py holds the port's ring across
    processes against the reference's ring): forward atol 1e-5, gradients
    1e-4, on key lengths off the block edges (37, 53) and an all-masked
    element (the mean of v over all T keys, as the reference's ring)."""
    from tpu_deer_torch.parallel.sequence import fold_attention

    q, k, v, do = (rng.normal(size=(3, 4, 64, d)).astype(np.float32)
                   for _ in range(4))
    mask = (np.arange(64)[None, :] < np.asarray([37, 53, 0])[:, None]
            ).astype(np.float32)
    ref, ref_grads = _jax(_reference_attention, q, k, v, mask, do)
    out, grads = _torch(lambda *a: fold_attention(*a, n_blocks=n_blocks),
                        q, k, v, mask, do)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    for g, r, name in zip(grads, ref_grads, "qkv"):
        np.testing.assert_allclose(g, r, atol=1e-4, err_msg=name)


def test_kernel_twins_match_the_autograd_plain(rng):
    """fwd (O, lse), bwd_dq (δ, dq) and bwd_dkv (dk, dv) on the CPU are the
    plain twins, and together give autograd's gradients of the plain
    function."""
    q, k, v, mask, do = (torch.from_numpy(x)
                         for x in _case(rng, tq=90, tk=110, masked=(1,)))
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    o, lse = tfa.flash_attention_fwd(q, k, v, mask)
    delta, dq = tfa.flash_attention_bwd_dq(q, k, v, mask, o, do, lse)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta)
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == before  # no kernel ran
    assert (lse[1] < tfa.NO_VALID_KEY).all() and (lse[0] > -1e4).all()
    _, grads = _torch(tfa.flash_attention_plain,
                      *(x.numpy() for x in (q, k, v, mask, do)))
    for g, r in zip((dq, dk, dv), grads):
        np.testing.assert_allclose(g.numpy(), r, **TOL)
    torch.testing.assert_close(delta, (do * o).sum(-1))


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "mask_shape"])
def test_wrapper_rejects_bad_input(bad, rng):
    q, k, v, mask, _ = (torch.from_numpy(x) for x in _case(rng, tq=8, tk=8))
    if bad == "float64":
        q = q.double()
    elif bad == "non_contiguous":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        mask = mask[:, :4].contiguous()
    with pytest.raises((TypeError, ValueError)):
        tfa.flash_attention_fwd(q, k, v, mask)


@pytest.mark.parametrize("d_model,heads,t", [(64, 2, 40), (128, 4, 33)])
def test_mha_flash_branch_matches_jax(d_model, heads, t, rng):
    """use_flash=True on both sides, a [B, 1, 1, Tk] key mask with one
    short element; output and every parameter gradient."""
    x = rng.normal(size=(2, t, d_model)).astype(np.float32)
    mask = np.ones((2, t), bool)
    mask[1, t // 2:] = False
    jm = JMHA(d_model, heads, use_flash=True)
    jmask = jnp.asarray(mask)[:, None, None, :]
    params = draw_params(jm, x, x, x, jmask)
    gy = rng.normal(size=(2, t, d_model)).astype(np.float32)
    loss = lambda p: jnp.sum(jm.apply({"params": p}, x, x, x, jmask) * gy)
    ref = np.asarray(jm.apply({"params": params}, x, x, x, jmask))
    ref_grads = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(params)))

    tm = MultiHeadAttention(d_model, heads, use_flash=True)
    tm.load_state_dict(flax_to_state_dict(params))
    tm.eval()
    tx = torch.from_numpy(x)
    out = tm(tx, tx, tx, torch.from_numpy(mask)[:, None, None, :])
    (out * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_text_encoder_flash_matches_jax(rng):
    """TextSequenceEncoder with use_flash=True (both blocks through K3's
    path) against the reference's: pooled output, pooling weights, token
    states and parameter gradients. atol 1e-4 on the gradients: sums over
    B·T = 80 token rows in another order."""
    vocab, t = 40, 40
    ids = rng.integers(5, vocab, size=(2, t)).astype(np.int32)
    mask = np.ones((2, t), np.int32)
    mask[1, 25:] = 0
    jm = JText(vocab, 48, model_dim=64, num_layers=2, num_heads=2,
               use_flash=True)
    params = draw_params(jm, ids, mask, seed=1)
    gy = rng.normal(size=(2, 48)).astype(np.float32)
    ref = jm.apply({"params": params}, ids, mask, return_sequence=True)
    loss = lambda p: jnp.sum(jm.apply({"params": p}, ids, mask)[0] * gy)
    ref_grads = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(params)))

    tm = TextSequenceEncoder(vocab, 48, model_dim=64, num_layers=2,
                             num_heads=2, use_flash=True)
    tm.load_state_dict(flax_to_state_dict(params))
    tm.eval()
    out = tm(torch.from_numpy(ids), torch.from_numpy(mask),
             return_sequence=True)
    (out[0] * torch.from_numpy(gy)).sum().backward()
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("t,training,want", [
    (1023, True, False), (1024, True, True),
    (2047, False, False), (2048, False, True),
])
def test_resolve_use_flash_thresholds(t, training, want):
    from tpu_deer.ops.flash_attention import resolve_use_flash as jresolve

    assert resolve_use_flash("auto", t, training) is want
    assert jresolve("auto", t, training) is want
    assert resolve_use_flash(True, 1) and not resolve_use_flash(False, 4096)
