"""The port's training losses (tpu_deer_torch.core.nig training half and
core.losses) against the JAX reference on the CPU, values and gradients.

Inputs are raw evidence [B, 1, 4] (a head's layout) from a numpy seed, constrained by
nig_params_from_evidence on each side. Tolerance rtol 1e-4, atol 1e-5:
float32 elementwise math (log, lgamma, softplus) whose library
implementations differ in the last bits, in sums of terms of size up to
~30 that cancel to results near 1, reduced over a batch of 32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deer.core import losses as jlosses
from tpu_deer.core import metrics as jmetrics
from tpu_deer.core import nig as jnig
from tpu_deer_torch.core import losses as tlosses
from tpu_deer_torch.core import metrics as tmetrics
from tpu_deer_torch.core import nig as tnig

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
ELEMENTWISE = ["nig_nll", "nig_nll_v2", "evidence_regularizer",
               "evidence_regularizer_v2", "kl_regularizer", "kl_regularizer_v2"]


def _evidence(rng, b=32, dims=1):
    ev = rng.normal(size=(b, dims, 4)).astype(np.float32)
    y = rng.uniform(-1, 1, size=(b, dims)).astype(np.float32)
    return ev, y


def _jax_value_grad(fn, ev, y):
    def f(e):
        return jnp.sum(fn(jnig.nig_params_from_evidence(e), y))
    return jax.value_and_grad(f)(jnp.asarray(ev))


def _torch_value_grad(fn, ev, y):
    e = torch.from_numpy(ev).requires_grad_()
    val = torch.sum(fn(tnig.nig_params_from_evidence(e), torch.from_numpy(y)))
    val.backward()
    return val, e.grad


@pytest.mark.parametrize("name", ELEMENTWISE)
def test_elementwise_terms_match_jax(name, rng):
    ev, y = _evidence(rng)
    takes_y = not name.startswith("kl")
    jfn, tfn = getattr(jnig, name), getattr(tnig, name)
    call = (lambda fn: (lambda p, t: fn(p, t))) if takes_y else (
        lambda fn: (lambda p, t: fn(p)))
    jv, jg = _jax_value_grad(call(jfn), ev, y)
    tv, tg = _torch_value_grad(call(tfn), ev, y)
    np.testing.assert_allclose(tv.item(), float(jv), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_deer_loss_matches_jax(variant, rng):
    ev, y = _evidence(rng)
    jcfg = jlosses.DEERLossConfig(variant=variant)
    tcfg = tlosses.DEERLossConfig(variant=variant)
    jout = jlosses.deer_loss(jnig.nig_params_from_evidence(jnp.asarray(ev)),
                             jnp.asarray(y), jcfg)
    e = torch.from_numpy(ev).requires_grad_()
    tout = tlosses.deer_loss(tnig.nig_params_from_evidence(e),
                             torch.from_numpy(y), tcfg)
    assert set(tout) == set(jout)
    for key in jout:
        np.testing.assert_allclose(tout[key].item(), float(jout[key]),
                                   err_msg=key, **TOL)
    tout["total_loss"].backward()
    jg = jax.grad(lambda x: jlosses.deer_loss(
        jnig.nig_params_from_evidence(x), jnp.asarray(y), jcfg)["total_loss"])(
        jnp.asarray(ev))
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_multi_task_deer_loss_matches_jax(variant, rng):
    """Three heads, the VAD targets and the cross-dimension consistency."""
    evs = [rng.normal(size=(32, 1, 4)).astype(np.float32) for _ in range(3)]
    y = rng.uniform(-1, 1, size=(32, 3)).astype(np.float32)
    jcfg = jlosses.DEERLossConfig(variant=variant)
    tcfg = tlosses.DEERLossConfig(variant=variant)

    def jtotal(*es):
        ps = [jnig.nig_params_from_evidence(e) for e in es]
        return jlosses.multi_task_deer_loss(ps, jnp.asarray(y), jcfg)

    jout = jtotal(*map(jnp.asarray, evs))
    jgrads = jax.grad(lambda *es: jtotal(*es)["total_loss"],
                      argnums=(0, 1, 2))(*map(jnp.asarray, evs))
    tevs = [torch.from_numpy(e).requires_grad_() for e in evs]
    tout = tlosses.multi_task_deer_loss(
        [tnig.nig_params_from_evidence(e) for e in tevs], torch.from_numpy(y),
        tcfg)
    assert set(tout) == set(jout)
    for key in jout:
        np.testing.assert_allclose(tout[key].item(), float(jout[key]),
                                   err_msg=key, **TOL)
    tout["total_loss"].backward()
    for e, g in zip(tevs, jgrads):
        np.testing.assert_allclose(e.grad.numpy(), np.asarray(g), **TOL)


def test_binned_ece_matches_jax(rng):
    ev, y = _evidence(rng, b=64)
    jp = jnig.nig_params_from_evidence(jnp.asarray(ev))
    tp = tnig.nig_params_from_evidence(torch.from_numpy(ev))
    for bins in (5, 10):
        np.testing.assert_allclose(
            tlosses.binned_ece_loss(tp, torch.from_numpy(y), bins).item(),
            float(jlosses.binned_ece_loss(jp, jnp.asarray(y), bins)), **TOL)


def test_unknown_variant_raises():
    ev = torch.zeros(2, 1, 4)
    with pytest.raises(ValueError, match="variant"):
        tlosses.deer_loss(tnig.nig_params_from_evidence(ev), torch.zeros(2, 1),
                          tlosses.DEERLossConfig(variant="v3"))


def test_numpy_metrics_match_reference(rng):
    x = rng.normal(size=200)
    y = 0.7 * x + 0.3 * rng.normal(size=200) + 0.1
    y[5] = np.nan
    assert tmetrics.ccc_np(x, y) == jmetrics.ccc_np(x, y)
    assert tmetrics.pearson_np(x, y) == jmetrics.pearson_np(x, y)
    assert tmetrics.ccc_np(x, x) == pytest.approx(1.0)
    assert tmetrics.ccc_np([np.nan], [1.0]) == 0.0
