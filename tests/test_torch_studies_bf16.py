"""The bf16 diagnosis twin's `adamw-f32opt` stage
(`tpu_deer_torch/experiments/bf16_diag.py:f32opt_update`) against the
reference's arithmetic (`experiments/bf16_diag.py:120-160`: optax's clip
and adamw on float32 gradients, moments and parameter copies, the update
cast to the parameter's dtype, `optax.apply_updates`), under jit, on a
small tree over two steps whose gradient norm is above the clip.

The update's float32 arithmetic is `AdamW`'s, which differs from optax's
in the last bits of the clip's norm and of the bias corrections (the
port's table is rounded from float64, optax takes 1 − b2ᵗ in float32:
1.3e-5 apart, relatively, at t = 1), so an update of about lr = 1e-3
moves by up to ~1e-8 a step. bf16 storage: every parameter equal in every
bit (the cast to bf16 rounds those bits away, as
tests/test_torch_memory_knobs.py holds `_update_low`). float32 storage:
rtol 1e-6, atol 1e-7 (five times that bound over the two steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_deer_torch.experiments import bf16_diag

torch.set_num_threads(1)

SHAPES = {"encoder.weight": (24, 16), "encoder.bias": (24,),
          "head.weight": (3, 24), "norm.scale": (24,)}
STEPS = 2


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_f32opt_update_matches_optax(storage):
    rng = np.random.default_rng(4)
    init = {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    assert all(np.sqrt(sum((g ** 2).sum() for g in step.values())) > 1.0
               for step in grads)
    jdt, tdt = jnp.dtype(storage), getattr(torch, storage)

    tx = optax.chain(optax.clip_by_global_norm(bf16_diag.MAX_NORM),
                     optax.adamw(bf16_diag.LR, weight_decay=bf16_diag.WEIGHT_DECAY))
    to32 = lambda tree: jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), tree)

    @jax.jit
    def ref_step(p, s, g):
        updates, s = tx.update(to32(g), s, to32(p))
        updates = jax.tree_util.tree_map(lambda u, pp: u.astype(pp.dtype), updates, p)
        return optax.apply_updates(p, updates), s

    p = {k: jnp.asarray(v).astype(jdt) for k, v in init.items()}
    s = tx.init(to32(p))
    # Copies: the update writes its inputs in place, and JAX may alias an
    # aligned numpy buffer it was given.
    params = {k: torch.tensor(v).to(tdt) for k, v in init.items()}
    opt = bf16_diag.f32_optimizer(params)
    opt.reserve(STEPS)
    for g in grads:
        p, s = ref_step(p, s, {k: jnp.asarray(v).astype(jdt) for k, v in g.items()})
        bf16_diag.f32opt_update(opt, list(params.values()),
                                [torch.tensor(g[k]).to(tdt) for k in params])
    for k, v in params.items():
        assert v.dtype == tdt, k
        got, want = v.float().numpy(), np.asarray(p[k].astype(jnp.float32))
        if storage == "bfloat16":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=k)
    assert int(opt.count) == STEPS
