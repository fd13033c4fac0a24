"""The reference's flagship factory with its init jitted, and weights drawn
for a reference module's init tree, for the port's tests.

`tpu_deer.models.deer_model.create_complete_deer_model` runs flax's init
eagerly: about a thousand dispatches, ~14 s at the flagship's width on a
CPU core. The same init under `jax.jit` gives the same parameters bit for
bit after a compile of ~6 s.
"""

import jax
import jax.numpy as jnp
import numpy as np

from tpu_deer.models.deer_model import CompleteDEERModel, DEERModelConfig


def create_complete_deer_model(config=None, seed=42):
    """(module, params) as the reference's factory returns them."""
    config = config or DEERModelConfig()
    model = CompleteDEERModel(config)
    dummy = tuple(jnp.zeros((2, d)) for d in
                  (config.audio_dim, config.video_dim, config.text_dim))
    params = jax.jit(lambda key: model.init(
        key, *dummy, deterministic=True)["params"])(jax.random.PRNGKey(seed))
    return model, params


def draw_params(module, *args, seed=0, **kwargs):
    """Weights (numpy leaves) for the tree of `module.init(key, *args,
    **kwargs)["params"]`: its paths, shapes and dtypes from `jax.eval_shape`
    (traced, never compiled: a jitted init compiles for ~2-7 s a module on a
    CPU core), its values drawn with numpy at flax's scales (kernels
    N(0, 1/fan_in), norm scales about 1, biases and the rest small and
    non-zero)."""
    shapes = jax.eval_shape(lambda key: module.init(key, *args, **kwargs),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.standard_normal(leaf.shape)
        if name == "kernel":
            x /= np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        else:
            x *= 0.1
        return x.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)
