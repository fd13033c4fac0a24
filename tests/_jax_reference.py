"""Weights drawn for a reference module's init tree, for the port's tests.

`tpu_deer.models.deer_model.create_complete_deer_model` runs flax's init
eagerly: about a thousand dispatches, ~14 s at the flagship's width on a
CPU core; under `jax.jit` the same init still compiles for ~6 s. A check
that holds the port to the reference on the same weights, whatever their
values, draws them instead: the tree from `jax.eval_shape` (traced, never
compiled), the values with numpy.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np

from tpu_deer.models.deer_model import CompleteDEERModel, DEERModelConfig


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


class Deterministic:
    """The reference's model with every dropout off, train step included."""

    def __init__(self, model):
        self._model = model
        self.config = model.config

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self._model.apply(variables, *args, deterministic=True, **kw)


def drawn_complete_deer_model(config=None, seed=0):
    """(module, numpy params) of the reference's flagship with weights from
    `draw_params`, in place of its factory's init."""
    config = config or DEERModelConfig()
    model = CompleteDEERModel(config)
    dummy = tuple(jnp.zeros((2, d)) for d in
                  (config.audio_dim, config.video_dim, config.text_dim))
    return model, draw_params(model, *dummy, seed=seed, deterministic=True)


class SharedEvalStep:
    """One jitted eval step for several reference trainers of one model and
    loss variant: `share(trainer)` points the trainer's `_eval_step` at the
    first shared trainer's, so their one program compiles once. Calls hold
    a lock: two threads that both missed the cache would each compile."""

    def __init__(self):
        self._lock = threading.Lock()
        self._step = None
        self._key = None

    def share(self, trainer):
        key = (trainer.model.config, trainer.config.loss_variant)
        with self._lock:
            if self._step is None:
                self._step, self._key = trainer._eval_step, key
            assert key == self._key, (key, self._key)
        trainer._eval_step = self._call
        return trainer

    def _call(self, *args, **kwargs):
        with self._lock:
            return self._step(*args, **kwargs)
