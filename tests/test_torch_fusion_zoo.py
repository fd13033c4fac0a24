"""The port's fusion zoo, CrossModalAttention and
HierarchicalDEERFusionModel against the JAX package on the CPU.

Each port module takes its seeded flax-style init, which
tpu_deer_torch.convert carries to a flax tree; that tree must have the
paths and shapes of the reference's own init (traced with jax.eval_shape,
which spares the init's op-by-op run) and convert back exactly. Both sides
then run the same inputs from a numpy seed at narrow widths (16-32) in eval
mode (flax's deterministic=True), the reference's apply jitted. Outputs
rtol 1e-4, atol 1e-5 (float32 on both sides, sums taken in another order).
"""

import jax
import numpy as np
import pytest
import torch

from tpu_deer.models import attention as jattn
from tpu_deer.models import fusion as jfusion
from tpu_deer.models.hierarchical_deer import (
    HierarchicalDEERFusionModel as JHierarchical,
)
from tpu_deer_torch.convert import flax_to_state_dict, state_dict_to_flax
from tpu_deer_torch.models import attention as tattn
from tpu_deer_torch.models import fusion as tfusion
from tpu_deer_torch.models.hierarchical_deer import (
    HierarchicalDEERFusionModel,
    create_hierarchical_deer_model,
)
from tpu_deer_torch.models.layers import init_flax_style_

torch.set_num_threads(1)

B = 5
TOL = dict(rtol=1e-4, atol=1e-5)
DIMS = (12, 20, 24)  # three modalities of different widths


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _list(rng):
    return ([_x(rng, B, d) for d in DIMS],)


# name: (flax module, port module, inputs from rng (a tuple of call args))
CASES = {
    "AudioVisualFusion": (
        lambda: jfusion.AudioVisualFusion(12, 20, 16, num_heads=4),
        lambda: tfusion.AudioVisualFusion(12, 20, 16, num_heads=4),
        lambda rng: (_x(rng, B, 12), _x(rng, B, 20))),
    "TrimodalFusion": (
        lambda: jfusion.TrimodalFusion(16, 24, 16, num_heads=4),
        lambda: tfusion.TrimodalFusion(16, 24, 16, num_heads=4),
        lambda rng: (_x(rng, B, 16), _x(rng, B, 24))),
    "UncertaintyAwareGating": (
        lambda: jfusion.UncertaintyAwareGating(DIMS, hidden_dim=16),
        lambda: tfusion.UncertaintyAwareGating(DIMS, hidden_dim=16),
        _list),
    "UncertaintyAwareGating+unc": (
        lambda: jfusion.UncertaintyAwareGating(DIMS, hidden_dim=16),
        lambda: tfusion.UncertaintyAwareGating(DIMS, hidden_dim=16,
                                               uncertainty_inputs=True),
        lambda rng: ([_x(rng, B, d) for d in DIMS],
                     rng.random((B, 3)).astype(np.float32))),
    "HierarchicalMultimodalFusion": (
        lambda: jfusion.HierarchicalMultimodalFusion(*DIMS, output_dim=16,
                                                     num_heads=4),
        lambda: tfusion.HierarchicalMultimodalFusion(*DIMS, output_dim=16,
                                                     num_heads=4),
        lambda rng: tuple(_x(rng, B, d) for d in DIMS)),
    "HierarchicalMultimodalFusion+unc": (
        lambda: jfusion.HierarchicalMultimodalFusion(*DIMS, output_dim=16,
                                                     num_heads=4),
        lambda: tfusion.HierarchicalMultimodalFusion(
            *DIMS, output_dim=16, num_heads=4, uncertainty_inputs=True),
        lambda rng: (*(_x(rng, B, d) for d in DIMS),
                     rng.random((B, 2)).astype(np.float32))),
    "HierarchicalMultimodalFusion-gating": (
        lambda: jfusion.HierarchicalMultimodalFusion(
            *DIMS, output_dim=16, num_heads=4, use_uncertainty_gating=False),
        lambda: tfusion.HierarchicalMultimodalFusion(
            *DIMS, output_dim=16, num_heads=4, use_uncertainty_gating=False),
        lambda rng: tuple(_x(rng, B, d) for d in DIMS)),
    "AttentionFusion": (lambda: jfusion.AttentionFusion(DIMS, 16),
                        lambda: tfusion.AttentionFusion(DIMS, 16), _list),
    "BilinearFusion": (lambda: jfusion.BilinearFusion(DIMS, 16),
                       lambda: tfusion.BilinearFusion(DIMS, 16), _list),
    "ConcatFusion": (lambda: jfusion.ConcatFusion(DIMS, 16),
                     lambda: tfusion.ConcatFusion(DIMS, 16), _list),
    "AdaptiveFusionGating": (lambda: jfusion.AdaptiveFusionGating(DIMS, 16),
                             lambda: tfusion.AdaptiveFusionGating(DIMS, 16),
                             _list),
    "MoEFusion": (
        lambda: jfusion.MoEFusion(DIMS, 16, num_experts=3, expert_hidden=20),
        lambda: tfusion.MoEFusion(DIMS, 16, num_experts=3, expert_hidden=20),
        _list),
    "CrossModalAttention": (
        lambda: jattn.CrossModalAttention(16, num_heads=4),
        lambda: tattn.CrossModalAttention(16, num_heads=4),
        lambda rng: tuple(_x(rng, B, 16) for _ in range(3))),
    "HierarchicalDEERFusionModel": (
        lambda: JHierarchical(hidden_dim=32, num_heads=4),
        lambda: HierarchicalDEERFusionModel(hidden_dim=32, num_heads=4),
        lambda rng: tuple(_x(rng, B, d) for d in (84, 256, 768))),
}


def _leaves(out):
    """Every array of a module's output (tuples, dicts and NIG params), in
    a fixed order."""
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [np.asarray(out.detach() if torch.is_tensor(out) else out)]


def _torch_args(args):
    conv = lambda a: ([torch.from_numpy(x) for x in a] if isinstance(a, list)
                      else torch.from_numpy(a))
    return tuple(conv(a) for a in args)


def ported_params(jm, model, *args, seed=0, **kwargs):
    """The port module's seeded init as a flax tree (numpy leaves), checked
    against the paths and shapes of the reference module's own init and
    for an exact way back."""
    init_flax_style_(model, torch.Generator().manual_seed(seed))
    params = state_dict_to_flax(model.state_dict())
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                            **kwargs))["params"]
    ref = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(ref, got):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
    back = flax_to_state_dict(params)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    return params


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_matches_jax(name, rng):
    make_j, make_t, inputs = CASES[name]
    args = inputs(rng)
    jm, model = make_j(), make_t().eval()
    params = ported_params(jm, model, *args)
    ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, *args)
    with torch.no_grad():
        out = model(*_torch_args(args))
    if isinstance(ref, dict):
        assert set(out) == set(ref)
    got, want = _leaves(out), _leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_factory_and_concat_fallback():
    """create_fusion_module builds what the reference's builds, and an
    unknown name falls back to ConcatFusion."""
    for kind, cls in (("attention", tfusion.AttentionFusion),
                      ("bilinear", tfusion.BilinearFusion),
                      ("adaptive", tfusion.AdaptiveFusionGating),
                      ("moe", tfusion.MoEFusion),
                      ("hierarchical", tfusion.HierarchicalMultimodalFusion),
                      ("whatever", tfusion.ConcatFusion)):
        module = tfusion.create_fusion_module(kind, DIMS, 16)
        ref = jfusion.create_fusion_module(kind, DIMS, 16)
        assert isinstance(module, cls)
        assert type(ref).__name__ == cls.__name__
    with pytest.raises(ValueError, match="uncertainty_inputs"):
        tfusion.UncertaintyAwareGating(DIMS)(
            [torch.zeros(2, d) for d in DIMS], torch.zeros(2, 3))


def test_hierarchical_model_seeded_init_and_gate(rng):
    model = create_hierarchical_deer_model(seed=3, device="cpu",
                                           hidden_dim=32, num_heads=4)
    again = create_hierarchical_deer_model(seed=3, device="cpu",
                                           hidden_dim=32, num_heads=4)
    assert not model.training
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  again.state_dict().values()))
    with torch.no_grad():
        out = model(*(torch.from_numpy(x) for x in
                      CASES["HierarchicalDEERFusionModel"][2](rng)))
    gate = out["modality_gate"]
    assert gate.shape == (B, 2)
    np.testing.assert_allclose(gate.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert out["mu_all"].shape == (B, 3)
