"""The uncertainty, spike and F0 study twins and the two entry-point shims
(`tpu_deer_torch/experiments/{uncertainty_diag,uncertainty_sweep,
nig_calibration_study,spike_study,f0_fidelity,run_multimodal_deer,
multi_dataset_framework}.py`) against the reference's scripts on the CPU.

(a) Each training study's run function runs on both sides with each
package's trainer and model factory replaced by a stub that records the
configs it is given and returns the same fixed predictions: the recipes
are equal field by field and the payloads within 1e-6 (`train_s`, a wall
time, left out). (b) The spike twin's dissection of one step against the
reference study's on the same converted weights at a small width, dropout
off on both sides (the reference's `module_norms`, `nig_stats`, pre-clip
gradients and parameter deltas, rtol 1e-4). (c) The F0 twin's route (the
power of `frame_signal`'s frames from K2's wrapper, here its plain twin)
on all 11 cases against the reference's jitted `autocorr_f0`: voicing
equal on every frame, f0 within 1e-3 relative; its numpy copies equal the
reference's. (d) Each shim's `main` is the port's.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiments.f0_fidelity as ref_f0
import experiments.nig_calibration_study as ref_nig
import experiments.spike_study as ref_spike
import experiments.uncertainty_diag as ref_diag
import experiments.uncertainty_sweep as ref_sweep
import tpu_deer.models.deer_model as jdeer
import tpu_deer.train.trainer as jtrainer
import tpu_deer_torch.models.deer_model as tdeer
import tpu_deer_torch.train.trainer as ttrainer
from _jax_reference import Deterministic
from tpu_deer.models.deer_model import CompleteDEERModel as JModel
from tpu_deer.models.deer_model import DEERModelConfig as JModelConfig
from tpu_deer_torch.convert import flax_to_state_dict, state_dict_to_flax
from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
from tpu_deer_torch.experiments import f0_fidelity as twin_f0
from tpu_deer_torch.experiments import nig_calibration_study as twin_nig
from tpu_deer_torch.experiments import spike_study as twin_spike
from tpu_deer_torch.experiments import uncertainty_diag as twin_diag
from tpu_deer_torch.experiments import uncertainty_sweep as twin_sweep

torch.set_num_threads(1)

# One width throughout: fewer distinct leaf shapes to compile for.
SMALL = dict(audio_dim=16, video_dim=16, text_dim=16, encoder_dim=16,
             fusion_dim=16, encoder_layers=1, attention_heads=2, dropout=0.0)


@functools.lru_cache(maxsize=None)
def _splits():
    return make_synthetic_splits(SyntheticConfig(
        n_train=96, n_val=16, n_test=48, audio_dim=16, video_dim=16, text_dim=16,
        seed=4))


def _predictions(n: int, nig: bool) -> dict:
    """Fixed predictions for `n` rows, the same on both sides."""
    rng = np.random.default_rng(17)
    pred = {k: rng.uniform(0.05, 1.0, (n, 3)).astype(np.float32)
            for k in ("uncertainty", "calibrated_uncertainty", "aleatoric",
                      "epistemic", "eabs")}
    pred["mu"] = rng.normal(0.0, 0.5, (n, 3)).astype(np.float32)
    if nig:
        pred["alpha"] = (1.0 + rng.uniform(0.05, 2.0, (n, 3))).astype(np.float32)
        pred["nu"] = rng.uniform(0.1, 3.0, (n, 3)).astype(np.float32)
        pred["beta"] = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    return pred


def _stub(monkeypatch, trainer_mod, deer_mod, reference: bool) -> dict:
    """Replace the package's DEERTrainer and create_complete_deer_model by
    stubs; returns the record of what they were given."""
    seen = {"model": [], "training": [], "steps": []}
    config_cls = trainer_mod.TrainingConfig

    def factory(config, seed=0, **kw):
        seen["model"].append((config, seed))
        return (object(), {}) if reference else object()

    class Trainer:
        def __init__(self, model, *args, steps_per_epoch=100, **kw):
            seen["training"].append(next(a for a in args
                                         if isinstance(a, config_cls)))
            seen["steps"].append(steps_per_epoch)

        def train(self, train, val, **kw):
            return {}

        def predict(self, dataset, return_nig=False, **kw):
            return _predictions(len(dataset.arrays["labels"]), return_nig)

    monkeypatch.setattr(trainer_mod, "DEERTrainer", Trainer)
    monkeypatch.setattr(deer_mod, "create_complete_deer_model", factory)
    return seen


def _fields(config) -> dict:
    return {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}


def _assert_payload_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            if k != "train_s":
                _assert_payload_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (float, np.floating)):
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=path)
    else:
        assert got == want, path


ARGS = SimpleNamespace(batch_size=16, lr=2e-3, epochs=3)
STUDIES = {
    "uncertainty_diag": (
        lambda s: ref_diag.run_one(s, JModelConfig(dropout=0.05), ARGS, 100, 1.0,
                                   0.1, 1.2e-3, moment_w=0.0, warmup=5),
        lambda s: twin_diag.run_one(s, tdeer.DEERModelConfig(dropout=0.05), ARGS,
                                    100, 1.0, 0.1, 1.2e-3, moment_w=0.0,
                                    warmup=5, device="cpu")),
    "uncertainty_sweep": (
        lambda s: ref_sweep.run_one(s, JModelConfig(), ARGS, 3.0, 1.0, 0.05, "v2"),
        lambda s: twin_sweep.run_one(s, tdeer.DEERModelConfig(), ARGS, 3.0, 1.0,
                                     0.05, "v2", device="cpu")),
    "nig_calibration_study": (
        lambda s: ref_nig.run_probe("loss-v1", s, ARGS, "cpu", loss_variant="v1",
                                    evidence_weight=0.1),
        lambda s: twin_nig.run_probe("loss-v1", s, ARGS, "cpu", loss_variant="v1",
                                     evidence_weight=0.1)),
}


@pytest.mark.parametrize("study", sorted(STUDIES))
def test_run_functions_match_reference_recipes_and_payloads(monkeypatch, study):
    ref_run, twin_run = STUDIES[study]
    ref_seen = _stub(monkeypatch, jtrainer, jdeer, reference=True)
    twin_seen = _stub(monkeypatch, ttrainer, tdeer, reference=False)
    want = ref_run(_splits())
    got = twin_run(_splits())
    assert len(ref_seen["training"]) == len(twin_seen["training"]) == 1
    assert _fields(twin_seen["training"][0]) == _fields(ref_seen["training"][0])
    (ref_model, ref_seed), = ref_seen["model"]
    (twin_model, twin_seed), = twin_seen["model"]
    assert _fields(twin_model) == _fields(ref_model) and twin_seed == ref_seed
    assert twin_seen["steps"] == ref_seen["steps"]
    _assert_payload_close(got, want)


def test_spike_dissection_matches_reference():
    """One step of the headline recipe (KL 0.01, calibration 0.15, batch
    32; at a constant lr, as a warm-up's first step has lr 0) from the
    port's seeded init at a small width: the twin's `dissect` against the
    reference study's phase 3 (its `nig_stats`; the pre-clip gradients of
    its jitted `_loss_fn` and the deltas of its `_train_step`, traced into
    one program with the sums of its `module_norms`, which would run
    eagerly, a compile for each leaf shape); the per-module norms combine
    to the step's gradient norm."""
    recipe = dict(learning_rate=1.2e-3, batch_size=32, num_epochs=100,
                  scheduler="constant", kl_weight=0.01,
                  calibration_alignment_weight=0.15, spike_backoff=False,
                  spike_rollback=False)
    model = tdeer.create_complete_deer_model(tdeer.DEERModelConfig(**SMALL),
                                             seed=2, device="cpu")
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    init = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = ttrainer.DEERTrainer(model, ttrainer.TrainingConfig(**recipe),
                                   steps_per_epoch=3, device="cpu")
    train = {k: v[:32] for k, v in _splits()["train"].items() if k != "is_hard"}
    tbatch = {k: torch.from_numpy(v) for k, v in train.items()}
    _, _, grads = twin_spike.preclip_grads(trainer, tbatch)
    got, step_norm = twin_spike.dissect(trainer, tbatch, 0,
                                        trainer.config.gradient_clip)

    jm = JModel(JModelConfig(**SMALL))
    jt = jtrainer.DEERTrainer(jm, state_dict_to_flax(init),
                              jtrainer.TrainingConfig(**recipe), steps_per_epoch=3)
    jt.model = Deterministic(jm)
    # Traced once: phase 3 and the train step take the same loss.
    jt._loss_fn = jax.jit(jt._loss_fn)
    batch = {k: jnp.asarray(v) for k, v in train.items()}
    one = jnp.asarray(1.0, jnp.float32)
    pre_nig = ref_spike.nig_stats(jt, batch)

    def squares(tree):
        """The reference's `module_norms` before its fetch and square root."""
        return {mod: sum(jnp.sum(jnp.square(leaf.astype(jnp.float32)))
                         for leaf in jax.tree_util.tree_leaves(sub))
                for mod, sub in tree.items()}

    def phase3(state):
        rng = jax.random.split(state.dropout_rng)[0]
        (loss, aux0), g = jax.value_and_grad(jt._loss_fn, has_aux=True)(
            state.params, batch, rng, one)
        new, _ = jt._train_step_impl(state, batch, one, one)
        delta = jax.tree_util.tree_map(lambda a, b: a - b, new.params, state.params)
        return loss, aux0, g, new, [squares(t) for t in (state.params, g, delta)]

    loss, aux0, jgrads, jt.state, sq = jax.jit(phase3)(jt.state)
    pre_norms, gmod, delta = ({m: float(np.sqrt(v)) for m, v in t.items()}
                              for t in jax.device_get(sq))
    want = {
        "loss_at_step": float(loss), "aux_nll": float(aux0["nll"]),
        "aux_calibration": float(aux0["calibration_alignment"]),
        "aux_mean_uncertainty": float(aux0["mean_uncertainty"]),
        "grad_norm_preclip_total": float(np.sqrt(sum(v * v for v in gmod.values()))),
        "grad_module_norms": gmod, "param_module_norms_pre": pre_norms,
        "param_delta_norms": delta, "nig_pre": pre_nig,
        "nig_post": ref_spike.nig_stats(jt, batch),
    }
    assert set(got) == set(want) | {"step", "clip_saturated"}
    assert got["clip_saturated"] == (want["grad_norm_preclip_total"]
                                     > trainer.config.gradient_clip)
    flat_got, flat_want = _flat(got), _flat(want)
    assert set(flat_want) <= set(flat_got)
    for key, value in flat_want.items():
        np.testing.assert_allclose(flat_got[key], value, rtol=1e-4, err_msg=key)
    assert "deer_head_valence" in got["grad_module_norms"]
    assert got["param_delta_norms"]["fusion"] > 0  # the step moved the trunk
    np.testing.assert_allclose(got["grad_norm_preclip_total"], step_norm, rtol=1e-5)
    for name, g in flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, jgrads)).items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def _flat(tree: dict, prefix: str = "") -> dict:
    """{"a/b": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_f0_route_matches_reference_on_every_case():
    from tpu_deer.ops.audio_frontend import (
        AudioFrontendConfig,
        _bases,
        _power_spectrum_xla,
        f0_autocorrelation,
        frame_signal,
    )

    cfg = AudioFrontendConfig()

    @jax.jit
    def autocorr_f0(signal):
        frames = frame_signal(signal, cfg)
        return f0_autocorrelation(_power_spectrum_xla(frames, _bases(cfg)), cfg)

    cases = twin_f0.make_cases(cfg.hop_length)
    ref_cases = ref_f0.make_cases(cfg.hop_length)
    assert list(cases) == list(ref_cases) and len(cases) == 11
    for name, case in cases.items():
        for key in ("signal", "f0", "voiced"):
            np.testing.assert_array_equal(case[key], ref_cases[name][key])
        f0, voiced = twin_f0.autocorr_f0(case["signal"], "cpu")
        want_f0, want_v = map(np.asarray, autocorr_f0(jnp.asarray(case["signal"])))
        np.testing.assert_array_equal(voiced, want_v, err_msg=name)
        np.testing.assert_allclose(f0, want_f0, rtol=1e-3, err_msg=name)
    case = cases["voiced/unvoiced alt"]
    got = twin_f0.pyin(case["signal"][:SHORT])
    want = ref_f0.pyin(case["signal"][:SHORT])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    truth = twin_f0.frame_truth(case, cfg.hop_length, len(got[0]))
    for g, w in zip(truth, ref_f0.frame_truth(case, cfg.hop_length, len(got[0]))):
        np.testing.assert_array_equal(g, w)
    assert twin_f0.score(*got, *truth) == ref_f0.score(*want, *truth)
    np.testing.assert_array_equal(
        twin_f0.synth_voiced(np.full(800, 150.0), snr_db=5.0, seed=3),
        ref_f0.synth_voiced(np.full(800, 150.0), snr_db=5.0, seed=3))


SHORT = 12000  # samples of the pyin check: 0.75 s, voiced and unvoiced


def test_shims_are_the_ports_entry_points():
    import tpu_deer_torch.cli
    import tpu_deer_torch.train.multi_dataset
    from tpu_deer_torch.experiments import multi_dataset_framework, run_multimodal_deer

    assert run_multimodal_deer.main is tpu_deer_torch.cli.main
    assert multi_dataset_framework.main is tpu_deer_torch.train.multi_dataset.main
