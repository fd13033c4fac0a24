"""The serving study's twin (`tpu_deer_torch/experiments/server_load.py`) on
the CPU: a `--quick` model behind a real localhost HTTP server, both
modes; and the seven study twins of this slice import nothing of JAX,
flax or the reference package."""

import json
import os
import re

import numpy as np
import torch

from tpu_deer_torch.experiments import server_load
from tpu_deer_torch.models.deer_model import create_complete_deer_model
from tpu_deer_torch.serve import InferenceEngine

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = ("server_load", "streaming_demo", "bf16_diag", "seed_study",
         "headline_ci", "conformal_study", "ood_study")


def test_server_load_cells_answer_as_the_engine():
    """2 clients × 3 requests, serialized and micro-batched: every reply
    equals `engine.predict` on the posted row (float32, the same model from
    seed 0) within the model's output tolerance, rtol 1e-4, atol 1e-5 (a
    coalesced wave runs in a larger bucket, whose GEMMs sum in another
    order), and the payload and each cell carry the reference's keys
    (`experiments/RESULTS_serving.json`)."""
    responses = []
    payload = server_load.run(True, 2.0, 2, torch.device("cpu"), "cpu",
                              client_grid=(2,), reqs=3, responses=responses)
    with open(os.path.join(ROOT, "experiments", "RESULTS_serving.json")) as f:
        ref = json.load(f)
    assert set(payload) == set(ref)
    for mode in ("serialized", "micro_batch"):
        assert set(payload["results"][mode][0]) == set(ref["results"][mode][0])
        assert payload["results"][mode][0]["requests"] == 6
    assert set(payload["micro_batch_stats"]) == set(ref["micro_batch_stats"])
    assert payload["micro_batch_stats"]["micro_batch"]["rows_dispatched"] == 7

    service, cfg = server_load.make_service(False, True, 2.0, 2, "cpu")
    row = server_load.client_row((cfg.audio_dim, cfg.video_dim, cfg.text_dim))
    engine = InferenceEngine(create_complete_deer_model(cfg, seed=0, device="cpu"),
                             device="cpu")
    want = engine.predict(*(np.asarray(row[m], np.float32)[None]
                            for m in server_load.MODALITIES))
    assert len(responses) == 12
    for reply in responses:
        for key in ("mu", "uncertainty", "calibrated_uncertainty",
                    "expected_abs_error"):
            np.testing.assert_allclose(np.asarray(reply[key], np.float32),
                                       want[key], rtol=1e-4, atol=1e-5,
                                       err_msg=key)
    assert service.batcher is None


def test_study_twins_import_no_jax():
    """No line of the seven twins imports jax, flax, optax or the
    reference package (`tpu_deer` without `_torch`)."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|tpu_deer)\b"
                     r"(?!_torch)")
    for name in TWINS:
        path = os.path.join(ROOT, "tpu_deer_torch", "experiments", f"{name}.py")
        with open(path) as f:
            hits = [line for line in f if bad.match(line)]
        assert not hits, (name, hits)
