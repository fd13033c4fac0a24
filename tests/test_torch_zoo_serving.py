"""Every fusion type and the stacked layout through the port's serving
entry points on the CPU: a checkpoint records the model's layout, the
engine's and the server's `from_checkpoint` rebuild that model without
being told, in float and int8, an int8 export of the bilinear fusion (its
3-D kernel passes through in float) serves what the int8 engine serves,
and the CLI trains `fusion_type: moe` (`--mode train`) and exports it from
the checkpoint's layout. Narrow width (encoder 16, fusion 32, one layer, 4
heads); float outputs rtol 1e-4, atol 1e-5, int8 mu within 0.05 of float.
"""

import json
import os

import numpy as np
import pytest
import torch

from tpu_deer_torch import cli as tcli
from tpu_deer_torch.export import export_inference, load_exported
from tpu_deer_torch.models.deer_model import (
    DEERModelConfig,
    create_complete_deer_model,
    layout_meta,
)
from tpu_deer_torch.serve import InferenceEngine
from tpu_deer_torch.server import PredictionService
from tpu_deer_torch.train.checkpoint import CheckpointManager
from tpu_deer_torch.utils import config as tconfig

torch.set_num_threads(1)

NARROW = dict(encoder_dim=16, fusion_dim=32, encoder_layers=1,
              attention_heads=4)
KINDS = {f: dict(fusion_type=f) for f in
         ("hierarchical", "attention", "bilinear", "concat", "adaptive", "moe")}
KINDS["stacked"] = dict(stacked_compute=True)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_serving_entry_points(kind, tmp_path, rng):
    """A checkpoint records its layout; from_checkpoint (the engine's and
    the server's) rebuilds that model without being told, in float and
    int8, and the int8 export serves what the int8 engine serves."""
    cfg = DEERModelConfig(**NARROW, **KINDS[kind])
    model = create_complete_deer_model(cfg, seed=1, device="cpu")
    root = str(tmp_path / "ckpt")
    CheckpointManager(root).save({"model": model.state_dict()}, step=1,
                                 metrics={"serving_channel": "eabs"},
                                 is_best=True, model=layout_meta(cfg))
    with open(os.path.join(root, "best", "meta.json")) as f:
        assert json.load(f)["model"]["fusion_type"] == cfg.fusion_type
    a, v, t = (rng.normal(size=(10, d)).astype(np.float32)
               for d in (84, 256, 768))
    with torch.no_grad():
        direct = model(*(torch.from_numpy(x) for x in (a, v, t)))["mu_all"]
    engine = InferenceEngine.from_checkpoint(root, device="cpu")
    assert engine.model.config == cfg
    np.testing.assert_allclose(engine.predict(a, v, t)["mu"], direct.numpy(),
                               **TOL)
    int8 = InferenceEngine.from_checkpoint(root, device="cpu",
                                           quantize_weights=True)
    q = int8.predict(a, v, t)
    assert np.abs(q["mu"] - direct.numpy()).max() < 0.05
    service = PredictionService.from_checkpoint(root, device="cpu")
    assert service.engine.model.config == cfg
    if kind == "bilinear":  # its 3-D kernel passes through the int8 artifact
        out = str(tmp_path / "exported")
        export_inference(model, out, batch_buckets=(16,), platforms=("cpu",),
                         quantize=True)
        np.testing.assert_allclose(
            load_exported(out, device="cpu").predict(a, v, t)["mu"], q["mu"],
            **TOL)


def test_cli_trains_and_exports_moe(tmp_path, monkeypatch):
    """`fusion_type: moe` in the config trains through the CLI at the quick
    pipeline's smallest size, and `--mode export` rebuilds the MoE model
    from the checkpoint's layout (the export itself, recorded here, is
    tested above and in tests/test_torch_export.py)."""
    cfg = tconfig.default_config()
    cfg["model"].update(encoder_dim=16, fusion_dim=32, encoder_layers=1,
                        attention_heads=4, fusion_type="moe", moe_experts=3)
    path = str(tmp_path / "moe.yaml")
    tconfig.save_yaml_config(cfg, path)
    out = tmp_path / "out"
    common = ["--config", path, "--platform", "cpu", "--quick", "--epochs", "1"]
    assert tcli.main([*common, "--mode", "train", "--output_dir", str(out),
                      "--experiment_name", "e"]) == 0
    models = out / "e" / "models"
    with open(models / "best" / "meta.json") as f:
        layout = json.load(f)["model"]
    assert layout["fusion_type"] == "moe" and layout["moe_experts"] == 3
    state = torch.load(models / "best" / "state.pt", weights_only=True)["model"]
    assert state["fusion.experts.mlp.layers.0.weight"].shape[0] == 3
    cfg["model"]["fusion_type"] = "hierarchical"  # the checkpoint decides
    tconfig.save_yaml_config(cfg, path)
    exported = {}
    monkeypatch.setattr("tpu_deer_torch.export.export_inference",
                        lambda model, out_dir, **kw: exported.update(
                            model=model, **kw) or {k: None for k in (
                                "buckets", "platforms", "n_params", "quantized",
                                "ensemble_members", "serving_channel")})
    assert tcli.main([*common, "--mode", "export", "--model_path", str(models),
                      "--output_dir", str(tmp_path / "x")]) == 0
    model = exported["model"]
    assert model.config.fusion_type == "moe" and model.config.moe_experts == 3
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in state.items())
