"""Ahead-of-time model export: `torch.export` serving artifacts.

Port of `tpu_deer/export.py`. The flagship model exports to an artifact
directory that loads and runs without the port's model code (torch, numpy
and the artifact):

  * one `torch.export` program a serving batch bucket, `forward_b{b}.pt2`,
    whose parameters are inputs, as in JAX's calling convention: the
    program holds the graph and no weights;
  * the parameters saved flat in `params.npz` (no pickle), under their
    `state_dict` names; with `quantize=True`, `q/<name>` (int8 Dense
    kernels, the rest as they are) and `scale/<name>` (a float32 per-channel
    scale, empty where nothing was quantized) from
    `ops.quantization.quantize_tree`, with the dequantize inside the
    program; with an OOD detector, its `ood/mean` and `ood/whitener`; a
    deep ensemble's (`ensemble=True`) stacked [K, ...] members, whose
    forwards the program vmaps (`torch.func.vmap` over the member axis) and
    combines by moment matching (`core/nig.py:combine_members`); the
    exported program is lowered to the ATen dialect, where the member axis
    is a batch dimension of its GEMMs;
  * a JSON manifest with the model's widths, the buckets, the platforms,
    the outputs' names and `ensemble_members`.

The manifest's format is "tpu_deer_torch.export.v1". The reference's
artifacts ("tpu_deer.export.v1") are StableHLO, which PyTorch cannot run:
`ExportedEngine` refuses them, as it refuses any other format.

The programs are traced on the CPU and moved to the serving device when
they load (`torch.export.passes.move_to_device_pass`); `platforms` records
where the artifact is meant to run ("cpu", "cuda"). On the card
`ExportedEngine` replays one CUDA graph a bucket around its program
(`graphs.GraphedCall`, as `serve.InferenceEngine` does).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from tpu_deer_torch.core.nig import combine_members, nig_expected_abs_error
from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.eval.ood import (
    input_norm_features_device,
    mahalanobis_score_device,
)
from tpu_deer_torch.graphs import BucketGraphs, bucketed_predict
from tpu_deer_torch.ops.quantization import dequantize_tree_device, quantize_tree

FORMAT = "tpu_deer_torch.export.v1"
MANIFEST = "manifest.json"
PARAMS_FILE = "params.npz"

# Outputs of the exported forward, in calling-convention order (the program
# returns a tuple; names are restored from here).
OUTPUT_NAMES = (
    "mu", "uncertainty", "calibrated_uncertainty", "expected_abs_error"
)


class _Program(torch.nn.Module):
    """(params, audio, video, text) → OUTPUT_NAMES (+ ood_score): the
    deterministic forward with every weight taken from `params` (an
    ensemble's: every member's, combined). The model is held outside the
    module tree, so the export lifts none of its tensors into the
    program."""

    def __init__(self, model, quantized: bool, ood: bool, ensemble: bool):
        super().__init__()
        self._model = (model.eval(),)
        self.quantized = quantized
        self.ood = ood
        self.ensemble = ensemble

    def _outputs(self, out: dict) -> dict:
        # Imported here: an artifact is served without the model code.
        from tpu_deer_torch.models.deer_model import uncertainty_outputs

        names = self._model[0].config.dim_names
        res = uncertainty_outputs(out, names)
        res["expected_abs_error"] = torch.cat(
            [nig_expected_abs_error(out[f"{n}_params"]) for n in names], dim=-1)
        return res

    def forward(self, params: dict, audio, video, text):
        model = self._model[0]
        if self.quantized:
            strip = lambda prefix: {k[len(prefix):]: v for k, v in params.items()
                                    if k.startswith(prefix)}
            weights = dequantize_tree_device(strip("q/"), strip("scale/"))
        else:
            weights = {k: v for k, v in params.items()
                       if not k.startswith("ood/")}
        one = lambda w: self._outputs(functional_call(model, w, (audio, video, text)))
        out = (combine_members(torch.func.vmap(one)(weights)) if self.ensemble
               else one(weights))
        res = tuple(out[k] for k in OUTPUT_NAMES)
        if self.ood:
            res += (mahalanobis_score_device(
                input_norm_features_device(audio, video, text),
                params["ood/mean"], params["ood/whitener"]),)
        return res


def _platforms(platforms: Optional[Sequence[str]]) -> list[str]:
    """The platforms an artifact is for: None = the CUDA card."""
    if platforms is None:
        return [resolve_device(None).type]
    out = []
    for p in platforms:
        if p not in ("cpu", "cuda"):
            raise ValueError(f"platforms take 'cpu' and 'cuda', got {p!r}")
        resolve_device(p)  # "cuda" raises without a card
        out.append(p)
    return out


def export_inference(
    model,
    output_dir: str,
    batch_buckets: Sequence[int] = (1, 8, 64, 256),
    platforms: Optional[Sequence[str]] = None,
    quantize: bool = False,
    ensemble: bool = False,
    ood_detector=None,
    ood_fpr: float = 0.01,
    serving_channel: str = "eabs",
    params: Optional[dict] = None,
) -> dict:
    """Export `model`'s (a CompleteDEERModel with its weights)
    deterministic forward for each batch bucket; returns the manifest.

    `serving_channel` ("calibrated" | "eabs") records which uncertainty
    channel deployment should read (the CLI's export mode passes the
    checkpoint's). `platforms=None` means the CUDA card (and raises without
    one); pass ("cpu",) or ("cpu", "cuda"). `quantize=True` stores int8
    Dense kernels and scales and dequantizes inside the program.
    `ood_detector` (a fitted MahalanobisOOD in "input_norm" space) adds an
    `ood_score` output, and the manifest records the `ood_fpr` threshold
    that ExportedEngine uses for `is_ood`; fused-space detectors are
    refused, as the reference refuses them. `ensemble=True` exports a deep
    ensemble: `model` gives the structure and `params` its stacked members
    ({state_dict name: [K, ...]}; int8 with per-member scales).
    """
    if ensemble and not params:
        raise ValueError("ensemble=True needs the stacked member params")
    if ood_detector is not None and ood_detector.space != "input_norm":
        raise ValueError(
            "export supports 'input_norm'-space OOD detectors only; got "
            f"space={ood_detector.space!r} (fused-space detectors are for "
            "representation monitoring, not exported serving)"
        )
    if serving_channel not in ("calibrated", "eabs"):
        raise ValueError(
            f"serving_channel must be 'calibrated' or 'eabs', "
            f"got {serving_channel!r}"
        )
    platforms = _platforms(platforms)
    os.makedirs(output_dir, exist_ok=True)
    cfg = model.config
    state = {k: v.detach().cpu()
             for k, v in (params if ensemble else model.state_dict()).items()}
    members = len(next(iter(state.values()))) if ensemble else 1
    if quantize:
        q, scales = quantize_tree(state, member_stacked=ensemble)
        flat = {**{f"q/{k}": v for k, v in q.items()},
                **{f"scale/{k}": v for k, v in scales.items()}}
    else:
        flat = dict(state)
    n_params = sum(v.numel() for k, v in flat.items()
                   if not k.startswith("scale/"))
    if ood_detector is not None:
        mean, whitener = ood_detector.device_arrays
        flat["ood/mean"] = torch.from_numpy(np.asarray(mean, np.float32))
        flat["ood/whitener"] = torch.from_numpy(np.asarray(whitener, np.float32))
    flat = dict(sorted(flat.items()))

    # Traced on the CPU (a model on the card is copied there for it); the
    # program keeps no example inputs, which would hold the parameters.
    shell = type(model)(cfg)
    if not ensemble:
        shell.load_state_dict(state)
    program = _Program(shell, quantize, ood_detector is not None, ensemble)
    artifacts = {}
    for b in sorted(batch_buckets):
        example = tuple(torch.zeros((b, d))
                        for d in (cfg.audio_dim, cfg.video_dim, cfg.text_dim))
        ep = torch.export.export(program, (flat, *example), strict=False)
        if ensemble:
            # Retraced to the ATen dialect, where vmap has batched every op
            # over the member axis (K-times batched GEMMs): the pre-dispatch
            # graph keeps functorch calls that some torch releases cannot
            # serialize.
            ep = ep.run_decompositions({})
        ep.example_inputs = None
        name = f"forward_b{b}.pt2"
        torch.export.save(ep, os.path.join(output_dir, name))
        artifacts[str(b)] = name

    np.savez(os.path.join(output_dir, PARAMS_FILE),
             **{k: v.numpy() for k, v in flat.items()})
    manifest = {
        "format": FORMAT,
        "model": "CompleteDEERModel",
        "config": {
            "audio_dim": cfg.audio_dim,
            "video_dim": cfg.video_dim,
            "text_dim": cfg.text_dim,
        },
        "outputs": list(OUTPUT_NAMES)
        + (["ood_score"] if ood_detector is not None else []),
        "buckets": sorted(int(b) for b in batch_buckets),
        "platforms": platforms,
        "artifacts": artifacts,
        "quantized": bool(quantize),
        "serving_channel": serving_channel,
        "ensemble_members": members,
        "n_params": int(n_params),
    }
    if ood_detector is not None:
        manifest["ood"] = {
            "space": ood_detector.space,
            "fpr": float(ood_fpr),
            "threshold": float(ood_detector.threshold(ood_fpr)),
        }
    with open(os.path.join(output_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ExportedEngine:
    """Serving engine over an exported artifact (no model code).

    Same predict contract as serve.InferenceEngine: bucketed padding,
    chunking past the largest bucket, numpy in and out; on the card one
    CUDA graph a bucket (`warmup()` captures them all; `graphs=False` runs
    the programs eagerly there)."""

    def __init__(self, output_dir: str, device: DeviceLike = None,
                 graphs: bool = True):
        from torch.export.passes import move_to_device_pass

        self.output_dir = output_dir
        with open(os.path.join(output_dir, MANIFEST)) as f:
            self.manifest = json.load(f)
        fmt = self.manifest.get("format")
        if fmt == "tpu_deer.export.v1":
            raise ValueError(
                f"{output_dir} is an artifact of the JAX package (StableHLO "
                "programs), which the PyTorch port cannot run: export the "
                "model with tpu_deer_torch.export")
        if fmt != FORMAT:
            raise ValueError(f"unrecognized export format in {output_dir}: "
                             f"{fmt!r}")
        self.device = resolve_device(device)
        if self.device.type not in self.manifest["platforms"]:
            raise ValueError(
                f"{output_dir} was exported for {self.manifest['platforms']}, "
                f"not {self.device.type}")
        self.graphs = graphs and self.device.type == "cuda"
        with np.load(os.path.join(output_dir, PARAMS_FILE)) as z:
            self.params = {k: torch.from_numpy(z[k]).to(self.device)
                           for k in z.files}
        self.buckets = self.manifest["buckets"]
        # Channel deployment should read, as recorded at export time.
        self.serving_channel = self.manifest.get("serving_channel", "eabs")
        self._programs = {}
        for b, name in self.manifest["artifacts"].items():
            ep = torch.export.load(os.path.join(output_dir, name))
            if self.device.type != "cpu":
                ep = move_to_device_pass(ep, self.device)
            self._programs[int(b)] = ep.module()
        c = self.manifest["config"]
        self.bucket_graphs = BucketGraphs(
            self._forward, (c["audio_dim"], c["video_dim"], c["text_dim"]),
            self.device, self.graphs)

    def _forward(self, batch: int):
        names = self.manifest["outputs"]
        program = self._programs[batch]
        return lambda a, v, t: dict(zip(names, program(self.params, a, v, t)))

    def warmup(self) -> None:
        """Capture every bucket's graph on the card, or run each bucket
        once."""
        self.bucket_graphs.warmup(self.buckets)

    def predict(self, audio: np.ndarray, video: np.ndarray,
                text: np.ndarray) -> dict[str, np.ndarray]:
        res = bucketed_predict(self.bucket_graphs.run, self.buckets,
                              audio, video, text)
        ood = self.manifest.get("ood")
        if ood is not None:
            res["is_ood"] = res["ood_score"] > ood["threshold"]
        return res


def load_exported(output_dir: str, device: DeviceLike = None,
                  graphs: bool = True) -> ExportedEngine:
    return ExportedEngine(output_dir, device=device, graphs=graphs)
