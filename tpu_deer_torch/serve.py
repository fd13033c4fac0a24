"""Batched inference engine for serving the flagship model.

Port of `tpu_deer/serve.py`: requests are padded up to the nearest batch
bucket (1, 8, 64, 256 by default), requests beyond the largest bucket are
chunked, the model runs in eval mode under inference_mode on its device, and
the result is VAD predictions with calibrated uncertainty, the
aleatoric/epistemic decomposition and the closed-form E|y - mu|.

With an OOD detector (`tpu_deer_torch.eval.ood.MahalanobisOOD`) every
prediction also carries `ood_score`, computed on the device in the
detector's feature space, and `is_ood` at its threshold.

`quantize_weights=True` serves int8 weights: `ops.quantization.quantize_tree`
quantizes the Dense kernels per output channel, they stay int8 on the
device, and each forward dequantizes them (q · scale, plain torch, as the
reference's `dequantize_tree_device` inside its jitted forward) into the
weights `torch.func.functional_call` runs the model with; the engine keeps
no float copy of them. `from_checkpoint` loads a trainer's checkpoint and
serves the channel its metadata selected. Ensembles are not ported yet and
raise NotImplementedError.

On the card each padded bucket runs as a CUDA graph of the whole forward
(`graphs.GraphedCall`: the model, E|y - mu|, the int8 dequantize and the
OOD score), the counterpart of the reference's jit-compiled bucket:
`warmup()` captures every bucket, as the reference compiles them, and a
bucket not yet captured is captured at its first request. All buckets share
one memory pool. `graphs=False` runs the same forward eagerly on the card
(to check the graphs against it); on the CPU the engine is always eager.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from tpu_deer_torch.core.nig import nig_expected_abs_error
from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.eval.ood import (
    input_norm_features_device,
    mahalanobis_score_device,
)
from tpu_deer_torch.graphs import BucketGraphs, bucketed_predict
from tpu_deer_torch.models.deer_model import CompleteDEERModel, DEERModelConfig
from tpu_deer_torch.ops.quantization import dequantize_tree_device, quantize_tree

DEFAULT_BUCKETS = (1, 8, 64, 256)


class InferenceEngine:
    def __init__(
        self,
        model: CompleteDEERModel,
        batch_buckets: Sequence[int] = DEFAULT_BUCKETS,
        quantize_weights: bool = False,
        ensemble: bool = False,
        ood_detector=None,
        ood_fpr: float = 0.01,
        serving_channel: str = "eabs",
        device: DeviceLike = None,
        graphs: bool = True,
    ):
        """Serve `model` (its weights, moved to `device`: None = the CUDA
        card). serving_channel names the uncertainty deployment reads:
        "calibrated" (calibrated_uncertainty) or "eabs" (expected_abs_error,
        the training-free default). ood_detector: a fitted MahalanobisOOD,
        scored in its own space ("input_norm": the normalized inputs,
        "fused": the model's fused features); is_ood flags scores above its
        threshold at the training false-positive rate `ood_fpr`.
        quantize_weights: serve int8 Dense kernels (the module's own weights
        are then not moved or kept). graphs: CUDA graphs where the device is
        the card (the CPU is always eager); False runs eagerly on the card,
        to check the graphs."""
        if ensemble:
            raise NotImplementedError(
                "ensemble serving is not ported yet (ROADMAP queue 1, item 12)")
        if serving_channel not in ("calibrated", "eabs"):
            raise ValueError(
                f"serving_channel must be 'calibrated' or 'eabs', "
                f"got {serving_channel!r}"
            )
        self.serving_channel = serving_channel
        self.device = resolve_device(device)
        self.graphs = graphs and self.device.type == "cuda"
        self.quantized = bool(quantize_weights)
        self.quantized_weights = None
        if self.quantized:
            q, scales = quantize_tree(model.state_dict())
            self.quantized_weights = (
                {k: v.to(self.device) for k, v in q.items()},
                {k: v.to(self.device) for k, v in scales.items()})
            # The module's structure without weights: every forward passes
            # the dequantized ones.
            with torch.device("meta"):
                model = CompleteDEERModel(model.config)
            self.model = model.eval()
        else:
            self.model = model.to(self.device).eval()
        self.buckets = sorted(batch_buckets)
        cfg = self.model.config
        self.bucket_graphs = BucketGraphs(
            lambda batch: self._forward,
            (cfg.audio_dim, cfg.video_dim, cfg.text_dim), self.device,
            self.graphs)
        self._ood = None
        self._ood_threshold = None
        if ood_detector is not None:
            self._ood = tuple(torch.from_numpy(np.asarray(a)).to(self.device)
                              for a in ood_detector.device_arrays)
            self._ood_threshold = ood_detector.threshold(ood_fpr)
            self._ood_space = ood_detector.space

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str,
                        config: Optional[DEERModelConfig] = None, step="best",
                        ensemble_members: int = 1, **kwargs) -> "InferenceEngine":
        """Serve the parameters of a DEERTrainer checkpoint (step "best", None
        for the latest, or a number) with the serving channel its metadata
        recorded ("eabs" where it recorded none)."""
        from tpu_deer_torch.train.checkpoint import CheckpointManager

        if ensemble_members > 1:
            raise NotImplementedError(
                "ensemble serving is not ported yet (ROADMAP queue 1, item 12)")
        model = CompleteDEERModel(config or DEERModelConfig())
        ckpt = CheckpointManager(checkpoint_dir)
        model.load_state_dict(ckpt.restore_params(step))
        if "serving_channel" not in kwargs:
            kwargs["serving_channel"] = ckpt.metadata(step)["metrics"].get(
                "serving_channel", "eabs")
        return cls(model, **kwargs)

    def _forward(self, audio, video, text) -> dict[str, torch.Tensor]:
        if self.quantized:
            out = functional_call(
                self.model, dequantize_tree_device(*self.quantized_weights),
                (audio, video, text))
        else:
            out = self.model(audio, video, text)
        names = self.model.config.dim_names
        cat = lambda key: torch.cat([out[f"{n}_{key}"] for n in names], dim=-1)
        res = {
            "mu": out["mu_all"],
            "uncertainty": out["uncertainty_all"],
            "calibrated_uncertainty": out["calibrated_uncertainty"],
            "aleatoric": cat("aleatoric_uncertainty"),
            "epistemic": cat("epistemic_uncertainty"),
            "expected_abs_error": torch.cat(
                [nig_expected_abs_error(out[f"{n}_params"]) for n in names],
                dim=-1,
            ),
            # In the compute dtype (bf16 in the reference's bf16 mode); numpy
            # has no bfloat16, so it leaves as float32 (exact).
            "attention_weights": out["attention_weights"].float(),
        }
        if self._ood is not None:
            # The fused features stay in the compute dtype: the score
            # promotes them to float32 against the detector's mean, as
            # jnp's promotion does in the reference.
            feats = (input_norm_features_device(audio, video, text)
                     if self._ood_space == "input_norm"
                     else out["fused_features"])
            res["ood_score"] = mahalanobis_score_device(feats, *self._ood)
        return res

    def warmup(self) -> None:
        """Capture every bucket's graph on the card (before any other thread
        uses it), or run each bucket once eagerly."""
        self.bucket_graphs.warmup(self.buckets)

    def predict(self, audio: np.ndarray, video: np.ndarray,
                text: np.ndarray) -> dict[str, np.ndarray]:
        """audio [N, 84], video [N, 256], text [N, 768] → prediction dict.

        Requests larger than the biggest bucket are processed in chunks.
        """
        out = bucketed_predict(self.bucket_graphs.run, self.buckets,
                              audio, video, text)
        if self._ood_threshold is not None:
            out["is_ood"] = out["ood_score"] > self._ood_threshold
        return out
