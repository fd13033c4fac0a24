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
serves the channel its metadata selected.

`ensemble=True` serves a deep ensemble's stacked K-member parameters
(`train/ensemble.py`; `from_checkpoint(..., ensemble_members=K)`): the
member forwards are vmapped inside the one forward (K-times batched GEMMs),
float or int8 (per-member, per-channel scales), and combined by moment
matching (`core/nig.py:combine_members`), the formulas training-side
evaluation uses; `attention_weights` and the fused features an OOD
detector reads are the member means.

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

from tpu_deer_torch.core.nig import combine_members, nig_expected_abs_error
from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.eval.ood import (
    input_norm_features_device,
    mahalanobis_score_device,
)
from tpu_deer_torch.graphs import BucketGraphs, bucketed_predict
from tpu_deer_torch.models.deer_model import (
    CompleteDEERModel,
    DEERModelConfig,
    config_from_meta,
    member_forward,
    structure,
    uncertainty_outputs,
)
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
        params: Optional[dict] = None,
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
        to check the graphs. ensemble: `params` are a deep ensemble's stacked
        members ({state_dict name: [K, ...]}) and `model` gives only the
        structure."""
        if serving_channel not in ("calibrated", "eabs"):
            raise ValueError(
                f"serving_channel must be 'calibrated' or 'eabs', "
                f"got {serving_channel!r}"
            )
        self.serving_channel = serving_channel
        self.device = resolve_device(device)
        self.graphs = graphs and self.device.type == "cuda"
        self.quantized = bool(quantize_weights)
        self.ensemble = bool(ensemble)
        self.quantized_weights = self.params = None
        if self.ensemble:
            if not params or len({v.shape[0] for v in params.values()}) != 1:
                raise ValueError(
                    "ensemble=True expects stacked member params from "
                    "create_deer_ensemble() (a shared leading member axis)")
            state = {k: v.detach() for k, v in params.items()}
        elif self.quantized:
            state = model.state_dict()
        if self.quantized:
            q, scales = quantize_tree(state, member_stacked=self.ensemble)
            self.quantized_weights = (
                {k: v.to(self.device) for k, v in q.items()},
                {k: v.to(self.device) for k, v in scales.items()})
        elif self.ensemble:
            self.params = {k: v.to(self.device) for k, v in state.items()}
        # Without weights of its own where every forward passes them (the
        # dequantized ones, or the members').
        self.model = (structure(model.config)
                      if self.quantized or self.ensemble
                      else model.to(self.device).eval())
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
        recorded ("eabs" where it recorded none), as the model its metadata
        records (`config_from_meta`: fusion type, stacked layout, widths)
        unless `config` is given. `ensemble_members=K`
        serves a stacked K-member checkpoint (an EnsembleTrainer's, `cli
        --ensemble K`) as one ensemble."""
        from tpu_deer_torch.train.checkpoint import CheckpointManager

        ckpt = CheckpointManager(checkpoint_dir)
        state = ckpt.restore_params(step)
        meta = ckpt.metadata(step)
        metrics = meta["metrics"]
        config = config or config_from_meta(meta.get("model", {}))
        recorded = int(metrics.get("ensemble_members", 1))
        if recorded != ensemble_members:
            raise ValueError(
                f"{checkpoint_dir} holds {recorded} member(s), not "
                f"ensemble_members={ensemble_members}")
        kwargs.setdefault("serving_channel", metrics.get("serving_channel", "eabs"))
        if ensemble_members > 1:
            return cls(structure(config), ensemble=True, params=state, **kwargs)
        model = CompleteDEERModel(config)
        model.load_state_dict(state)
        return cls(model, **kwargs)

    def _outputs(self, out: dict) -> dict[str, torch.Tensor]:
        names = self.model.config.dim_names
        res = uncertainty_outputs(out, names)
        res["expected_abs_error"] = torch.cat(
            [nig_expected_abs_error(out[f"{n}_params"]) for n in names], dim=-1)
        # In the compute dtype (bf16 in the reference's bf16 mode); numpy has
        # no bfloat16, so it leaves as float32 (exact).
        res["attention_weights"] = out["attention_weights"].float()
        # The fused features stay in the compute dtype: the OOD score
        # promotes them to float32 against the detector's mean, as jnp's
        # promotion does in the reference.
        res["fused"] = out["fused_features"]
        return res

    def _forward(self, audio, video, text) -> dict[str, torch.Tensor]:
        weights = (dequantize_tree_device(*self.quantized_weights)
                   if self.quantized else self.params)
        if self.ensemble:
            res = combine_members(member_forward(
                self.model, weights, audio, video, text, self._outputs))
        elif weights is not None:
            res = self._outputs(functional_call(self.model, weights,
                                                (audio, video, text)))
        else:
            res = self._outputs(self.model(audio, video, text))
        fused = res.pop("fused")
        if self._ood is not None:
            feats = (input_norm_features_device(audio, video, text)
                     if self._ood_space == "input_norm" else fused)
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
