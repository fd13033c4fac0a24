"""Batched inference engine for serving the flagship model.

Port of `tpu_deer/serve.py` (float path): requests are padded up to the
nearest batch bucket (1, 8, 64, 256 by default), requests beyond the largest
bucket are chunked, the model runs in eval mode under inference_mode on its
device, and the result is VAD predictions with calibrated uncertainty, the
aleatoric/epistemic decomposition and the closed-form E|y - mu|.

With an OOD detector (`tpu_deer_torch.eval.ood.MahalanobisOOD`) every
prediction also carries `ood_score`, computed on the device in the
detector's feature space, and `is_ood` at its threshold.

int8 weights, ensembles and loading from a checkpoint are not ported yet
and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from tpu_deer_torch.core.nig import nig_expected_abs_error
from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.eval.ood import (
    input_norm_features_device,
    mahalanobis_score_device,
)
from tpu_deer_torch.models.deer_model import CompleteDEERModel

DEFAULT_BUCKETS = (1, 8, 64, 256)


def bucketed_predict(
    predict_padded: Callable[..., dict], buckets: Sequence[int],
    audio: np.ndarray, video: np.ndarray, text: np.ndarray,
) -> dict[str, np.ndarray]:
    """Pad requests up to the nearest bucket, chunk requests beyond the
    largest bucket, and unpad the outputs back to the request size.

    `predict_padded(audio, video, text)` runs one padded batch and returns a
    dict of arrays."""
    n = len(audio)
    max_b = buckets[-1]
    if n > max_b:
        parts = [
            bucketed_predict(
                predict_padded, buckets,
                audio[i : i + max_b], video[i : i + max_b], text[i : i + max_b],
            )
            for i in range(0, n, max_b)
        ]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    b = next((bk for bk in buckets if n <= bk), max_b)
    pad = b - n
    if pad:
        padz = lambda x: np.concatenate(
            [x, np.zeros((pad,) + x.shape[1:], x.dtype)]
        )
        audio, video, text = padz(audio), padz(video), padz(text)
    out = predict_padded(audio, video, text)
    return {k: np.asarray(v)[:n] for k, v in out.items()}


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
    ):
        """Serve `model` (its weights, moved to `device`: None = the CUDA
        card). serving_channel names the uncertainty deployment reads:
        "calibrated" (calibrated_uncertainty) or "eabs" (expected_abs_error,
        the training-free default). ood_detector: a fitted MahalanobisOOD,
        scored in its own space ("input_norm": the normalized inputs,
        "fused": the model's fused features); is_ood flags scores above its
        threshold at the training false-positive rate `ood_fpr`."""
        if quantize_weights:
            raise NotImplementedError("int8 serving is not ported yet")
        if ensemble:
            raise NotImplementedError("ensemble serving is not ported yet")
        if serving_channel not in ("calibrated", "eabs"):
            raise ValueError(
                f"serving_channel must be 'calibrated' or 'eabs', "
                f"got {serving_channel!r}"
            )
        self.serving_channel = serving_channel
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.buckets = sorted(batch_buckets)
        self._ood = None
        self._ood_threshold = None
        if ood_detector is not None:
            self._ood = tuple(torch.from_numpy(np.asarray(a)).to(self.device)
                              for a in ood_detector.device_arrays)
            self._ood_threshold = ood_detector.threshold(ood_fpr)
            self._ood_space = ood_detector.space

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, *args, **kwargs):
        raise NotImplementedError("checkpoints are not ported yet")

    def _forward(self, audio, video, text) -> dict[str, torch.Tensor]:
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
            "attention_weights": out["attention_weights"],
        }
        if self._ood is not None:
            feats = (input_norm_features_device(audio, video, text)
                     if self._ood_space == "input_norm"
                     else out["fused_features"])
            res["ood_score"] = mahalanobis_score_device(feats, *self._ood)
        return res

    def _run(self, audio, video, text) -> dict[str, np.ndarray]:
        as_t = lambda x: torch.from_numpy(
            np.ascontiguousarray(x, dtype=np.float32)).to(self.device)
        with torch.inference_mode():
            out = self._forward(as_t(audio), as_t(video), as_t(text))
            return {k: v.cpu().numpy() for k, v in out.items()}

    def predict(self, audio: np.ndarray, video: np.ndarray,
                text: np.ndarray) -> dict[str, np.ndarray]:
        """audio [N, 84], video [N, 256], text [N, 768] → prediction dict.

        Requests larger than the biggest bucket are processed in chunks.
        """
        out = bucketed_predict(self._run, self.buckets, audio, video, text)
        if self._ood_threshold is not None:
            out["is_ood"] = out["ood_score"] > self._ood_threshold
        return out
