"""Raw-media trainer: waveform → front-end (K1) → sequence model → evidential
loss → AdamW, on the card.

Port of `tpu_deer/train/raw_trainer.py`. A step takes a batch of raw
signals [B, L], video frames [B, T, H, W, 3] and token ids [B, Tt]; the
front-end turns the signals into frame features with one K1 launch; the
model runs in train mode (its text encoder takes K3 from a transcript
length of 1024); the loss is `multi_task_deer_loss`; the gradients are
clipped to a global norm and AdamW updates every parameter outside
`frozen_prefixes`.

As in the reference: the data are staged on the device once and a step
gathers its rows there; the batch order is a host permutation drawn from
`np.random.default_rng(seed)`, and `train` drops the tail that does not
fill a batch; `predict` pads its last batch with `np.resize` and unpads the
outputs. The clip and the optimizer are the reference's optax chain,
`optax.clip_by_global_norm` then `adamw` at a constant rate
(`train/optim.py:AdamW`, which DEERTrainer shares): the clip's norm is over
every gradient, frozen parameters included.

Dropout draws from the trainer's own generator, seeded from `config.seed`
(`train/rng.py:seeded_dropout`), and a step's convolutions take cuDNN's
deterministic algorithms (`deterministic_convolutions`), so two runs with
one seed repeat bit for bit on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from tpu_deer_torch.core import losses as loss_lib
from tpu_deer_torch.core import metrics as metrics_lib
from tpu_deer_torch.device import DeviceLike, resolve_device
from tpu_deer_torch.models.hierarchical_deer import RawSequenceDEERModel
from tpu_deer_torch.ops.audio_frontend import (
    AudioFrontendConfig,
    audio_frame_features_batch,
)
from tpu_deer_torch.train.optim import AdamW
from tpu_deer_torch.train.rng import deterministic_convolutions, seeded_dropout

BATCH_KEYS = ("signal", "video_frames", "token_ids", "token_mask", "labels")


@dataclasses.dataclass(frozen=True)
class RawTrainingConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    gradient_clip: float = 1.0
    batch_size: int = 16
    num_epochs: int = 20
    loss_variant: str = "v2"
    # Parameter-name prefixes (state_dict names, e.g. "text_encoder.embed")
    # whose parameters take no update.
    frozen_prefixes: tuple = ()
    seed: int = 0


class RawSequenceTrainer:
    """End-to-end trainer for RawSequenceDEERModel on raw-media arrays.

    `model` is trained in place on `device` (None = the CUDA card). Arrays
    (from data.raw_corpus.load_raw_corpus): signal [N, L], video_frames
    [N, T, H, W, 3], token_ids / token_mask [N, Tt], labels [N, 3].
    """

    def __init__(self, model: RawSequenceDEERModel,
                 config: RawTrainingConfig = RawTrainingConfig(),
                 frontend_config: AudioFrontendConfig = AudioFrontendConfig(),
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        self.frontend_config = frontend_config
        self.loss_config = loss_lib.DEERLossConfig(variant=config.loss_variant)
        self._params = {n: p for n, p in model.named_parameters()
                        if p.requires_grad}
        trained = [n for n in self._params
                   if not n.startswith(tuple(config.frozen_prefixes))]
        self.optimizer = AdamW(self._params, {"trained": (1.0, trained)},
                               lambda count: config.learning_rate,
                               config.weight_decay, config.gradient_clip)
        self.history: dict[str, list] = {"train_loss": [], "val_ccc": []}
        self._staged: dict[int, tuple] = {}  # id → (arrays, staged)
        # Dropout draws (seeded_dropout), one seed a step.
        self.generator = torch.Generator().manual_seed(config.seed)

    # -- steps -------------------------------------------------------------
    def _forward(self, batch: dict) -> dict:
        frames = audio_frame_features_batch(batch["signal"],
                                            self.frontend_config)
        return self.model(frames, batch["video_frames"], batch["token_ids"],
                          batch["token_mask"])

    def _train_step(self, batch: dict) -> torch.Tensor:
        self.model.train()
        with deterministic_convolutions():
            with seeded_dropout(self.generator, self.device):
                out = self._forward(batch)
            params = [out[f"{n}_params"] for n in self.model.dim_names]
            loss = loss_lib.multi_task_deer_loss(params, batch["labels"],
                                                 self.loss_config)["total_loss"]
            grads = torch.autograd.grad(loss, list(self._params.values()),
                                        allow_unused=True)
        self.optimizer.step(grads)
        return loss.detach()

    # -- data --------------------------------------------------------------
    def _stage(self, arrays: dict) -> dict:
        key = id(arrays)
        if key not in self._staged:
            # The entry holds `arrays` too, so that its id is not reused (a
            # dict can be neither hashed nor weakly referenced).
            self._staged[key] = (arrays, {
                k: torch.from_numpy(np.asarray(arrays[k])).to(self.device)
                for k in BATCH_KEYS})
        return self._staged[key][1]

    def _gather(self, staged: dict, idx: np.ndarray) -> dict:
        index = torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)
        return {k: v.index_select(0, index) for k, v in staged.items()}

    # -- loops -------------------------------------------------------------
    def train(self, train_arrays: dict, val_arrays: Optional[dict] = None,
              num_epochs: Optional[int] = None) -> dict:
        cfg = self.config
        num_epochs = num_epochs or cfg.num_epochs
        staged = self._stage(train_arrays)
        n = len(train_arrays["labels"])
        bs = min(cfg.batch_size, n)
        host_rng = np.random.default_rng(cfg.seed)
        t0 = time.time()
        best_ccc = -np.inf
        for _ in range(num_epochs):
            order = host_rng.permutation(n)
            losses = [self._train_step(self._gather(staged, order[s:s + bs]))
                      for s in range(0, n - bs + 1, bs)]
            self.history["train_loss"].append(
                float(torch.stack(losses).mean()))
            if val_arrays is not None:
                mu = self.predict(val_arrays)["mu"]
                ccc = float(np.mean([
                    metrics_lib.ccc_np(val_arrays["labels"][:, i], mu[:, i])
                    for i in range(mu.shape[1])]))
                self.history["val_ccc"].append(ccc)
                best_ccc = max(best_ccc, ccc)
        return {"history": self.history, "best_val_ccc": float(best_ccc),
                "training_time_s": time.time() - t0}

    def predict(self, arrays: dict) -> dict:
        """{"mu": [N, 3], "uncertainty": [N, 3]} as numpy, in eval mode."""
        staged = self._stage(arrays)
        n = len(arrays["labels"])
        bs = min(self.config.batch_size, n)
        self.model.eval()
        mus, uncs = [], []
        with torch.no_grad():
            for start in range(0, n, bs):
                idx = np.arange(start, min(start + bs, n))
                # Pad the tail to the batch size; unpad after.
                out = self._forward(self._gather(staged, np.resize(idx, bs)))
                mus.append(out["mu_all"][: len(idx)].cpu().numpy())
                uncs.append(out["uncertainty_all"][: len(idx)].cpu().numpy())
        return {"mu": np.concatenate(mus), "uncertainty": np.concatenate(uncs)}
