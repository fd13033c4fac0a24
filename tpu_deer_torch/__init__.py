"""tpu_deer_torch — the PyTorch/CUDA port of tpu_deer for NVIDIA Hopper.

The JAX package `tpu_deer` is the reference; this package computes the same
functions with PyTorch, and every Pallas kernel of the reference becomes a
kernel written by hand for Hopper (`tpu_deer_torch.kernels`). Module names
follow the reference so each piece has an obvious counterpart:

  tpu_deer.ops.dsp             → tpu_deer_torch.ops.dsp (own numpy copy)
  tpu_deer.ops.audio_frontend  → tpu_deer_torch.ops.audio_frontend
                                 + tpu_deer_torch.kernels.mfcc_signal (K1)
                                 + tpu_deer_torch.kernels.mfcc_frames (K2)
  tpu_deer.ops.flash_attention → tpu_deer_torch.kernels.flash_attention
                                 (K3a-c, forward and backward)
  tpu_deer.ops.quantization    → tpu_deer_torch.ops.quantization
                                 + tpu_deer_torch.kernels.quantize_int8 (K4)
  tpu_deer.data.features       → tpu_deer_torch.data.features
  tpu_deer.data.{vocab,audio_io,raw_corpus,synthetic,pipeline}
                               → tpu_deer_torch.data.* (own copies; IEMOCAP
                                 layout of the raw corpus)
  tpu_deer.core.{nig,losses}   → tpu_deer_torch.core.*
  tpu_deer.core.metrics        → tpu_deer_torch.core.metrics (numpy half)
  tpu_deer.models.*            → tpu_deer_torch.models.*
  tpu_deer.train.{trainer,checkpoint,raw_trainer,ensemble,distill}
                               → tpu_deer_torch.train.*
  tpu_deer.eval.{ood,evaluator,statistics,calibration,conformal,
                 uncertainty,comprehensive}
                               → tpu_deer_torch.eval.* (numpy parts: own
                                 copies)
  experiments/{synthetic_headline,ensemble_study}.py
                               → tpu_deer_torch.experiments.*
  tpu_deer.viz.{report,html_report}
                               → tpu_deer_torch.viz.* (own copies)
  tpu_deer.utils.{config,logging}
                               → tpu_deer_torch.utils.*
  tpu_deer.serve               → tpu_deer_torch.serve (float, int8, ensembles)
  tpu_deer.stream              → tpu_deer_torch.stream
  tpu_deer.server              → tpu_deer_torch.server
  tpu_deer.export              → tpu_deer_torch.export (torch.export)
  (jit-compiled buckets, tick) → tpu_deer_torch.graphs (CUDA graphs)
  tpu_deer.cli                 → tpu_deer_torch.cli
  (flax params ↔ state_dict)   → tpu_deer_torch.convert

Nothing here imports `jax`, `flax` or `tpu_deer`. Entry points run on CUDA
unless the caller passes `device="cpu"` (the CLI: `--platform cpu`);
without a card and without that request they raise (`tpu_deer_torch.device.resolve_device`).
"""

__version__ = "0.1.0"
