"""Seeded dropout draws, and a step that repeats bit for bit, for the
trainers.

The reference's trainers draw dropout from a key split off their seed every
step, so two runs with one seed repeat, and a checkpoint holds the key.
The port's layers are plain `nn.Dropout`, which draws from PyTorch's global
generator of the tensor's device (`F.dropout` takes no generator). Rather
than threading a generator through every layer of every model, a trainer
owns a CPU `torch.Generator` seeded from its config and runs each step's
forward inside `seeded_dropout`: it draws a 63-bit seed from the trainer's
generator, forks the global generator of the trainer's device, seeds it,
and restores it on exit. So the draws depend only on the trainer's seed and
its step, nothing outside the trainer sees or moves them, the models stay
the same modules that serving runs, and the generator's state (a uint8
tensor) is all a checkpoint needs to repeat them.

A step replayed from a CUDA graph draws the same masks. A fused epoch
(`DEERTrainer`) runs inside one `forked_rng` and, before each step, draws
the step's seed from the trainer's generator and seeds the card's global
generator with it on the host (`seed_global`), as `seeded_dropout` does.
PyTorch's graph-safe Philox reads the generator's seed and offset when a
graph is replayed, and each dropout of the step takes its offset from the
step's start (0 after the seed) plus the increments before it, as eagerly;
so a step's masks depend only on the trainer's seed and the step, in both
forms. `chip_smoke.py` phase 10(d) holds graphed steps against eager ones
on the card.

A forward under `remat` (the trainers' `TrainingConfig.remat`, the
reference's `jax.checkpoint` of the whole forward) keeps none of its
activations: the backward runs it again, and that recomputation must draw
the forward's dropout masks. On the CPU `torch.utils.checkpoint` keeps
the generator's state for it. On the card it cannot: reading the card
generator's seed and offset is refused inside a CUDA graph capture. There
the trainer keeps a second generator state (`RecomputeRNG`), seeded with
each step's seed beside the global generator; the recomputation runs with
that state swapped in (`graphsafe_set_state`), so its dropouts start from
the step's offset 0 of the same seed, as the forward's did. A captured
graph registers the second state, so its replays read its seed as they
read the global generator's.

A seeded step repeats only if its sums do too. The reference's gradients
are XLA's, which give the same bits on every run. On the card, cuDNN's
default convolution backward (the raw model's video encoder) adds in an
order that varies by run; `deterministic_convolutions` picks its
deterministic algorithms for the body of a step and restores the setting
after, so nothing outside the step changes. (The token-embedding gradient
has a kernel of its own for the same reason, `kernels/embedding.py`.)
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint


def draw_seed(generator: torch.Generator) -> int:
    """The next step's 63-bit dropout seed from the trainer's generator."""
    return int(torch.randint(2**63 - 1, (), generator=generator))


def _cuda_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


@contextlib.contextmanager
def forked_rng(device: torch.device):
    """Run the body with `device`'s global generator forked: its state is
    restored on exit."""
    cuda = device.type == "cuda"
    with torch.random.fork_rng(devices=[_cuda_index(device)] if cuda else []):
        yield


def seed_global(device: torch.device, seed: int) -> None:
    """Seed `device`'s global generator (its offset back to 0)."""
    if device.type == "cuda":
        torch.cuda.default_generators[_cuda_index(device)].manual_seed(seed)
    else:
        torch.default_generator.manual_seed(seed)


class RecomputeRNG:
    """The card's second generator state for a recomputed forward (module
    docstring): `seed` it with each step's seed, `register` it with a graph
    before its capture, and run the recomputation inside `recompute()`."""

    def __init__(self, device: torch.device):
        self.generator = torch.cuda.default_generators[_cuda_index(device)]
        self.twin = self.generator.clone_state()

    def seed(self, seed: int) -> None:
        self.twin.manual_seed(seed)

    def register(self, graph: torch.cuda.CUDAGraph) -> None:
        graph.register_generator_state(self.twin)

    @contextlib.contextmanager
    def recompute(self):
        saved = self.generator.graphsafe_get_state()
        self.generator.graphsafe_set_state(self.twin)
        try:
            yield
        finally:
            self.generator.graphsafe_set_state(saved)


def seed_step(device: torch.device, seed: int,
              recompute: Optional[RecomputeRNG] = None) -> None:
    """Seed a step's draws: the global generator and, under remat on the
    card, the recomputation's state."""
    seed_global(device, seed)
    if recompute is not None:
        recompute.seed(seed)


def remat(fn: Callable, *args, recompute: Optional[RecomputeRNG] = None):
    """fn(*args) as one checkpointed block (`torch.utils.checkpoint`,
    non-reentrant): its activations are dropped and recomputed in the
    backward with the forward's dropout draws (module docstring)."""
    if recompute is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          recompute.recompute()))


@contextlib.contextmanager
def seeded_dropout(generator: torch.Generator, device: torch.device,
                   recompute: Optional[RecomputeRNG] = None):
    """Run the body with `device`'s global generator seeded from
    `generator` (advancing it by one draw), then restore the global state."""
    seed = draw_seed(generator)
    with forked_rng(device):
        seed_step(device, seed, recompute)
        yield


@contextlib.contextmanager
def deterministic_convolutions():
    """Run the body with cuDNN's deterministic convolution algorithms, then
    restore the previous setting."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before
