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

import torch


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


@contextlib.contextmanager
def seeded_dropout(generator: torch.Generator, device: torch.device):
    """Run the body with `device`'s global generator seeded from
    `generator` (advancing it by one draw), then restore the global state."""
    seed = draw_seed(generator)
    with forked_rng(device):
        seed_global(device, seed)
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
