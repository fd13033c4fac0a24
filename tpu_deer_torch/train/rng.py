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


@contextlib.contextmanager
def seeded_dropout(generator: torch.Generator, device: torch.device):
    """Run the body with `device`'s global generator seeded from
    `generator` (advancing it by one draw), then restore the global state."""
    seed = int(torch.randint(2**63 - 1, (), generator=generator))
    cuda = device.type == "cuda"
    index = device.index if device.index is not None else 0
    if cuda and device.index is None:
        index = torch.cuda.current_device()
    with torch.random.fork_rng(devices=[index] if cuda else []):
        if cuda:
            torch.cuda.default_generators[index].manual_seed(seed)
        else:
            torch.default_generator.manual_seed(seed)
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
