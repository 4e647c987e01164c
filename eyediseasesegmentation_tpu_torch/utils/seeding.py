"""Seeding discipline (torch port).

Counterpart of ``eyediseasesegmentation_tpu/utils/seeding.py``: the reference
seeds python / numpy / torch with SEED=1999 (``pipeline.py:36-40``). Here one
root ``torch.Generator`` per experiment; :func:`fold_in` derives the
per-epoch and per-step generators from it (the role of
``jax.random.fold_in``), on any device, deterministically from the root's
seed and the indices alone.
"""

from __future__ import annotations

import random

import numpy as np
import torch

DEFAULT_SEED = 1999
_MASK = (1 << 63) - 1


def set_global_seed(seed: int = DEFAULT_SEED) -> torch.Generator:
    """Seed the host RNGs (python, numpy, torch) and return the root CPU
    generator."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def fold_in(generator: torch.Generator, data: int,
            device="cpu") -> torch.Generator:
    """A new generator on ``device`` whose seed mixes ``generator``'s seed
    with ``data`` (splitmix64); ``generator``'s own stream is not
    consumed."""
    z = (generator.initial_seed() + 0x9E3779B97F4A7C15 * (int(data) + 1)) \
        & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return torch.Generator(device=device).manual_seed((z ^ (z >> 31)) & _MASK)


def key_iter(generator: torch.Generator, device="cpu"):
    """Infinite deterministic stream of generators: ``fold_in(generator,
    i)`` for i = 0, 1, ... (the role of the JAX package's key stream)."""
    i = 0
    while True:
        yield fold_in(generator, i, device)
        i += 1
