"""Random streams derived from a run's ``--seed``: one independent stream
per named purpose, for any whole number a run is given (negative or
above 64 bits included)."""

from __future__ import annotations

import zlib

import numpy as np


def _key(seed: int, names) -> list:
    return [int(seed) % 2 ** 64] + [
        zlib.crc32(str(n).encode()) for n in names]


def rng(seed: int, *names) -> np.random.Generator:
    """A numpy Generator for ``seed`` and the purpose ``names``."""
    return np.random.default_rng(_key(seed, names))


def torch_seed(seed: int, *names) -> int:
    """A 63-bit seed for a ``torch.Generator``."""
    state = np.random.SeedSequence(_key(seed, names)).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1
