"""Seedable global RNG for host-side sampling.

reference: include/lama/random.h, src/random.cpp:37-73 — a global mt19937
with genSeed/setSeed and uniform/normal draws. The drivers draw from their
own ``torch.Generator`` (see PFSlam2D); this module covers the host-side
uses (seeding, dataset noise) with the same one-global-generator
ergonomics, on numpy's generator: the same seed gives the JAX package's
draws.
"""

from __future__ import annotations

import time

import numpy as np

_rng = np.random.default_rng(0)
_seed = 0


def gen_seed() -> int:
    """random.cpp:41-49."""
    return int(time.time_ns() % (2 ** 31 - 1)) or 1


def set_seed(seed: int) -> int:
    global _rng, _seed
    _seed = int(seed) if seed else gen_seed()
    _rng = np.random.default_rng(_seed)
    return _seed


def seed() -> int:
    return _seed


def uniform(low: float = 0.0, high: float = 1.0):
    return float(_rng.uniform(low, high))


def normal(sigma: float = 1.0, mean: float = 0.0):
    return float(_rng.normal(mean, sigma))


def integers(low: int, high: int) -> int:
    return int(_rng.integers(low, high))
