"""Random streams drawn from ``--seed``: one per use, so that adding a draw
to one use changes no other."""

from __future__ import annotations

import numpy as np

SCENE, TRAFFIC, SAMPLE = 0, 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for ``stream`` of ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])
