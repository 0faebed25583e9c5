"""The arithmetic of the end-to-end metrics, on the host clock's readings."""

from __future__ import annotations

import math
from typing import Sequence


def rate_ms(window_s: float, units: int) -> float:
    """Milliseconds a unit over the whole window: window seconds divided by
    the units completed in it (a stall anywhere in the window counts)."""
    if units <= 0:
        raise ValueError("no unit completed in the window")
    return 1000.0 * window_s / units


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value: the least value
    that at least ``q`` percent of the values do not exceed."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def per_second(work: float, window_s: float) -> float:
    """Work done in the window divided by its seconds."""
    if window_s <= 0:
        raise ValueError("empty window")
    return work / window_s
