"""A scene's first state from its configuration, without the program.

Frozen from ``egg_fluid_simulation_tpu_torch/handler.py`` (commit
e9e0aedb87f3): ``_fibonacci_spiral``, ``_mass_distribution_t`` and the
field fill of ``add_many`` (batch ``i`` of an empty handler takes slot ``i``;
colours are ones without particle colour).
"""

from __future__ import annotations

import math

import numpy as np

from .frozen.utils.mathx import mix

_GOLDEN_RATIO = (1 + math.sqrt(5)) / 2
_GOLDEN_ANGLE = 2 * math.pi / (_GOLDEN_RATIO * _GOLDEN_RATIO)
MASS_VARIANCE = 4.0


def fibonacci_spiral(n: int, x_radius: float, y_radius: float) -> np.ndarray:
    i = np.arange(1, n + 1, dtype=np.float64)
    r = np.sqrt((i - 1) / n)
    theta = i * _GOLDEN_ANGLE
    return np.stack([r * x_radius * np.cos(theta),
                     r * y_radius * np.sin(theta)], axis=-1).astype(np.float32)


def mass_distribution_t(n: int, variance: float) -> np.ndarray:
    i = np.arange(1, n + 1, dtype=np.float64)
    left = (i - 0.5) / n
    right = (i + 0.5) / n
    center = 0.5 * (left + right)
    half_width = 0.5 * (right - left)
    t1 = center - half_width / math.sqrt(3)
    t2 = center + half_width / math.sqrt(3)

    def butterworth(t):
        return 1.0 / (1.0 + (variance * (t - 0.5)) ** 4)

    return (0.5 * (butterworth(t1) + butterworth(t2))).astype(np.float32)


def spawn(specs: list, configs: tuple, capacity: int,
          max_batches: int) -> dict:
    """The state fields after ``add_many(specs)`` on an empty handler, as
    numpy arrays keyed like the program's ``ParticleState``."""
    n_pop = 2
    out = {
        "pos": np.zeros((n_pop, capacity, 2), np.float32),
        "radius": np.zeros((n_pop, capacity), np.float32),
        "mass_t": np.zeros((n_pop, capacity), np.float32),
        "inv_mass": np.ones((n_pop, capacity), np.float32),
        "batch_slot": np.zeros((n_pop, capacity), np.int32),
        "count": np.zeros((n_pop,), np.int32),
        "batch_target": np.zeros((max_batches, 2), np.float32),
        "batch_radius": np.ones((n_pop, max_batches), np.float32),
    }
    for slot, p in enumerate(specs):
        for pop, nm in ((0, "white"), (1, "yolk")):
            cfg = configs[pop]
            n = p[f"{nm}_n_particles"]
            rad = p[f"{nm}_radius"]
            t = mass_distribution_t(n, MASS_VARIANCE)
            mass = np.maximum(mix(cfg["min_mass"], cfg["max_mass"], t), 1e-12)
            lo = int(out["count"][pop])
            sl = slice(lo, lo + n)
            out["pos"][pop, sl] = (np.array([p["x"], p["y"]], np.float32)
                                   + fibonacci_spiral(n, rad, rad))
            out["radius"][pop, sl] = mix(cfg["min_radius"], cfg["max_radius"],
                                         t).astype(np.float32)
            out["mass_t"][pop, sl] = t
            out["inv_mass"][pop, sl] = (1.0 / mass).astype(np.float32)
            out["batch_slot"][pop, sl] = slot
            out["count"][pop] += n
        out["batch_target"][slot] = (p["x"], p["y"])
        out["batch_radius"][:, slot] = (p["white_radius"], p["yolk_radius"])
    return out
