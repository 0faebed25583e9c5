"""A configuration's scene: its batches and where they spawn.

The lattice recipe is frozen from ``egg_fluid_simulation_tpu_torch/bench.py``
(``build_handler``, commit e9e0aedb87f3): batches on a square lattice of
``lattice_side`` columns, ``spacing_radii`` white radii apart, the first
centre ``white_radius + margin_px`` from the origin. The seed moves each
centre by up to ``jitter_px`` in x and y; the sizes never change with it.
"""

from __future__ import annotations

import numpy as np

from . import seeds


def homes(scene: dict) -> np.ndarray:
    """(B, 2) float64 lattice centres, before the seed's jitter."""
    b = np.arange(scene["batches"])
    side = scene["lattice_side"]
    r = scene["white_radius"]
    spacing = scene["spacing_radii"] * r
    first = r + scene["margin_px"]
    return np.stack([(b % side) * spacing + first,
                     (b // side) * spacing + first], axis=1)


def centres(scene: dict, seed: int) -> np.ndarray:
    """(B, 2) float64 spawn centres of ``seed``."""
    j = scene["jitter_px"]
    shift = seeds.rng(seed, seeds.SCENE).uniform(-j, j, (scene["batches"], 2))
    return homes(scene) + shift


def batch_specs(scene: dict, seed: int) -> list:
    """The ``SimulationHandler.add_many`` specs of ``seed``, in add order."""
    r = float(scene["white_radius"])
    return [dict(x=float(x), y=float(y), white_radius=r,
                 yolk_radius=r * scene["yolk_radius_factor"],
                 white_n_particles=int(scene["white_n_particles"]),
                 yolk_n_particles=int(scene["yolk_n_particles"]))
            for x, y in centres(scene, seed)]


def particles(scene: dict) -> tuple:
    """(white, yolk) live particles of the scene."""
    b = scene["batches"]
    return b * scene["white_n_particles"], b * scene["yolk_n_particles"]
