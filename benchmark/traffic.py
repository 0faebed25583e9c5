"""The one generator of every traffic mix: it reads a mix's parameters
(``traffic/<name>.json``) and gives the calls of each unit of work.

Two kinds of mix. ``frames``: an interactive app's loop, a closed loop with
one client; each frame sets every batch's target (where ``moving_targets``),
calls ``update(frame_dt_s)`` and ``draw(viewport)`` and waits for the device.
``headless``: offline fast-forward, ``run_steps(steps_per_call)`` calls back
to back, each followed by a wait for the device.

Moving targets follow the upstream demo (``test.lua:223-262``, mirrored in
``egg_fluid_simulation_tpu/demo.py``'s ``regenerate_path`` and ``update``):
one point runs along a closed regular polygon at ``path_speed_px_s``, and
every batch's target is that one shared point, set before each ``update``.
The polygon is centred on the viewport, its vertices
``path_radius_of_viewport`` (the demo's 1 / 2.5) of the viewport's side from
the centre; the seed draws its vertex count between ``path_vertices_min``
and ``path_vertices_max`` (the demo's 3 and 7) and its angular offset. The
point starts at the first vertex at the spawn and moves by arc length, as
the demo's reparameterized ``Path`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import manifest, seeds

KINDS = ("frames", "headless")


@dataclass(frozen=True)
class Mix:
    name: str
    params: dict

    @property
    def kind(self) -> str:
        return self.params["kind"]

    def __getitem__(self, key):
        return self.params[key]


def load(name: str) -> Mix:
    params = manifest.traffic(name)
    if params.get("kind") not in KINDS:
        raise ValueError(f"traffic {name!r}: kind must be one of {KINDS}")
    return Mix(name, params)


class TargetPath:
    """The moving point of a ``frames`` mix with ``moving_targets``, about
    ``centre`` in a square viewport of side ``viewport_px``."""

    def __init__(self, mix: Mix, seed: int, centre, viewport_px: float):
        rng = seeds.rng(seed, seeds.TRAFFIC)
        n = int(rng.integers(mix["path_vertices_min"],
                             mix["path_vertices_max"] + 1))
        offset = rng.uniform(0.0, 2.0 * np.pi)
        r = mix["path_radius_of_viewport"] * viewport_px
        angles = offset + 2.0 * np.pi * np.arange(n) / n
        verts = np.asarray(centre, np.float64) + r * np.stack(
            [np.cos(angles), np.sin(angles)], 1)
        self.verts = np.concatenate([verts, verts[:1]])          # closed
        edges = np.linalg.norm(np.diff(self.verts, axis=0), axis=1)
        self.cum = np.concatenate([[0.0], np.cumsum(edges)])
        self.length = float(self.cum[-1])
        self.speed = float(mix["path_speed_px_s"])
        self.frame_dt = float(mix["frame_dt_s"])

    def point(self, frame: int) -> np.ndarray:
        """(2,) float64 position of the point at the start of ``frame``."""
        s = (self.speed * self.frame_dt * frame) % self.length
        i = min(int(np.searchsorted(self.cum, s, side="right")) - 1,
                len(self.cum) - 2)
        t = (s - self.cum[i]) / (self.cum[i + 1] - self.cum[i])
        return self.verts[i] + t * (self.verts[i + 1] - self.verts[i])


def targets(mix: Mix, centres: np.ndarray, seed: int, viewport_px: float):
    """``frame -> (B, 2) float64`` targets of every batch, or None where
    the mix leaves the targets at the spawn centres. The viewport is
    centred on the spawn centres' mean, as the frames cells draw it."""
    if mix.kind != "frames" or not mix.params.get("moving_targets"):
        return None
    path = TargetPath(mix, seed, centres.mean(axis=0), viewport_px)
    ones = np.ones((len(centres), 1))
    return lambda frame: ones * path.point(frame)
