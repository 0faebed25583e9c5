# Frozen copy of egg_fluid_simulation_tpu_torch/state.py at commit e9e0aedb87f3: the port's plain
# PyTorch path, kept as the benchmark's reference, trimmed to what the
# cells run.
"""Fixed-capacity SoA particle state on the simulation device.

Same fields, shapes and dtypes as ``egg_fluid_simulation_tpu/state.py``: a
leading population axis of size 2 (0 = white, 1 = yolk) over
fixed-capacity arrays.

``count`` (2,) holds the number of live particles per population; live
particles always occupy the prefix ``[0, count)``.

``StepStats`` mirrors the per-step "environment" the reference rebuilds
every ``_step`` (simulation_handler.lua:1344-1390): AABB, centroid, last
centroid, max radius/velocity, per-batch position sums.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

__all__ = ["ParticleState", "StepStats", "WHITE", "YOLK"]

N_POPULATIONS = 2  # white, yolk
WHITE, YOLK = 0, 1


@dataclass(frozen=True)
class ParticleState:
    pos: torch.Tensor          # (2, N, 2) f32
    prev: torch.Tensor         # (2, N, 2) f32
    vel: torch.Tensor          # (2, N, 2) f32
    last_pos: torch.Tensor     # (2, N, 2) f32  position at start of last whole step
    radius: torch.Tensor       # (2, N)    f32
    mass_t: torch.Tensor       # (2, N)    f32  mass-distribution interpolant
    inv_mass: torch.Tensor     # (2, N)    f32
    batch_slot: torch.Tensor   # (2, N)    i32
    color: torch.Tensor        # (2, N, 4) f32
    count: torch.Tensor        # (2,)      i32  live particles per population
    batch_target: torch.Tensor  # (B, 2)   f32  follow target per batch slot
    batch_radius: torch.Tensor  # (2, B)   f32  white/yolk egg radius per batch slot
    batch_used: torch.Tensor    # (B,)     bool

    @property
    def capacity(self) -> int:
        return self.pos.shape[1]

    @property
    def max_batches(self) -> int:
        return self.batch_target.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def active_mask(self) -> torch.Tensor:
        """(2, N) bool — particle slots below the live count."""
        idx = torch.arange(self.capacity, dtype=torch.int32,
                           device=self.device)[None, :]
        return idx < self.count[:, None]

    def replace(self, **kw) -> "ParticleState":
        return replace(self, **kw)


@dataclass(frozen=True)
class StepStats:
    """Per-population aggregates produced by each step (env analog, :1344-1390)."""
    aabb_min: torch.Tensor        # (2, 2) f32
    aabb_max: torch.Tensor        # (2, 2) f32
    centroid: torch.Tensor        # (2, 2) f32
    last_centroid: torch.Tensor   # (2, 2) f32 centroid at start of step (frame interp)
    max_radius: torch.Tensor      # (2,)   f32
    max_velocity: torch.Tensor    # (2,)   f32
    batch_pos_sum: torch.Tensor   # (2, B, 2) f32  per-batch position sums
    batch_count: torch.Tensor     # (2, B) f32     per-batch particle counts


