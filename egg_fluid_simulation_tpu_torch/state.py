"""Fixed-capacity SoA particle state on the simulation device.

Same fields, shapes and dtypes as ``egg_fluid_simulation_tpu/state.py``: a
leading population axis of size 2 (0 = white, 1 = yolk) over
fixed-capacity arrays, so a checkpoint or a host view moves between the two
packages field for field (see :mod:`.interop`).

``count`` (2,) holds the number of live particles per population; live
particles always occupy the prefix ``[0, count)``.

``StepStats`` mirrors the per-step "environment" the reference rebuilds
every ``_step`` (simulation_handler.lua:1344-1390): AABB, centroid, last
centroid, max radius/velocity, per-batch position sums.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

__all__ = ["ParticleState", "StepStats", "zeros_state", "zeros_stats",
           "host_view", "WHITE", "YOLK", "PARTICLE_FIELDS"]

N_POPULATIONS = 2  # white, yolk
WHITE, YOLK = 0, 1
# the per-particle fields (a particle axis after the population axis); the
# others are per population or per batch
PARTICLE_FIELDS = ("pos", "prev", "vel", "last_pos", "radius", "mass_t",
                   "inv_mass", "batch_slot", "color")


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

    def batch_centroid(self, slot) -> torch.Tensor:
        """Combined white+yolk centroid of a batch slot (reference :1134-1148)."""
        total = self.batch_count[0, slot] + self.batch_count[1, slot]
        s = self.batch_pos_sum[0, slot] + self.batch_pos_sum[1, slot]
        return s / torch.clamp(total, min=1.0)


def zeros_state(capacity: int, max_batches: int, device="cpu") -> ParticleState:
    f32 = dict(dtype=torch.float32, device=device)
    n2 = (N_POPULATIONS, capacity, 2)
    n1 = (N_POPULATIONS, capacity)
    return ParticleState(
        pos=torch.zeros(n2, **f32),
        prev=torch.zeros(n2, **f32),
        vel=torch.zeros(n2, **f32),
        last_pos=torch.zeros(n2, **f32),
        radius=torch.zeros(n1, **f32),
        mass_t=torch.zeros(n1, **f32),
        inv_mass=torch.ones(n1, **f32),
        batch_slot=torch.zeros(n1, dtype=torch.int32, device=device),
        color=torch.ones((N_POPULATIONS, capacity, 4), **f32),
        count=torch.zeros((N_POPULATIONS,), dtype=torch.int32, device=device),
        batch_target=torch.zeros((max_batches, 2), **f32),
        batch_radius=torch.ones((N_POPULATIONS, max_batches), **f32),
        batch_used=torch.zeros((max_batches,), dtype=torch.bool, device=device),
    )


def zeros_stats(max_batches: int, device="cpu") -> StepStats:
    f32 = dict(dtype=torch.float32, device=device)
    return StepStats(
        aabb_min=torch.zeros((N_POPULATIONS, 2), **f32),
        aabb_max=torch.zeros((N_POPULATIONS, 2), **f32),
        centroid=torch.zeros((N_POPULATIONS, 2), **f32),
        last_centroid=torch.zeros((N_POPULATIONS, 2), **f32),
        max_radius=torch.ones((N_POPULATIONS,), **f32),
        max_velocity=torch.zeros((N_POPULATIONS,), **f32),
        batch_pos_sum=torch.zeros((N_POPULATIONS, max_batches, 2), **f32),
        batch_count=torch.zeros((N_POPULATIONS, max_batches), **f32),
    )


def host_view(state: ParticleState) -> dict:
    """The full state as host numpy arrays, keyed like the JAX package's
    ``state.host_view``."""
    return {f.name: getattr(state, f.name).cpu().numpy()
            for f in fields(ParticleState)}
