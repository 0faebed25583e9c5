# Frozen copy of egg_fluid_simulation_tpu_torch/ops/solver.py at commit e9e0aedb87f3: the port's plain
# PyTorch path, kept as the benchmark's reference, trimmed to the gather
# engine's step (``solver.py`` beside it keeps the dense engine and calls
# :func:`population_step` for ``engine="gather"``).
"""XPBD solver core: the gather engine's step of one population.

The counterpart of ``egg_fluid_simulation_tpu/ops/solver.py``, reference
pipeline ``simulation_handler.lua:1324-1990``, as the handler's automatic
options run it below capacity 16384 (``engine="gather"``, the ordered
budget): per substep, in particle layout, pre-solve (damped integration),
the follow constraint, then ``n_collision_steps`` passes, each a fresh hash
grid and one Jacobi pair pass (kernel H's plain versions,
``kernels/gather_kernel.py``), then the true-velocity update. The per-pass
dense route and ``post_solve`` (no step calls it) are left out of this
copy.
"""

from __future__ import annotations

import torch

from ..config import DeviceConfig
from ..utils.mathx import torch_mix
from . import hash_grid
from . import solver as S
from .kernels import gather_kernel

__all__ = ["pre_solve", "solve_follow", "solve_pairs", "substep",
           "population_step"]


def pre_solve(pos, prev, vel, mass_t, active, cfg: DeviceConfig, sub_dt):
    """Damped velocity integration + mass/radius derivation (reference
    :1393-1432)."""
    damping_mult = 1.0 - torch.clamp(cfg.damping, 0.0, 1.0)  # :1768
    new_vel = vel * damping_mult
    new_pos = pos + sub_dt * new_vel
    mass = torch_mix(cfg.min_mass, cfg.max_mass, mass_t)
    inv_mass = 1.0 / torch.clamp(mass, min=1e-12)
    radius = torch_mix(cfg.min_radius, cfg.max_radius, mass_t)
    keep = active[:, None]
    return (torch.where(keep, new_pos, pos), torch.where(keep, pos, prev),
            torch.where(keep, new_vel, vel), torch.where(active, inv_mass, 0.0),
            torch.where(active, radius, 0.0))


def solve_follow(pos, inv_mass, batch_slot, active, batch_target,
                 follow_radius, compliance):
    """Pull particles toward their batch target (reference :1435-1471);
    ``follow_radius`` is ``sqrt(batch_radius)`` per slot, a ``2*sqrt(r)`` px
    dead zone (:1789-1792)."""
    table = torch.cat([batch_target, follow_radius[:, None]], dim=1)
    rows = S.take_batch_rows(table, batch_slot)
    dx, dy = S._follow_delta(pos[:, 0], pos[:, 1], inv_mass, active,
                             rows[:, 0], rows[:, 1], 2.0 * rows[:, 2],
                             compliance)
    return pos + torch.stack([dx, dy], dim=1)


def _max_pairs(active):
    """The reference's ordered collision budget, ``0.05 * n_live^2``
    examined pairs a pass (:1749-1753), as a 0-dim float32 tensor."""
    n_live = torch.sum(active).to(torch.float32)
    return 0.05 * n_live * n_live


def solve_pairs(pos, inv_mass, radius, batch_slot, active, cfg: DeviceConfig,
                collision_compliance, cohesion_compliance, relaxation,
                options: S.SolverOptions):
    """One grid rebuild + Jacobi pair projection pass (the gather engine).

    Vectorized ``_rebuild_spatial_hash`` + ``_solve_collision`` (reference
    :1486-1511, :1548-1666) with ``_enforce_distance``'s symmetric
    projection (:1514-1545): correction ``-(dist - target) / (w_a + w_b +
    alpha)`` clamped to +-|violation|, each endpoint moving by its
    inverse-mass share. The front writes each particle's record and bucket,
    the slot table's sort, rank and scatter follow (``hash_grid.slot_table``),
    and the count and the sweep read the record."""
    max_factor = torch.maximum(cfg.collision_overlap_factor,
                               cfg.cohesion_interaction_distance_factor)
    cell_size = torch.clamp(cfg.max_radius * max_factor, min=1.0)  # :1756-1760
    record, bucket = gather_kernel.gather_front(
        pos, inv_mass, radius, batch_slot, active, cell_size,
        options.table_size)
    table = hash_grid.slot_table(bucket, options.table_size,
                                 options.slots_per_cell)
    grid = hash_grid.CellGrid(table=table,
                              cell_xy=gather_kernel.record_cells(record),
                              table_size=options.table_size)
    cum = max_pairs = None
    if options.budget_mode == "ordered":
        new_pairs = gather_kernel.gather_count(record, grid)
        cum = torch.cumsum(new_pairs, 0) - new_pairs
        max_pairs = _max_pairs(active)
    return gather_kernel.gather_sweep(
        record, grid, cum, max_pairs, collision_compliance,
        cohesion_compliance, cfg.collision_overlap_factor,
        cfg.cohesion_interaction_distance_factor, relaxation,
        spacing=options.cohesion_mode == "spacing",
        pair_chunk=options.pair_chunk)


def substep(pos, prev, vel, inv_mass, radius, mass_t, batch_slot, active,
            cfg: DeviceConfig, batch_target, follow_radius, sub_dt,
            relaxation, options: S.SolverOptions):
    """One solver substep of one population in particle layout (reference
    :1821-1932) on the gather engine."""
    follow_c = S.strength_to_compliance(cfg.follow_strength, sub_dt)
    collision_c = S.strength_to_compliance(cfg.collision_strength, sub_dt)
    cohesion_c = S.strength_to_compliance(cfg.cohesion_strength, sub_dt)
    pos, prev, vel, inv_mass, radius = pre_solve(pos, prev, vel, mass_t,
                                                 active, cfg, sub_dt)
    pos = solve_follow(pos, inv_mass, batch_slot, active, batch_target,
                       follow_radius, follow_c)
    for _ in range(options.n_collision_steps):
        pos = solve_pairs(pos, inv_mass, radius, batch_slot, active, cfg,
                          collision_c, cohesion_c, relaxation, options)
    # true-velocity update (:1690-1693); the step takes the aggregates once
    vel = torch.where(active[:, None], (pos - prev) / sub_dt, 0.0)
    return pos, prev, vel, inv_mass, radius


def population_step(state, i: int, cap: int, act, cfg: DeviceConfig,
                    follow_radius, sub_dt, relaxation,
                    options: S.SolverOptions):
    """``_step_impl``'s loop of substeps for population ``i`` (its first
    ``cap`` rows, ``act`` live) on the gather engine, which has no wide
    machinery: ``(pos, prev, vel, inv_mass, radius)``."""
    pos, prev, vel = (state.pos[i, :cap], state.prev[i, :cap],
                      state.vel[i, :cap])
    inv_mass, radius = state.inv_mass[i, :cap], state.radius[i, :cap]
    for _ in range(options.n_substeps):
        pos, prev, vel, inv_mass, radius = substep(
            pos, prev, vel, inv_mass, radius, state.mass_t[i, :cap],
            state.batch_slot[i, :cap], act, cfg, state.batch_target,
            follow_radius[i], sub_dt, relaxation, options)
    return pos, prev, vel, inv_mass, radius
