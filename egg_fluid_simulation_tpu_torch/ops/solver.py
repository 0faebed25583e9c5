"""XPBD solver core: the dense engine's fused component-layout step.

The counterpart of ``egg_fluid_simulation_tpu/ops/solver.py`` on its main
path (``_population_step_dense``, fused branch), reference pipeline
``simulation_handler.lua:1324-1990``:

  per population, once per step: sort-bin into the torus cell planes
  (kernel A) -> per substep: n_collision_steps fused passes (kernel B; the
  first also integrates and applies the follow constraint) -> extract.

Positions live in an unpadded (2, G, L) tensor, the step-static pair fields
(W, R, BATCH, boost) in (4, G, L), the follow targets in (3, G, L).
Velocity is encoded by ``prev``: ``v = (x - prev) / sub_dt``. Particles
over the per-cell budget K integrate without collision (the fallback
substep), as reference particles past the 0.05 n^2 cutoff do (:1656-1658).

The two populations run as one Python loop. Everything dynamic (configs,
dt, the violence gate) stays in device tensors, so a step never waits on
the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from ..config import DeviceConfig, population_config
from ..state import ParticleState, StepStats
from ..utils.mathx import EPS, torch_mix
from . import dense as dense_ops
from .kernels import sweep_kernel

__all__ = ["SolverOptions", "step", "strength_to_compliance",
           "take_batch_rows", "batch_segment_sums", "wide_state_init"]

_BIG = 3.4e38


def _per_pop(v: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


@dataclass(frozen=True)
class SolverOptions:
    """Static solver configuration.

    Field names and meanings are the JAX package's, so one constructor call
    configures both packages. Only the dense engine's fused path is ported:
    ``engine="dense"``, ``budget_mode="off"``, ``dense_rebin="step"`` and
    ``cohesion_mode="spacing"`` are the only accepted values (they are the
    defaults here). ``dense_grid_dim`` / ``dense_slots`` / ``pop_caps`` take
    one int for both populations or a (white, yolk) tuple.
    """
    engine: str = "dense"
    budget_mode: str = "off"
    dense_rebin: str = "step"
    cohesion_mode: str = "spacing"
    dense_grid_dim: Union[int, Tuple[int, int]] = 512  # G per population
    dense_slots: Union[int, Tuple[int, int]] = 4       # K per population
    n_substeps: int = 2             # reference default, simulation_handler.lua:170
    n_collision_steps: int = 3      # reference default, :171
    pop_caps: Optional[Union[int, Tuple[int, int]]] = None  # per-pop particle
                                    # slice; each must be >= the live count
    wide_threshold_cells: float = 0.5  # violence gate: relative motion past
                                    # this fraction of a cell ...
    wide_tolerance: float = 0.02    # ... for more than this fraction of live
                                    # particles runs the next substep wide
    wide_budget_substeps: int = 240 # wide substeps per violent episode;
                                    # 0 disables the gate statically
    wide_rearm_substeps: int = 12   # calm substeps that end an episode
    occ_pressure_cap: float = 8.0   # occupancy-pressure boost cap

    def __post_init__(self):
        for name, only in (("engine", "dense"), ("budget_mode", "off"),
                           ("dense_rebin", "step"),
                           ("cohesion_mode", "spacing")):
            if getattr(self, name) != only:
                raise NotImplementedError(
                    f"SolverOptions.{name}={getattr(self, name)!r}: only "
                    f"{only!r} is ported to egg_fluid_simulation_tpu_torch")
        if self.n_collision_steps < 1:
            raise ValueError("n_collision_steps must be >= 1")
        object.__setattr__(self, "dense_grid_dim", _per_pop(self.dense_grid_dim))
        object.__setattr__(self, "dense_slots", _per_pop(self.dense_slots))
        if self.pop_caps is not None:
            object.__setattr__(self, "pop_caps", _per_pop(self.pop_caps))


def strength_to_compliance(strength, sub_dt):
    """XPBD compliance-per-substep, ``(1 - clamp(s)) / dt^2`` (reference :1337-1341)."""
    return (1.0 - torch.clamp(strength, 0.0, 1.0)) / (sub_dt * sub_dt)


def take_batch_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a small (B, C) per-batch table.

    An exact gather. (The JAX package forms it as a one-hot product of a
    bf16 hi/lo split, which keeps ~16 bits of each value; the two agree
    exactly on tables whose entries fit in 16 significant bits, e.g.
    integer pixel targets.)"""
    return table[idx.to(torch.int64)]


def batch_segment_sums(pos, active, batch_slot, max_batches: int):
    """Per-batch position sums + counts of active particles (``index_add_``)."""
    w = active.to(torch.float32)
    idx = batch_slot.to(torch.int64)
    sums = torch.zeros((max_batches, 2), dtype=torch.float32,
                       device=pos.device)
    sums.index_add_(0, idx, torch.where(active[:, None], pos, 0.0))
    counts = torch.zeros((max_batches,), dtype=torch.float32,
                         device=pos.device)
    counts.index_add_(0, idx, w)
    return sums, counts


def _follow_delta(x, y, inv_mass, apply_mask, tx, ty, td, compliance):
    """XPBD follow-constraint correction, shape-generic (reference :1435-1471).

    Returns (dx, dy) to add to positions; ``td`` is the ``2*sqrt(batch_radius)``
    dead-zone distance (:1789-1792)."""
    dx = tx - x
    dy = ty - y
    dist = torch.sqrt(dx * dx + dy * dy)
    inv_dist = torch.where(dist > EPS, 1.0 / torch.clamp(dist, min=EPS), 0.0)
    violation = dist - td
    delta_lambda = violation / (inv_mass + compliance)
    apply = apply_mask & (inv_mass > EPS) & (dist > td)
    scale = torch.where(apply, delta_lambda * inv_mass * inv_dist, 0.0)
    return dx * scale, dy * scale


def _dense_params(cfg: DeviceConfig, collision_compliance,
                  cohesion_compliance, options: SolverOptions):
    """Cell size + packed sweep params; the torus grid never coarsens."""
    max_factor = torch.maximum(cfg.collision_overlap_factor,
                               cfg.cohesion_interaction_distance_factor)
    cell_size = torch.clamp(cfg.max_radius * max_factor, min=1.0)  # :1756-1760
    params = dense_ops.SweepParams(
        collision_compliance=collision_compliance,
        cohesion_compliance=cohesion_compliance,
        collision_overlap_factor=cfg.collision_overlap_factor,
        cohesion_factor=cfg.cohesion_interaction_distance_factor,
        max_pairs=_BIG,
        cell_size=cell_size,
        occ_boost_cap=options.occ_pressure_cap)
    return cell_size, params


def _bin_components(p, v, inv_mass, radius, batch_slot, act, cell_size,
                    tx, ty, td, sub_dt, g: int, k: int, occ_cap: float = 8.0,
                    use_placement: bool = True):
    """Sort-bin directly into the fused component layout.

    ``prev`` starts at ``pos - sub_dt * vel`` so the first damped integration
    reproduces ``x + sub_dt * damp * vel`` to float rounding, and extraction
    derives the input velocity even when no substep ran. ``stat`` row 3
    holds the precomputed occupancy-pressure boost ``clip(count / k, 1,
    occ_cap)`` (0 = empty slot). ``use_placement=False`` takes the golden
    scatter binning instead of kernel A. Returns (xy, prev, stat, follow,
    slot)."""
    aux_cols = torch.stack([p[:, 0] - sub_dt * v[:, 0],
                            p[:, 1] - sub_dt * v[:, 1], tx, ty, td], dim=1)
    binning = dense_ops.bin_to_planes(
        p, inv_mass, radius, batch_slot, act, cell_size,
        grid_dim=g, slots_per_cell=k, aux_cols=aux_cols,
        use_placement=use_placement)
    rp = dense_ops.ROW_PAD
    core = binning.planes[:, rp:rp + g]
    a = binning.aux[:, rp:rp + g]
    occ = core[dense_ops.FIELD_OCC]
    boost = torch.where(occ > 0.0,
                        torch.clamp(occ * (1.0 / k), 1.0, max(occ_cap, 1.0)),
                        0.0)
    stat = torch.stack([core[dense_ops.FIELD_W], core[dense_ops.FIELD_R],
                        core[dense_ops.FIELD_BATCH], boost])
    return (core[:2].contiguous(), a[0:2].contiguous(), stat,
            a[2:5].contiguous(), binning.slot)


def _fused_run(xy, prev, stat, follow, params_packed, aux_packed, k: int,
               n_collision_steps: int, *, cohesion: bool, wide):
    """One substep in component layout: the integrating pass, then
    ``n_collision_steps - 1`` plain passes. ``wide`` is a bool (static
    window) or a 0-dim device tensor (the violence gate)."""
    kw = dict(cohesion=cohesion)
    if isinstance(wide, torch.Tensor):
        kw["wide"] = wide
    else:
        kw.update(window=3 if wide else 1, fresh_mask=bool(wide))
    xy, prev = sweep_kernel.substep_pass(xy, stat, params_packed, aux_packed,
                                         k, prev=prev, follow=follow,
                                         integrate=True, **kw)
    for _ in range(n_collision_steps - 1):
        xy = sweep_kernel.substep_pass(xy, stat, params_packed, aux_packed,
                                       k, **kw)
    return xy, prev


def _comp_extract(xy, prev, stat, slot, g: int, lanes: int, sub_dt):
    """Component-layout extraction — one gather, velocity derived exactly."""
    ext = torch.stack([xy[0], xy[1], prev[0], prev[1], stat[3]],
                      dim=-1).reshape(-1, 5)
    safe = torch.clamp(slot, max=g * lanes - 1)
    got = ext[safe]
    in_grid = (slot < g * lanes) & (got[:, 4] > 0.0)
    p = got[:, 0:2]
    pr = got[:, 2:4]
    return p, pr, (p - pr) / sub_dt, in_grid


def _comp_drift_over(xy, occ, ref_xy, thresh2):
    """Count of occupied slots whose drift RELATIVE to the population-mean
    displacement exceeds ``thresh2`` (uniform translation keeps every pair
    window valid; only differential motion invalidates it)."""
    occ01 = torch.clamp(occ, max=1.0)
    n_occ = torch.clamp(torch.sum(occ01), min=1.0)
    dxp = (xy[0] - ref_xy[0]) * occ01
    dyp = (xy[1] - ref_xy[1]) * occ01
    mx = torch.sum(dxp) / n_occ
    my = torch.sum(dyp) / n_occ
    rel2 = (dxp - mx * occ01) ** 2 + (dyp - my * occ01) ** 2
    return torch.sum(rel2 > thresh2), n_occ, torch.stack([mx, my])


def wide_state_init(options: SolverOptions, device="cpu"):
    """Fresh violence-episode state ``(trip, budget, calm)`` of the
    wide-sweep gate, as device tensors."""
    return (torch.tensor(False, device=device),
            torch.tensor(options.wide_budget_substeps, dtype=torch.int32,
                         device=device),
            torch.tensor(0, dtype=torch.int32, device=device))


def _fused_adaptive_run(xy, prev, stat, follow, fb_p, fb_prev, fb_v,
                        fallback_substep, act, cell_size, params_packed,
                        aux_packed, options: SolverOptions, k: int, n_sub: int,
                        *, cohesion: bool, wide=None):
    """Violence-gated substep runner: a substep whose relative motion tripped
    the drift metric runs the NEXT substep with window 3 + the fresh-cell
    mask, for up to ``wide_budget_substeps`` substeps per episode;
    ``wide_rearm_substeps`` calm substeps end the episode. The gate state
    ``(trip, budget, calm)`` stays on the device."""
    if wide is None:
        wide = wide_state_init(options, xy.device)
    if options.wide_budget_substeps == 0:
        for _ in range(n_sub):
            xy, prev = _fused_run(xy, prev, stat, follow, params_packed,
                                  aux_packed, k, options.n_collision_steps,
                                  cohesion=cohesion, wide=False)
            fb_p, fb_prev, fb_v = fallback_substep(fb_p, fb_v)
        return xy, prev, fb_p, fb_prev, fb_v, wide

    thresh2 = (options.wide_threshold_cells * cell_size) ** 2
    wide_tol = options.wide_tolerance
    n_live = torch.clamp(torch.sum(act), min=1)
    occ01 = torch.clamp(stat[3], max=1.0)
    n_occ = torch.clamp(torch.sum(occ01), min=1.0)
    # velocity-predicted first-substep trip: (x - prev) == vel * sub_dt
    pdx = (xy[0] - prev[0]) * occ01
    pdy = (xy[1] - prev[1]) * occ01
    mx = torch.sum(pdx) / n_occ
    my = torch.sum(pdy) / n_occ
    rel2 = (pdx - mx * occ01) ** 2 + (pdy - my * occ01) ** 2
    pred_trip = torch.sum(rel2 > thresh2) > wide_tol * n_live
    trip, budget, calm = wide
    trip = trip | pred_trip
    move_ref = xy
    for _ in range(n_sub):
        wide_now = trip & (budget > 0)
        xy, prev = _fused_run(xy, prev, stat, follow, params_packed,
                              aux_packed, k, options.n_collision_steps,
                              cohesion=cohesion, wide=wide_now)
        budget = torch.where(wide_now, budget - 1, budget)
        fb_p, fb_prev, fb_v = fallback_substep(fb_p, fb_v)
        n_over, _, _ = _comp_drift_over(xy, stat[3], move_ref, thresh2)
        move_ref = xy
        trip = n_over > wide_tol * n_live
        calm = torch.where(trip, 0, calm + 1).to(torch.int32)
        budget = torch.where(calm >= options.wide_rearm_substeps,
                             options.wide_budget_substeps, budget
                             ).to(torch.int32)
    return xy, prev, fb_p, fb_prev, fb_v, (trip, budget, calm)


def _population_step_dense(pos, vel, mass_t, batch_slot, act,
                           cfg: DeviceConfig, batch_target, follow_radius,
                           sub_dt, relaxation, options: SolverOptions,
                           g: int, k: int, wide_state=None):
    """Whole-step dense path of one population: one binning per step, all
    substeps in the fused component layout; budget-dropped particles fall
    back to integration without collision (reference :1656-1658)."""
    damp = 1.0 - torch.clamp(cfg.damping, 0.0, 1.0)         # :1768
    mass = torch_mix(cfg.min_mass, cfg.max_mass, mass_t)
    inv_mass = torch.where(act, 1.0 / torch.clamp(mass, min=1e-12), 0.0)
    radius = torch.where(act, torch_mix(cfg.min_radius, cfg.max_radius,
                                        mass_t), 0.0)

    follow_c = strength_to_compliance(cfg.follow_strength, sub_dt)
    collision_c = strength_to_compliance(cfg.collision_strength, sub_dt)
    cohesion_c = strength_to_compliance(cfg.cohesion_strength, sub_dt)
    cell_size, params = _dense_params(cfg, collision_c, cohesion_c, options)

    # follow target per particle, once per step (static within a step)
    table = torch.cat([batch_target, follow_radius[:, None]], dim=1)
    rows3 = take_batch_rows(table, batch_slot)
    tx, ty, td = rows3[:, 0], rows3[:, 1], 2.0 * rows3[:, 2]

    def fallback_substep(p, v):
        """One pre-solve + follow substep in particle layout (no collision)."""
        v = v * damp
        prev = p
        p = p + sub_dt * v
        fdx, fdy = _follow_delta(p[:, 0], p[:, 1], inv_mass, act,
                                 tx, ty, td, follow_c)
        p = p + torch.stack([fdx, fdy], dim=1)
        return p, prev, (p - prev) / sub_dt

    lanes = g * k
    xy, prev_c, stat_c, follow3, slot = _bin_components(
        pos, vel, inv_mass, radius, batch_slot, act, cell_size,
        tx, ty, td, sub_dt, g, k, occ_cap=options.occ_pressure_cap)
    params_packed = params.pack(pos.device)
    aux_packed = torch.stack([damp, follow_c,
                              torch.as_tensor(relaxation, dtype=torch.float32,
                                              device=pos.device),
                              torch.zeros((), device=pos.device)])
    xy, prev_c, fb_p, fb_prev, fb_v, ws = _fused_adaptive_run(
        xy, prev_c, stat_c, follow3, pos, pos, vel, fallback_substep, act,
        cell_size, params_packed, aux_packed, options, k,
        options.n_substeps, cohesion=options.cohesion_mode == "spacing",
        wide=wide_state)
    p_pl, prev_pl, v_pl, in_grid = _comp_extract(xy, prev_c, stat_c, slot, g,
                                                 lanes, sub_dt)
    sel = (in_grid & act)[:, None]
    keep = act[:, None]
    new_pos = torch.where(sel, p_pl, torch.where(keep, fb_p, pos))
    new_prev = torch.where(sel, prev_pl, torch.where(keep, fb_prev, pos))
    new_vel = torch.where(sel, v_pl, torch.where(keep, fb_v, vel))
    return new_pos, new_prev, new_vel, inv_mass, radius, ws


def _aabb(pos, radius, active):
    """Radius-inclusive AABB over active particles (reference :1703-1709)."""
    lo = torch.amin(torch.where(active[:, None], pos - radius[:, None], _BIG),
                    dim=0)
    hi = torch.amax(torch.where(active[:, None], pos + radius[:, None], -_BIG),
                    dim=0)
    return lo, hi


def _step_impl(state: ParticleState, cfg2: DeviceConfig, step_delta,
               relaxation, options: SolverOptions, with_stats: bool = True,
               wide_state=None):
    """Returns ``(state, stats)``, or ``(state, stats, wide_state_out)`` when
    ``wide_state`` (per-population episode tuples) is passed."""
    dev = state.device
    thread_wide = wide_state is not None
    ws_out = [None, None]
    step_delta = torch.as_tensor(step_delta, dtype=torch.float32, device=dev)
    sub_dt = torch.clamp(step_delta / options.n_substeps, min=EPS)  # :1723
    capacity = state.capacity
    caps = options.pop_caps or (capacity, capacity)
    caps = tuple(min(c, capacity) for c in caps)
    active_full = state.active_mask()
    max_batches = state.max_batches

    # pre-step positions + centroid for frame interpolation (:1795-1818)
    last_pos = state.pos
    if with_stats:
        n_act = torch.clamp(torch.sum(active_full, dim=1), min=1)
        last_centroid = (torch.sum(torch.where(active_full[..., None],
                                               state.pos, 0.0), dim=1)
                         / n_act[:, None])

    follow_radius = torch.sqrt(torch.clamp(state.batch_radius, min=0.0))

    new_pos, new_prev, new_vel = (state.pos.clone(), state.prev.clone(),
                                  state.vel.clone())
    new_inv, new_rad = state.inv_mass.clone(), state.radius.clone()
    stat_outs = []
    for i in range(2):
        cap = caps[i]
        act = active_full[i, :cap]
        pos, prev, vel, inv_mass, radius, ws_out[i] = _population_step_dense(
            state.pos[i, :cap], state.vel[i, :cap], state.mass_t[i, :cap],
            state.batch_slot[i, :cap], act, population_config(cfg2, i),
            state.batch_target, follow_radius[i], sub_dt, relaxation,
            options, options.dense_grid_dim[i], options.dense_slots[i],
            wide_state=wide_state[i] if thread_wide else None)

        if with_stats:
            n_a = torch.clamp(torch.sum(act), min=1)
            centroid = torch.sum(torch.where(act[:, None], pos, 0.0),
                                 dim=0) / n_a
            speed2 = torch.sum(vel * vel, dim=-1)
            max_vel = torch.sqrt(torch.max(torch.where(act, speed2, 0.0)))
            batch_sum, batch_count = batch_segment_sums(
                pos, act, state.batch_slot[i, :cap], max_batches)
            lo, hi = _aabb(pos, radius, act)
            mrad = torch.max(torch.where(act, radius, 0.0))
            stat_outs.append((centroid, max_vel, batch_sum, batch_count,
                              lo, hi, mrad))

        new_pos[i, :cap] = pos
        new_prev[i, :cap] = prev
        new_vel[i, :cap] = vel
        new_inv[i, :cap] = inv_mass
        new_rad[i, :cap] = radius

    new_state = state.replace(pos=new_pos, prev=new_prev, vel=new_vel,
                              inv_mass=new_inv, radius=new_rad,
                              last_pos=last_pos)
    if not with_stats:
        return (new_state, None, tuple(ws_out)) if thread_wide \
            else (new_state, None)

    centroid, max_vel, batch_sum, batch_count, lo, hi, mrad = (
        torch.stack(xs) for xs in zip(*stat_outs))
    stats = StepStats(
        aabb_min=lo, aabb_max=hi, centroid=centroid,
        last_centroid=last_centroid, max_radius=torch.clamp(mrad, min=1.0),
        max_velocity=max_vel, batch_pos_sum=batch_sum,
        batch_count=batch_count)
    if thread_wide:
        return new_state, stats, tuple(ws_out)
    return new_state, stats


@torch.no_grad()
def step(state: ParticleState, cfg2: DeviceConfig, step_delta, relaxation,
         options: SolverOptions, wide_state=None):
    """One fixed step: both populations, all substeps (reference ``_step``
    :1722-1989). ``cfg2`` is a (2,)-leading :class:`DeviceConfig`.

    Returns ``(state, stats)``; with ``wide_state`` (per-population episode
    tuples, see :func:`wide_state_init`) it returns ``(state, stats,
    wide_state_out)``, so per-tick callers keep the episode budget."""
    return _step_impl(state, cfg2, step_delta, relaxation, options,
                      wide_state=wide_state)
