"""XPBD solver core: the gather engine and the dense engine.

The counterpart of ``egg_fluid_simulation_tpu/ops/solver.py``, reference
pipeline ``simulation_handler.lua:1324-1990``. The gather engine
(``engine="gather"``, the default, and the handler's choice below capacity
16384) runs the particle-layout :func:`substep` with a fresh hash grid and
an exact candidate sweep per collision pass (:func:`solve_pairs`: the grid
in PyTorch, the ordered budget's count and the sweep in kernel H, where
the JAX package's pass is plain XLA). The dense engine has three routes,
chosen by :class:`SolverOptions` as in the JAX package:

- the fused component path (``budget_mode="off"``, ``dense_rebin="step"``,
  the handler's automatic options): per population, once per step,
  sort-bin into the torus cell planes (kernel A) -> per substep:
  ``n_collision_steps`` fused passes (kernel B; the first also integrates
  and applies the follow constraint) -> extract;
- the plane-resident path (the ordered budget, the symmetric sweep, or
  ``dense_rebin="substep"``): bin into halo-padded planes (with the ordered
  budget's examined-pair prefix, kernel F) -> per substep: integration and
  follow in plane layout, then ``n_collision_steps`` sweeps (kernel D, or E
  when symmetric) whose corrections apply in place -> extract;
- the per-pass route (``dense_rebin="pass"``): the particle-layout
  ``substep`` with a fresh binning and sweep per collision pass.

Velocity is encoded by ``prev`` on the fused path (``v = (x - prev) /
sub_dt``). Particles over the per-cell budget K integrate without collision
(the fallback substep), as reference particles past the 0.05 n^2 cutoff do
(:1656-1658).

The two populations run as one Python loop. Everything dynamic (configs,
dt, the violence gate) stays in device tensors, so a step never waits on
the device: a CUDA handler captures :func:`step` once in a CUDA graph and
replays it (``ops/step_graph.py``).

Multi-step residency (:func:`multi_step`, :func:`multi_step_frames`) keeps
the binned layout across steps and rebins only when the drift since bin
time passes a quarter cell for more than ``rebin_tolerance`` of the live
particles. Run eagerly, that decision is a branch on the host: it costs
one device-to-host read per population per resident step, counted in
``host_syncs``; ``rebins`` counts the rebins per population. Replayed
(``ops/resident_graph.py``), it is an IF node taken on the card.
"""

from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from ..config import DeviceConfig, population_config
from ..state import ParticleState, StepStats
from ..utils.mathx import EPS, torch_mix
from . import dense as dense_ops
from . import grid as grid_ops
from .kernels import gather_kernel, sweep_kernel

__all__ = ["SolverOptions", "step", "multi_step", "multi_step_frames",
           "substep", "pre_solve", "solve_follow", "solve_pairs",
           "solve_pairs_dense", "post_solve",
           "strength_to_compliance", "take_batch_rows", "batch_segment_sums",
           "wide_state_init", "multi_step_is_loop", "host_syncs", "rebins"]

host_syncs = 0      # device-to-host reads of the resident rebin flag
rebins = [0, 0]     # resident rebins per population (white, yolk)

_BIG = 3.4e38

# aux plane field layout (ride-along fields of the plane-resident step)
AUX_PX = 0   # previous x (start of the current substep)
AUX_PY = 1
AUX_VX = 2   # velocity
AUX_VY = 3
AUX_TX = 4   # follow target x (static within a step)
AUX_TY = 5
AUX_TD = 6   # follow dead-zone distance (2 * sqrt(batch_radius))


def _per_pop(v: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


@dataclass(frozen=True)
class SolverOptions:
    """Static solver configuration.

    Field names, order, meanings, defaults and checks are the JAX package's,
    so one constructor call configures both packages. ``use_pallas`` is
    accepted and has no effect (see the field). ``dense_grid_dim`` /
    ``dense_slots`` / ``pop_caps`` take one int for both populations or a
    (white, yolk) tuple.
    """
    table_size: int = 1 << 14       # gather engine: grid buckets, power of two
    slots_per_cell: int = 16        # gather engine: K, per-cell capacity cap
    cohesion_mode: str = "spacing"  # "spacing" (documented intent) | "literal"
    budget_mode: str = "ordered"    # "ordered" (reference 0.05 n^2 cutoff) | "off"
    pair_chunk: int = 1 << 15       # gather engine: particles a sweep chunk
                                    # (caps the (chunk, 9K, 6) gathered block)
    engine: str = "gather"          # "gather" (exact, small N) | "dense" (big N)
    dense_grid_dim: Union[int, Tuple[int, int]] = 512  # dense: G per population
    dense_slots: Union[int, Tuple[int, int]] = 4       # dense: K per population
    use_pallas: bool = True         # accepted for the JAX package's calls and
                                    # ignored: the tensors' device decides
                                    # (CUDA: the hand-written kernels; CPU:
                                    # their plain versions)
    dense_rebin: str = "step"       # "step" (one binning per step) |
                                    # "substep" (per substep) | "pass" (per
                                    # collision pass, strict)
    n_substeps: int = 2             # reference default, simulation_handler.lua:170
    n_collision_steps: int = 3      # reference default, :171; 0 runs no pass
    pop_caps: Optional[Union[int, Tuple[int, int]]] = None  # per-pop particle
                                    # slice; each must be >= the live count
    adaptive_rebin: bool = True     # multi_step: keep the binned layout
                                    # across steps, rebinning only when the
                                    # drift since bin time passes cell/4
    rebin_tolerance: float = 1e-3   # fraction of live particles allowed past
                                    # that drift before a rebin (0.0 = strict)
    wide_threshold_cells: float = 0.5  # violence gate: relative motion past
                                    # this fraction of a cell ...
    wide_tolerance: float = 0.02    # ... for more than this fraction of live
                                    # particles runs the next substep wide
    wide_budget_substeps: int = 240 # wide substeps per violent episode;
                                    # 0 disables the gate statically
    wide_rearm_substeps: int = 12   # calm substeps that end an episode
    occ_pressure_cap: float = 8.0   # occupancy-pressure boost cap
    sweep_symmetric: bool = False   # plane sweeps evaluate each unordered
                                    # pair once (kernel E)
    stale_hash_compat: bool = False # the reference's substep-stale pair set:
                                    # substeps after a step's first run one
                                    # collision pass fewer (reference
                                    # :1905-1912); dense engine only

    def __post_init__(self):
        for name, allowed in (("engine", ("gather", "dense")),
                              ("budget_mode", ("ordered", "off")),
                              ("dense_rebin", ("step", "substep", "pass")),
                              ("cohesion_mode", ("spacing", "literal"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"SolverOptions.{name}="
                                 f"{getattr(self, name)!r}: expected one of "
                                 f"{allowed}")
        if self.table_size < 1 or self.table_size & (self.table_size - 1):
            raise ValueError(f"SolverOptions.table_size={self.table_size}: "
                             f"must be a power of two")
        if self.stale_hash_compat and self.engine != "dense":
            raise ValueError("SolverOptions.stale_hash_compat emulates the "
                             "reference's substep-stale pair set on the dense "
                             "engine's frozen-membership passes: it needs "
                             "engine='dense'")
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


def _dense_params(cfg: DeviceConfig, active, collision_compliance,
                  cohesion_compliance, options: SolverOptions):
    """Cell size + sweep params; the torus grid never coarsens. Under the
    ordered budget ``max_pairs`` is the reference's 0.05 n_live^2 examined-
    pair cutoff (:1749-1753)."""
    max_factor = torch.maximum(cfg.collision_overlap_factor,
                               cfg.cohesion_interaction_distance_factor)
    cell_size = torch.clamp(cfg.max_radius * max_factor, min=1.0)  # :1756-1760
    if options.budget_mode == "ordered":
        max_pairs = _max_pairs(active)
    else:
        max_pairs = _BIG
    params = dense_ops.SweepParams(
        collision_compliance=collision_compliance,
        cohesion_compliance=cohesion_compliance,
        collision_overlap_factor=cfg.collision_overlap_factor,
        cohesion_factor=cfg.cohesion_interaction_distance_factor,
        max_pairs=max_pairs,
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
        use_placement=use_placement, rotate=True)
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
               options: SolverOptions, *, cohesion: bool, wide,
               first_substep: bool = True):
    """One substep in component layout: the integrating pass, then the plain
    passes. ``wide`` is a bool (static window) or a 0-dim device tensor (the
    violence gate). With ``options.stale_hash_compat`` a substep that is not
    the step's first runs one collision pass fewer (the reference's
    substep-stale pair set, :1905-1912)."""
    n_passes = options.n_collision_steps
    if options.stale_hash_compat and not first_substep:
        n_passes -= 1
    kw = dict(cohesion=cohesion)
    if isinstance(wide, torch.Tensor):
        kw["wide"] = wide
    else:
        kw.update(window=3 if wide else 1, fresh_mask=bool(wide))
    xy, prev = sweep_kernel.substep_pass(xy, stat, params_packed, aux_packed,
                                         k, prev=prev, follow=follow,
                                         integrate=True, **kw)
    for _ in range(n_passes - 1):
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


def drift_rel2(disp, occ):
    """Per slot, the squared displacement ``disp`` (2, G, L) RELATIVE to
    the population-mean displacement (uniform translation keeps every pair
    window valid; only differential motion invalidates it), 0 on empty
    slots, and the (2,) mean over the occupied slots (``occ`` > 0)."""
    occ01 = torch.clamp(occ, max=1.0)
    n_occ = torch.clamp(torch.sum(occ01), min=1.0)
    dxp = disp[0] * occ01
    dyp = disp[1] * occ01
    mx = torch.sum(dxp) / n_occ
    my = torch.sum(dyp) / n_occ
    rel2 = (dxp - mx * occ01) ** 2 + (dyp - my * occ01) ** 2
    return rel2, torch.stack([mx, my])


def _drift_over(disp, occ, thresh2):
    """Drift metric of the binned layout (JAX ``_comp_drift_over`` and, on
    the real rows of the planes, ``_plane_drift_over``): the count of
    occupied slots whose relative squared displacement (:func:`drift_rel2`)
    exceeds ``thresh2``, and the (2,) mean displacement."""
    rel2, mean = drift_rel2(disp, occ)
    return torch.sum(rel2 > thresh2), mean


def wide_thresh2(options: SolverOptions, cell_size):
    """The violence gate's threshold on a slot's squared relative
    displacement in a substep: ``(wide_threshold_cells * cell)^2``."""
    return (options.wide_threshold_cells * cell_size) ** 2


def drift_thresh2(cell_size):
    """The resident loop's rebin threshold on a slot's squared relative
    drift since bin time: a quarter cell, squared."""
    return (0.25 * cell_size) ** 2


def wide_state_init(options: SolverOptions, device="cpu"):
    """Fresh violence-episode state ``(trip, budget, calm)`` of the
    wide-sweep gate, as device tensors (fills, not copies from the host: a
    CUDA graph can capture them)."""
    return (torch.zeros((), dtype=torch.bool, device=device),
            torch.full((), options.wide_budget_substeps, dtype=torch.int32,
                       device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def _no_record(event: str, s: int, **values) -> None:
    pass


def _gated_substeps(run, positions, occ, pred_disp, fb, fallback_substep,
                    act, cell_size, options: SolverOptions, n_sub: int,
                    wide=None, record=None):
    """``n_sub`` substeps under the violence gate of the wide sweep.

    A substep whose relative motion tripped the drift metric runs the NEXT
    substep with window 3 + the fresh-cell mask, for up to
    ``wide_budget_substeps`` substeps per episode; ``wide_rearm_substeps``
    calm substeps end the episode. The first substep is widened too when the
    velocity-predicted displacement trips the metric. The gate state
    ``(trip, budget, calm)`` stays on the device.

    ``run(wide, first_substep)`` advances the layout (fused components or
    planes) by one substep; ``wide`` is a 0-dim bool tensor, or False when
    ``wide_budget_substeps == 0`` turns the gate off statically.
    ``positions()`` gives the (2, G, L) positions of the real slots, ``occ``
    their occupancy, ``pred_disp()`` the velocity-predicted displacement of
    the first substep. ``fb`` = (pos, prev, vel) of the particle-layout
    fallback, advanced once per substep. Returns ``(fb, wide_state)``.

    ``record(event, s, **values)``, if given, sees the gate at work (the
    step replayed substep by substep, ``utils/lockstep.py``): ``"gate"``
    for each evaluation that decides substep ``s`` (the velocity-predicted
    one for ``s == 0``, the movement during substep ``s - 1`` after it),
    with the per-slot ``rel2``, the displacement ``disp``, the ``mean``,
    the count ``n_over`` and the ``trip``; ``"substep"`` before substep
    ``s`` runs, with its window ``wide``; ``"ran"`` after it."""
    note = record or _no_record
    fb_p, fb_prev, fb_v = fb
    if wide is None:
        wide = wide_state_init(options, occ.device)
    if options.wide_budget_substeps == 0:
        for s in range(n_sub):
            note("substep", s, wide=False)
            run(False, s == 0)
            fb_p, fb_prev, fb_v = fallback_substep(fb_p, fb_v)
            note("ran", s)
        return (fb_p, fb_prev, fb_v), wide

    thresh2 = wide_thresh2(options, cell_size)
    wide_tol = options.wide_tolerance
    n_live = torch.clamp(torch.sum(act), min=1)

    def over(s, disp):
        rel2, mean = drift_rel2(disp, occ)
        n_over = torch.sum(rel2 > thresh2)
        trip = n_over > wide_tol * n_live
        note("gate", s, rel2=rel2, disp=disp, mean=mean, n_over=n_over,
             trip=trip)
        return trip

    trip, budget, calm = wide
    trip = trip | over(0, pred_disp())
    move_ref = positions().clone()
    for s in range(n_sub):
        wide_now = trip & (budget > 0)
        note("substep", s, wide=wide_now)
        run(wide_now, s == 0)
        budget = torch.where(wide_now, budget - 1, budget)
        fb_p, fb_prev, fb_v = fallback_substep(fb_p, fb_v)
        note("ran", s)
        xy = positions()
        trip = over(s + 1, xy - move_ref)
        move_ref = xy.clone()
        calm = torch.where(trip, 0, calm + 1).to(torch.int32)
        budget = torch.where(calm >= options.wide_rearm_substeps,
                             options.wide_budget_substeps, budget
                             ).to(torch.int32)
    return (fb_p, fb_prev, fb_v), (trip, budget, calm)


# ------------------------------------------ dense engine (plane-resident) --

def _dense_add_cum(binning, k: int):
    """Ordered-budget prefix (reference :1656-1658) in grid layout: each
    slot's examined-pair count (kernel F), its exclusive prefix in particle
    order, written to ``FIELD_CUM``."""
    planes = binning.planes
    g_lanes = planes.shape[2] * (planes.shape[1] - 2 * dense_ops.ROW_PAD)
    counts = sweep_kernel.count_planes(planes, k)
    safe = torch.clamp(binning.slot, max=g_lanes - 1)
    c_p = torch.where(binning.slot < g_lanes, counts.reshape(-1)[safe], 0.0)
    cum = torch.cumsum(c_p, 0) - c_p
    return dense_ops.update_cum_field(binning, cum)


def _bin_dense(pos, inv_mass, radius, batch_slot, act, cell_size, g: int,
               k: int, options: SolverOptions, aux_cols=None):
    """Bin one population into halo-padded planes. Budget off: the rotating
    winners, placed by kernel A; ordered budget: the stable index order
    through the scatter binning (``update_cum_field`` needs ``pidx_grid``)
    plus the examined-pair prefix."""
    ordered = options.budget_mode == "ordered"
    binning = dense_ops.bin_to_planes(
        pos, inv_mass, radius, batch_slot, act, cell_size, grid_dim=g,
        slots_per_cell=k, aux_cols=aux_cols, use_placement=not ordered,
        rotate=not ordered)
    if ordered:
        binning = _dense_add_cum(binning, k)
    return binning


def _plane_substep(planes, aux, damp, follow_c, params_packed, sub_dt,
                   relaxation, options: SolverOptions, g: int, k: int, *,
                   wide=False, first_substep: bool = True) -> None:
    """One substep of the whole pipeline in plane layout, IN PLACE on
    ``planes`` and ``aux`` (fresh tensors of this step's binning).

    Empty slots hold all-zero fields and every elementwise update maps zeros
    to zeros; the halo rows stay copies of their source rows under
    elementwise updates, so only the sweep's correction (real rows) needs a
    halo refresh. ``wide`` is a bool (static window) or a 0-dim device
    tensor (the violence gate, read by kernel D/E itself). With
    ``options.stale_hash_compat`` a substep that is not the step's first
    runs one collision pass fewer (reference :1905-1912)."""
    rp = dense_ops.ROW_PAD
    X, Y = dense_ops.FIELD_X, dense_ops.FIELD_Y
    kw = dict(cohesion=options.cohesion_mode == "spacing",
              ordered_budget=options.budget_mode == "ordered",
              symmetric=options.sweep_symmetric)
    if isinstance(wide, torch.Tensor):
        kw["wide"] = wide
    else:
        kw.update(window=3 if wide else 1, fresh_mask=bool(wide))
    # pre-solve (:1393-1432): damped integration; mass/radius derived once
    # per step
    aux[AUX_VX:AUX_VY + 1] *= damp
    aux[AUX_PX:AUX_PY + 1] = planes[X:Y + 1]
    x = aux[AUX_PX] + sub_dt * aux[AUX_VX]
    y = aux[AUX_PY] + sub_dt * aux[AUX_VY]
    # follow constraint (:1435-1471), targets plane-resident
    dx, dy = _follow_delta(x, y, planes[dense_ops.FIELD_W],
                           planes[dense_ops.FIELD_OCC] > 0.0,
                           aux[AUX_TX], aux[AUX_TY], aux[AUX_TD], follow_c)
    planes[X] = x + dx
    planes[Y] = y + dy
    # collision passes (:1866-1913)
    n_passes = options.n_collision_steps
    if options.stale_hash_compat and not first_substep:
        n_passes -= 1
    for _ in range(n_passes):
        corr = sweep_kernel.sweep_planes(planes, params_packed, k, **kw)
        planes[X, rp:rp + g] += relaxation * corr[0]
        planes[Y, rp:rp + g] += relaxation * corr[1]
        dense_ops.refresh_halo_xy(planes)
    # post-solve velocity (:1690-1693)
    aux[AUX_VX:AUX_VY + 1] = (planes[X:Y + 1] - aux[AUX_PX:AUX_PY + 1]) / sub_dt


def _plane_extract(planes, aux, slot, g: int, lanes: int, sub_dt):
    """One gather pulling (pos, prev, vel) per particle out of plane layout;
    the velocity is derived, ``(pos - prev) / sub_dt`` (at least one substep
    has run). ``in_grid`` also requires the slot's ``FIELD_OCC``: a
    particle that got no slot falls back to integration without
    collision."""
    rp = dense_ops.ROW_PAD
    ext = torch.stack([planes[dense_ops.FIELD_X], planes[dense_ops.FIELD_Y],
                       aux[AUX_PX], aux[AUX_PY],
                       planes[dense_ops.FIELD_OCC]], dim=-1).reshape(-1, 5)
    got = ext[torch.clamp(slot + rp * lanes, max=ext.shape[0] - 1)]
    in_grid = (slot < g * lanes) & (got[:, 4] > 0.0)
    p, prev = got[:, 0:2], got[:, 2:4]
    return p, prev, (p - prev) / sub_dt, in_grid


def _plane_aux_cols(pos, vel, tx, ty, td):
    return torch.stack([pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1],
                        tx, ty, td], dim=1)


def _fused_component_path(options: SolverOptions) -> bool:
    """Whether the fused component-layout path applies (the JAX package's
    test without its TPU condition: the port runs it on every device)."""
    return (options.budget_mode == "off"
            and not options.sweep_symmetric
            and options.n_collision_steps >= 1
            and not (options.stale_hash_compat
                     and options.n_collision_steps < 2))


class _Population:
    """One population's step constants on the dense engine and the layout
    operations every dense route shares (one step, resident steps, resident
    frames). ``follow_rows`` is the per-particle (N, 3) follow table
    ``(tx, ty, sqrt(batch_radius))``. The binned layout ``grid`` is a list,
    ``[xy, prev, stat, follow]`` on the fused path or ``[planes, aux]`` on
    the plane path, advanced in place by :meth:`substeps`."""

    def __init__(self, mass_t, batch_slot, act, cfg: DeviceConfig,
                 follow_rows, sub_dt, relaxation, options: SolverOptions,
                 g: int, k: int):
        self.act, self.batch_slot = act, batch_slot
        self.sub_dt, self.relaxation, self.options = sub_dt, relaxation, options
        self.g, self.k, self.lanes = g, k, g * k
        self.fused = _fused_component_path(options)
        self.damp = 1.0 - torch.clamp(cfg.damping, 0.0, 1.0)     # :1768
        mass = torch_mix(cfg.min_mass, cfg.max_mass, mass_t)
        self.inv_mass = torch.where(act, 1.0 / torch.clamp(mass, min=1e-12),
                                    0.0)
        self.radius = torch.where(act, torch_mix(cfg.min_radius,
                                                 cfg.max_radius, mass_t), 0.0)
        self.follow_c = strength_to_compliance(cfg.follow_strength, sub_dt)
        collision_c = strength_to_compliance(cfg.collision_strength, sub_dt)
        cohesion_c = strength_to_compliance(cfg.cohesion_strength, sub_dt)
        self.cell_size, params = _dense_params(cfg, act, collision_c,
                                               cohesion_c, options)
        self.params_packed = params.pack(mass_t.device)
        self.tx, self.ty = follow_rows[:, 0], follow_rows[:, 1]
        self.td = 2.0 * follow_rows[:, 2]
        self._aux_packed = None

    def fallback_substep(self, p, v):
        """One pre-solve + follow substep in particle layout (no collision)."""
        v = v * self.damp
        prev = p
        p = p + self.sub_dt * v
        fdx, fdy = _follow_delta(p[:, 0], p[:, 1], self.inv_mass, self.act,
                                 self.tx, self.ty, self.td, self.follow_c)
        p = p + torch.stack([fdx, fdy], dim=1)
        return p, prev, (p - prev) / self.sub_dt

    def bin(self, p, v):
        """Bin positions ``p`` with velocities ``v``: ``(grid, slot)``."""
        if self.fused:
            xy, prev, stat, follow, slot = _bin_components(
                p, v, self.inv_mass, self.radius, self.batch_slot, self.act,
                self.cell_size, self.tx, self.ty, self.td, self.sub_dt,
                self.g, self.k, occ_cap=self.options.occ_pressure_cap)
            return [xy, prev, stat, follow], slot
        binning = _bin_dense(p, self.inv_mass, self.radius, self.batch_slot,
                             self.act, self.cell_size, self.g, self.k,
                             self.options,
                             _plane_aux_cols(p, v, self.tx, self.ty, self.td))
        return [binning.planes, binning.aux], binning.slot

    def positions(self, grid):
        """(2, G, L) positions of the real slots (a view on the plane path,
        whose substeps write the planes in place)."""
        if self.fused:
            return grid[0]
        rp = dense_ops.ROW_PAD
        return grid[0][:2, rp:rp + self.g]

    def occupancy(self, grid):
        if self.fused:
            return grid[2][3]
        rp = dense_ops.ROW_PAD
        return grid[0][dense_ops.FIELD_OCC, rp:rp + self.g]

    def substep(self, grid, wide, first: bool) -> None:
        """One substep on ``grid``, in place: ``wide`` a 0-dim bool tensor
        (the gate's decision, read by kernel B or D itself) or a bool (a
        static window); ``first`` marks the step's first substep."""
        opts = self.options
        if not self.fused:
            _plane_substep(grid[0], grid[1], self.damp, self.follow_c,
                           self.params_packed, self.sub_dt, self.relaxation,
                           opts, self.g, self.k, wide=wide,
                           first_substep=first)
            return
        if self._aux_packed is None:
            dev = self.damp.device
            self._aux_packed = torch.stack([
                self.damp, self.follow_c,
                torch.as_tensor(self.relaxation, dtype=torch.float32,
                                device=dev),
                torch.zeros((), device=dev)])
        grid[0], grid[1] = _fused_run(
            grid[0], grid[1], grid[2], grid[3], self.params_packed,
            self._aux_packed, self.k, opts,
            cohesion=opts.cohesion_mode == "spacing", wide=wide,
            first_substep=first)

    def pred_disp(self, grid):
        """(2, G, L) velocity-predicted displacement of the first substep
        (fused: ``x - prev == vel * sub_dt``)."""
        if self.fused:
            return grid[0] - grid[1]
        rp = dense_ops.ROW_PAD
        return grid[1][AUX_VX:AUX_VY + 1, rp:rp + self.g] * self.sub_dt

    def substeps(self, grid, fb, wide_state, record=None):
        """One step's substeps on ``grid`` under the violence gate; the
        fallback ``fb`` = (pos, prev, vel) advances in particle layout.
        Returns ``(fb, wide_state)``; ``record`` as
        :func:`_gated_substeps` takes it, each event given the layout as
        ``layout=(self, grid)`` too."""
        opts = self.options
        if record is not None:
            record = functools.partial(record, layout=(self, grid))
        return _gated_substeps(lambda wide, first: self.substep(grid, wide,
                                                                first),
                               lambda: self.positions(grid),
                               self.occupancy(grid),
                               lambda: self.pred_disp(grid), fb,
                               self.fallback_substep, self.act,
                               self.cell_size, opts, opts.n_substeps,
                               wide_state, record)

    def extract(self, grid, slot):
        """(pos, prev, vel, in_grid) per particle; the velocity is derived,
        so at least one substep must have run on ``grid``."""
        if self.fused:
            return _comp_extract(grid[0], grid[1], grid[2], slot, self.g,
                                 self.lanes, self.sub_dt)
        return _plane_extract(grid[0], grid[1], slot, self.g, self.lanes,
                              self.sub_dt)

    def merge(self, extracted, fb):
        """Particle arrays of a step: binned particles from the layout
        (``extracted``, as :meth:`extract` gives it), every other row from
        the fallback ``fb``."""
        p_pl, prev_pl, v_pl, in_grid = extracted
        sel = (in_grid & self.act)[:, None]
        return tuple(torch.where(sel, a, b)
                     for a, b in zip((p_pl, prev_pl, v_pl), fb))

    def keep_inactive(self, merged, old):
        """``merged`` on the live rows, ``old`` on the inactive ones."""
        live = self.act[:, None]
        return tuple(torch.where(live, a, b) for a, b in zip(merged, old))


def _population_step_dense(pos, vel, mass_t, batch_slot, act,
                           cfg: DeviceConfig, follow_rows, sub_dt, relaxation,
                           options: SolverOptions, g: int, k: int,
                           wide_state=None):
    """Whole-step dense path of one population: one binning per step (or per
    substep), all substep math in the fused component layout or in plane
    layout; budget-dropped particles fall back to integration without
    collision (reference :1656-1658)."""
    pop = _Population(mass_t, batch_slot, act, cfg, follow_rows, sub_dt,
                      relaxation, options, g, k)
    if options.dense_rebin == "substep":
        # strict rebuild before every substep; no wide machinery, the
        # episode state passes through untouched
        new_pos, new_prev, new_vel = pos, pos, vel
        for s in range(options.n_substeps):
            binning = _bin_dense(new_pos, pop.inv_mass, pop.radius, batch_slot,
                                 act, pop.cell_size, g, k, options,
                                 _plane_aux_cols(new_pos, new_vel, pop.tx,
                                                 pop.ty, pop.td))
            _plane_substep(binning.planes, binning.aux, pop.damp,
                           pop.follow_c, pop.params_packed, sub_dt,
                           relaxation, options, g, k, first_substep=s == 0)
            fb = pop.fallback_substep(new_pos, new_vel)
            new_pos, new_prev, new_vel = pop.keep_inactive(
                pop.merge(_plane_extract(binning.planes, binning.aux,
                                         binning.slot, g, pop.lanes, sub_dt),
                          fb), (new_pos, new_prev, new_vel))
        ws = wide_state if wide_state is not None else \
            wide_state_init(options, pos.device)
        return new_pos, new_prev, new_vel, pop.inv_mass, pop.radius, ws

    grid, slot = pop.bin(pos, vel)
    fb, ws = pop.substeps(grid, (pos, pos, vel), wide_state)
    return (*pop.keep_inactive(pop.merge(pop.extract(grid, slot), fb),
                               (pos, pos, vel)),
            pop.inv_mass, pop.radius, ws)


# ------------------------------------ dense engine (multi-step residency) --

def rebin_if(pred, pop_index: int, fn, force=None, cond=None, *,
             count) -> None:
    """The resident rebin decision (JAX: a ``lax.cond``): run ``fn`` when
    the 0-dim bool tensor ``pred`` is true. Shared by this module's
    resident loops and the spatial layer's.

    ``cond`` (a graph being captured gives it) records the branch instead,
    as ``cond(pred, pop_index)``: an IF node of the graph on ``pred``, whose
    body is ``fn`` captured beforehand, so the card takes the branch at each
    replay and nothing is read back. Otherwise ``pred`` is read on the host
    and ``count(pop_index, taken)`` counts the read in the caller's host
    counters. ``force`` (a bool) decides without reading ``pred`` and counts
    nothing (:class:`.resident_graph.ResidentGraph`'s warm-up runs the
    branch eagerly that way). ``fn`` writes its results into buffers
    allocated before, with ``copy_``: the graph after the node reads fixed
    addresses."""
    if cond is not None:
        cond(pred, pop_index)
        return
    if force is None:
        force = bool(pred)
        count(pop_index, force)
    if force:
        fn()


def _count_read(pop_index: int, taken: bool) -> None:
    global host_syncs
    host_syncs += 1
    if taken:
        rebins[pop_index] += 1


def _rebin_if(pred, pop_index: int, fn, force=None, cond=None) -> None:
    """:func:`rebin_if` counted in ``host_syncs`` and ``rebins``."""
    rebin_if(pred, pop_index, fn, force, cond, count=_count_read)


def _copy_into(dsts, srcs) -> None:
    """``d.copy_(s)`` for each pair whose source is not its destination."""
    for d, s in zip(dsts, srcs):
        if s is not d:
            d.copy_(s)


class _ResidentPop:
    """One population's binned layout kept across steps or frames (JAX
    ``_population_multi_dense`` and its fused variant, and the per-population
    carry of ``multi_step_frames``), in buffers that :meth:`step`,
    :meth:`frame` and :meth:`rebin` update in place, so a captured step
    replays on fixed addresses. Construction is the *enter*: bin
    ``pos``/``vel`` and take the drift references (copies: the plane path
    writes its planes in place). ``fb`` = (pos, prev, vel) of the
    particle-layout fallback; ``views`` (the frame loop's) gives the tensors
    ``fb`` and ``last`` (the frame's start positions) are kept in:
    ``(pos, prev, vel, last_pos)`` rows of its state buffers.

    ``counter`` (a (2,) int32 device tensor or None) adds one at
    ``pop_index`` per rebin; ``force`` and ``cond`` go to
    :func:`_rebin_if`."""

    def __init__(self, pop: _Population, pos, vel, wide_state,
                 pop_index: int, views=None, counter=None):
        self.pop, self.i, self.counter = pop, pop_index, counter
        self.frames = views is not None
        self.thresh2 = drift_thresh2(pop.cell_size)
        self.n_live = torch.clamp(torch.sum(pop.act), min=1)
        self.grid, self.slot = pop.bin(pos, vel)
        if views is None:
            self.fb = [pos.clone(), pos.clone(), vel.clone()]
        else:
            self.fb, self.last = list(views[:3]), views[3]
            _copy_into(self.fb + [self.last], (pos, pos, vel, pos))
        self.ws = [t.clone() for t in wide_state]
        self.ref_p = pos.clone()                    # positions at bin time
        self.ref_xy = pop.positions(self.grid).clone()   # and in the layout

    def _substeps(self, record=None):
        """One step's substeps on the layout; returns the fallback."""
        work = list(self.grid)
        fb, ws = self.pop.substeps(work, tuple(self.fb), tuple(self.ws),
                                   record)
        _copy_into(self.grid, work)
        _copy_into(self.ws, ws)
        return fb

    def rebin(self) -> None:
        """The rebin branch: a fresh binning of the particle arrays (in a
        resident step, the layout merged with the fallback first; in a
        frame, the arrays the frame extracted) and new drift references,
        all written into the buffers."""
        pop = self.pop
        if not self.frames:
            _copy_into(self.fb, self.merged())
        grid, slot = pop.bin(self.fb[0], self.fb[2])
        _copy_into(self.grid, grid)
        self.slot.copy_(slot)
        self.ref_p.copy_(self.fb[0])
        self.ref_xy.copy_(pop.positions(self.grid))
        if self.counter is not None:
            self.counter[self.i].add_(1)

    def _decide(self, n_over, force, cond) -> None:
        _rebin_if(n_over > self.pop.options.rebin_tolerance * self.n_live,
                  self.i, self.rebin, force, cond)

    def step(self, check: bool = True, force=None, cond=None,
             record=None) -> None:
        """One resident step of :func:`multi_step`: the drift since bin time
        (the budget-dropped particles, integrated by the fallback, count
        too), the rebin from the merged particle arrays when more than
        ``rebin_tolerance`` of the live particles drifted past a quarter
        cell relative to the mean, then the substeps. ``check=False`` skips
        the decision (a layout just binned has no drift). ``record`` sees
        the decision as a ``"rebin"`` event (the per-slot ``rel2``, the
        ``disp`` since bin time, the ``mean``, per particle the squared
        drift ``extra`` of the budget-dropped live particles, -1 for every
        other, the count ``n_over`` and the ``trip``), then the substeps as
        :func:`_gated_substeps` shows them to it."""
        if check:
            pop = self.pop
            disp = pop.positions(self.grid) - self.ref_xy
            rel2, mean = drift_rel2(disp, pop.occupancy(self.grid))
            dropped = pop.act & (self.slot >= pop.g * pop.lanes)
            dfb = self.fb[0] - self.ref_p - mean
            extra = torch.where(dropped, torch.sum(dfb * dfb, dim=1), -1.0)
            n_over = (torch.sum(rel2 > self.thresh2)
                      + torch.sum(extra > self.thresh2))
            pred = n_over > pop.options.rebin_tolerance * self.n_live
            if record is not None:
                record("rebin", 0, rel2=rel2, disp=disp, mean=mean,
                       extra=extra, n_over=n_over, trip=pred)
            _rebin_if(pred, self.i, self.rebin, force, cond)
        _copy_into(self.fb, self._substeps(record))

    def frame(self, force=None, cond=None):
        """One step of :func:`multi_step_frames`: the substeps, the particle
        arrays extracted into ``fb`` (the frame needs them; ``last`` takes
        the frame's start positions), then the rebin from those arrays when
        the per-particle drift since bin time demands it. Returns the live
        centroid."""
        pop = self.pop
        fb = self._substeps()
        p, pr, v = pop.merge(pop.extract(self.grid, self.slot), fb)
        n_over = _drift_over((p - self.ref_p).T, pop.act.to(torch.float32),
                             self.thresh2)[0]
        self.last.copy_(self.fb[0])
        _copy_into(self.fb, (p, pr, v))
        self._decide(n_over, force, cond)
        return torch.sum(torch.where(pop.act[:, None], p, 0.0),
                         dim=0) / self.n_live

    def merged(self):
        """(pos, prev, vel) of the particles: the layout's, merged with the
        fallback. At least one substep must have run."""
        return self.pop.merge(self.pop.extract(self.grid, self.slot),
                              tuple(self.fb))


def _resident_pops(state: ParticleState, cfg2: DeviceConfig, step_delta,
                   relaxation, options: SolverOptions, wide_state,
                   views=None, counter=None):
    """The two populations' :class:`_ResidentPop`, binned from ``state``
    (``views``: the frame loop's (2,)-leading state buffers)."""
    caps = _pop_caps(options, state.capacity)
    follow_rows = _follow_rows(state, caps)
    step_delta = torch.as_tensor(step_delta, dtype=torch.float32,
                                 device=state.device)
    sub_dt = torch.clamp(step_delta / options.n_substeps, min=EPS)
    active_full = state.active_mask()
    pops = []
    for i, cap in enumerate(caps):
        pop = _Population(state.mass_t[i, :cap], state.batch_slot[i, :cap],
                          active_full[i, :cap], population_config(cfg2, i),
                          follow_rows[i], sub_dt, relaxation, options,
                          options.dense_grid_dim[i], options.dense_slots[i])
        pops.append(_ResidentPop(
            pop, state.pos[i, :cap], state.vel[i, :cap], wide_state[i], i,
            views=None if views is None else [b[i, :cap] for b in views],
            counter=counter))
    return pops


class ResidentSteps:
    """The resident steps of :func:`multi_step`, both populations, in three
    parts: construction (*enter*: bin from ``state``), :meth:`step` (one
    resident step) and :meth:`exit` (merge). Every part reads and writes
    buffers made at the enter, so each can be captured once and replayed
    (``ops/resident_graph.py``); ``pops[i].rebin`` is population ``i``'s
    rebin branch. ``counter``: see :class:`_ResidentPop`."""

    def __init__(self, state: ParticleState, cfg2: DeviceConfig, step_delta,
                 relaxation, options: SolverOptions, wide_state,
                 counter=None):
        self.state = state
        self.pops = _resident_pops(state, cfg2, step_delta, relaxation,
                                   options, wide_state, counter=counter)

    def step(self, check: bool = True, force=None, cond=None,
             record=None) -> None:
        """One resident step of both populations; ``record(i)``, if given,
        is population ``i``'s recorder (:meth:`_ResidentPop.step`)."""
        for r in self.pops:
            r.step(check, force, cond,
                   None if record is None else record(r.i))

    def exit(self):
        """``(fields, wide_state)``: the state fields the steps wrote
        (positions, previous positions, velocities, inverse masses, radii),
        fresh tensors, and the carried wide-gate state."""
        new = {f: getattr(self.state, f).clone()
               for f in ("pos", "prev", "vel", "inv_mass", "radius")}
        for i, r in enumerate(self.pops):
            cap = r.pop.act.shape[0]
            for f, v in zip(("pos", "prev", "vel", "inv_mass", "radius"),
                            (*r.merged(), r.pop.inv_mass, r.pop.radius)):
                new[f][i, :cap] = v
        return new, [tuple(r.ws) for r in self.pops]


class FrameLoop:
    """The carry of :func:`multi_step_frames`, both populations: the state
    buffers (positions, previous positions, velocities, last positions),
    the binned layouts, the live centroid and the last one. Construction is
    the *enter*; :meth:`frame` advances one frame in place;
    ``pops[i].rebin`` is population ``i``'s rebin branch. ``counter``: see
    :class:`_ResidentPop`."""

    FIELDS = ("pos", "prev", "vel", "last_pos")

    def __init__(self, state: ParticleState, cfg2: DeviceConfig, step_delta,
                 relaxation, options: SolverOptions, wide_state,
                 counter=None):
        self.state = state
        self.buf = [getattr(state, f).clone() for f in self.FIELDS]
        self.pops = _resident_pops(state, cfg2, step_delta, relaxation,
                                   options, wide_state, views=self.buf,
                                   counter=counter)
        active_full = state.active_mask()
        n_a0 = torch.clamp(torch.sum(active_full, dim=1), min=1)
        self.centroid = (torch.sum(torch.where(active_full[..., None],
                                               state.pos, 0.0), dim=1)
                         / n_a0[:, None])
        self.last_centroid = self.centroid.clone()

    def frame(self, force=None, cond=None) -> None:
        cents = torch.stack([r.frame(force, cond) for r in self.pops])
        self.last_centroid.copy_(self.centroid)
        self.centroid.copy_(cents)

    def frame_state(self) -> ParticleState:
        """The state after the last frame, in fresh tensors."""
        return self.state.replace(**{f: b.clone()
                                     for f, b in zip(self.FIELDS, self.buf)})

    def frame_stats(self) -> StepStats:
        """The stats a frame hands on: the centroid and the last centroid
        (fresh tensors); the other fields zero, ``max_radius`` one."""
        dev = self.centroid.device
        z2 = torch.zeros((2, 2), dtype=torch.float32, device=dev)
        mb = self.state.max_batches
        return StepStats(
            aabb_min=z2, aabb_max=z2, centroid=self.centroid.clone(),
            last_centroid=self.last_centroid.clone(),
            max_radius=torch.ones((2,), dtype=torch.float32, device=dev),
            max_velocity=torch.zeros((2,), dtype=torch.float32, device=dev),
            batch_pos_sum=torch.zeros((2, mb, 2), dtype=torch.float32,
                                      device=dev),
            batch_count=torch.zeros((2, mb), dtype=torch.float32,
                                    device=dev))

    def wide_state(self):
        """The carried wide-gate state, in fresh tensors."""
        return tuple(tuple(t.clone() for t in r.ws) for r in self.pops)


# ----------------------------------------------- dense engine (per pass) --

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
    rows = take_batch_rows(table, batch_slot)
    dx, dy = _follow_delta(pos[:, 0], pos[:, 1], inv_mass, active,
                           rows[:, 0], rows[:, 1], 2.0 * rows[:, 2],
                           compliance)
    return pos + torch.stack([dx, dy], dim=1)


def _pair_candidates(pos, active, cell_size, options: SolverOptions):
    """The gather engine's candidates of one pass, in the plain version's
    form: ``(grid, cand, valid)``, the hash grid, the candidate indices
    ``cand`` (N, 9K) of each particle's 3x3 buckets, and ``valid``, the live
    candidates of live particles other than the particle itself. A pair
    also needs the TRUE 3x3 cell test (``gather_kernel.in_cells``)."""
    grid = grid_ops.build_grid(pos, active, cell_size,
                               table_size=options.table_size,
                               slots_per_cell=options.slots_per_cell)
    return (grid, *gather_kernel.candidates(grid, active))


def _max_pairs(active):
    """The reference's ordered collision budget, ``0.05 * n_live^2``
    examined pairs a pass (:1749-1753), as a 0-dim float32 tensor."""
    n_live = torch.sum(active).to(torch.float32)
    return 0.05 * n_live * n_live


def _ordered_budget(grid, cand, valid, active):
    """The reference's ordered collision budget (:1749-1753, :1656-1658):
    ``(new_pairs, cum, max_pairs)`` from the plain version's candidates.
    Each pass examines unique pairs in particle order and stops after
    ``max_pairs = 0.05 * n_live^2``; a pair (p, q) is first examined while
    processing min(p, q), so its rank is the count of pairs first seen at
    earlier particles: the exclusive prefix ``cum`` of ``new_pairs``, each
    particle's pairs in its true 3x3 cells with later particles. The float32
    prefix counts exactly below 2^24."""
    new_pairs = gather_kernel.count_from_candidates(grid, cand, valid)
    cum = torch.cumsum(new_pairs, 0) - new_pairs
    return new_pairs, cum, _max_pairs(active)


def solve_pairs(pos, inv_mass, radius, batch_slot, active, cfg: DeviceConfig,
                collision_compliance, cohesion_compliance, relaxation,
                options: SolverOptions, pop: Optional[int] = None):
    """One grid rebuild + Jacobi pair projection pass (the gather engine).

    Vectorized ``_rebuild_spatial_hash`` + ``_solve_collision`` (reference
    :1486-1511, :1548-1666) with ``_enforce_distance``'s symmetric
    projection (:1514-1545): correction ``-(dist - target) / (w_a + w_b +
    alpha)`` clamped to +-|violation|, each endpoint moving by its
    inverse-mass share. The grid is built here; the ordered budget's count
    and the pass itself are kernel H (``ops/kernels/gather_kernel.py``) on
    CUDA tensors and its plain version on CPU tensors: H's front writes
    each particle's record and bucket, the slot table's sort, rank and
    scatter are PyTorch (``grid.slot_table``), and the count and the sweep
    read the record. With ``pop``, a step's pass of that population, the
    budget's cuts are counted on the device
    (``gather_kernel.cut_counter``)."""
    max_factor = torch.maximum(cfg.collision_overlap_factor,
                               cfg.cohesion_interaction_distance_factor)
    cell_size = torch.clamp(cfg.max_radius * max_factor, min=1.0)  # :1756-1760
    record, bucket = gather_kernel.gather_front(
        pos, inv_mass, radius, batch_slot, active, cell_size,
        options.table_size)
    table = grid_ops.slot_table(bucket, options.table_size,
                                options.slots_per_cell)
    grid = grid_ops.CellGrid(table=table,
                             cell_xy=gather_kernel.record_cells(record),
                             table_size=options.table_size)
    cum = max_pairs = cuts = None
    if options.budget_mode == "ordered":
        if pop is not None:
            cuts = gather_kernel.cut_counter(pos.device)[pop]
        new_pairs = gather_kernel.gather_count(record, grid, cuts)
        cum = torch.cumsum(new_pairs, 0) - new_pairs
        max_pairs = _max_pairs(active)
    return gather_kernel.gather_sweep(
        record, grid, cum, max_pairs, collision_compliance,
        cohesion_compliance, cfg.collision_overlap_factor,
        cfg.cohesion_interaction_distance_factor, relaxation,
        spacing=options.cohesion_mode == "spacing",
        pair_chunk=options.pair_chunk, cuts=cuts)


def solve_pairs_dense(pos, inv_mass, radius, batch_slot, active,
                      cfg: DeviceConfig, collision_compliance,
                      cohesion_compliance, relaxation,
                      options: SolverOptions, g: int, k: int):
    """One collision pass with a fresh binning (``dense_rebin="pass"``, the
    strict per-pass rebuild of reference :1866-1879)."""
    lanes = g * k
    cell_size, params = _dense_params(cfg, active, collision_compliance,
                                      cohesion_compliance, options)
    binning = _bin_dense(pos, inv_mass, radius, batch_slot, active, cell_size,
                         g, k, options)
    corr = sweep_kernel.sweep_planes(
        binning.planes, params.pack(pos.device), k,
        cohesion=options.cohesion_mode == "spacing",
        ordered_budget=options.budget_mode == "ordered",
        symmetric=options.sweep_symmetric).reshape(2, -1)
    slot = binning.slot
    safe = torch.clamp(slot, max=lanes * g - 1)
    dx = torch.where(slot < lanes * g, corr[0][safe], 0.0)
    dy = torch.where(slot < lanes * g, corr[1][safe], 0.0)
    delta = torch.stack([dx, dy], dim=1)
    return pos + torch.where(active[:, None], relaxation * delta, 0.0)


def substep(pos, prev, vel, inv_mass, radius, mass_t, batch_slot, active,
            cfg: DeviceConfig, batch_target, follow_radius, sub_dt,
            relaxation, options: SolverOptions, g: int = 0, k: int = 0,
            pop: Optional[int] = None):
    """One solver substep of one population in particle layout (reference
    :1821-1932): the gather engine and the per-pass dense route; ``pop``
    as for :func:`solve_pairs`."""
    follow_c = strength_to_compliance(cfg.follow_strength, sub_dt)
    collision_c = strength_to_compliance(cfg.collision_strength, sub_dt)
    cohesion_c = strength_to_compliance(cfg.cohesion_strength, sub_dt)
    pos, prev, vel, inv_mass, radius = pre_solve(pos, prev, vel, mass_t,
                                                 active, cfg, sub_dt)
    pos = solve_follow(pos, inv_mass, batch_slot, active, batch_target,
                       follow_radius, follow_c)
    for _ in range(options.n_collision_steps):
        if options.engine == "gather":
            pos = solve_pairs(pos, inv_mass, radius, batch_slot, active, cfg,
                              collision_c, cohesion_c, relaxation, options,
                              pop=pop)
        else:
            pos = solve_pairs_dense(pos, inv_mass, radius, batch_slot, active,
                                    cfg, collision_c, cohesion_c, relaxation,
                                    options, g, k)
    # true-velocity update (:1690-1693); the aggregates of post_solve are
    # taken once per step
    vel = torch.where(active[:, None], (pos - prev) / sub_dt, 0.0)
    return pos, prev, vel, inv_mass, radius


def post_solve(pos, prev, active, batch_slot, sub_dt, max_batches: int):
    """True-velocity update + centroid/max aggregates (reference
    :1669-1718). The per-batch sums of ``get_position`` are taken once per
    step in :func:`step` (:func:`batch_segment_sums`)."""
    del batch_slot, max_batches
    vel = torch.where(active[:, None], (pos - prev) / sub_dt, 0.0)
    speed = torch.sqrt(torch.sum(vel * vel, dim=-1))
    n_active = torch.clamp(torch.sum(active), min=1)
    centroid = torch.sum(torch.where(active[:, None], pos, 0.0),
                         dim=0) / n_active
    max_velocity = torch.max(torch.where(active, speed, 0.0))
    return vel, centroid, max_velocity


def _aabb(pos, radius, active):
    """Radius-inclusive AABB over active particles (reference :1703-1709)."""
    lo = torch.amin(torch.where(active[:, None], pos - radius[:, None], _BIG),
                    dim=0)
    hi = torch.amax(torch.where(active[:, None], pos + radius[:, None], -_BIG),
                    dim=0)
    return lo, hi


def _pop_caps(options: SolverOptions, capacity: int) -> Tuple[int, int]:
    caps = options.pop_caps or (capacity, capacity)
    return tuple(min(c, capacity) for c in caps)


def _follow_rows(state: ParticleState, caps):
    """Per-population (cap, 3) follow tables ``(tx, ty, sqrt(batch_radius))``
    of every particle's batch (reference :1789-1792)."""
    follow_radius = torch.sqrt(torch.clamp(state.batch_radius, min=0.0))
    return tuple(
        take_batch_rows(torch.cat([state.batch_target,
                                   follow_radius[i][:, None]], dim=1),
                        state.batch_slot[i, :caps[i]])
        for i in range(2))


def _step_impl(state: ParticleState, cfg2: DeviceConfig, step_delta,
               relaxation, options: SolverOptions, with_stats: bool = True,
               follow_rows=None, wide_state=None):
    """Returns ``(state, stats)``, or ``(state, stats, wide_state_out)`` when
    ``wide_state`` (per-population episode tuples) is passed.
    ``follow_rows`` (from :func:`_follow_rows`) lets a multi-step caller
    build the follow tables once."""
    dev = state.device
    thread_wide = wide_state is not None
    ws_out = [None, None]
    step_delta = torch.as_tensor(step_delta, dtype=torch.float32, device=dev)
    sub_dt = torch.clamp(step_delta / options.n_substeps, min=EPS)  # :1723
    caps = _pop_caps(options, state.capacity)
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
    plane_steps = (options.engine == "dense"
                   and options.dense_rebin in ("step", "substep"))
    if plane_steps and follow_rows is None:
        follow_rows = _follow_rows(state, caps)

    new_pos, new_prev, new_vel = (state.pos.clone(), state.prev.clone(),
                                  state.vel.clone())
    new_inv, new_rad = state.inv_mass.clone(), state.radius.clone()
    stat_outs = []
    for i in range(2):
        cap = caps[i]
        act = active_full[i, :cap]
        cfg = population_config(cfg2, i)
        g, k = options.dense_grid_dim[i], options.dense_slots[i]
        if plane_steps:
            pos, prev, vel, inv_mass, radius, ws_out[i] = \
                _population_step_dense(
                    state.pos[i, :cap], state.vel[i, :cap],
                    state.mass_t[i, :cap], state.batch_slot[i, :cap], act,
                    cfg, follow_rows[i], sub_dt, relaxation, options, g, k,
                    wide_state=wide_state[i] if thread_wide else None)
        else:
            # the engines without wide machinery (gather, dense per pass)
            # pass the episode state through untouched
            ws_out[i] = wide_state[i] if thread_wide else None
            pos, prev, vel = (state.pos[i, :cap], state.prev[i, :cap],
                              state.vel[i, :cap])
            inv_mass, radius = state.inv_mass[i, :cap], state.radius[i, :cap]
            for _ in range(options.n_substeps):
                pos, prev, vel, inv_mass, radius = substep(
                    pos, prev, vel, inv_mass, radius, state.mass_t[i, :cap],
                    state.batch_slot[i, :cap], act, cfg, state.batch_target,
                    follow_radius[i], sub_dt, relaxation, options, g, k,
                    pop=i)

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


def _resident(options: SolverOptions) -> bool:
    """Whether multi-step residency applies (JAX ``multi_step``'s test)."""
    return (options.engine == "dense" and options.dense_rebin == "step"
            and options.budget_mode == "off")


def multi_step_is_loop(options: SolverOptions) -> bool:
    """Whether :func:`multi_step` is a loop of :func:`step` calls (the
    gather engine, the ordered budget, ``dense_rebin != "step"`` or
    ``adaptive_rebin=False``), with the same result as calling ``step``
    ``n_steps`` times."""
    return not (_resident(options) and options.adaptive_rebin)


@torch.no_grad()
def multi_step(state: ParticleState, cfg2: DeviceConfig, step_delta,
               relaxation, options: SolverOptions, n_steps: int,
               wide_state=None, graphs=None, record=None):
    """``n_steps`` chained fixed steps (headless fast-forward).

    Returns ``(state, stats)``, or ``(state, stats, wide_state_out)`` when
    ``wide_state`` is passed. On the dense engine with the budget off,
    ``dense_rebin="step"`` and ``adaptive_rebin``, the first ``n_steps - 1``
    steps run resident (:class:`ResidentSteps`); otherwise they are a loop
    of steps. Either way one full step comes last, giving the stats and
    ``last_pos`` (the stats are the final step's only, as the reference
    reads centroids lazily, :289-293). ``n_steps <= 1`` runs that one step.
    The follow tables are built once for all steps.

    ``graphs`` (a ``resident_graph.ResidentGraphs``) runs the resident
    route as graph replays, with no read of the device; None runs it
    eagerly, reading the rebin flag on the host. The loop of steps ignores
    it. ``record(i, pop)``, if given, is the recorder of resident step
    ``i`` of population ``pop`` on the eager resident route
    (:meth:`_ResidentPop.step`)."""
    caps = _pop_caps(options, state.capacity)
    thread_wide = wide_state is not None
    ws = (tuple(wide_state) if thread_wide
          else (wide_state_init(options, state.device),) * 2)
    n_res = max(int(n_steps) - 1, 0)
    if not multi_step_is_loop(options) and graphs is not None:
        state, stats, ws_fin = graphs.steps(state, cfg2, step_delta,
                                            relaxation, options, n_steps, ws)
        return (state, stats, ws_fin) if thread_wide else (state, stats)
    follow_rows = _follow_rows(state, caps)
    if not multi_step_is_loop(options):
        # no resident step: the final step reads only pos and vel, so
        # skipping the binning gives JAX's zero-step result
        if n_res:
            loop = ResidentSteps(state, cfg2, step_delta, relaxation,
                                 options, ws)
            for i in range(n_res):
                loop.step(check=i > 0,      # the first layout was just binned
                          record=None if record is None else
                          functools.partial(record, i))
            new, ws = loop.exit()
            state = state.replace(**new)
    else:
        for _ in range(n_res):
            state, _, ws = _step_impl(state, cfg2, step_delta, relaxation,
                                      options, with_stats=False,
                                      follow_rows=follow_rows,
                                      wide_state=tuple(ws))
    state, stats, ws_fin = _step_impl(state, cfg2, step_delta, relaxation,
                                      options, follow_rows=follow_rows,
                                      wide_state=tuple(ws))
    if thread_wide:
        return state, stats, ws_fin
    return state, stats


@torch.no_grad()
def multi_step_frames(state: ParticleState, cfg2: DeviceConfig, step_delta,
                      relaxation, options: SolverOptions, n_steps: int,
                      frame_fn, wide_state=None, graphs=None):
    """Resident frame loop: per iteration one fixed step, then
    ``frame_fn(state, stats)`` or ``frame_fn(state, stats, t)`` (``t`` the
    frame index), whose scalar results are summed.

    The interactive update -> draw loop with the layout kept across frames:
    per frame and population, the step runs on the binned layout, the
    particle arrays are extracted (``frame_fn`` needs them), and a rebin
    from those arrays follows when the per-particle drift since bin time
    demands it (the :func:`multi_step` rule). ``last_pos`` is each frame's
    start position. ``stats`` carries the centroid and last centroid the
    renderer reads; the other fields are zero (ones for ``max_radius``).
    Each frame's state and stats are fresh tensors.

    ``graphs`` (a ``resident_graph.ResidentGraphs``) runs each frame's step
    as a graph replay, with no read of the device; None runs it eagerly,
    reading the rebin flag on the host. ``frame_fn`` is called from Python
    either way.

    Returns ``(state, total)``, or ``(state, total, wide_state_out)`` when
    ``wide_state`` is passed. Requires ``engine='dense'``,
    ``budget_mode='off'`` and ``dense_rebin='step'``."""
    if not _resident(options):
        raise ValueError("multi_step_frames requires the resident dense "
                         "configuration: engine='dense', budget_mode='off', "
                         "dense_rebin='step'")
    ws = (tuple(wide_state) if wide_state is not None
          else (wide_state_init(options, state.device),) * 2)
    if graphs is None:
        loop = FrameLoop(state, cfg2, step_delta, relaxation, options, ws)
        advance = loop.frame
    else:
        loop, advance = graphs.frames(state, cfg2, step_delta, relaxation,
                                      options, ws)
    wants_index = len(inspect.signature(frame_fn).parameters) >= 3
    total = torch.zeros((), dtype=torch.float32, device=state.device)
    for t in range(int(n_steps)):
        advance()
        args = (loop.frame_state(), loop.frame_stats())
        total = total + (frame_fn(*args, t) if wants_index
                         else frame_fn(*args))
    final = loop.frame_state()
    if wide_state is not None:
        return final, total, loop.wide_state()
    return final, total
