"""2D spatial domain decomposition of the dense engine over a mesh of ranks.

The counterpart of ``egg_fluid_simulation_tpu/parallel/spatial.py`` on
``torch.distributed`` (:mod:`.mesh`). The dense engine's torus cell grid is
cut into a ``(bands, blocks)`` mesh: bands split grid rows (y), blocks split
lane groups (x), and every collective moves only boundary-sized bytes:

- **Halo exchange.** Each rank bins its particles into a local plane window,
  its own ``Gb x Lb`` cells plus ``ROW_PAD`` halo rows and ``lp`` halo
  lanes a side (:func:`_bin_local`). Halos come from ring shifts along each
  axis, rows first, then lanes: the second pass carries the corners. On a
  one-rank axis the shift is a copy, which is the single-card torus wrap.
- **Plane-resident substeps.** Damped integration, the follow constraint,
  the pair sweep (kernel D on the local window, :func:`_sweep_local`) and
  the velocity update run in the local plane layout as on one card; only
  the X/Y halos are exchanged again after each collision pass.
- **Ring migration.** After the step each particle's owner is recomputed
  from its torus cell, and movers ride fixed-size buffers one hop per axis
  and step (y first, then x). Particles in transit, or past a buffer,
  integrate without collision until they arrive; a receiver out of free
  slots drops and counts them, so the host can redistribute.

The layout invariant: rank ``(b, x)`` holds, in its slice of the particle
axis, only particles whose torus cell lies in its window, padded with
inactive slots (``batch_slot < 0``); :func:`redistribute` establishes it
from any state. A rank's state is its slice ``(2, capacity / ranks, ...)``
with the batch tables replicated (JAX: slice ``b * Dx + x`` of a global
array).

Where the JAX package branches on a traced predicate (``lax.cond``):

- the violence gate of the wide sweep: its drift metric is summed over the
  mesh, and the flag stays on the device: kernel D reads it (window 3 and
  the fresh-cell mask when set). No host read;
- the rebin of the resident steps (:class:`SpatialSteps`): the drift count
  is summed over the mesh, so every rank computes the same flag. Where the
  steps are replayed from CUDA graphs (``parallel/spatial_graph.py``, how a
  card runs them) on a one-rank mesh, the flag stays on the device: an IF
  node of the step's graph takes the branch, and nothing is read. Replayed
  on more ranks, the step writes both populations' flags and the host
  reads them once a step. The eager loop (:func:`spatial_multi_step`)
  reads the flag on the host, one read per population and resident step.
  Every host read is counted in ``host_reads``.

The step, the resident steps and the draw read nothing from the device
(the migrants land through a dump row, not a boolean mask; the draw's
outline thickness can come from the host), so each can be captured.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DeviceConfig, population_config
from ..ops import dense as dense_ops
from ..ops import render as render_ops
from ..ops import solver as solver_ops
from ..ops.grid import segment_extent
from ..ops.kernels import composite_kernel, sweep_kernel
from ..ops.solver import SolverOptions, _copy_into
from ..state import PARTICLE_FIELDS, ParticleState, StepStats
from ..utils.mathx import EPS, torch_mix
from .mesh import BANDS, BLOCKS, Mesh, make_spatial_mesh
from .sharding import global_stats, unshard_state

__all__ = ["SpatialLayout", "SpatialSteps", "make_spatial_mesh",
           "spatial_step", "spatial_multi_step", "redistribute", "owner_of",
           "spatial_draw", "draw_frame", "host_reads", "rebins"]

RP = dense_ops.ROW_PAD
N_AUX = solver_ops.AUX_TD + 1     # ride-along plane fields (JAX N_AUX)
_MIG_FIELDS = 15  # as JAX names it; a migrant row is 16 floats (pos2 prev2
                  # vel2 last2 radius mass_t inv_mass batch color4) plus the
                  # validity flag: _MIG_FIELDS + 2 columns
host_reads = 0    # host reads of the resident rebin decision
rebins = [0, 0]   # rebins the host decided, per population (white, yolk)


class SpatialLayout(NamedTuple):
    """Static decomposition geometry."""
    grid_dim: int          # G: torus cells per axis (shared by both pops)
    slots_per_cell: int    # K
    db: int                # ranks along y (bands)
    dx: int                # ranks along x (blocks)
    migrate_cap: int       # M: max migrants per direction per step

    @property
    def gb(self) -> int:
        return self.grid_dim // self.db

    @property
    def gx(self) -> int:
        return self.grid_dim // self.dx          # cell columns per block

    @property
    def lb(self) -> int:
        return self.gx * self.slots_per_cell     # real lanes per block

    @property
    def lp(self) -> int:
        # halo lanes a side: the 4K - 1 lane reach of the wide (window 3)
        # sweep, at least 64 lanes (the JAX package's lane-tile alignment,
        # kept so both packages lay the window out alike); 64 % K == 0 keeps
        # the lane mask's K-periodicity in phase
        return max(4 * self.slots_per_cell, 64)

    @property
    def rows(self) -> int:
        return self.gb + 2 * RP

    @property
    def width(self) -> int:
        return self.lb + 2 * self.lp

    def check(self):
        if not (self.grid_dim % self.db == 0 and self.grid_dim % self.dx == 0):
            raise ValueError(f"grid_dim {self.grid_dim} must divide by the "
                             f"mesh ({self.db} x {self.dx})")
        if self.gb < RP:
            raise ValueError("band height must cover the row halo")
        if self.gx < 2:
            raise ValueError("block must span at least 2 cell columns")
        if self.lp % self.slots_per_cell != 0:
            raise ValueError("halo lane count must be a multiple of "
                             "slots_per_cell; use a power-of-two K <= 64")

    def collective_bytes_per_step(self, options) -> dict:
        """Bytes one rank sends in one :func:`spatial_step`, per category.

        The JAX package's model and categories (its docstring: full-field
        halo exchange once per binning, the X/Y refresh after every
        collision pass, two fixed-size migration buffers per axis), counted
        for what the step sends: both populations (JAX's formula is one
        population's), and nothing along an axis of one rank, where the
        exchange is a copy. The scalar reductions of the gate and the step
        statistics are not in the model (nor in JAX's)."""
        width, rows = self.width, self.rows
        n_fields = dense_ops.N_FIELDS + N_AUX
        row_halo = 2 * RP * width * 4 if self.db > 1 else 0
        lane_halo = 2 * self.lp * rows * 4 if self.dx > 1 else 0
        axes = int(self.db > 1) + int(self.dx > 1)
        n_pop = 2
        full_exchange = n_pop * n_fields * (row_halo + lane_halo)
        xy_refresh = n_pop * 2 * (row_halo + lane_halo)
        passes = options.n_substeps * options.n_collision_steps
        migration = n_pop * axes * 2 * self.migrate_cap * (_MIG_FIELDS + 2) * 4
        return {
            "full_halo_exchange": full_exchange,
            "xy_refresh_per_pass": xy_refresh,
            "migration": migration,
            "total_per_step": full_exchange + passes * xy_refresh + migration,
        }


# ------------------------------------------------------------- ownership --

def owner_of(pos, cell_size, lay: SpatialLayout):
    """(band, block) mesh coords of each particle's torus cell."""
    cxy = dense_ops.torus_cells(pos, cell_size, lay.grid_dim)
    return (torch.div(cxy[:, 1], lay.gb, rounding_mode="floor"),
            torch.div(cxy[:, 0], lay.gx, rounding_mode="floor"))


def _ring_dir(dest, mine: int, size: int):
    """Shortest-direction step (-1/0/+1) from ``mine`` toward ``dest`` on a
    ring."""
    if size == 1:
        return torch.zeros_like(dest)
    diff = torch.remainder(dest - mine, size)
    return torch.where(diff == 0, 0, torch.where(diff <= size // 2, 1, -1))


# ---------------------------------------------------------- halo exchange --

def _exchange_rows(t, lay: SpatialLayout, mesh: Mesh, category: str):
    """Fill the ROW_PAD halo rows of ``t`` (F, RP + Gb + RP, W) from the ring
    neighbours, IN PLACE: the top halo is the band above's last RP real
    rows, the bottom halo the band below's first (the torus wrap in y)."""
    gb = lay.gb
    top_src = t[:, gb:gb + RP]         # my last rows -> the band below's top
    bot_src = t[:, RP:2 * RP]          # my first rows -> the band above's bottom
    if lay.db == 1:
        top, bot = top_src, bot_src    # disjoint from the halo rows (gb >= RP)
    else:
        top = mesh.ring_shift(top_src, BANDS, 1, category)
        bot = mesh.ring_shift(bot_src, BANDS, -1, category)
    t[:, :RP] = top
    t[:, RP + gb:] = bot
    return t


def _exchange_lanes(t, lay: SpatialLayout, mesh: Mesh, category: str):
    """Fill the ``lp`` halo lanes a side from the ring neighbours, IN PLACE
    (the torus wrap in x)."""
    lb, lp = lay.lb, lay.lp
    left_src = t[..., lb:lb + lp]      # my last lp real lanes
    right_src = t[..., lp:2 * lp]      # my first lp real lanes
    if lay.dx == 1:
        if lb < lp:                    # sources overlap the halo lanes
            left_src, right_src = left_src.clone(), right_src.clone()
        left, right = left_src, right_src
    else:
        left = mesh.ring_shift(left_src, BLOCKS, 1, category)
        right = mesh.ring_shift(right_src, BLOCKS, -1, category)
    t[..., :lp] = left
    t[..., lp + lb:] = right
    return t


def _exchange_halos(t, lay: SpatialLayout, mesh: Mesh, category: str):
    """Rows first, then lanes: the lane pass carries the four corners."""
    return _exchange_lanes(_exchange_rows(t, lay, mesh, category), lay, mesh,
                           category)


# --------------------------------------------------------- local binning --

def _bin_local(pos, inv_mass, radius, batch_slot, active, cell_size,
               band: int, block: int, lay: SpatialLayout, aux_cols):
    """Sort-bin this rank's particles into its padded plane window.

    Bit for bit the JAX package's ``_bin_local``: the rotating winner hash
    of the position bits with buckets from the GLOBAL grid (so winner sets
    match the single-card engine), ``segment_extent`` ranks, slots with the
    halo offsets baked in, ``FIELD_OCC`` the cell's true occupancy. Returns
    ``(planes, aux, slot, in_grid, transit)``: ``slot`` addresses the padded
    ``(rows, width)`` window, ``rows * width`` for a particle out of the
    window or over the cell budget; the halos are zero. ``transit`` marks
    the active particles whose torus cell lies outside the window: the ones
    in transit. A particle over its cell's budget is in the window, so not
    in transit, though it integrates without collision all the same (the
    JAX package counts both kinds as in transit: its count is this one plus
    the over-budget particles).
    """
    n = pos.shape[0]
    dev = pos.device
    g, k = lay.grid_dim, lay.slots_per_cell
    gb, gx, lp = lay.gb, lay.gx, lay.lp
    rows, width = lay.rows, lay.width

    cxy = dense_ops.torus_cells(pos, cell_size, g)
    ly = cxy[:, 1] - band * gb                        # local row
    lx = cxy[:, 0] - block * gx                       # local cell column
    in_win = (ly >= 0) & (ly < gb) & (lx >= 0) & (lx < gx) & active
    local_cell = torch.where(in_win, ly * gx + lx, gb * gx)

    hb = dense_ops.rotate_hash_buckets(g)
    key = local_cell * hb + dense_ops._winner_hash(pos, hb)
    key_sorted, pidx_sorted = torch.sort(key, stable=True)
    cid_sorted = torch.div(key_sorted, hb, rounding_mode="floor")
    rank, cnt_sorted = segment_extent(cid_sorted)
    ok = (rank < k) & (cid_sorted < gb * gx)
    row_s = torch.div(cid_sorted, gx, rounding_mode="floor")
    col_s = cid_sorted - row_s * gx
    slot_sorted = torch.where(ok, (row_s + RP) * width + lp + col_s * k + rank,
                              rows * width)
    slot = torch.empty_like(slot_sorted)
    slot[pidx_sorted] = slot_sorted
    occ_col = torch.empty((n,), dtype=torch.float32, device=dev)
    occ_col[pidx_sorted] = cnt_sorted.to(torch.float32)

    idx = torch.arange(n, device=dev)
    cols = [pos[:, 0], pos[:, 1], inv_mass, radius,
            batch_slot.to(torch.float32), torch.zeros((n,), device=dev),
            idx.to(torch.float32), torch.where(active, occ_col, 0.0)]
    pack = torch.stack(cols, dim=1)
    if aux_cols is not None:
        pack = torch.cat([pack, aux_cols], dim=1)

    grid_idx = torch.full((rows * width + 1,), -1, dtype=torch.int64,
                          device=dev)
    grid_idx[torch.where(ok, slot_sorted, rows * width)] = pidx_sorted
    grid_idx = grid_idx[:-1]
    occupied = grid_idx >= 0
    # field-major gather (as ops/dense.bin_to_planes): contiguous planes
    all_planes = torch.where(occupied,
                             pack.T.contiguous()[:, torch.clamp(grid_idx, min=0)],
                             0.0).reshape(pack.shape[1], rows, width)
    planes = all_planes[:dense_ops.N_FIELDS]
    aux = all_planes[dense_ops.N_FIELDS:] if aux_cols is not None else None
    return planes, aux, slot, slot < rows * width, active & ~in_win


# ----------------------------------------------------------- plane sweep --

def _sweep_local(planes, params_packed, lay: SpatialLayout, cohesion: bool,
                 wide=False):
    """Pair sweep over the local padded window -> (2, Gb, W) corrections.

    Kernel D (``sweep_kernel.sweep_planes``) on a window that is not a
    torus: partner rows are read through the halo rows (the window's
    ROW_PAD rows cover the +-3 row reach), lanes wrap mod the window's width
    (the halo lanes, ``lp >= 4K``, cover the 4K - 1 lane reach, and ``lp``
    is a whole number of cells, so the lane mask stays in phase); the halo
    lanes' corrections are garbage that the next halo exchange overwrites.
    The fresh-cell mask's modulus is the GLOBAL grid (``params[6]``, set by
    :func:`_pop_env`). ``wide`` is a bool (static window) or a 0-dim device
    flag: true selects window 3 with the fresh mask. Always the one-sided
    kernel: the symmetric one (E) folds pushes into its partners' slots,
    and a window's halo slots belong to the neighbours."""
    kw = dict(cohesion=cohesion, ordered_budget=False)
    if isinstance(wide, torch.Tensor):
        kw["wide"] = wide
    else:
        kw.update(window=3 if wide else 1, fresh_mask=bool(wide))
    return sweep_kernel.sweep_planes(planes, params_packed,
                                     lay.slots_per_cell, **kw)


# ------------------------------------------------------------- migration --

def _pack_migrants(fields, send_mask, cap: int):
    """Select up to ``cap`` masked rows into a fixed (cap, F + 1) buffer, the
    last column the validity flag; ascending particle index (a stable
    sort). Returns ``(buffer, sent)``."""
    n = send_mask.shape[0]
    key = torch.where(send_mask, 0, 1).to(torch.int32)
    _, idx_sorted = torch.sort(key, stable=True)
    take = idx_sorted[:cap]
    valid = send_mask[take]
    rows = torch.where(valid[:, None], fields[take], 0.0)
    sent = torch.zeros((n,), dtype=torch.bool, device=fields.device)
    sent[take] = valid
    return torch.cat([rows, valid[:, None].to(torch.float32)], dim=1), sent


def _place_migrants(fields, active, bufs, n_free_needed: int):
    """Scatter received migrant rows into free (inactive) slots.

    Returns ``(fields, active, n_dropped)``: rows beyond the free-slot supply
    are dropped and counted. Out-of-range gathers clamp, as XLA's do; a row
    that finds no free slot is written to a dump row past the end (JAX's
    ``mode="drop"``), so the scatter needs no boolean mask and reads nothing
    from the device."""
    n = active.shape[0]
    dev = fields.device
    key = torch.where(active, 1, 0).to(torch.int32)      # free slots first
    _, idx_sorted = torch.sort(key, stable=True)
    free = idx_sorted[:n_free_needed]
    free_ok = ~active[free]
    free_ext = torch.cat([free, torch.zeros((1,), dtype=free.dtype,
                                            device=dev)])
    ok_ext = torch.cat([free_ok, torch.zeros((1,), dtype=torch.bool,
                                             device=dev)])
    offset = torch.zeros((), dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    fields = torch.cat([fields, fields.new_zeros((1, fields.shape[1]))])
    active = torch.cat([active, active.new_zeros((1,))])
    for buf in bufs:
        rows, valid = buf[:, :-1], buf[:, -1] > 0.5
        cap = rows.shape[0]
        # this buffer's valid rows to the front
        _, vsort = torch.sort(torch.where(valid, 0, 1).to(torch.int32),
                              stable=True)
        rows, valid = rows[vsort], valid[vsort]
        nv = torch.sum(valid)
        dst_i = offset + torch.arange(cap, device=dev)
        dst_ok = valid & (dst_i < n_free_needed)
        dst = torch.clamp(torch.where(dst_ok, dst_i, n_free_needed),
                          max=free_ext.shape[0] - 1)
        usable = dst_ok & ok_ext[dst]
        target = torch.where(usable, free_ext[dst], n)   # n: the dump row
        fields[target] = rows
        active.index_fill_(0, target, True)   # a fill: no host copy
        dropped = dropped + torch.sum(valid & ~usable)
        offset = offset + nv
    return fields[:n], active[:n], dropped


def _migrate_axis(fields, active, want_dir, axis: str, size: int, cap: int,
                  mesh: Mesh):
    """One-hop ring migration along one mesh axis. Returns the updated
    ``(fields, active, n_dropped)``."""
    if size == 1:
        return fields, active, torch.zeros((), dtype=torch.int64,
                                           device=fields.device)
    up_buf, up_sent = _pack_migrants(fields, active & (want_dir > 0), cap)
    dn_buf, dn_sent = _pack_migrants(fields, active & (want_dir < 0), cap)
    active = active & ~up_sent & ~dn_sent
    up_recv = mesh.ring_shift(up_buf, axis, 1, "migration")
    dn_recv = mesh.ring_shift(dn_buf, axis, -1, "migration")
    return _place_migrants(fields, active, (up_recv, dn_recv), 2 * cap)


def _migrate(fields, active, cell_size, lay: SpatialLayout, mesh: Mesh):
    """Both axes' migration, y then x (the x phase recomputes owners, so
    rows received in y move on in x the same step). Returns ``(fields,
    active, n_dropped)``."""
    band, block = mesh.coords
    dest_b, _ = owner_of(fields[:, 0:2], cell_size, lay)
    fields, act2, drop_y = _migrate_axis(
        fields, active, _ring_dir(dest_b, band, lay.db), BANDS, lay.db,
        lay.migrate_cap, mesh)
    _, dest_x = owner_of(fields[:, 0:2], cell_size, lay)
    fields, act3, drop_x = _migrate_axis(
        fields, act2, _ring_dir(dest_x, block, lay.dx), BLOCKS, lay.dx,
        lay.migrate_cap, mesh)
    return fields, act3, drop_y + drop_x


def _fields(pos, prev, vel, last, radius, mass_t, inv_mass, batch_slot,
            color):
    """The (C, 16) migrant row of every particle (JAX's concatenation)."""
    return torch.cat([pos, prev, vel, last, radius[:, None], mass_t[:, None],
                      inv_mass[:, None],
                      batch_slot.to(torch.float32)[:, None], color], dim=1)


def _unpack(fields, act):
    """The state fields of migrant rows (inactive rows: radius, inverse
    mass 0, batch slot -1, the rest as carried)."""
    return dict(pos=fields[:, 0:2], prev=fields[:, 2:4], vel=fields[:, 4:6],
                last_pos=fields[:, 6:8],
                radius=torch.where(act, fields[:, 8], 0.0),
                mass_t=fields[:, 9],
                inv_mass=torch.where(act, fields[:, 10], 0.0),
                batch_slot=torch.where(act, fields[:, 11].to(torch.int32), -1),
                color=fields[:, 12:16])


# --------------------------------------------------- shared step pieces --

def _pop_env(cfg: DeviceConfig, mass_t, active, batch_slot, batch_target,
             follow_radius, sub_dt, options: SolverOptions,
             lay: SpatialLayout):
    """Per-population step environment (the reference's env, :1726-1786)."""
    damp = 1.0 - torch.clamp(cfg.damping, 0.0, 1.0)
    mass = torch_mix(cfg.min_mass, cfg.max_mass, mass_t)
    inv_mass = torch.where(active, 1.0 / torch.clamp(mass, min=1e-12), 0.0)
    radius = torch.where(active, torch_mix(cfg.min_radius, cfg.max_radius,
                                           mass_t), 0.0)
    follow_c = solver_ops.strength_to_compliance(cfg.follow_strength, sub_dt)
    collision_c = solver_ops.strength_to_compliance(cfg.collision_strength,
                                                    sub_dt)
    cohesion_c = solver_ops.strength_to_compliance(cfg.cohesion_strength,
                                                   sub_dt)
    cell_size, params = solver_ops._dense_params(cfg, active, collision_c,
                                                 cohesion_c, options)
    # fresh cells of the wide sweep wrap on the GLOBAL torus: a window's
    # width is not G * K, so the default lanes // K modulus would reject the
    # globally wrap-adjacent cells G - 1 and 0
    params = params._replace(fresh_mod=float(lay.grid_dim))
    table = torch.cat([batch_target, follow_radius[:, None]], dim=1)
    rows3 = table[torch.clamp(batch_slot, min=0).to(torch.int64)]
    return dict(damp=damp, inv_mass=inv_mass, radius=radius,
                follow_c=follow_c, cell_size=cell_size,
                params=params.pack(mass_t.device),
                tx=rows3[:, 0], ty=rows3[:, 1], td=2.0 * rows3[:, 2])


def _real(x, lay: SpatialLayout):
    return x[..., RP:RP + lay.gb, lay.lp:lay.lp + lay.lb]


def _plane_run_local(planes, aux, env, sub_dt, relaxation,
                     options: SolverOptions, lay: SpatialLayout, mesh: Mesh,
                     cohesion: bool, n_live, wide=None):
    """``n_substeps`` of the substep pipeline on the local window, IN PLACE
    on ``planes`` and ``aux``; the X/Y halos are exchanged after every
    collision pass (JAX ``_plane_run_local``).

    The violence gate's drift metric reduces over the real rows and lanes
    and is summed over the mesh, so every rank gets the same flag; the flag
    stays on the device and kernel D reads it. ``wide_budget_substeps == 0``
    turns the gate off statically (window 1, the episode state passed
    through), as on one card. Returns the episode state ``(trip, budget,
    calm)``."""
    A = solver_ops
    X, Y = dense_ops.FIELD_X, dense_ops.FIELD_Y
    dev = planes.device
    if wide is None:
        wide = A.wide_state_init(options, dev)
    gate = options.wide_budget_substeps != 0
    if gate:
        thresh2 = (options.wide_threshold_cells * env["cell_size"]) ** 2
        occ = torch.clamp(_real(planes[dense_ops.FIELD_OCC], lay), max=1.0)
        n_occ = torch.clamp(mesh.psum(torch.sum(occ)), min=1.0)
        tol = options.wide_tolerance * n_live

        def rel_over(dxp, dyp):
            """Occupied real slots whose drift relative to the mesh-wide
            mean passes the violence threshold."""
            m = mesh.psum(torch.stack([torch.sum(dxp), torch.sum(dyp)])) / n_occ
            rel2 = (dxp - m[0] * occ) ** 2 + (dyp - m[1] * occ) ** 2
            return mesh.psum(torch.sum(rel2 > thresh2).to(torch.float32))

        # the velocity-predicted movement gates the very first substep
        pred = rel_over(_real(aux[A.AUX_VX], lay) * occ * sub_dt,
                        _real(aux[A.AUX_VY], lay) * occ * sub_dt)
        trip, budget, calm = wide
        trip = trip | (pred > tol)
    for _ in range(options.n_substeps):
        if gate:
            move_ref = _real(planes[X:Y + 1], lay).clone()
            wide_now = trip & (budget > 0)
        else:
            wide_now = False
        aux[A.AUX_VX:A.AUX_VY + 1] *= env["damp"]
        aux[A.AUX_PX:A.AUX_PY + 1] = planes[X:Y + 1]
        x = aux[A.AUX_PX] + sub_dt * aux[A.AUX_VX]
        y = aux[A.AUX_PY] + sub_dt * aux[A.AUX_VY]
        dx, dy = A._follow_delta(x, y, planes[dense_ops.FIELD_W],
                                 planes[dense_ops.FIELD_OCC] > 0.0,
                                 aux[A.AUX_TX], aux[A.AUX_TY], aux[A.AUX_TD],
                                 env["follow_c"])
        planes[X] = x + dx
        planes[Y] = y + dy
        for _ in range(options.n_collision_steps):
            corr = _sweep_local(planes, env["params"], lay, cohesion,
                                wide=wide_now)
            planes[X, RP:RP + lay.gb] += relaxation * corr[0]
            planes[Y, RP:RP + lay.gb] += relaxation * corr[1]
            # refresh only the X/Y halos the correction touched
            _exchange_halos(planes[X:Y + 1], lay, mesh, "xy_refresh_per_pass")
        if gate:
            budget = torch.where(wide_now, budget - 1, budget)
            # movement DURING this substep decides the next one's window
            disp = _real(planes[X:Y + 1], lay) - move_ref
            n_over = rel_over(disp[0] * occ, disp[1] * occ)
            trip = n_over > tol
            calm = torch.where(trip, 0, calm + 1).to(torch.int32)
            budget = torch.where(calm >= options.wide_rearm_substeps,
                                 options.wide_budget_substeps, budget
                                 ).to(torch.int32)
        aux[A.AUX_VX:A.AUX_VY + 1] = (planes[X:Y + 1]
                                      - aux[A.AUX_PX:A.AUX_PY + 1]) / sub_dt
    return (trip, budget, calm) if gate else wide


def _extract_local(planes, aux, slot):
    """(pos, prev, vel, in_grid) per local particle; ``FIELD_OCC`` guards
    against unplaced slots."""
    A = solver_ops
    ext = torch.stack([planes[dense_ops.FIELD_X], planes[dense_ops.FIELD_Y],
                       aux[A.AUX_PX], aux[A.AUX_PY], aux[A.AUX_VX],
                       aux[A.AUX_VY], planes[dense_ops.FIELD_OCC]],
                      dim=-1).reshape(-1, 7)
    got = ext[torch.clamp(slot, max=ext.shape[0] - 1)]
    in_grid = (slot < planes.shape[1] * planes.shape[2]) & (got[:, 6] > 0.0)
    return got[:, 0:2], got[:, 2:4], got[:, 4:6], in_grid


def _fallback_steps(pos, vel, env, active, sub_dt, n_sub: int):
    """Integration without collision for particles outside the window or
    over the cell budget (the reference's past-cutoff behaviour,
    :1656-1658)."""
    fb_p, fb_v, fb_prev = pos, vel, pos
    for _ in range(n_sub):
        fb_v = fb_v * env["damp"]
        fb_prev = fb_p
        fb_p = fb_p + sub_dt * fb_v
        fdx, fdy = solver_ops._follow_delta(
            fb_p[:, 0], fb_p[:, 1], env["inv_mass"], active, env["tx"],
            env["ty"], env["td"], env["follow_c"])
        fb_p = fb_p + torch.stack([fdx, fdy], dim=1)
        fb_v = (fb_p - fb_prev) / sub_dt
    return fb_p, fb_prev, fb_v


def _bin_and_exchange(pos, vel, batch_slot, active, env, lay, mesh):
    """Bin the local particles with the plane step's ride-along fields and
    fill every halo: ``(planes, aux, slot, transit)`` (:func:`_bin_local`)."""
    band, block = mesh.coords
    aux_cols = torch.stack([pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1],
                            env["tx"], env["ty"], env["td"]], dim=1)
    planes, aux, slot, _, transit = _bin_local(
        pos, env["inv_mass"], env["radius"], batch_slot, active,
        env["cell_size"], band, block, lay, aux_cols)
    _exchange_halos(planes, lay, mesh, "full_halo_exchange")
    _exchange_halos(aux, lay, mesh, "full_halo_exchange")
    return planes, aux, slot, transit


def _stats(finals, max_batches: int, mesh: Mesh) -> StepStats:
    """Global step statistics of both populations from each one's final
    migrant rows and liveness ``(fields, act)``."""
    return global_stats(
        [(f[:, 0:2], f[:, 6:8], f[:, 4:6], torch.where(act, f[:, 8], 0.0),
          act, torch.clamp(torch.where(act, f[:, 11].to(torch.int64), -1),
                           min=0)) for f, act in finals],
        max_batches, mesh)


def _new_state(state: ParticleState, outs) -> ParticleState:
    """``state`` with both populations' unpacked fields stacked."""
    return state.replace(**{f: torch.stack([o[f] for o in outs])
                            for f in outs[0]})


# ------------------------------------------------------------- the step --

def spatial_step(mesh: Mesh, lay: SpatialLayout, options: SolverOptions):
    """The 2D spatially sharded dense step.

    ``step(state, cfg2, step_delta, relaxation) -> (state, stats, info)``
    on this rank's slice, with ``batch_slot < 0`` marking inactive slots
    (see :func:`redistribute`); the semantics of the single-card dense
    engine with ``budget_mode='off'`` and ``dense_rebin='step'``. ``info``
    is a (2, 2) int64 tensor of (migration-dropped, in-transit) counts per
    population, summed over the mesh; in transit: active at the step's
    start, in a torus cell outside the rank's window (:func:`_bin_local`).
    The step reads nothing from the device."""
    lay.check()
    if options.budget_mode != "off":
        raise ValueError("spatial_step implements budget_mode='off' (the "
                         "ordered 0.05 n^2 cutoff is inert at multi-device "
                         "counts)")
    n_sub = options.n_substeps
    cohesion = options.cohesion_mode == "spacing"

    @torch.no_grad()
    def step(state: ParticleState, cfg2: DeviceConfig, step_delta,
             relaxation):
        dev = state.device
        step_delta = torch.as_tensor(step_delta, dtype=torch.float32,
                                     device=dev)
        sub_dt = torch.clamp(step_delta / n_sub, min=EPS)
        follow_radius = torch.sqrt(torch.clamp(state.batch_radius, min=0.0))
        outs, finals, info = [], [], []
        for i in range(2):
            cfg = population_config(cfg2, i)
            active = state.batch_slot[i] >= 0
            pos, vel = state.pos[i], state.vel[i]
            env = _pop_env(cfg, state.mass_t[i], active, state.batch_slot[i],
                           state.batch_target, follow_radius[i], sub_dt,
                           options, lay)
            planes, aux, slot, transit = _bin_and_exchange(
                pos, vel, state.batch_slot[i], active, env, lay, mesh)
            n_live = torch.clamp(mesh.psum(torch.sum(active).to(
                torch.float32)), min=1.0)
            _plane_run_local(planes, aux, env, sub_dt, relaxation, options,
                             lay, mesh, cohesion, n_live)
            p_pl, prev_pl, v_pl, in_grid = _extract_local(planes, aux, slot)
            fb_p, fb_prev, fb_v = _fallback_steps(pos, vel, env, active,
                                                  sub_dt, n_sub)
            sel = (in_grid & active)[:, None]
            keep = active[:, None]
            new_pos = torch.where(sel, p_pl, torch.where(keep, fb_p, pos))
            new_prev = torch.where(sel, prev_pl,
                                   torch.where(keep, fb_prev, state.prev[i]))
            new_vel = torch.where(sel, v_pl, torch.where(keep, fb_v, vel))
            n_transit = torch.sum(transit)

            fields = _fields(new_pos, new_prev, new_vel, pos, env["radius"],
                             state.mass_t[i], env["inv_mass"],
                             state.batch_slot[i], state.color[i])
            fields, act, dropped = _migrate(fields, active, env["cell_size"],
                                            lay, mesh)
            outs.append(_unpack(fields, act))
            finals.append((fields, act))
            info.append(torch.stack([dropped, n_transit]))
        stats = _stats(finals, state.max_batches, mesh)
        info = mesh.psum(torch.stack(info))
        return _new_state(state, outs), stats, info

    return step


# -------------------------------------------------------- resident steps --

def _count_read(pop_index: int, taken: bool) -> None:
    global host_reads
    host_reads += 1
    if taken:
        rebins[pop_index] += 1


def _rebin_if(pred, pop_index: int, fn, cond=None) -> None:
    """The resident rebin decision on the psum'd predicate (JAX: a
    ``lax.cond``), :func:`.solver.rebin_if`: run ``fn`` when ``pred`` is
    true, read on the host (counted in ``host_reads``; ``rebins`` counts the
    branches taken) unless ``cond`` records the branch (a capture)."""
    solver_ops.rebin_if(pred, pop_index, fn, cond=cond, count=_count_read)


class _SpatialPop:
    """One population's carry across resident steps (JAX
    ``spatial_multi_step``'s per-population carry): the local plane window,
    the particle arrays, the drift reference, the in-transit mask of the last
    binning, the migration drop count and the wide-gate state, in buffers
    that :meth:`step` and :meth:`rebin`
    update in place, so a captured step replays on fixed addresses.
    Construction is the *enter*: bin this rank's particles and fill every
    halo."""

    # per-particle arrays of the carry, in the order _fields packs them
    ARRAYS = ("pos", "prev", "vel", "last", "radius", "mass_t", "inv_mass",
              "batch_slot", "color")

    def __init__(self, loop: "SpatialSteps", i: int, wide):
        st = loop.state
        self.loop, self.i = loop, i
        active = st.batch_slot[i] >= 0
        env, self.planes, self.aux, self.slot, self.transit = loop.bin(
            i, st.pos[i], st.vel[i], st.mass_t[i], st.batch_slot[i], active)
        # the particle-independent pieces, stable across migrations
        self.static_env = {k: env[k] for k in
                           ("damp", "follow_c", "cell_size", "params")}
        self.thresh2 = (0.25 * env["cell_size"]) ** 2
        # copies: the steps update them in place
        self.ref_pos = st.pos[i].clone()
        self.pos, self.prev, self.vel = (st.pos[i].clone(),
                                         st.prev[i].clone(),
                                         st.vel[i].clone())
        self.last = st.pos[i].clone()
        self.mass_t = st.mass_t[i].clone()
        self.batch_slot = st.batch_slot[i].clone()
        self.color = st.color[i].clone()
        self.inv_mass, self.radius = env["inv_mass"], env["radius"]
        self.tx, self.ty, self.td = env["tx"], env["ty"], env["td"]
        self.dropped = torch.zeros((), dtype=torch.int64, device=st.device)
        self.ws = [t.clone() for t in wide]

    def _env(self):
        return dict(self.static_env, inv_mass=self.inv_mass,
                    radius=self.radius, tx=self.tx, ty=self.ty, td=self.td)

    def fields(self):
        """The (C, 16) migrant row of every particle of the carry."""
        return _fields(*(getattr(self, f) for f in self.ARRAYS))

    def step(self, cond=None) -> None:
        """One resident step: the substeps on the window, the fallback
        integration, the particle arrays merged, then the rebin when the
        drift since bin time, relative to the mesh-wide mean, passes a
        quarter cell for more than ``rebin_tolerance`` of the live
        particles (counts summed over the mesh: every rank branches
        alike)."""
        lp, mesh, options = self.loop, self.loop.mesh, self.loop.options
        act = self.batch_slot >= 0
        env = self._env()
        n_live = torch.clamp(mesh.psum(torch.sum(act).to(torch.float32)),
                             min=1.0)
        ws = _plane_run_local(self.planes, self.aux, env, lp.sub_dt,
                              lp.relaxation, options, lp.lay, mesh,
                              lp.cohesion, n_live, wide=tuple(self.ws))
        _copy_into(self.ws, ws)
        fb_p, fb_prev, fb_v = _fallback_steps(self.pos, self.vel, env, act,
                                              lp.sub_dt, options.n_substeps)
        p_pl, prev_pl, v_pl, in_grid = _extract_local(self.planes, self.aux,
                                                      self.slot)
        sel = (in_grid & act)[:, None]
        p = torch.where(sel, p_pl, fb_p)
        # pre-step positions anchor frame interpolation
        _copy_into((self.last, self.pos, self.prev, self.vel),
                   (self.pos, p, torch.where(sel, prev_pl, fb_prev),
                    torch.where(sel, v_pl, fb_v)))
        d = p - self.ref_pos
        mean_d = mesh.psum(torch.sum(torch.where(act[:, None], d, 0.0),
                                     dim=0)) / n_live
        rel2 = torch.sum((d - mean_d) ** 2, dim=1)
        n_over = mesh.psum(torch.sum(act & (rel2 > self.thresh2)).to(
            torch.float32))
        _rebin_if(n_over > options.rebin_tolerance * n_live, self.i,
                  self.rebin, cond)

    def rebin(self) -> None:
        """The rebin branch: migrate movers one hop (y then x), bin again
        and exchange every field's halo on the new ownership, all written
        into the carry's buffers; adds one to the loop's counter."""
        lp = self.loop
        fields, act3, dropped = _migrate(
            self.fields(), self.batch_slot >= 0,
            self.static_env["cell_size"], lp.lay, lp.mesh)
        pos, vel, mass_t = fields[:, 0:2], fields[:, 4:6], fields[:, 9]
        batch_slot = torch.where(act3, fields[:, 11].to(torch.int32), -1)
        env, planes, aux, slot, transit = lp.bin(self.i, pos, vel, mass_t,
                                                 batch_slot, act3)
        _copy_into((self.planes, self.aux, self.slot, self.transit,
                    self.ref_pos, self.pos, self.prev, self.vel, self.last,
                    self.mass_t, self.batch_slot, self.color, self.inv_mass,
                    self.radius, self.tx, self.ty, self.td),
                   (planes, aux, slot, transit, pos, pos, fields[:, 2:4], vel,
                    fields[:, 6:8], mass_t, batch_slot, fields[:, 12:16],
                    env["inv_mass"], env["radius"], env["tx"], env["ty"],
                    env["td"]))
        self.dropped.add_(dropped)
        if lp.counter is not None:
            lp.counter[self.i].add_(1)


class SpatialSteps:
    """The resident steps of :func:`spatial_multi_step`, both populations,
    in three parts: construction (*enter*: bin this rank's particles and
    fill the halos), :meth:`step` (one resident step) and :meth:`exit` (the
    final migration, which restores the ownership invariant, and the
    stats). Every part reads and writes buffers made at the enter, so each
    can be captured once and replayed (``parallel/spatial_graph.py``);
    ``pops[i].rebin`` is population ``i``'s rebin branch. ``counter`` (a
    (2,) int32 device tensor or None) adds one per rebin at the
    population's index; ``cond`` goes to :func:`_rebin_if`."""

    @staticmethod
    def check(lay: SpatialLayout, options: SolverOptions) -> None:
        """Raise unless ``lay`` and ``options`` admit the resident steps."""
        lay.check()
        if options.budget_mode != "off" or options.dense_rebin != "step":
            raise ValueError("spatial_multi_step requires the plane-resident "
                             "dense configuration (budget_mode='off', "
                             "dense_rebin='step')")

    def __init__(self, mesh: Mesh, lay: SpatialLayout, options: SolverOptions,
                 state: ParticleState, cfg2: DeviceConfig, step_delta,
                 relaxation, wide_state=None, counter=None):
        self.mesh, self.lay, self.options = mesh, lay, options
        self.state, self.relaxation, self.counter = state, relaxation, counter
        self.cohesion = options.cohesion_mode == "spacing"
        dev = state.device
        step_delta = torch.as_tensor(step_delta, dtype=torch.float32,
                                     device=dev)
        self.sub_dt = torch.clamp(step_delta / options.n_substeps, min=EPS)
        self.follow_radius = torch.sqrt(torch.clamp(state.batch_radius,
                                                    min=0.0))
        self.cfgs = [population_config(cfg2, i) for i in range(2)]
        if wide_state is None:
            wide_state = [solver_ops.wide_state_init(options, dev)
                          for _ in range(2)]
        self.pops = [_SpatialPop(self, i, wide_state[i]) for i in range(2)]

    def bin(self, i, pos, vel, mass_t, batch_slot, active):
        """Population ``i``'s environment, binned window, slots and
        in-transit mask."""
        env = _pop_env(self.cfgs[i], mass_t, active, batch_slot,
                       self.state.batch_target, self.follow_radius[i],
                       self.sub_dt, self.options, self.lay)
        return (env, *_bin_and_exchange(pos, vel, batch_slot, active, env,
                                        self.lay, self.mesh))

    def step(self, cond=None) -> None:
        for p in self.pops:
            p.step(cond)

    def exit(self):
        """``(fields, stats, info, wide_state)``: the state fields the steps
        wrote (``_new_state``'s form, fresh tensors), the step statistics,
        the (2, 2) (migration-dropped, in-transit) counts summed over the
        mesh, and the carried wide-gate state. In transit: the slots active
        after the final migration whose particle the last binning found
        outside the window (the JAX package counts every slot that binning
        left unplaced: these, the over-budget particles' and the empty
        ones')."""
        outs, finals, info = [], [], []
        for p in self.pops:
            fields, act, dropped = _migrate(
                p.fields(), p.batch_slot >= 0, p.static_env["cell_size"],
                self.lay, self.mesh)
            outs.append(_unpack(fields, act))
            finals.append((fields, act))
            n_transit = torch.sum(act & p.transit)
            info.append(torch.stack([p.dropped + dropped, n_transit]))
        stats = _stats(finals, self.state.max_batches, self.mesh)
        info = self.mesh.psum(torch.stack(info))
        fields = {f: torch.stack([o[f] for o in outs]) for f in outs[0]}
        return fields, stats, info, tuple(tuple(p.ws) for p in self.pops)


def spatial_multi_step(mesh: Mesh, lay: SpatialLayout,
                       options: SolverOptions):
    """Plane-RESIDENT steps over the 2D spatial mesh (JAX
    ``spatial_multi_step``), run eagerly (:class:`SpatialSteps`).

    Each rank keeps its local plane window across steps and pays per step
    only the substeps and their X/Y halo refreshes. A fresh binning, the
    full-field halo exchange and one-hop migration run only when the drift
    since bin time, summed over the mesh, passes a quarter cell for more
    than ``rebin_tolerance`` of the live particles: every rank reads the
    same sum, so the ranks branch alike. This eager loop reads the decision
    on the host, one read per population and step (``host_reads``); the
    replayed loop of ``parallel/spatial_graph.py`` takes it on the device.
    Between rebins particles that crossed an ownership boundary stay in
    their bin-time rank's planes, pair-correct through the halos.

    Returns ``fn(state, cfg2, step_delta, relaxation, n_steps,
    wide_state=None) -> (state, stats, info, wide_state_out)``; ``info`` is
    (2, 2): (migration-dropped, in-transit)."""
    SpatialSteps.check(lay, options)

    @torch.no_grad()
    def call(state: ParticleState, cfg2: DeviceConfig, step_delta,
             relaxation, n_steps: int, wide_state=None):
        loop = SpatialSteps(mesh, lay, options, state, cfg2, step_delta,
                            relaxation, wide_state)
        for _ in range(int(n_steps)):
            loop.step()
        fields, stats, info, wide = loop.exit()
        return state.replace(**fields), stats, info, wide

    return call


# ----------------------------------------------------------- redistribute --

def _host_layout(state: ParticleState, cfg2_cell_size, lay: SpatialLayout,
                 from_spatial: bool):
    """The whole spatial-layout particle arrays of ``state`` (numpy, keyed
    by field), computed on the host as the JAX package's ``redistribute``
    does: each population's live particles sorted into the rank slices by
    torus-cell owner, stably (in particle order); padding inactive with
    ``batch_slot = -1``."""
    n_dev = lay.db * lay.dx
    cap = state.capacity
    if cap % n_dev != 0:
        raise ValueError(f"capacity {cap} does not divide over {n_dev} ranks")
    c_loc = cap // n_dev
    out = {f: getattr(state, f).cpu().numpy().copy()
           for f in PARTICLE_FIELDS}
    counts = state.count.cpu().numpy()
    for i in range(2):
        if from_spatial:
            live_idx = np.nonzero(out["batch_slot"][i] >= 0)[0]
        else:
            live_idx = np.arange(int(counts[i]))
        pos = out["pos"][i][live_idx]
        cell = np.floor(pos / np.float32(np.asarray(cfg2_cell_size)[i]))
        cxy = np.mod(cell.astype(np.int64), lay.grid_dim)
        owner = (cxy[:, 1] // lay.gb) * lay.dx + (cxy[:, 0] // lay.gx)
        per_dev = np.bincount(owner, minlength=n_dev)
        if per_dev.max() > c_loc:
            raise ValueError(
                f"spatial redistribute overflow: a device needs "
                f"{int(per_dev.max())} slots but slice capacity is {c_loc}; "
                f"increase capacity or mesh size")
        order = np.argsort(owner, kind="stable")
        sorted_owner = owner[order]
        # rank within each device's contiguous run
        seg_starts = np.zeros(live_idx.size, np.int64)
        change = np.nonzero(np.diff(sorted_owner))[0] + 1
        seg_starts[change] = change
        seg_starts = np.maximum.accumulate(seg_starts)
        dst = sorted_owner * c_loc + np.arange(live_idx.size) - seg_starts
        for f in out:
            src = out[f][i][live_idx][order]
            fresh = (np.full_like(out[f][i], -1) if f == "batch_slot"
                     else np.zeros_like(out[f][i]))
            fresh[dst] = src
            out[f][i] = fresh
    return out


def redistribute(state: ParticleState, cfg2_cell_size, lay: SpatialLayout,
                 mesh: Mesh, from_spatial: bool = False) -> ParticleState:
    """Re-establish the spatial layout invariant from any state; returns
    this rank's slice.

    ``cfg2_cell_size``: (2,) per-population cell size. ``from_spatial=False``
    reads ``state`` as a whole prefix-contiguous handler state (live = the
    first ``count`` slots; the same on every rank); ``True`` as this rank's
    slice of a spatial-layout state (live = ``batch_slot >= 0``), gathered
    from every rank first. Every rank computes the same layout on the host
    (:func:`_host_layout`). Raises ``ValueError`` if a rank's share exceeds
    its slice."""
    lay.check()
    if lay.db * lay.dx != mesh.size:
        raise ValueError(f"layout {lay.db} x {lay.dx} on a mesh of "
                         f"{mesh.size} ranks")
    if from_spatial:
        state = unshard_state(state, mesh)
    out = _host_layout(state, cfg2_cell_size, lay, from_spatial)
    c_loc = state.capacity // mesh.size
    lo = mesh.rank * c_loc
    return state.replace(**{
        f: torch.from_numpy(np.ascontiguousarray(out[f][:, lo:lo + c_loc]))
        .to(mesh.device) for f in out},
        **{f: getattr(state, f).to(mesh.device) for f in
           ("count", "batch_target", "batch_radius", "batch_used")})


# ---------------------------------------------------------- sharded render --

@torch.no_grad()
def draw_frame(mesh: Mesh, state: ParticleState, stats: StepStats,
               cfg2: DeviceConfig, interpolation_alpha, threshold, smoothness,
               viewport_origin, *, opts2, vw: int, vh: int,
               use_lighting: bool, thickness=None):
    """One sharded frame (:func:`spatial_draw`): ``interpolation_alpha``,
    ``threshold`` and ``smoothness`` are 0-dim float32 tensors and
    ``viewport_origin`` a (2,) float32 tensor on the state's device;
    ``thickness`` each population's outline thickness as a host float
    (without it the outline pass reads ``cfg2``'s from the device). With
    ``thickness`` it reads nothing from the device, so a graph can capture
    it. Returns ``(frame (vh, vw, 4), audits (2, 2))``: each population's
    render-budget audit as ``render._render_frame`` gives it, [splats
    dropped past the per-bin budget, peak bin occupancy], the drops summed
    over the mesh and the peak its maximum, so every rank holds the same
    audit (and takes the same boost)."""
    dev = state.device
    f32 = dict(dtype=torch.float32, device=dev)
    alpha_t = interpolation_alpha
    centers = (stats.last_centroid
               + (stats.centroid - stats.last_centroid) * alpha_t)
    frame = torch.empty((vh, vw, 4), **f32)
    audits = []
    for i in (0, 1):  # white first, then yolk (:2163-2171)
        opts = opts2[i]
        cfg = population_config(cfg2, i)
        active = state.batch_slot[i] >= 0
        alpha_local, _, audit = render_ops.splat_population(
            state.pos[i], state.last_pos[i], state.vel[i],
            state.radius[i], state.color[i], active, centers[i], alpha_t,
            cfg.texture_scale, cfg.motion_blur, opts)
        audits.append(audit)
        # 1 - prod_rank(1 - a_rank), through one log-space sum
        log1m = torch.log(torch.clamp(1.0 - alpha_local, min=1e-30))
        alpha = 1.0 - torch.exp(mesh.psum(log1m, "render"))
        rgba = render_ops.post_population(
            alpha, None, cfg, threshold, smoothness, use_lighting, opts,
            None if thickness is None else thickness[i])
        # pasted at the RAW centroid like the reference (:2132-2133);
        # only the splat centres on the interpolated one
        corner = stats.centroid[i] - 0.5 * opts.canvas_size - viewport_origin
        composite_kernel.composite(frame, rgba, opts.canvas_size, corner,
                                   over_zero=i == 0)
    audits = torch.stack(audits)
    audits = torch.stack([mesh.psum(audits[:, 0], "render"),
                          mesh.pmax(audits[:, 1], "render")], dim=1)
    return frame, audits


def check_draw_options(opts2) -> None:
    if opts2[0].use_particle_color or opts2[1].use_particle_color:
        raise ValueError("spatial_draw does not support per-particle colour")


def spatial_draw(mesh: Mesh, lay: SpatialLayout, opts2, viewport,
                 threshold: float, smoothness: float, use_lighting: bool,
                 thickness=None):
    """A renderer of spatial-layout states over the mesh.

    Screen-blend accumulation is ``1 - prod(1 - a)`` over particles and the
    product factorizes over ranks: each rank splats only its own particles
    into the whole canvas (``render.splat_population``: kernel C on a card)
    and the canvases combine with one log-space sum over the mesh, at the
    coarse resolution (the blend does not commute with the resampling).
    Outline and lighting (at the resolution of each population's
    ``post_mode``) and the paste then run on every rank alike, so every
    rank returns the same frame. ``opts2``: (white, yolk) RenderOptions;
    per-particle colour is refused (``ValueError``), as the JAX package's
    ``spatial_draw`` refuses it. ``thickness``: see :func:`draw_frame`.

    Returns ``draw(state, stats, cfg2, interpolation_alpha) -> (frame (H,
    W, 4), audits (2, 2))``, the audit combined over the mesh (the JAX
    package's draw returns the frame alone and drops the audit).
    """
    check_draw_options(opts2)
    x, y, vw, vh = viewport

    def draw(state: ParticleState, stats: StepStats, cfg2: DeviceConfig,
             interpolation_alpha):
        f32 = dict(dtype=torch.float32, device=state.device)
        return draw_frame(
            mesh, state, stats, cfg2,
            torch.as_tensor(interpolation_alpha, **f32),
            torch.tensor(threshold, **f32), torch.tensor(smoothness, **f32),
            torch.tensor([x, y], **f32), opts2=opts2, vw=int(vw),
            vh=int(vh), use_lighting=use_lighting, thickness=thickness)

    return draw
