"""Dense cell-grid binning — the neighbour structure of the dense engine.

The counterpart of ``egg_fluid_simulation_tpu/ops/dense.py``. Particles are
binned into field *planes* of shape ``(F, G + 2*ROW_PAD, L)`` with
``L = G * K`` lanes: plane row = y cell (plus ``ROW_PAD`` torus halo rows top
and bottom), lane = ``x_cell * K + slot``. Cells are ``floor(pos / cell) mod
G``: the grid is a torus in both axes.

Two layouts, as in the JAX package:

- ``rotate=True`` (budget off; the fused path): which ``K`` members of a
  cell get slots is decided by a hash of their position bits folded into the
  sort key (the rotating winner order), reproduced bit for bit.
  ``FIELD_OCC`` carries the cell's true occupancy, over-budget members
  included.
- ``rotate=False`` (the ordered budget): a stable ``(cell_id, idx)`` sort, so
  the lowest indices of a cell win; ``FIELD_OCC`` is 1.0 and ``FIELD_CUM``
  carries the examined-pair prefix (:func:`update_cum_field`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.mathx import torch_scalar
from .grid import segment_extent, segmented_rank

__all__ = ["DenseBinning", "SweepParams", "bin_to_planes", "sort_bin", "fill_halo",
           "refresh_halo_xy", "update_cum_field", "lane_mask",
           "torus_cells", "rotate_hash_buckets", "FIELD_X", "FIELD_Y",
           "FIELD_W", "FIELD_R", "FIELD_BATCH", "FIELD_CUM", "FIELD_IDX",
           "FIELD_OCC", "N_FIELDS", "ROW_PAD", "TIE_X", "TIE_Y"]

# Separation axis for COINCIDENT pairs (dist <= eps), with an antisymmetric
# sign per pair side, so both sides push apart (see the JAX package).
TIE_X = 0.5403023  # cos(1) — oblique so lines don't align with the cell grid
TIE_Y = 0.8414710  # sin(1)

# field layout of the (F, G+2R, L) pair-plane tensor
FIELD_X = 0       # position x (px)
FIELD_Y = 1       # position y
FIELD_W = 2       # inverse mass
FIELD_R = 3       # radius
FIELD_BATCH = 4   # batch slot as float (exact below 2^24)
FIELD_CUM = 5     # exclusive prefix of examined-pair counts (ordered budget;
                  # 0 when the budget is off)
FIELD_IDX = 6     # particle index as float
FIELD_OCC = 7     # > 0 = occupied slot: the cell's TRUE occupancy with
                  # rotate=True, 1.0 in the ordered layout
N_FIELDS = 8

ROW_PAD = 8       # halo rows above/below the grid


class DenseBinning(NamedTuple):
    planes: torch.Tensor           # (8, G+2*ROW_PAD, L) f32 pair fields
    aux: Optional[torch.Tensor]    # (A, G+2*ROW_PAD, L) f32 ride-along fields
    slot: torch.Tensor             # (N,) i64 unpadded flat slot, G*L = dropped
    pidx_grid: Optional[torch.Tensor]  # (rows*L,) i64 particle per padded slot,
                                   # -1 empty; None on the placement path
    cell_size: torch.Tensor        # 0-dim f32


class SweepParams(NamedTuple):
    """Scalars of the pair sweep, packed to an (8,) float32 tensor."""
    collision_compliance: torch.Tensor
    cohesion_compliance: torch.Tensor
    collision_overlap_factor: torch.Tensor
    cohesion_factor: torch.Tensor
    max_pairs: torch.Tensor        # ordered-budget cutoff; +big when off
    cell_size: torch.Tensor = np.float32(1.0)   # fresh-cell mask of the wide sweep
    fresh_mod: torch.Tensor = np.float32(0.0)   # 0 = the plane's own G
    occ_boost_cap: torch.Tensor = np.float32(8.0)

    def pack(self, device) -> torch.Tensor:
        """The (8,) float32 tensor the sweeps read (no host copy: a CUDA
        graph can capture it)."""
        return torch.stack([torch_scalar(v, device) for v in self])


def fill_halo(t: torch.Tensor) -> torch.Tensor:
    """Copy the opposite grid edges into the halo rows (torus wrap in y),
    IN PLACE; returns ``t``.

    ``t`` is (F, ROW_PAD + G + ROW_PAD, L); real row r lives at ROW_PAD + r.
    Top halo := last ROW_PAD real rows, bottom halo := first ROW_PAD real rows.
    """
    g = t.shape[1] - 2 * ROW_PAD
    t[:, :ROW_PAD] = t[:, g:g + ROW_PAD]
    t[:, ROW_PAD + g:] = t[:, ROW_PAD:2 * ROW_PAD]
    return t


def refresh_halo_xy(planes: torch.Tensor) -> torch.Tensor:
    """Re-copy only the X/Y halo rows after an in-plane position update,
    IN PLACE; returns ``planes``."""
    fill_halo(planes[:2])
    return planes


def lane_mask(lanes: int, k: int, d: int, window: int = 1,
              device=None) -> torch.Tensor:
    """(lanes,) bool — pairs (l, l-d) whose cells are within +-window columns.

    cell(l) - cell(l-d) = -floor((s - d) / k) for s = l mod k. The pattern
    is k-periodic, so it also holds at the lane wrap, where columns 0 and
    G-1 are adjacent on the torus."""
    s = torch.arange(lanes, device=device) % k
    cell_diff = -torch.div(s - d, k, rounding_mode="floor")
    return torch.abs(cell_diff) <= window


def torus_cells(pos: torch.Tensor, cell_size, grid_dim: int) -> torch.Tensor:
    """(N, 2) int64 torus cell coords ``floor(pos / cell) mod G``.

    The pre-clamp bounds the float before the int cast (NaN/overflow
    safety); the cast truncates to int32 like the JAX package's."""
    c = torch.floor(pos / cell_size)
    c = torch.clamp(torch.where(torch.isfinite(c), c, 0.0), -1e9, 1e9)
    return torch.remainder(c.to(torch.int32), grid_dim).to(torch.int64)


def rotate_hash_buckets(grid_dim: int) -> int:
    """Hash buckets per cell for the rotating winner key: as many low bits as
    fit beside ``cell_id`` in a non-negative int32, capped at 4096."""
    return 1 << min(12, int(math.floor(math.log2((2**31 - 1)
                                                 / (grid_dim * grid_dim + 1)))))


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of int64 values into the int32 range."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _winner_hash(pos: torch.Tensor, hb: int) -> torch.Tensor:
    """The rotating winner hash of ``dense.bin_to_planes`` bit for bit:
    int32 multiplies that wrap, an arithmetic ``>> 15`` and a mask, over the
    float32 position bits. The products run in int64 and wrap explicitly."""
    p = pos.contiguous()
    xb = p[:, 0].contiguous().view(torch.int32).to(torch.int64)
    yb = p[:, 1].contiguous().view(torch.int32).to(torch.int64)
    h = _wrap_i32(_wrap_i32(xb * -1640531535) + _wrap_i32(yb * -2048144789))
    return torch.bitwise_and(torch.bitwise_xor(h, h >> 15), hb - 1)


def sort_bin(pos, inv_mass, radius, batch_slot, active, cell_size,
             *, grid_dim: int, slots_per_cell: int, cum=None, aux_cols=None,
             rotate: bool = False):
    """The sort half of :func:`bin_to_planes` (same keywords).

    Returns ``(slot_sorted, pidx_sorted, slot, pack, cell_sorted)``: the
    (N,) int64 slot of each cell-sorted entry (``G*L`` = over budget or
    inactive), the particle index of each sorted entry, the per-particle
    slot, the (N, 8 + A) float32 payload in particle order, and the cell id
    of each sorted entry (ascending; ``G*G`` for inactive entries), which is
    the search key of kernel A's chunks."""
    n = pos.shape[0]
    dev = pos.device
    g, k = grid_dim, slots_per_cell
    if g < 2 * ROW_PAD:
        raise ValueError("grid_dim must be at least 2*ROW_PAD")
    lanes = g * k

    cxy = torus_cells(pos, cell_size, g)
    cell_id = cxy[:, 1] * g + cxy[:, 0]
    cell_id = torch.where(active, cell_id, g * g)          # sentinel

    if rotate:
        # winner rank within a cell = hash of the position bits, folded into
        # the low bits of the sort key; the sort is STABLE, as jax.lax.sort is
        hb = rotate_hash_buckets(g)
        key = cell_id * hb + _winner_hash(pos, hb)
        key_sorted, pidx_sorted = torch.sort(key, stable=True)
        cid_sorted = torch.div(key_sorted, hb, rounding_mode="floor")
        rank, cnt_sorted = segment_extent(cid_sorted)
    else:
        # stable (cell_id, idx) order: the lowest indices of a cell win
        cid_sorted, pidx_sorted = torch.sort(cell_id, stable=True)
        rank = segmented_rank(cid_sorted)
    row = torch.div(cid_sorted, g, rounding_mode="floor")
    cx = cid_sorted - row * g
    slot_sorted = torch.where((rank < k) & (cid_sorted < g * g),
                              row * lanes + cx * k + rank, g * lanes)

    # per-particle slot (and cell count): the inverse permutation, a scatter
    slot = torch.empty_like(slot_sorted)
    slot[pidx_sorted] = slot_sorted
    if rotate:
        occ_col = torch.empty((n,), dtype=torch.float32, device=dev)
        occ_col[pidx_sorted] = cnt_sorted.to(torch.float32)
    else:
        occ_col = torch.ones((n,), dtype=torch.float32, device=dev)
    if cum is None:
        cum = torch.zeros((n,), dtype=torch.float32, device=dev)

    idx = torch.arange(n, device=dev)
    cols = [pos[:, 0], pos[:, 1], inv_mass, radius,
            batch_slot.to(torch.float32), cum, idx.to(torch.float32),
            torch.where(active, occ_col, 0.0)]
    pack = torch.stack(cols, dim=1)                        # (N, 8)
    if aux_cols is not None:
        pack = torch.cat([pack, aux_cols], dim=1)          # (N, 8 + A)
    return slot_sorted, pidx_sorted, slot, pack, cid_sorted


def bin_to_planes(pos, inv_mass, radius, batch_slot, active, cell_size,
                  *, grid_dim: int, slots_per_cell: int, cum=None,
                  aux_cols=None, use_placement: bool = False,
                  rotate: bool = False) -> DenseBinning:
    """Sort-bin particles into dense field planes.

    ``rotate`` selects the rotating winner order (budget off) over the
    stable index order (ordered budget); ``cum`` is an optional (N,)
    ordered-budget prefix written to ``FIELD_CUM``. ``aux_cols`` is an
    optional (N, A) matrix of extra per-particle fields that ride along in
    ``aux`` (same layout, not read by the sweep).

    Two placement backends, bit-identical outputs:

    - default: inverse-index scatter + row gather, the golden model (the
      scatter branch of the JAX package's ``bin_to_planes``). It is the one
      that returns ``pidx_grid``, which :func:`update_cum_field` needs;
    - ``use_placement=True``: the payload rows are placed through the sort
      order by :func:`.kernels.place_kernel.place_planes` (kernel A on CUDA,
      its plain version on the CPU).
    """
    g, k = grid_dim, slots_per_cell
    lanes = g * k
    slot_sorted, pidx_sorted, slot, pack, cell_sorted = sort_bin(
        pos, inv_mass, radius, batch_slot, active, cell_size, grid_dim=g,
        slots_per_cell=k, cum=cum, aux_cols=aux_cols, rotate=rotate)

    rows = g + 2 * ROW_PAD
    if use_placement:
        from .kernels import place_kernel
        all_planes = place_kernel.place_planes(cell_sorted, slot_sorted,
                                               pidx_sorted, pack, g, k)
        aux = all_planes[N_FIELDS:] if aux_cols is not None else None
        return DenseBinning(planes=all_planes[:N_FIELDS], aux=aux, slot=slot,
                            pidx_grid=None, cell_size=cell_size)

    slot_padded = torch.where(slot_sorted < g * lanes,
                              slot_sorted + ROW_PAD * lanes, rows * lanes)
    pidx_grid = torch.full((rows * lanes + 1,), -1, dtype=torch.int64,
                           device=pos.device)
    pidx_grid[slot_padded] = pidx_sorted                   # last entry dropped
    pidx_grid = pidx_grid[:-1]

    # field-major gather: contiguous (F, rows, L) planes, which the kernels
    # and the plane path's elementwise updates read row by row
    occupied = pidx_grid >= 0
    cols = pack.T.contiguous()                             # (F, N)
    all_planes = torch.where(occupied, cols[:, torch.clamp(pidx_grid, min=0)],
                             0.0).reshape(pack.shape[1], rows, lanes)
    planes = fill_halo(all_planes[:N_FIELDS])
    aux = fill_halo(all_planes[N_FIELDS:]) if aux_cols is not None else None
    return DenseBinning(planes=planes, aux=aux, slot=slot, pidx_grid=pidx_grid,
                        cell_size=cell_size)


def update_cum_field(binning: DenseBinning, cum: torch.Tensor) -> DenseBinning:
    """Write a fresh ordered-budget prefix into ``FIELD_CUM`` (gather by
    ``pidx_grid``), IN PLACE in ``binning.planes``; returns the binning."""
    planes = binning.planes
    rows, lanes = planes.shape[1], planes.shape[2]
    occupied = binning.pidx_grid >= 0
    vals = cum[torch.clamp(binning.pidx_grid, min=0)]
    planes[FIELD_CUM] = torch.where(occupied, vals, 0.0).reshape(rows, lanes)
    fill_halo(planes[FIELD_CUM:FIELD_CUM + 1])
    return binning
