"""Neighbour search: the gather engine's hash grid, run-length helpers over
sorted keys, and pair counting.

The counterpart of ``egg_fluid_simulation_tpu/ops/grid.py``. The gather
engine's grid (reference ``simulation_handler.lua:1474-1511``) is
sort-based:

1. integer cell coords ``floor(pos / cell_size)`` (:1494-1495),
2. a multiplicative XOR hash of the cell coords into a power-of-two table
   (a well-mixed bucket index in place of the reference's Szudzik pairing),
3. one stable sort by bucket and the rank of each particle in its bucket,
4. a scatter into a dense ``(table_size + 1, K)`` slot table. Particles past
   ``K`` in a bucket are dropped: the static-capacity analog of the
   reference's collision budget (:1749-1753, :1656-1658).

Bucket collisions only add candidates that the solver's true 3x3 cell test
rejects. The table and the candidate lists are bit-identical to the JAX
package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CellGrid", "build_grid", "cells_and_buckets", "slot_table",
           "neighbor_candidates",
           "NEIGHBOR_OFFSETS", "segmented_rank", "segment_extent",
           "count_pairs"]

# the JAX package's multiplicative hash constants (uint32 products there)
_HASH_X = 0x9E3779B1
_HASH_Y = 0x85EBCA77

# 3x3 neighborhood, matching the reference's cell scan at :1568-1569.
NEIGHBOR_OFFSETS = [(-1, -1), (-1, 0), (-1, 1),
                    (0, -1), (0, 0), (0, 1),
                    (1, -1), (1, 0), (1, 1)]


_OFFSETS = {}


def _offsets(device) -> torch.Tensor:
    """``NEIGHBOR_OFFSETS`` as a (2, 9) int64 tensor on ``device`` (dx row,
    dy row), made once a device."""
    off = _OFFSETS.get(device)
    if off is None:
        off = _OFFSETS[device] = torch.tensor(
            NEIGHBOR_OFFSETS, dtype=torch.int64, device=device).T.contiguous()
    return off


class CellGrid(NamedTuple):
    table: torch.Tensor     # (table_size + 1, K) i32, -1 = empty slot
    cell_xy: torch.Tensor   # (N, 2) i32 cell coords per particle
    table_size: int


def _bucket_of(cell_x: torch.Tensor, cell_y: torch.Tensor,
               table_size: int) -> torch.Tensor:
    """The JAX package's bucket: the cell coords as uint32 (two's
    complement for negative coords) times the hash constants mod 2^32,
    XOR-ed and masked to the table (a power of two up to 2^31). (N,) int32.

    Only the low log2(table_size) bits survive the mask, and the low bits
    of a product depend only on the low bits of its factors, so each
    product runs on the masked coordinate and the masked constant: in
    int32 up to a table of 2^15 (products below 2^30), in int64 above
    (below 2^62). Bit-identical to the 32-bit products, in a few ops."""
    m = table_size - 1
    dtype = torch.int32 if table_size <= 1 << 15 else torch.int64
    hx = (cell_x & m).to(dtype) * (_HASH_X & m)
    hy = (cell_y & m).to(dtype) * (_HASH_Y & m)
    return ((hx ^ hy) & m).to(torch.int32)


def cells_and_buckets(pos: torch.Tensor, active: torch.Tensor,
                      cell_size: torch.Tensor, table_size: int):
    """The front of :func:`build_grid`: ``(cell_xy, bucket)``, the (N, 2)
    int32 cell coords ``floor(pos / cell_size)`` and the (N,) int32 bucket
    of each particle, ``table_size`` (the sentinel row) where inactive."""
    cell_xy = torch.floor(pos / cell_size).to(torch.int32)
    bucket = _bucket_of(cell_xy[:, 0], cell_xy[:, 1], table_size)
    return cell_xy, torch.where(active, bucket, table_size)


def slot_table(bucket: torch.Tensor, table_size: int, slots_per_cell: int):
    """The rest of :func:`build_grid`: the ``(table_size + 1, K)`` int32
    slot table of the buckets ``bucket`` (N,) (the first ``K`` particles of
    each bucket, in particle order)."""
    # stable, as the JAX package's lax.sort_key_val: a bucket keeps its
    # first K particles in particle order
    bucket_sorted, idx_sorted = torch.sort(bucket, stable=True)
    rank = segmented_rank(bucket_sorted)
    k = slots_per_cell
    # rank >= K goes to a dump row past the table, cut off below
    flat = torch.where(rank < k, bucket_sorted.to(torch.int64) * k + rank,
                       (table_size + 1) * k)
    table = torch.full(((table_size + 2) * k,), -1, dtype=torch.int32,
                       device=bucket.device)
    table[flat] = idx_sorted.to(torch.int32)
    return table[:(table_size + 1) * k].reshape(table_size + 1, k)


def build_grid(pos: torch.Tensor, active: torch.Tensor,
               cell_size: torch.Tensor, *, table_size: int,
               slots_per_cell: int) -> CellGrid:
    """Hash-grid slot table of ``pos`` (N, 2): the first ``slots_per_cell``
    particles of each bucket, in particle order; inactive particles go to
    the sentinel row ``table_size``, never queried."""
    cell_xy, bucket = cells_and_buckets(pos, active, cell_size, table_size)
    table = slot_table(bucket, table_size, slots_per_cell)
    return CellGrid(table=table, cell_xy=cell_xy, table_size=table_size)


def neighbor_candidates(grid: CellGrid) -> torch.Tensor:
    """(N, 9 * K) int32 candidate particle indices per particle, -1 = empty.

    The 3x3 scan around each particle's own cell (reference :1568-1573).
    Distinct cells can hash to the same bucket; the reference's Szudzik
    pairing (:1474-1483) never visits a cell twice, so a bucket repeated
    within a particle's 9 is masked after its first visit."""
    off = _offsets(grid.cell_xy.device)                          # (2, 9)
    cxy = grid.cell_xy.to(torch.int64)
    buckets = _bucket_of(cxy[:, 0, None] + off[0], cxy[:, 1, None] + off[1],
                         grid.table_size)                          # (N, 9)
    n_off = len(NEIGHBOR_OFFSETS)
    earlier = torch.tril(torch.ones((n_off, n_off), dtype=torch.bool,
                                    device=buckets.device), diagonal=-1)
    dup = ((buckets[:, :, None] == buckets[:, None, :])
           & earlier[None]).any(dim=2)                             # (N, 9)
    cand = grid.table.index_select(0, buckets.reshape(-1).to(torch.int64)) \
        .reshape(*buckets.shape, grid.table.shape[1])              # (N, 9, K)
    cand = torch.where(dup[:, :, None], -1, cand)
    return cand.reshape(cand.shape[0], -1)


def _run_bounds(sorted_keys: torch.Tensor):
    """Index, run start and run end (inclusive) of each element of a sorted
    key array. Two binary searches of the keys in themselves: the same
    bounds as the JAX package's forward cummax / reverse cummin scans, which
    are slow on a GPU for int64 (an index-tracking scan)."""
    n = sorted_keys.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=sorted_keys.device)
    keys = sorted_keys.contiguous()
    run_start = torch.searchsorted(keys, keys, right=False)
    run_end = torch.searchsorted(keys, keys, right=True) - 1
    return idx, run_start, run_end


def segmented_rank(sorted_keys: torch.Tensor) -> torch.Tensor:
    """(N,) int32 rank of each element within its run of equal sorted keys
    (the run's start only: one binary search)."""
    keys = sorted_keys.contiguous()
    idx = torch.arange(keys.shape[0], dtype=torch.int64, device=keys.device)
    return (idx - torch.searchsorted(keys, keys, right=False)).to(torch.int32)


def segment_extent(sorted_keys: torch.Tensor):
    """(rank, count) int32 of each element within its run of equal sorted keys.

    ``count`` is the run's TOTAL length — for cell-sorted particles, the
    cell's true occupancy including members past the slot budget."""
    idx, run_start, run_end = _run_bounds(sorted_keys)
    return ((idx - run_start).to(torch.int32),
            (run_end - run_start + 1).to(torch.int32))


def count_pairs(hi: torch.Tensor, lo: torch.Tensor, n_hi: int,
                n_lo: int) -> torch.Tensor:
    """(n_hi, n_lo) int64 occurrence counts of id pairs.

    The counterpart of the JAX package's ``count_pairs_mxu`` (a one-hot
    matrix product there), as an ``index_add_`` of ones into
    ``n_hi * n_lo + 1`` bins, the last a sentinel for ids outside
    ``[0, n_hi) x [0, n_lo)``, which count toward nothing. The output size
    is fixed, so nothing is read back from the device (``bincount`` reads
    the ids' maximum to size its output), and integer adds are exact."""
    hi = hi.to(torch.int64)
    lo = lo.to(torch.int64)
    ok = (hi >= 0) & (hi < n_hi) & (lo >= 0) & (lo < n_lo)
    flat = torch.where(ok, hi * n_lo + lo, n_hi * n_lo)
    counts = torch.zeros(n_hi * n_lo + 1, dtype=torch.int64, device=hi.device)
    counts.index_add_(0, flat, torch.ones_like(flat))
    return counts[:n_hi * n_lo].reshape(n_hi, n_lo)
