# Frozen copy of egg_fluid_simulation_tpu_torch/ops/grid.py at commit e9e0aedb87f3: the port's plain
# PyTorch path, kept as the benchmark's reference, trimmed to the gather
# engine's hash grid (the run-length helpers are in ``grid.py`` beside it).
"""Neighbour search: the gather engine's hash grid.

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

from .grid import segmented_rank

__all__ = ["CellGrid", "cells_and_buckets", "slot_table",
           "neighbor_candidates", "NEIGHBOR_OFFSETS"]

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
    """The front of ``build_grid``: ``(cell_xy, bucket)``, the (N, 2)
    int32 cell coords ``floor(pos / cell_size)`` and the (N,) int32 bucket
    of each particle, ``table_size`` (the sentinel row) where inactive."""
    cell_xy = torch.floor(pos / cell_size).to(torch.int32)
    bucket = _bucket_of(cell_xy[:, 0], cell_xy[:, 1], table_size)
    return cell_xy, torch.where(active, bucket, table_size)


def slot_table(bucket: torch.Tensor, table_size: int, slots_per_cell: int):
    """The rest of ``build_grid``: the ``(table_size + 1, K)`` int32
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
