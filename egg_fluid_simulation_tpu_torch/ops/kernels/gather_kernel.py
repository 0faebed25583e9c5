"""Kernel H: the gather engine's collision pass (``csrc/gather_pairs.cu``).

H has no TPU counterpart: in the JAX package XLA fuses ``solve_pairs``
(``egg_fluid_simulation_tpu/ops/solver.py``) by itself, and the port's plain
PyTorch version of the same pass (:func:`gather_sweep_plain`,
:func:`gather_count_plain`) issues a few hundred small ops on (N, 9K)
candidate arrays. H computes the pass per particle from the hash grid of
:func:`..grid.build_grid` (the slot table and the cell coords), without
materialising the (N, 9K) candidate array or the (C, 9K, 6) gathered block:

- :func:`gather_count` (the ordered budget only): ``new_pairs`` per
  particle, its pairs in its TRUE 3x3 cells with later particles, as an
  (N,) float32 count. The caller takes the exclusive prefix
  ``cumsum(new_pairs) - new_pairs`` (exact below 2^24);
- :func:`gather_sweep`: each particle's correction sum of one Jacobi pass
  over its candidates (the nine buckets of its 3x3 cells, a bucket repeated
  within the nine visited once, the true 3x3 cell test, live partners other
  than itself, ``w_sum >= EPS``, under the ordered budget
  ``cum[min(self, cand)] < max_pairs``): the collision term and, in the
  ``spacing`` cohesion mode, the same-batch cohesion term, each clamped to
  +-|violation|; then ``pos + where(active, relaxation * total, 0)``.

On the H100 a 16-lane group owns a particle: lane ``s`` reads slot ``s``
of each of the nine table rows (one coalesced 64-byte row at K = 16) and
the candidate's fields, and a shuffle reduction sums the group's partial
sums, so each particle writes its own output and nothing is atomic. The
pass is bound by the latency of those dependent loads (table row, then the
candidate's cell, then its fields), all of which fit in L2 at the gather
engine's sizes (N <= 16384), not by bytes or arithmetic. The per-pair
arithmetic is the plain version's, op for op (``--fmad=false``, IEEE
division and square root), so a pair's term rounds alike; only the order of
the sum differs.

The dispatchers take the tensors' device: CPU tensors take the ``*_plain``
version; CUDA tensors launch the kernel, or raise. ``launches`` counts the
sweep's launches, ``count_launches`` the count's.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...utils.mathx import EPS, torch_scalar
from .. import grid as grid_ops

__all__ = ["gather_sweep", "gather_sweep_plain", "gather_count",
           "gather_count_plain", "candidates", "in_cells",
           "count_from_candidates", "launches", "count_launches"]

launches = 0         # kernel H, sweep
count_launches = 0   # kernel H, count


def candidates(grid: grid_ops.CellGrid, active: torch.Tensor):
    """``(cand, valid)``: the candidate indices (N, 9K) of each particle's
    3x3 buckets, and the live candidates of live particles other than the
    particle itself. A pair also needs the TRUE 3x3 cell test,
    :func:`in_cells`."""
    cand = grid_ops.neighbor_candidates(grid)
    self_idx = torch.arange(cand.shape[0], dtype=torch.int32,
                            device=cand.device)[:, None]
    valid = (cand >= 0) & (cand != self_idx) & active[:, None]
    return cand, valid


def in_cells(cell_xy, safe, lo: int = 0):
    """The TRUE 3x3 cell test of the candidates ``safe`` (C, 9K, indices
    clamped to >= 0) of particles [lo, lo + C). A bucket collision can
    admit a far cell whose particles still sit within the collision radius
    (the reference's cell size under-covers it, :1756-1760); the cell test
    keeps the pair set the reference's (an injective Szudzik hash)."""
    o_cells = cell_xy.index_select(0, safe.reshape(-1)).reshape(
        *safe.shape, 2)                                          # (C, 9K, 2)
    me = cell_xy[lo:lo + safe.shape[0], None, :]
    return ((torch.abs(o_cells[..., 0] - me[..., 0]) <= 1)
            & (torch.abs(o_cells[..., 1] - me[..., 1]) <= 1))


def count_from_candidates(grid: grid_ops.CellGrid, cand, valid):
    """(N,) float32 ``new_pairs`` from the candidates of :func:`candidates`:
    each particle's pairs in its true 3x3 cells with later particles."""
    near = in_cells(grid.cell_xy, torch.clamp(cand, min=0).to(torch.int64))
    self_idx = torch.arange(cand.shape[0], dtype=torch.int32,
                            device=cand.device)[:, None]
    return torch.sum(valid & near & (cand > self_idx),
                     dim=1).to(torch.float32)


def gather_count_plain(grid: grid_ops.CellGrid, active: torch.Tensor):
    """Plain PyTorch :func:`gather_count`."""
    return count_from_candidates(grid, *candidates(grid, active))


def gather_sweep_plain(pos, inv_mass, radius, batch_slot, active,
                       grid: grid_ops.CellGrid, cum, max_pairs,
                       collision_compliance, cohesion_compliance, overlap,
                       coh_factor, relaxation, *, spacing: bool,
                       pair_chunk: int = 1 << 15):
    """Plain PyTorch :func:`gather_sweep`. Particles are swept
    ``pair_chunk`` at a time, which bounds the gathered (chunk, 9K, 6)
    block. The JAX package's masks of the partner's mass and radius, and its
    guard of the divisor, change nothing a contributing pair sees (its
    ``w_a + w_b >= EPS`` and the compliances are >= 0), so they are left
    out."""
    n = pos.shape[0]
    cand, valid = candidates(grid, active)
    ordered = cum is not None
    if not ordered:
        cum = torch.zeros((n,), dtype=torch.float32, device=pos.device)

    # every per-particle field a candidate needs, gathered in one row; the
    # batch slot and the budget prefix ride as floats (exact below 2^24).
    # The cell coords stay a gather of their own: rows of 8 floats take
    # index_select's vectorised kernel, 5.1 ms an update at N = 8192,
    # 9K = 144 on an H100 against 0.66 ms for all the gathers of this form
    pack = torch.stack([pos[:, 0], pos[:, 1], inv_mass, radius,
                        batch_slot.to(torch.float32), cum], dim=1)  # (N, 6)

    def sweep(lo, hi):
        """Correction sum (C, 2) of particles [lo, hi)."""
        cand_c = cand[lo:hi]
        safe = torch.clamp(cand_c, min=0).to(torch.int64)
        g = pack.index_select(0, safe.reshape(-1)).reshape(
            *safe.shape, pack.shape[1])                             # (C, 9K, 6)
        me = pack[lo:hi, None, :]
        s_w = me[..., 2]
        ok = valid[lo:hi] & in_cells(grid.cell_xy, safe, lo)
        if ordered:
            # cum[min(self, cand)] without a second gather
            self_idx = torch.arange(lo, hi, dtype=torch.int32,
                                    device=pos.device)[:, None]
            cum_min = torch.where(cand_c < self_idx, g[..., 5], me[..., 5])
            ok = ok & (cum_min < max_pairs)
        dx = g[..., 0] - me[..., 0]
        dy = g[..., 1] - me[..., 1]
        dist2 = dx * dx + dy * dy
        dist = torch.sqrt(dist2)
        inv_dist = torch.where(dist > EPS, 1.0 / torch.clamp(dist, min=EPS),
                               0.0)
        w_sum = s_w + g[..., 2]
        ok = ok & (w_sum >= EPS)                                    # :1601
        r_sum = me[..., 3] + g[..., 3]

        def half_scale(target, compliance, apply):
            """|correction| * w_self of ``_enforce_distance`` (:1514-1545)."""
            violation = dist - target
            corr = -violation / (w_sum + compliance)
            bound = torch.abs(violation)
            corr = torch.clamp(corr, -bound, bound)                 # :1535-1536
            return torch.where(apply & ok, corr * s_w, 0.0)         # :1538-1539

        min_dist = overlap * r_sum                                  # :1632-1654
        scale = half_scale(min_dist, collision_compliance,
                           dist2 <= min_dist * min_dist)
        if spacing:
            # cohesion (:1603-1630). "literal" mode: the same-batch
            # interaction distance is 0 (:1609-1613), so the constraint
            # fires only for coincident particles, whose direction is the
            # zero vector: no correction
            coh_dist = coh_factor * r_sum
            scale = half_scale(coh_dist, cohesion_compliance,
                               (g[..., 4] == me[..., 4])
                               & (dist2 <= coh_dist * coh_dist)) + scale
        return torch.stack([torch.sum(-(dx * inv_dist) * scale, dim=1),
                            torch.sum(-(dy * inv_dist) * scale, dim=1)], dim=1)

    c = max(1, min(pair_chunk, n))
    total = torch.cat([sweep(lo, min(lo + c, n)) for lo in range(0, n, c)])
    return pos + torch.where(active[:, None], relaxation * total, 0.0)


def _check(name: str, grid: grid_ops.CellGrid, active, fields=()):
    n = active.shape[0]
    dev = active.device
    table = grid.table
    if (active.dtype != torch.bool or active.shape != (n,)
            or grid.cell_xy.shape != (n, 2) or grid.cell_xy.dtype != torch.int32
            or table.dtype != torch.int32 or table.dim() != 2
            or table.shape[0] != grid.table_size + 1
            or grid.table_size & (grid.table_size - 1)
            or any(t.device != dev for t in (table, grid.cell_xy, *fields))):
        raise ValueError(f"{name}: bool active (N,), int32 cell_xy (N, 2) and "
                         "an int32 (table_size + 1, K) table with table_size "
                         "a power of two, on one device expected")
    if n * max(table.shape[1], 1) * 9 >= 2 ** 31:
        raise ValueError(f"{name}: N * 9K must stay below 2^31")


def gather_count(grid: grid_ops.CellGrid, active: torch.Tensor):
    """(N,) float32 ``new_pairs`` of the ordered budget (see the module)."""
    dev = active.device
    if dev.type == "cpu":
        return gather_count_plain(grid, active)
    if dev.type != "cuda":
        raise RuntimeError(f"gather_count: no kernel for device {dev}")
    from . import library
    _check("gather_count", grid, active)
    n, k = active.shape[0], grid.table.shape[1]
    table, cell_xy, active = (t.contiguous() for t in
                              (grid.table, grid.cell_xy, active))
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = library.load()
    err = lib.egg_gather_count(table.data_ptr(), cell_xy.data_ptr(),
                               active.data_ptr(), out.data_ptr(), n,
                               grid.table_size, k, library.stream_handle(dev))
    library.check("gather_count", err)
    global count_launches
    count_launches += 1
    return out


def gather_sweep(pos, inv_mass, radius, batch_slot, active,
                 grid: grid_ops.CellGrid, cum: Optional[torch.Tensor],
                 max_pairs, collision_compliance, cohesion_compliance,
                 overlap, coh_factor, relaxation, *, spacing: bool,
                 pair_chunk: int = 1 << 15):
    """(N, 2) positions after one Jacobi pair pass over the grid ``grid``
    of ``pos`` (see the module). ``cum`` (N,) float32 is the ordered
    budget's exclusive prefix and ``max_pairs`` its cutoff, or both None
    with the budget off. ``pair_chunk`` caps the plain version's gathered
    block; H gathers nothing into memory, so it has no meaning there."""
    dev = pos.device
    if dev.type == "cpu":
        return gather_sweep_plain(
            pos, inv_mass, radius, batch_slot, active, grid, cum, max_pairs,
            collision_compliance, cohesion_compliance, overlap, coh_factor,
            relaxation, spacing=spacing, pair_chunk=pair_chunk)
    if dev.type != "cuda":
        raise RuntimeError(f"gather_sweep: no kernel for device {dev}")
    from . import library
    n = pos.shape[0]
    ordered = cum is not None
    fields = (pos, inv_mass, radius, batch_slot) + ((cum,) if ordered else ())
    _check("gather_sweep", grid, active, fields)
    if (pos.shape != (n, 2) or inv_mass.shape != (n,) or radius.shape != (n,)
            or batch_slot.shape != (n,) or batch_slot.dtype != torch.int32
            or any(t.dtype != torch.float32 for t in (pos, inv_mass, radius))
            or (ordered and (cum.shape != (n,) or cum.dtype != torch.float32
                             or max_pairs is None))):
        raise ValueError("gather_sweep: float32 pos (N, 2), inv_mass, radius, "
                         "int32 batch_slot (N,) [and float32 cum (N,) with "
                         "max_pairs] on one device expected")
    k = grid.table.shape[1]
    pos, inv_mass, radius, batch_slot, table, cell_xy, active = (
        t.contiguous() for t in (pos, inv_mass, radius, batch_slot,
                                 grid.table, grid.cell_xy, active))
    if ordered:
        cum = cum.contiguous()
    scalars = [torch_scalar(v, dev) for v in (
        collision_compliance, cohesion_compliance, overlap, coh_factor,
        relaxation)]
    mp = torch_scalar(max_pairs, dev) if ordered else None
    out = torch.empty_like(pos)
    lib = library.load()
    err = lib.egg_gather_sweep(
        pos.data_ptr(), inv_mass.data_ptr(), radius.data_ptr(),
        batch_slot.data_ptr(), active.data_ptr(), cell_xy.data_ptr(),
        table.data_ptr(), library.ptr(cum), library.ptr(mp),
        *(s.data_ptr() for s in scalars), out.data_ptr(), n, grid.table_size,
        k, int(spacing), library.stream_handle(dev))
    library.check("gather_sweep", err)
    global launches
    launches += 1
    return out
