"""Kernel H: the gather engine's collision pass (``csrc/gather_pairs.cu``).

H has no TPU counterpart: in the JAX package XLA fuses ``solve_pairs``
(``egg_fluid_simulation_tpu/ops/solver.py``) by itself, and the port's plain
PyTorch version of the same pass (:func:`gather_front_plain`,
:func:`gather_count_plain`, :func:`gather_sweep_plain`) issues a few
hundred small ops on (N, 9K) candidate arrays. A pass is three launches:

- :func:`gather_front`: each particle's **record**, (N, 8) float32, 32
  bytes a particle: ``x, y, inv_mass, radius`` and, stored as their int32
  bits, ``cell_x, cell_y, batch, active`` (:func:`record_cells`,
  :func:`record_active`), with the cell ``floor(pos / cell_size)``; and its
  (N,) int32 bucket, ``table_size`` where inactive. Bit-identical to
  :func:`..grid.cells_and_buckets`, the front of ``build_grid``; the sort,
  rank and scatter of :func:`..grid.slot_table` stay PyTorch;
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
  +-|violation|; then ``pos + where(active, relaxation * total, 0)``. An
  owned range ``(offset, count)`` sweeps particles ``offset + i`` of the
  record (the particle-sharded step's local slice).

The count and the sweep read every per-particle field from the record, one
32-byte load a candidate. On the H100 a group of lanes owns a particle (16
in the sweep, 8 in the count) and keeps its nine table rows in flight: a lane issues its nine
slot loads, then its nine candidates' cell and budget loads, before it uses
any (the pass is bound by those dependent loads, all from L2 at the gather
engine's sizes, and by the index work each lane repeats, not by bytes or
arithmetic); the sweep lists the candidates that pass the cell test and the
budget in shared memory and the group's lanes share out the pair
arithmetic; a shuffle tree sums the group's partial sums, so each particle
writes its own output and nothing is atomic. K = 4, 8, 16 and 32 slots a
bucket are compiled in, any other K is read at run time. The groups take
the particles in index order. The per-pair arithmetic is
the plain version's, op for op (``--fmad=false``, IEEE division and square
root), so a pair's term rounds alike; only the order of the sum differs.

The dispatchers take the tensors' device: CPU tensors take the ``*_plain``
version; CUDA tensors launch the kernel, or raise. ``launches`` counts the
sweep's launches, ``count_launches`` the count's, ``front_launches`` the
front's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utils.mathx import EPS, torch_scalar
from .. import grid as grid_ops

__all__ = ["gather_front", "gather_front_plain", "gather_sweep",
           "gather_sweep_plain", "gather_count", "gather_count_plain",
           "record_cells", "record_active", "candidates", "in_cells",
           "count_from_candidates", "launches", "count_launches", "front_launches"]

launches = 0         # kernel H, sweep
count_launches = 0   # kernel H, count
front_launches = 0   # kernel H, front (record and bucket)

RECORD_WORDS = 8     # float32 words a particle record


def record_cells(record: torch.Tensor) -> torch.Tensor:
    """(N, 2) int32 cell coords of a record (a view)."""
    return record.view(torch.int32)[:, 4:6]


def record_active(record: torch.Tensor) -> torch.Tensor:
    """(N,) bool liveness of a record."""
    return record.view(torch.int32)[:, 7] != 0


def candidates(grid: grid_ops.CellGrid, active: torch.Tensor, lo: int = 0):
    """``(cand, valid)``: the candidate indices (C, 9K) of the 3x3 buckets
    of the grid's particles (``grid.cell_xy``, C of them, particles
    ``lo + i``), and the live candidates of live particles other than the
    particle itself (``active`` (C,)). A pair also needs the TRUE 3x3 cell
    test, :func:`in_cells`."""
    cand = grid_ops.neighbor_candidates(grid)
    self_idx = lo + torch.arange(cand.shape[0], dtype=torch.int32,
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


def gather_front_plain(pos, inv_mass, radius, batch_slot, active, cell_size,
                       table_size: int):
    """Plain PyTorch :func:`gather_front`."""
    cell_xy, bucket = grid_ops.cells_and_buckets(pos, active, cell_size,
                                                 table_size)
    ints = torch.stack([cell_xy[:, 0], cell_xy[:, 1],
                        batch_slot.to(torch.int32), active.to(torch.int32)],
                       dim=1)
    record = torch.cat([torch.stack([pos[:, 0], pos[:, 1], inv_mass, radius],
                                    dim=1), ints.view(torch.float32)], dim=1)
    return record, bucket


def _live_end(active: torch.Tensor) -> int:
    """One past the last live row of ``active`` (0 when none). A pass
    leaves the rows after it as they are and counts no pair there, so the
    plain versions stop at it: a handler's live particles are a prefix of
    its population cap, which can be many times their number."""
    live = torch.nonzero(active)
    return int(live[-1]) + 1 if live.numel() else 0


def gather_count_plain(record, grid: grid_ops.CellGrid):
    """Plain PyTorch :func:`gather_count`."""
    active = record_active(record)
    m = _live_end(active)
    counts = record.new_zeros(record.shape[0])
    if m:
        cells = record_cells(record)
        cand, valid = candidates(grid._replace(cell_xy=cells[:m]),
                                 active[:m])
        counts[:m] = count_from_candidates(grid._replace(cell_xy=cells),
                                           cand, valid)
    return counts


def gather_sweep_plain(record, grid: grid_ops.CellGrid, cum, max_pairs,
                       collision_compliance, cohesion_compliance, overlap,
                       coh_factor, relaxation, *, spacing: bool,
                       owned: Optional[Tuple[int, int]] = None,
                       pair_chunk: int = 1 << 15):
    """Plain PyTorch :func:`gather_sweep`. Particles are swept
    ``pair_chunk`` at a time, which bounds the gathered (chunk, 9K, 8)
    block of records. The JAX package's masks of the partner's mass and
    radius, and its guard of the divisor, change nothing a contributing
    pair sees (its ``w_a + w_b >= EPS`` and the compliances are >= 0), so
    they are left out."""
    n = record.shape[0]
    off, cnt = owned if owned is not None else (0, n)
    if cnt == 0:
        return record.new_empty((0, 2))
    rec_i = record.view(torch.int32)
    cells = record_cells(record)
    # owned rows past the last live one move by nothing: swept no further
    live = _live_end(rec_i[off:off + cnt, 7] != 0)
    if live == 0:
        return record[off:off + cnt, 0:2] + 0.0
    cand, valid = candidates(
        grid_ops.CellGrid(table=grid.table, cell_xy=cells[off:off + live],
                          table_size=grid.table_size),
        rec_i[off:off + live, 7] != 0, off)
    ordered = cum is not None

    def sweep(lo, hi):
        """Correction sum (C, 2) of owned particles [lo, hi)."""
        cand_c = cand[lo:hi]
        safe = torch.clamp(cand_c, min=0).to(torch.int64)
        # every per-particle field a candidate needs, in one gathered row
        g = record.index_select(0, safe.reshape(-1)).reshape(
            *safe.shape, RECORD_WORDS)                              # (C, 9K, 8)
        g_i = g.view(torch.int32)
        me = record[off + lo:off + hi, None, :]
        me_i = me.view(torch.int32)
        s_w = me[..., 2]
        ok = (valid[lo:hi]
              & (torch.abs(g_i[..., 4] - me_i[..., 4]) <= 1)
              & (torch.abs(g_i[..., 5] - me_i[..., 5]) <= 1))
        if ordered:
            self_idx = off + torch.arange(lo, hi, dtype=torch.int32,
                                          device=record.device)[:, None]
            cum_min = torch.where(cand_c < self_idx, cum[safe],
                                  cum[off + lo:off + hi, None])
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
                               (g_i[..., 6] == me_i[..., 6])
                               & (dist2 <= coh_dist * coh_dist)) + scale
        return torch.stack([torch.sum(-(dx * inv_dist) * scale, dim=1),
                            torch.sum(-(dy * inv_dist) * scale, dim=1)], dim=1)

    c = max(1, min(pair_chunk, cnt))
    total = record.new_zeros((cnt, 2))
    for lo in range(0, live, c):
        total[lo:min(lo + c, live)] = sweep(lo, min(lo + c, live))
    active = rec_i[off:off + cnt, 7] != 0
    return record[off:off + cnt, 0:2] + torch.where(
        active[:, None], relaxation * total, 0.0)


def _check_record(name: str, record, grid: grid_ops.CellGrid):
    n = record.shape[0]
    table = grid.table
    if (record.dtype != torch.float32 or record.shape != (n, RECORD_WORDS)
            or table.dtype != torch.int32 or table.dim() != 2
            or table.shape[0] != grid.table_size + 1
            or grid.table_size & (grid.table_size - 1)
            or table.device != record.device
            or record.data_ptr() % 16):    # read as float4 / int4
        raise ValueError(f"{name}: a float32 record (N, 8) and an int32 "
                         "(table_size + 1, K) table with table_size a power "
                         "of two on one device expected")
    if n * max(table.shape[1], 1) * 9 >= 2 ** 31:
        raise ValueError(f"{name}: N * 9K must stay below 2^31")


def _check_front(pos, inv_mass, radius, batch_slot, active,
                 table_size: int):
    n = pos.shape[0]
    dev = pos.device
    if (pos.shape != (n, 2) or inv_mass.shape != (n,) or radius.shape != (n,)
            or batch_slot.shape != (n,) or active.shape != (n,)
            or any(t.dtype != torch.float32 for t in (pos, inv_mass, radius))
            or batch_slot.dtype != torch.int32 or active.dtype != torch.bool
            or any(t.device != dev for t in (inv_mass, radius, batch_slot,
                                             active))
            or table_size < 1 or table_size & (table_size - 1)
            or table_size > 1 << 30):
        raise ValueError("gather_front: float32 pos (N, 2), inv_mass, radius, "
                         "int32 batch_slot, bool active (N,) on one device "
                         "and table_size a power of two up to 2^30 expected")


def gather_front(pos, inv_mass, radius, batch_slot, active, cell_size,
                 table_size: int):
    """``(record, bucket)``: the (N, 8) float32 particle record and the (N,)
    int32 bucket of each particle (see the module) of one pass, with
    ``cell_size`` a 0-dim float32 tensor (or a number)."""
    dev = pos.device
    if dev.type == "cpu":
        return gather_front_plain(pos, inv_mass, radius, batch_slot, active,
                                  cell_size, table_size)
    if dev.type != "cuda":
        raise RuntimeError(f"gather_front: no kernel for device {dev}")
    from . import library
    _check_front(pos, inv_mass, radius, batch_slot, active, table_size)
    n = pos.shape[0]
    pos, inv_mass, radius, batch_slot, active = (
        t.contiguous() for t in (pos, inv_mass, radius, batch_slot, active))
    if pos.data_ptr() % 8:          # the kernel reads a float2 a particle
        pos = pos.clone()
    cs = torch_scalar(cell_size, dev)
    record = torch.empty((n, RECORD_WORDS), dtype=torch.float32, device=dev)
    bucket = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = library.load()
    err = lib.egg_gather_front(
        pos.data_ptr(), inv_mass.data_ptr(), radius.data_ptr(),
        batch_slot.data_ptr(), active.data_ptr(), cs.data_ptr(),
        record.data_ptr(), bucket.data_ptr(), n, table_size,
        library.stream_handle(dev))
    library.check("gather_front", err)
    global front_launches
    front_launches += 1
    return record, bucket


def gather_count(record, grid: grid_ops.CellGrid):
    """(N,) float32 ``new_pairs`` of the ordered budget (see the module):
    the record's particles on the slot table ``grid.table`` (the cells are
    the record's)."""
    dev = record.device
    if dev.type == "cpu":
        return gather_count_plain(record, grid)
    if dev.type != "cuda":
        raise RuntimeError(f"gather_count: no kernel for device {dev}")
    from . import library
    _check_record("gather_count", record, grid)
    n, k = record.shape[0], grid.table.shape[1]
    record, table = record.contiguous(), grid.table.contiguous()
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = library.load()
    err = lib.egg_gather_count(record.data_ptr(), table.data_ptr(),
                               out.data_ptr(), n, grid.table_size, k,
                               library.stream_handle(dev))
    library.check("gather_count", err)
    global count_launches
    count_launches += 1
    return out


def gather_sweep(record, grid: grid_ops.CellGrid, cum: Optional[torch.Tensor],
                 max_pairs, collision_compliance, cohesion_compliance,
                 overlap, coh_factor, relaxation, *, spacing: bool,
                 owned: Optional[Tuple[int, int]] = None,
                 pair_chunk: int = 1 << 15):
    """(C, 2) positions after one Jacobi pair pass of the record's
    particles on the slot table ``grid.table`` (see the module): all N, or
    the ``owned = (offset, count)`` particles ``offset + i``. ``cum`` (N,)
    float32 is the ordered budget's exclusive prefix and ``max_pairs`` its
    cutoff, or both None with the budget off. ``pair_chunk`` caps the plain
    version's gathered block; H gathers nothing into memory, so it has no
    meaning there."""
    dev = record.device
    n = record.shape[0]
    if owned is not None:
        off, cnt = (int(v) for v in owned)
        if not (0 <= off and 0 <= cnt and off + cnt <= n):
            raise ValueError(f"gather_sweep: owned range {owned} outside the "
                             f"record's {n} particles")
        owned = (off, cnt)
    if dev.type == "cpu":
        return gather_sweep_plain(
            record, grid, cum, max_pairs, collision_compliance,
            cohesion_compliance, overlap, coh_factor, relaxation,
            spacing=spacing, owned=owned, pair_chunk=pair_chunk)
    if dev.type != "cuda":
        raise RuntimeError(f"gather_sweep: no kernel for device {dev}")
    from . import library
    ordered = cum is not None
    _check_record("gather_sweep", record, grid)
    if ordered and (cum.shape != (n,) or cum.dtype != torch.float32
                    or cum.device != dev or max_pairs is None):
        raise ValueError("gather_sweep: float32 cum (N,) with max_pairs on "
                         "the record's device expected")
    off, cnt = owned if owned is not None else (0, n)
    k = grid.table.shape[1]
    record, table = record.contiguous(), grid.table.contiguous()
    if ordered:
        cum = cum.contiguous()
    scalars = [torch_scalar(v, dev) for v in (
        collision_compliance, cohesion_compliance, overlap, coh_factor,
        relaxation)]
    mp = torch_scalar(max_pairs, dev) if ordered else None
    out = torch.empty((cnt, 2), dtype=torch.float32, device=dev)
    if cnt == 0:
        return out
    lib = library.load()
    err = lib.egg_gather_sweep(
        record.data_ptr(), table.data_ptr(), library.ptr(cum),
        library.ptr(mp), *(s.data_ptr() for s in scalars), out.data_ptr(),
        cnt, off, grid.table_size, k, int(spacing),
        library.stream_handle(dev))
    library.check("gather_sweep", err)
    global launches
    launches += 1
    return out
