"""The gather engine's hash grid of the PyTorch port against the JAX package.

``_bucket_of``, ``build_grid`` (``table``, ``cell_xy``), its two halves
(``cells_and_buckets``, the front that kernel H's ``gather_front`` writes
on the card with the particle record, and ``slot_table``) and
``neighbor_candidates`` must be bit-identical to the JAX package's: one
wrong bit of the hash moves a particle to another bucket and changes the
candidate lists and their dedup mask. Inputs are built from a numpy seed:
negative and large cell coordinates, small tables (forced bucket
collisions), crowds past the K slots of a bucket and an inactive tail. The
twins of ``tests/test_grid.py`` run the same checks on the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egg_fluid_simulation_tpu.ops import grid as jgrid
from egg_fluid_simulation_tpu_torch.ops import grid as tgrid
from egg_fluid_simulation_tpu_torch.ops.kernels import gather_kernel as GK


@pytest.mark.parametrize("table_size", [1, 2, 64, 1 << 14, 1 << 30])
def test_bucket_of_bit_identical(table_size):
    """Every int32 coordinate, negative and extreme ones included."""
    rng = np.random.default_rng(table_size)
    edge = np.array([-2 ** 31, -2 ** 31 + 1, -1, 0, 1, 2 ** 31 - 2,
                     2 ** 31 - 1], np.int64)
    x = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 4000),
                        np.repeat(edge, edge.size)]).astype(np.int32)
    y = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 4000),
                        np.tile(edge, edge.size)]).astype(np.int32)
    want = np.asarray(jgrid._bucket_of(jnp.asarray(x), jnp.asarray(y),
                                       table_size))
    got = tgrid._bucket_of(torch.from_numpy(x), torch.from_numpy(y),
                           table_size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _scene(n, seed, span, crowds, k):
    """``n`` particles over [-span, span]^2 (negative cells included), each
    crowd a cell holding 2K + 3 particles, the last eighth inactive."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-span, span, (n, 2))
    crowd = 2 * k + 3
    for j, c in enumerate(crowds):
        pos[j * crowd:(j + 1) * crowd] = (np.asarray(c, np.float64)
                                          + rng.uniform(0.1, 0.9, (crowd, 2))) * 16.0
    active = np.ones(n, bool)
    active[n - n // 8:] = False
    return pos.astype(np.float32), active


CASES = {
    # table, K, span (px), crowded cells (cell coords)
    "collisions": (16, 4, 300.0, [(0, 0), (-3, 2)]),
    "crowds_past_k": (1024, 4, 200.0, [(1, 1), (-5, -5), (7, -2)]),
    "negative_far": (256, 8, 5e5, [(-20000, -31000)]),
    "wide_k": (4096, 32, 120.0, [(-1, -1)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_grid_and_candidates_bit_identical(case):
    table_size, k, span, crowds = CASES[case]
    pos, active = _scene(600, len(case), span, crowds, k)
    cell = 16.0
    gj = jgrid.build_grid(jnp.asarray(pos), jnp.asarray(active),
                          jnp.float32(cell), table_size=table_size,
                          slots_per_cell=k)
    gt = tgrid.build_grid(torch.from_numpy(pos), torch.from_numpy(active),
                          torch.tensor(cell), table_size=table_size,
                          slots_per_cell=k)
    assert gt.table_size == table_size
    assert gt.table.dtype == gt.cell_xy.dtype == torch.int32
    np.testing.assert_array_equal(gt.cell_xy.numpy(), np.asarray(gj.cell_xy))
    np.testing.assert_array_equal(gt.table.numpy(), np.asarray(gj.table))
    cj = np.asarray(jgrid.neighbor_candidates(gj))
    ct = tgrid.neighbor_candidates(gt)
    assert ct.dtype == torch.int32 and ct.shape == (600, 9 * k)
    np.testing.assert_array_equal(ct.numpy(), cj)
    # every case has a bucket past K (its crowds), whose extra members
    # are in no slot; a table of 16 buckets repeats buckets within a
    # particle's 3x3 cells (the dedup mask)
    assert int((gt.table[:table_size] >= 0).sum()) < int(active.sum())
    if case == "collisions":
        cx, cy = gt.cell_xy[:, 0], gt.cell_xy[:, 1]
        nine = torch.stack([tgrid._bucket_of(cx + dx, cy + dy, table_size)
                            for dx, dy in tgrid.NEIGHBOR_OFFSETS], 1)
        assert any(len(set(r)) < 9 for r in nine.tolist())


@pytest.mark.parametrize("case", sorted(CASES))
def test_front_and_slot_table_bit_identical(case):
    """The two halves of the build against JAX's ``build_grid``: the
    front's cell coords and bucket (the masked sentinel where inactive),
    bit for bit, also as ``gather_front_plain`` writes them into the
    record with the other fields; and the slot table from those
    buckets."""
    table_size, k, span, crowds = CASES[case]
    pos, active = _scene(600, len(case), span, crowds, k)
    cell = 16.0
    cell_j = jnp.floor(jnp.asarray(pos) / jnp.float32(cell)).astype(jnp.int32)
    bucket_j = np.asarray(jnp.where(
        jnp.asarray(active),
        jgrid._bucket_of(cell_j[:, 0], cell_j[:, 1], table_size), table_size))
    gj = jgrid.build_grid(jnp.asarray(pos), jnp.asarray(active),
                          jnp.float32(cell), table_size=table_size,
                          slots_per_cell=k)
    pos_t, act_t = torch.from_numpy(pos), torch.from_numpy(active)
    cell_xy, bucket = tgrid.cells_and_buckets(pos_t, act_t, torch.tensor(cell),
                                              table_size)
    np.testing.assert_array_equal(cell_xy.numpy(), np.asarray(cell_j))
    np.testing.assert_array_equal(bucket.numpy(), bucket_j)
    assert bucket.dtype == torch.int32
    assert (bucket[~act_t] == table_size).all() and (bucket[act_t] < table_size).all()
    assert (cell_xy < 0).any()                  # negative cells covered
    rng = np.random.default_rng(3)
    inv = torch.from_numpy(rng.uniform(0.5, 1.0, 600).astype(np.float32))
    rad = torch.from_numpy(rng.uniform(1.0, 4.0, 600).astype(np.float32))
    bslot = torch.from_numpy(rng.integers(0, 9, 600).astype(np.int32))
    record, bucket_r = GK.gather_front_plain(pos_t, inv, rad, bslot, act_t,
                                             torch.tensor(cell), table_size)
    assert record.shape == (600, 8) and record.dtype == torch.float32
    assert torch.equal(bucket_r, bucket)
    assert torch.equal(GK.record_cells(record), cell_xy)
    assert torch.equal(GK.record_active(record), act_t)
    for col, want in ((0, pos_t[:, 0]), (1, pos_t[:, 1]), (2, inv), (3, rad)):
        assert torch.equal(record[:, col].view(torch.int32),
                           want.contiguous().view(torch.int32))
    assert torch.equal(record.view(torch.int32)[:, 6], bslot)
    assert torch.equal(record.view(torch.int32)[:, 7], act_t.to(torch.int32))
    table = tgrid.slot_table(bucket, table_size, k)
    assert table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), np.asarray(gj.table))


def _brute_force_neighbors(pos, active, cell):
    cells = np.floor(pos / cell).astype(np.int64)
    out = []
    for i in range(len(pos)):
        near = (np.abs(cells - cells[i]) <= 1).all(axis=1) & active
        near[i] = False
        out.append(set(np.nonzero(near)[0].tolist()) if active[i] else set())
    return out


def test_grid_contains_all_true_neighbors():
    """Twin of tests/test_grid.py: with K large enough that nothing drops,
    every true 3x3 neighbour is a candidate and no inactive particle is."""
    rng = np.random.default_rng(0)
    n = 256
    pos = rng.uniform(-100, 100, size=(n, 2)).astype(np.float32)
    active = np.ones(n, bool)
    active[200:] = False
    grid = tgrid.build_grid(torch.from_numpy(pos), torch.from_numpy(active),
                            torch.tensor(16.0), table_size=1024,
                            slots_per_cell=32)
    cand = tgrid.neighbor_candidates(grid).numpy()
    truth = _brute_force_neighbors(pos, active, 16.0)
    for i in range(n):
        got = set(c for c in cand[i].tolist() if c >= 0 and c != i)
        assert not truth[i] - got, f"particle {i} misses {truth[i] - got}"
        assert all(active[c] for c in got)


def test_grid_budget_drops_beyond_capacity():
    """Twin of tests/test_grid.py: 40 coincident particles, K = 8: exactly
    the first 8 (in particle order) survive in the shared cell."""
    grid = tgrid.build_grid(torch.zeros((40, 2)), torch.ones(40, dtype=torch.bool),
                            torch.tensor(10.0), table_size=256,
                            slots_per_cell=8)
    cand = tgrid.neighbor_candidates(grid).numpy()
    assert sorted(set(cand[0][cand[0] >= 0].tolist())) == list(range(8))


def test_grid_negative_coordinates():
    pos = torch.tensor([[-5.0, -5.0], [-6.0, -5.5], [100.0, 100.0]])
    grid = tgrid.build_grid(pos, torch.ones(3, dtype=torch.bool),
                            torch.tensor(4.0), table_size=256,
                            slots_per_cell=4)
    cand = tgrid.neighbor_candidates(grid).numpy()
    assert 1 in cand[0] and 0 in cand[1]
    assert 2 not in cand[0] and 2 not in cand[1]
