"""Dense binning of the PyTorch port against the JAX package, bit for bit.

The golden model of placement is the scatter branch of the JAX package's
``dense.bin_to_planes(rotate=True)``: the rotating winner hash (int32
multiplies that wrap, an arithmetic shift, the float32 bit pattern), a
STABLE sort, cell ranks and counts, the inverse permutation and the plane
layout are all integer or copy operations, so the port must reproduce slots,
all 8 pair planes, the aux columns and FIELD_OCC exactly — with
over-occupied cells (count > K) and inactive rows present. Both of the
port's placement backends (its own scatter, and kernel A's plain version)
are held to it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egg_fluid_simulation_tpu.ops import dense as jdense
from egg_fluid_simulation_tpu.ops import grid as jgrid
from egg_fluid_simulation_tpu.ops.pallas import place_kernel as jplace
from egg_fluid_simulation_tpu_torch.ops import dense as tdense
from egg_fluid_simulation_tpu_torch.ops import grid as tgrid
from egg_fluid_simulation_tpu_torch.ops.kernels import place_kernel as tplace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _particles(n, seed, crowd=150, spread=420.0):
    """Random particles with a crowd in a few cells (count > K) and the last
    rows inactive; some positions negative, to exercise the torus wrap."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-40.0, spread, size=(n, 2)).astype(np.float32)
    pos[:crowd] = (pos[0] + rng.uniform(0.0, 14.0, size=(crowd, 2))).astype(
        np.float32)
    inv = rng.uniform(0.5, 1.0, n).astype(np.float32)
    rad = rng.uniform(3.0, 4.0, n).astype(np.float32)
    batch = rng.randint(0, 5, n).astype(np.int32)
    act = np.ones(n, bool)
    act[-60:] = False
    aux = rng.normal(size=(n, 5)).astype(np.float32)
    return pos, inv, rad, batch, act, aux


def _np(x):
    return np.asarray(jax.block_until_ready(x))


@pytest.mark.parametrize("use_placement", [False, True],
                         ids=["scatter", "placement"])
@pytest.mark.parametrize("g,n,seed", [(16, 1200, 0), (32, 3000, 1),
                                      (64, 5000, 2)])
def test_bin_to_planes_bit_identical(g, n, seed, use_placement):
    """Slots, all 8 planes, aux columns and FIELD_OCC equal the JAX scatter
    branch with rotate=True exactly (tolerance: none)."""
    pos, inv, rad, batch, act, aux = _particles(n, seed)
    cell = np.float32(8.0)
    jb = jdense.bin_to_planes(
        jnp.asarray(pos), jnp.asarray(inv), jnp.asarray(rad),
        jnp.asarray(batch), jnp.asarray(act), jnp.float32(cell),
        grid_dim=g, slots_per_cell=4, aux_cols=jnp.asarray(aux),
        rotate=True, use_placement=False)
    tb = tdense.bin_to_planes(
        torch.from_numpy(pos), torch.from_numpy(inv), torch.from_numpy(rad),
        torch.from_numpy(batch), torch.from_numpy(act), torch.tensor(cell),
        grid_dim=g, slots_per_cell=4, aux_cols=torch.from_numpy(aux),
        use_placement=use_placement, rotate=True)
    j_slot = _np(jb.slot)
    np.testing.assert_array_equal(tb.slot.numpy(), j_slot)
    np.testing.assert_array_equal(tb.planes.numpy(), _np(jb.planes))
    np.testing.assert_array_equal(tb.aux.numpy(), _np(jb.aux))
    occ = tb.planes[tdense.FIELD_OCC].numpy()
    # the scene really has over-budget cells and inactive rows
    assert occ.max() > 4
    assert (j_slot == g * g * 4).sum() > 60
    if not use_placement:
        np.testing.assert_array_equal(tb.pidx_grid.numpy(), _np(jb.pidx_grid))


@pytest.mark.parametrize("g", [32, 64])
def test_place_planes_plain_matches_jax_kernel(g):
    """Kernel A's plain version against the TPU placement kernel in
    interpret mode, on a compacted (ascending-slot) input whose window spans
    stay within the kernel's slack. The TPU kernel leaves the halo rows
    empty for the caller's fill_halo; the port fills them, so its halo is
    compared with fill_halo of the JAX output. Tolerance: none (copies)."""
    pos, inv, rad, batch, act, aux = _particles(2500, 7)
    k = 4
    slot_sorted, pidx_sorted, _, pack = tdense.sort_bin(
        torch.from_numpy(pos), torch.from_numpy(inv), torch.from_numpy(rad),
        torch.from_numpy(batch), torch.from_numpy(act), torch.tensor(8.0),
        grid_dim=g, slots_per_cell=k, aux_cols=torch.from_numpy(aux),
        rotate=True)
    order = torch.sort(slot_sorted, stable=True).indices    # compact
    slots = slot_sorted[order]
    pack_sorted = pack[pidx_sorted][order]
    got = tplace.place_planes(slots, pack_sorted, g, k)     # CPU: plain
    want = _np(jplace.place_planes(jnp.asarray(slots.numpy().astype(np.int32)),
                                   jnp.asarray(pack_sorted.numpy()), g, k,
                                   interpret=True))
    n_f = pack.shape[1]
    want = _np(jdense.fill_halo(jnp.asarray(want[:n_f])))
    np.testing.assert_array_equal(got.numpy(), want)


def test_place_planes_rejects_unknown_devices():
    slots = torch.zeros(4, dtype=torch.int64, device="meta")
    pack = torch.zeros((4, 8), device="meta")
    with pytest.raises(RuntimeError):
        tplace.place_planes(slots, pack, 16, 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_extent_and_rank_match_jax(seed):
    rng = np.random.RandomState(seed)
    keys = np.sort(rng.randint(0, 50, 400)).astype(np.int32)
    j_rank, j_cnt = jgrid.segment_extent(jnp.asarray(keys))
    t_rank, t_cnt = tgrid.segment_extent(torch.from_numpy(keys))
    np.testing.assert_array_equal(t_rank.numpy(), _np(j_rank))
    np.testing.assert_array_equal(t_cnt.numpy(), _np(j_cnt))
    np.testing.assert_array_equal(
        tgrid.segmented_rank(torch.from_numpy(keys)).numpy(),
        _np(jgrid.segmented_rank(jnp.asarray(keys))))


def test_count_pairs_matches_mxu_counts():
    rng = np.random.RandomState(3)
    hi = rng.randint(0, 13, 3000).astype(np.int32)   # 12 = out of range
    lo = rng.randint(0, 9, 3000).astype(np.int32)    # 8 = out of range
    want = _np(jgrid.count_pairs_mxu(jnp.asarray(hi), jnp.asarray(lo), 12, 8))
    got = tgrid.count_pairs(torch.from_numpy(hi), torch.from_numpy(lo), 12, 8)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("g", [16, 64, 768])
def test_torus_cells_and_hash_buckets(g):
    rng = np.random.RandomState(g)
    pos = rng.uniform(-5000.0, 5000.0, size=(2000, 2)).astype(np.float32)
    pos[0] = [np.nan, np.inf]
    want = _np(jdense.torus_cells(jnp.asarray(pos), jnp.float32(8.0), g))
    got = tdense.torus_cells(torch.from_numpy(pos), torch.tensor(8.0), g)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tdense.rotate_hash_buckets(g) == jdense.rotate_hash_buckets(g)
