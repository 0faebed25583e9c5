"""Kernel H's plain version (``ops/kernels/gather_kernel.py``) against the
JAX package's gather engine.

Inputs are built from a numpy seed and fed to both packages as the same
arrays. On the CPU the dispatchers ``gather_count`` / ``gather_sweep`` take
the plain versions, which the card's kernel H is held against by
``chip_smoke.py`` (``check.gather_pairs``).

- ``gather_sweep_plain``: one pass on the port's grid, with the ordered
  budget's prefix from ``gather_count_plain``, against JAX ``solve_pairs``
  at 1e-4 px (the candidate sums run in another order);
- ``gather_count_plain``: ``new_pairs`` bit for bit against the JAX
  package's ordered budget (its inline count in ``solve_pairs``, on JAX's
  own grid).

Cases: a packed scene where the 0.05 n^2 budget binds and a loose one where
it does not; ``spacing`` and ``literal`` cohesion; a normal table and a
16-bucket table with K = 4, where distinct cells of a particle's nine share
buckets and cells hold more particles than K; an inactive tail; N = 509, not
a multiple of the kernel's 16 particles a block.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egg_fluid_simulation_tpu import config as jconfig
from egg_fluid_simulation_tpu.ops import grid as jgrid
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu_torch import config as tconfig
from egg_fluid_simulation_tpu_torch.ops import grid as tgrid
from egg_fluid_simulation_tpu_torch.ops import solver as tsolver
from egg_fluid_simulation_tpu_torch.ops.kernels import gather_kernel as GK

PASS_TOL = 1e-4    # px, one pass
N = 509            # not a multiple of kernel H's 16 particles a block
COMPLIANCE = (1e-3, 4e-3, 1.0)   # collision, cohesion compliance, relaxation

# (table_size, K): the default-like table, and a 16-bucket table with K = 4
TABLES = {"table256_k16": (256, 16), "table16_k4": (16, 4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scene(name):
    """(N) arrays of one population: ``packed``, 240 live particles in a
    50 px square (the ordered budget binds); ``loose``, 400 in a 400 px
    square (it does not). Three batches, the tail inactive."""
    rng = np.random.default_rng(11)
    live, span = (240, 50.0) if name == "packed" else (400, 400.0)
    return dict(pos=rng.uniform(-span / 2, span / 2, (N, 2)).astype(np.float32),
                inv=rng.uniform(0.55, 1.0, N).astype(np.float32),
                rad=rng.uniform(3.0, 4.0, N).astype(np.float32),
                batch=rng.integers(0, 3, N).astype(np.int32),
                act=np.arange(N) < live)


def _cell_size(cfg):
    return torch.clamp(cfg.max_radius
                       * torch.maximum(cfg.collision_overlap_factor,
                                       cfg.cohesion_interaction_distance_factor),
                       min=1.0)


def _port_grid(d, table):
    ct = tconfig.device_config_from_dict(tconfig.default_white_config())
    act = torch.from_numpy(d["act"])
    grid = tgrid.build_grid(torch.from_numpy(d["pos"]), act, _cell_size(ct),
                            table_size=table[0], slots_per_cell=table[1])
    return ct, act, grid


def _jax_new_pairs(d, table):
    """The JAX package's ordered-budget count (``solve_pairs``, ordered
    branch), on JAX's own grid."""
    cj = jconfig.device_config_from_dict(jconfig.default_white_config())
    cell = jnp.maximum(1.0, cj.max_radius
                       * jnp.maximum(cj.collision_overlap_factor,
                                     cj.cohesion_interaction_distance_factor))
    act = jnp.asarray(d["act"])
    grid = jgrid.build_grid(jnp.asarray(d["pos"]), act, cell,
                            table_size=table[0], slots_per_cell=table[1])
    cand = jgrid.neighbor_candidates(grid)
    self_idx = jnp.arange(N, dtype=jnp.int32)[:, None]
    valid = (cand >= 0) & (cand != self_idx) & act[:, None]
    o_cells = grid.cell_xy[jnp.maximum(cand, 0)]
    near = ((jnp.abs(o_cells[..., 0] - grid.cell_xy[:, None, 0]) <= 1)
            & (jnp.abs(o_cells[..., 1] - grid.cell_xy[:, None, 1]) <= 1))
    return np.asarray(jnp.sum(valid & near & (cand > self_idx),
                              axis=1).astype(jnp.float32))


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("scene", ["packed", "loose"])
def test_gather_count_plain_matches_jax_bitwise(scene, table):
    d = _scene(scene)
    _, act, grid = _port_grid(d, TABLES[table])
    got = GK.gather_count(grid, act)            # CPU: the plain version
    assert torch.equal(got, GK.gather_count_plain(grid, act))
    want = _jax_new_pairs(d, TABLES[table])
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and float(got.sum()) > 0.0
    assert not got[~act].any()                  # inactive particles count 0
    if table == "table16_k4":
        # the case is what its name says: repeated buckets among a live
        # particle's nine, and buckets holding more particles than K
        cxy = grid.cell_xy[act].to(torch.int64)
        off = torch.tensor(tgrid.NEIGHBOR_OFFSETS).T
        b = tgrid._bucket_of(cxy[:, 0, None] + off[0], cxy[:, 1, None] + off[1],
                             16)
        assert bool((b[:, :, None] == b[:, None, :]).sum((1, 2)).gt(9).any())
        bucket = tgrid._bucket_of(grid.cell_xy[act, 0], grid.cell_xy[act, 1],
                                  16)
        assert int(torch.bincount(bucket.to(torch.int64)).max()) > 4
    # and the port's own budget helper agrees
    ct = tconfig.device_config_from_dict(tconfig.default_white_config())
    _, cand, valid = tsolver._pair_candidates(
        torch.from_numpy(d["pos"]), act, _cell_size(ct),
        tsolver.SolverOptions(table_size=TABLES[table][0],
                              slots_per_cell=TABLES[table][1]))
    new_pairs, _, max_pairs = tsolver._ordered_budget(grid, cand, valid, act)
    assert torch.equal(new_pairs, got)
    if table == "table256_k16":
        # the budget binds on the packed scene only (on the 16-bucket
        # table most particles are past K and count no pair)
        assert (float(got.sum()) > float(max_pairs)) == (scene == "packed")


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("cohesion", ["spacing", "literal"])
@pytest.mark.parametrize("budget", ["ordered", "off"])
@pytest.mark.parametrize("scene", ["packed", "loose"])
def test_gather_sweep_plain_matches_jax(scene, budget, cohesion, table):
    d = _scene(scene)
    ts, k = TABLES[table]
    ct, act, grid = _port_grid(d, TABLES[table])
    cum = max_pairs = None
    if budget == "ordered":
        new_pairs = GK.gather_count_plain(grid, act)
        cum = torch.cumsum(new_pairs, 0) - new_pairs
        max_pairs = tsolver._max_pairs(act)
    args = (torch.from_numpy(d["pos"]), torch.from_numpy(d["inv"]),
            torch.from_numpy(d["rad"]), torch.from_numpy(d["batch"]), act,
            grid, cum, max_pairs, torch.tensor(COMPLIANCE[0]),
            torch.tensor(COMPLIANCE[1]), ct.collision_overlap_factor,
            ct.cohesion_interaction_distance_factor,
            torch.tensor(COMPLIANCE[2]))
    got = GK.gather_sweep_plain(*args, spacing=cohesion == "spacing")
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(GK.gather_sweep(*args, spacing=cohesion == "spacing"),
                       got)
    cj = jconfig.device_config_from_dict(jconfig.default_white_config())
    want = np.asarray(jsolver.solve_pairs(
        jnp.asarray(d["pos"]), jnp.asarray(d["inv"]), jnp.asarray(d["rad"]),
        jnp.asarray(d["batch"]), jnp.asarray(d["act"]), cj,
        *(jnp.float32(c) for c in COMPLIANCE),
        jsolver.SolverOptions(table_size=ts, slots_per_cell=k,
                              budget_mode=budget, cohesion_mode=cohesion)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PASS_TOL)
    assert np.abs(got.numpy() - d["pos"]).max() > 1.0    # the pass moved them
    np.testing.assert_array_equal(got.numpy()[~d["act"]], d["pos"][~d["act"]])
    # ... and so does the engine's pass, which builds its own grid
    whole = tsolver.solve_pairs(
        *args[:5], ct, *args[8:10], args[12],
        tsolver.SolverOptions(table_size=ts, slots_per_cell=k,
                              budget_mode=budget, cohesion_mode=cohesion))
    assert torch.equal(whole, got)


def test_dispatchers_raise_without_a_kernel():
    """A tensor on a device that is neither the CPU nor a CUDA card finds no
    kernel and no plain fallback."""
    d = _scene("loose")
    _, act, grid = _port_grid(d, TABLES["table256_k16"])
    meta = tgrid.CellGrid(table=grid.table.to("meta"),
                          cell_xy=grid.cell_xy.to("meta"),
                          table_size=grid.table_size)
    with pytest.raises(RuntimeError, match="no kernel"):
        GK.gather_count(meta, act.to("meta"))
    z = torch.zeros((N,), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        GK.gather_sweep(torch.zeros((N, 2), device="meta"), z, z,
                        torch.zeros((N,), dtype=torch.int32, device="meta"),
                        act.to("meta"), meta, None, None, 0.0, 0.0, 1.0, 1.0,
                        1.0, spacing=True)
