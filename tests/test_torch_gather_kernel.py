"""Kernel H's plain versions (``ops/kernels/gather_kernel.py``) against the
JAX package's gather engine and against the field-by-field forms they
replaced.

Inputs are built from a numpy seed and fed to both packages as the same
arrays. On the CPU the dispatchers ``gather_count`` / ``gather_sweep`` take
the plain versions, which the card's kernel H is held against by
``chip_smoke.py`` (``check.gather_pairs``).

- ``gather_sweep_plain``: one pass on the port's grid, with the ordered
  budget's prefix from ``gather_count_plain``, against JAX ``solve_pairs``
  at 1e-4 px (the candidate sums run in another order);
- ``gather_count_plain``: ``new_pairs`` bit for bit against the JAX
  package's ordered budget (its inline count in ``solve_pairs``, on JAX's
  own grid);
- both read the particle record of ``gather_front_plain`` (one (N, 8) row
  a particle) and are held bit for bit against the forms before the
  record: the count on ``build_grid``'s cells, the sweep against
  :func:`_fields_sweep` (the plain pass on separate field tensors);
- the owned range (``owned=(offset, count)``, the particle-sharded step's
  local slice) bit for bit against :func:`_inline_sharded_pass`, the pass
  ``parallel/sharding.py`` wrote inline before it called kernel H, and
  against JAX ``solve_pairs`` on those rows at 1e-4 px;
- the wrappers' argument checks.

Cases: a packed scene where the 0.05 n^2 budget binds and a loose one where
it does not; ``spacing`` and ``literal`` cohesion; a normal table and a
16-bucket table with K = 4, where distinct cells of a particle's nine share
buckets and cells hold more particles than K; an inactive tail; N = 509, not
a multiple of the kernel's 16 or 32 particles a block.
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
from egg_fluid_simulation_tpu_torch.utils.mathx import EPS

PASS_TOL = 1e-4    # px, one pass
N = 509            # not a multiple of kernel H's particles a block
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
    """``(config, active, record, grid)``: the pass's record from
    ``gather_front_plain`` and the slot table of its buckets, as
    ``solver.solve_pairs`` builds them."""
    ct = tconfig.device_config_from_dict(tconfig.default_white_config())
    act = torch.from_numpy(d["act"])
    record, bucket = GK.gather_front(
        torch.from_numpy(d["pos"]), torch.from_numpy(d["inv"]),
        torch.from_numpy(d["rad"]), torch.from_numpy(d["batch"]), act,
        _cell_size(ct), table[0])
    table_ = tgrid.slot_table(bucket, table[0], table[1])
    grid = tgrid.CellGrid(table=table_, cell_xy=GK.record_cells(record),
                          table_size=table[0])
    return ct, act, record, grid


def _fields_sweep(pos, inv_mass, radius, batch_slot, active, grid, cum,
                  max_pairs, collision_compliance, cohesion_compliance,
                  overlap, coh_factor, relaxation, *, spacing):
    """The plain pass as it read separate field tensors, before the
    record: the fields stacked into one gathered row, the cells gathered
    on their own."""
    n = pos.shape[0]
    cand, valid = GK.candidates(grid, active)
    ordered = cum is not None
    if not ordered:
        cum = torch.zeros((n,), dtype=torch.float32)
    pack = torch.stack([pos[:, 0], pos[:, 1], inv_mass, radius,
                        batch_slot.to(torch.float32), cum], dim=1)
    safe = torch.clamp(cand, min=0).to(torch.int64)
    g = pack.index_select(0, safe.reshape(-1)).reshape(*safe.shape, 6)
    me = pack[:, None, :]
    s_w = me[..., 2]
    ok = valid & GK.in_cells(grid.cell_xy, safe)
    if ordered:
        self_idx = torch.arange(n, dtype=torch.int32)[:, None]
        cum_min = torch.where(cand < self_idx, g[..., 5], me[..., 5])
        ok = ok & (cum_min < max_pairs)
    dx = g[..., 0] - me[..., 0]
    dy = g[..., 1] - me[..., 1]
    dist2 = dx * dx + dy * dy
    dist = torch.sqrt(dist2)
    inv_dist = torch.where(dist > EPS, 1.0 / torch.clamp(dist, min=EPS), 0.0)
    w_sum = s_w + g[..., 2]
    ok = ok & (w_sum >= EPS)
    r_sum = me[..., 3] + g[..., 3]

    def half_scale(target, compliance, apply):
        violation = dist - target
        corr = -violation / (w_sum + compliance)
        bound = torch.abs(violation)
        corr = torch.clamp(corr, -bound, bound)
        return torch.where(apply & ok, corr * s_w, 0.0)

    min_dist = overlap * r_sum
    scale = half_scale(min_dist, collision_compliance,
                       dist2 <= min_dist * min_dist)
    if spacing:
        coh_dist = coh_factor * r_sum
        scale = half_scale(coh_dist, cohesion_compliance,
                           (g[..., 4] == me[..., 4])
                           & (dist2 <= coh_dist * coh_dist)) + scale
    total = torch.stack([torch.sum(-(dx * inv_dist) * scale, dim=1),
                         torch.sum(-(dy * inv_dist) * scale, dim=1)], dim=1)
    return pos + torch.where(active[:, None], relaxation * total, 0.0)


def _inline_sharded_pass(pos, inv_mass, radius, batch_slot, active, cfg,
                         collision_c, cohesion_c, relaxation, table_size, k,
                         shard, n_local, spacing):
    """The particle-sharded step's collision pass as ``parallel/sharding.py``
    wrote it inline (budget off), after the all-gather: the whole set's
    grid, the candidates of particles [shard, shard + n_local)."""
    g_pack = torch.stack([pos[:, 0], pos[:, 1], inv_mass, radius,
                          batch_slot.to(torch.float32),
                          active.to(torch.float32)], dim=1)
    g_pos = g_pack[:, 0:2].contiguous()
    g_act = g_pack[:, 5] > 0.5
    grid = tgrid.build_grid(g_pos, g_act, _cell_size(cfg),
                            table_size=table_size, slots_per_cell=k)
    sl = slice(shard, shard + n_local)
    pos, inv_mass, radius = pos[sl], inv_mass[sl], radius[sl]
    batch_slot, active = batch_slot[sl], active[sl]
    cell_local = grid.cell_xy[sl]
    cand = tgrid.neighbor_candidates(grid._replace(cell_xy=cell_local))
    self_idx = shard + torch.arange(n_local, dtype=torch.int32)[:, None]
    valid = (cand >= 0) & (cand != self_idx) & active[:, None]
    safe = torch.clamp(cand, min=0).to(torch.int64)
    cell_f = grid.cell_xy.to(torch.float32)
    full = torch.cat([g_pack[:, 0:5], cell_f], dim=1)
    g = full[safe]
    s_cell = cell_local.to(torch.float32)
    valid = (valid
             & (torch.abs(g[..., 5] - s_cell[:, None, 0]) <= 1.0)
             & (torch.abs(g[..., 6] - s_cell[:, None, 1]) <= 1.0))
    o_w = torch.where(valid, g[..., 2], 0.0)
    o_r = torch.where(valid, g[..., 3], 0.0)
    dx = g[..., 0] - pos[:, None, 0]
    dy = g[..., 1] - pos[:, None, 1]
    dist2 = dx * dx + dy * dy
    dist = torch.sqrt(dist2)
    inv_dist = torch.where(dist > EPS, 1.0 / torch.clamp(dist, min=EPS), 0.0)
    w_sum = inv_mass[:, None] + o_w
    ok = valid & (w_sum >= EPS)

    def half_scale(target, compliance, apply):
        viol = dist - target
        divisor = w_sum + compliance
        corr = torch.where(divisor >= EPS,
                           -viol / torch.clamp(divisor, min=EPS), 0.0)
        corr = torch.clamp(corr, -torch.abs(viol), torch.abs(viol))
        return torch.where(apply & ok, corr * inv_mass[:, None], 0.0)

    scale = torch.zeros_like(dist)
    if spacing:
        same = g[..., 4] == batch_slot.to(torch.float32)[:, None]
        coh_d = cfg.cohesion_interaction_distance_factor * (radius[:, None]
                                                           + o_r)
        scale = scale + half_scale(coh_d, cohesion_c,
                                   same & (dist2 <= coh_d * coh_d))
    min_d = cfg.collision_overlap_factor * (radius[:, None] + o_r)
    scale = scale + half_scale(min_d, collision_c, dist2 <= min_d * min_d)
    tx = torch.sum(-dx * inv_dist * scale, dim=1)
    ty = torch.sum(-dy * inv_dist * scale, dim=1)
    total = torch.stack([tx, ty], dim=1)
    return pos + torch.where(active[:, None], relaxation * total, 0.0)


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
    _, act, record, grid = _port_grid(d, TABLES[table])
    got = GK.gather_count(record, grid)         # CPU: the plain version
    assert torch.equal(got, GK.gather_count_plain(record, grid))
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
    # and the port's own budget helper, on build_grid's grid (the count
    # before the record), agrees
    ct = tconfig.device_config_from_dict(tconfig.default_white_config())
    g_old, cand, valid = tsolver._pair_candidates(
        torch.from_numpy(d["pos"]), act, _cell_size(ct),
        tsolver.SolverOptions(table_size=TABLES[table][0],
                              slots_per_cell=TABLES[table][1]))
    assert torch.equal(g_old.table, grid.table)
    new_pairs, _, max_pairs = tsolver._ordered_budget(g_old, cand, valid, act)
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
    ct, act, record, grid = _port_grid(d, TABLES[table])
    cum = max_pairs = None
    if budget == "ordered":
        new_pairs = GK.gather_count_plain(record, grid)
        cum = torch.cumsum(new_pairs, 0) - new_pairs
        max_pairs = tsolver._max_pairs(act)
    fields = (torch.from_numpy(d["pos"]), torch.from_numpy(d["inv"]),
              torch.from_numpy(d["rad"]), torch.from_numpy(d["batch"]), act)
    scal = (torch.tensor(COMPLIANCE[0]), torch.tensor(COMPLIANCE[1]),
            ct.collision_overlap_factor,
            ct.cohesion_interaction_distance_factor,
            torch.tensor(COMPLIANCE[2]))
    spacing = cohesion == "spacing"
    got = GK.gather_sweep_plain(record, grid, cum, max_pairs, *scal,
                                spacing=spacing)
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(GK.gather_sweep(record, grid, cum, max_pairs, *scal,
                                       spacing=spacing), got)
    # the pass on the record is the pass on separate fields, bit for bit
    assert torch.equal(_fields_sweep(*fields, grid, cum, max_pairs, *scal,
                                     spacing=spacing), got)
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
        *fields, ct, *scal[:2], scal[4],
        tsolver.SolverOptions(table_size=ts, slots_per_cell=k,
                              budget_mode=budget, cohesion_mode=cohesion))
    assert torch.equal(whole, got)


@pytest.mark.parametrize("live", ["holes", "none"])
def test_plain_pass_stops_at_the_last_live_row(live):
    """The plain count and sweep stop at the last live row; with live rows
    scattered among dead ones (and none after row 400), or none live, both
    equal the whole-population computations bit for bit: the count JAX's,
    the sweep the field-by-field pass, which sweeps every row."""
    d = _scene("packed")
    rng = np.random.default_rng(5)
    d["act"] = ((rng.random(N) < 0.6) & (np.arange(N) < 400)
                if live == "holes" else np.zeros(N, bool))
    ct, act, record, grid = _port_grid(d, TABLES["table256_k16"])
    new_pairs = GK.gather_count_plain(record, grid)
    np.testing.assert_array_equal(new_pairs.numpy(),
                                  _jax_new_pairs(d, TABLES["table256_k16"]))
    cum = torch.cumsum(new_pairs, 0) - new_pairs
    fields = (torch.from_numpy(d["pos"]), torch.from_numpy(d["inv"]),
              torch.from_numpy(d["rad"]), torch.from_numpy(d["batch"]), act)
    scal = (torch.tensor(COMPLIANCE[0]), torch.tensor(COMPLIANCE[1]),
            ct.collision_overlap_factor,
            ct.cohesion_interaction_distance_factor,
            torch.tensor(COMPLIANCE[2]))
    for budget in (cum, None):
        max_pairs = tsolver._max_pairs(act) if budget is not None else None
        got = GK.gather_sweep_plain(record, grid, budget, max_pairs, *scal,
                                    spacing=True)
        assert torch.equal(_fields_sweep(*fields, grid, budget, max_pairs,
                                         *scal, spacing=True), got)
    assert (float(new_pairs.sum()) > 0) == (live == "holes")


# (offset, count) of the 509-particle record (240 live): the first half,
# the middle (the live ones' end inside), through the last row, and an
# empty range
OWNED = {"first": (0, 254), "middle": (200, 100), "to_end": (120, 389),
         "empty": (509, 0)}


@pytest.mark.parametrize("cohesion", ["spacing", "literal"])
@pytest.mark.parametrize("owned", sorted(OWNED))
def test_owned_range_matches_inline_sharded_pass(owned, cohesion):
    """The sweep of an owned range of the record (budget off), as the
    particle-sharded step calls it: bit for bit against the pass
    ``parallel/sharding.py`` wrote inline (the same pair arithmetic; its
    float cell test and divisor guard change nothing at these
    coordinates), and against JAX ``solve_pairs`` on the same rows at
    1e-4 px."""
    d = _scene("packed")
    off, cnt = OWNED[owned]
    ct, act, record, grid = _port_grid(d, TABLES["table256_k16"])
    scal = (torch.tensor(COMPLIANCE[0]), torch.tensor(COMPLIANCE[1]),
            ct.collision_overlap_factor,
            ct.cohesion_interaction_distance_factor,
            torch.tensor(COMPLIANCE[2]))
    spacing = cohesion == "spacing"
    got = GK.gather_sweep(record, grid, None, None, *scal, spacing=spacing,
                          owned=(off, cnt))
    assert got.shape == (cnt, 2) and got.dtype == torch.float32
    if cnt == 0:
        return
    whole = GK.gather_sweep_plain(record, grid, None, None, *scal,
                                  spacing=spacing)
    assert torch.equal(got, whole[off:off + cnt])
    fields = (torch.from_numpy(d["pos"]), torch.from_numpy(d["inv"]),
              torch.from_numpy(d["rad"]), torch.from_numpy(d["batch"]), act)
    want = _inline_sharded_pass(*fields, ct, *scal[:2], scal[4],
                                *TABLES["table256_k16"], off, cnt, spacing)
    assert torch.equal(got, want)
    cj = jconfig.device_config_from_dict(jconfig.default_white_config())
    jax_all = np.asarray(jsolver.solve_pairs(
        jnp.asarray(d["pos"]), jnp.asarray(d["inv"]), jnp.asarray(d["rad"]),
        jnp.asarray(d["batch"]), jnp.asarray(d["act"]), cj,
        *(jnp.float32(c) for c in COMPLIANCE),
        jsolver.SolverOptions(table_size=256, slots_per_cell=16,
                              budget_mode="off", cohesion_mode=cohesion)))
    np.testing.assert_allclose(got.numpy(), jax_all[off:off + cnt], rtol=0,
                               atol=PASS_TOL)
    assert np.abs(got.numpy() - d["pos"][off:off + cnt]).max() > 1.0


def test_dispatchers_raise_without_a_kernel():
    """A tensor on a device that is neither the CPU nor a CUDA card finds no
    kernel and no plain fallback."""
    d = _scene("loose")
    _, act, record, grid = _port_grid(d, TABLES["table256_k16"])
    meta = tgrid.CellGrid(table=grid.table.to("meta"),
                          cell_xy=grid.cell_xy.to("meta"),
                          table_size=grid.table_size)
    rec = record.to("meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        GK.gather_count(rec, meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        GK.gather_sweep(rec, meta, None, None, 0.0, 0.0, 1.0, 1.0, 1.0,
                        spacing=True)
    z = torch.zeros((N,), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        GK.gather_front(torch.zeros((N, 2), device="meta"), z, z,
                        torch.zeros((N,), dtype=torch.int32, device="meta"),
                        act.to("meta"), 1.0, 256)


def _bad_front_args(case):
    """gather_front's arguments, good or with one fault."""
    n = 64
    args = dict(pos=torch.zeros((n, 2)), inv_mass=torch.ones(n),
                radius=torch.ones(n), batch_slot=torch.zeros(n, dtype=torch.int32),
                active=torch.ones(n, dtype=torch.bool), table_size=256)
    if case == "pos_shape":
        args["pos"] = torch.zeros((n, 3))
    elif case == "batch_dtype":
        args["batch_slot"] = torch.zeros(n, dtype=torch.int64)
    elif case == "active_dtype":
        args["active"] = torch.ones(n, dtype=torch.uint8)
    elif case == "table_not_pow2":
        args["table_size"] = 100
    return args


@pytest.mark.parametrize("case", ["ok", "pos_shape", "batch_dtype",
                                  "active_dtype", "table_not_pow2"])
def test_front_argument_checks(case):
    """What gather_front's card path refuses (``_check_front``)."""
    args = _bad_front_args(case)
    if case == "ok":
        GK._check_front(**args)
    else:
        with pytest.raises(ValueError, match="gather_front"):
            GK._check_front(**args)


@pytest.mark.parametrize("case", ["ok", "record_width", "record_dtype",
                                  "record_misaligned", "table_rows",
                                  "table_not_pow2", "table_device",
                                  "owned_past_end", "owned_negative"])
def test_pass_argument_checks(case):
    """What the count and the sweep refuse: a record that is not (N, 8)
    float32 at a 16-byte aligned address, a table that is not
    (table_size + 1, K) with table_size a power of two on the record's
    device (``_check_record``, on the card path), and an owned range
    outside the record (on any device)."""
    d = _scene("loose")
    _, act, record, grid = _port_grid(d, TABLES["table256_k16"])
    owned = None
    if case == "record_width":
        record = record[:, :6].contiguous()
    elif case == "record_dtype":
        record = record.double()
    elif case == "record_misaligned":      # the kernels read float4 / int4
        record = torch.empty(N * 8 + 1)[1:].view(N, 8).copy_(record)
    elif case == "table_rows":
        grid = grid._replace(table=grid.table[:-1])
    elif case == "table_not_pow2":
        grid = grid._replace(table=grid.table[:101], table_size=100)
    elif case == "table_device":
        grid = grid._replace(table=grid.table.to("meta"))
    elif case == "owned_past_end":
        owned = (500, 10)
    elif case == "owned_negative":
        owned = (-1, 4)
    if case == "ok":
        GK._check_record("gather_sweep", record, grid)
        GK.gather_sweep(record, grid, None, None, 0.0, 0.0, 1.0, 1.0, 1.0,
                        spacing=True, owned=(8, 16))
    elif owned is not None:
        with pytest.raises(ValueError, match="owned range"):
            GK.gather_sweep(record, grid, None, None, 0.0, 0.0, 1.0, 1.0, 1.0,
                            spacing=True, owned=owned)
    else:
        with pytest.raises(ValueError, match="gather_sweep"):
            GK._check_record("gather_sweep", record, grid)
