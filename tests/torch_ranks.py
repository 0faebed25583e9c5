"""The PyTorch side of the multi-rank twin tests, run in spawned gloo ranks.

A test module writes its inputs (the JAX handler's state as a host view,
configs, layout) to an ``.npz``, starts one set of ranks for all its
scenarios (:func:`start`), computes the JAX side meanwhile, and reads the
ranks' results back (:meth:`Ranks.result`: rank 0 writes them). The ranks
import torch and the port only, never JAX. A rank set that fails, or runs
past its time limit, is killed and fails the test.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict

import numpy as np
import torch

from egg_fluid_simulation_tpu_torch.parallel.mesh import spawn_ranks

RANK_TIMEOUT_S = 600.0      # a rank set's whole run (~60 s on an idle CPU)
GROUP_TIMEOUT_S = 300.0     # one collective's wait on a slow peer


class Ranks:
    """A rank set running in the background (a thread waits on it)."""

    def __init__(self, program: str, inputs: Dict[str, np.ndarray], tmp,
                 n_ranks: int):
        self.out = os.path.join(str(tmp), f"{program}_result.npz")
        inp = os.path.join(str(tmp), f"{program}_inputs.npz")
        np.savez(inp, **inputs)
        self.error = None

        def run():
            try:
                spawn_ranks(_program_main, (program, inp, self.out), n_ranks,
                            "cpu", timeout_s=RANK_TIMEOUT_S,
                            group_timeout_s=GROUP_TIMEOUT_S)
            except BaseException as e:  # re-raised in result()
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def result(self) -> Dict[str, np.ndarray]:
        self.thread.join(RANK_TIMEOUT_S + 30.0)
        assert not self.thread.is_alive(), "rank set did not end"
        if self.error is not None:
            raise AssertionError(f"rank set failed: {self.error!r}")
        with np.load(self.out) as f:
            return {k: f[k] for k in f.files}


def start(program: str, inputs: Dict[str, np.ndarray], tmp,
          n_ranks: int) -> Ranks:
    return Ranks(program, inputs, tmp, n_ranks)


def _program_main(program: str, inp: str, out: str) -> None:
    import torch.distributed as dist
    with np.load(inp) as f:
        inputs = {k: f[k] for k in f.files}
    res: Dict[str, np.ndarray] = {}
    globals()[program](inputs, res)
    if dist.get_rank() == 0:
        np.savez(out, **res)


# ------------------------------------------------------ window counts --

def cell_size_f32(config) -> np.float32:
    """A population's dense cell size as the step forms it in float32:
    ``max(max_radius * max(overlap, cohesion distance), 1)``."""
    f = max(np.float32(config["collision_overlap_factor"]),
            np.float32(config["cohesion_interaction_distance_factor"]))
    return max(np.float32(config["max_radius"]) * f, np.float32(1.0))


def _wrap_i32(x):
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def window_masks(pos, active, cell, grid_dim: int, k: int, db: int, dx: int,
                 rank: int):
    """``(transit, over)`` masks of one rank's particles as its binning
    sees them, in numpy: ``transit`` the active particles whose torus cell
    ``floor(pos / cell) mod G`` lies outside the rank's window; ``over``
    the particles in the window past rank ``k`` of their cell, ranked by
    the rotating winner hash of the position bits (ties by particle
    index), as ``dense.bin_to_planes`` ranks them."""
    pos = np.asarray(pos, np.float32)
    gb, gx = grid_dim // db, grid_dim // dx
    band, block = divmod(rank, dx)
    c = np.floor(pos / np.float32(cell))
    c = np.clip(np.where(np.isfinite(c), c, 0.0), -1e9, 1e9)
    cxy = np.mod(c.astype(np.int32).astype(np.int64), grid_dim)
    ly, lx = cxy[:, 1] - band * gb, cxy[:, 0] - block * gx
    in_win = (ly >= 0) & (ly < gb) & (lx >= 0) & (lx < gx) & active
    hb = 1 << min(12, int(np.floor(np.log2((2**31 - 1)
                                           / (grid_dim * grid_dim + 1)))))
    bits = np.ascontiguousarray(pos).view(np.int32).astype(np.int64)
    h = _wrap_i32(_wrap_i32(bits[:, 0] * -1640531535)
                  + _wrap_i32(bits[:, 1] * -2048144789))
    h = (h ^ (h >> 15)) & (hb - 1)
    local = np.where(in_win, ly * gx + lx, gb * gx)
    order = np.lexsort((np.arange(pos.shape[0]), h, local))
    run_start = np.r_[True, local[order][1:] != local[order][:-1]]
    first = np.maximum.accumulate(np.where(run_start,
                                           np.arange(order.size), 0))
    rank_in_cell = np.empty(order.size, np.int64)
    rank_in_cell[order] = np.arange(order.size) - first
    return active & ~in_win, in_win & (rank_in_cell >= k)


def layout_counts(pos, batch_slot, cells, grid_dim: int, k: int, db: int,
                  dx: int, after_slot=None):
    """Per population ``(transit, over, arrived)`` counts of a whole
    spatial-layout state (``(2, C, ...)`` arrays, rank ``r`` holding slice
    ``r`` of ``C / (db * dx)``) binned as its ranks bin it: the masks of
    :func:`window_masks` summed over the ranks, each counted over the slots
    active in ``after_slot`` (the batch slots after the call's final
    migration; the binned state's own by default); ``arrived`` counts the
    slots active there that the binning found empty."""
    n_ranks = db * dx
    c_loc = pos.shape[1] // n_ranks
    after_slot = batch_slot if after_slot is None else after_slot
    out = np.zeros((2, 3), np.int64)
    for i in range(2):
        for r in range(n_ranks):
            sl = slice(r * c_loc, (r + 1) * c_loc)
            active = batch_slot[i][sl] >= 0
            after = after_slot[i][sl] >= 0
            transit, over = window_masks(pos[i][sl], active, cells[i],
                                         grid_dim, k, db, dx, r)
            out[i] += [np.sum(after & transit), np.sum(after & over),
                       np.sum(after & ~active)]
    return out


# ------------------------------------------------------------- helpers --

def _configs(inputs):
    from egg_fluid_simulation_tpu_torch.config import (device_config_from_dict,
                                                       stack_device_configs)
    white = json.loads(str(inputs["white_config"]))
    yolk = json.loads(str(inputs["yolk_config"]))
    return white, yolk, stack_device_configs(device_config_from_dict(white),
                                             device_config_from_dict(yolk))


def _spatial_setup(inputs):
    from egg_fluid_simulation_tpu_torch.interop import state_from_numpy
    from egg_fluid_simulation_tpu_torch.ops.solver import SolverOptions
    from egg_fluid_simulation_tpu_torch.parallel import spatial as S
    g, k, db, dx, cap = (int(inputs[n]) for n in
                         ("grid_dim", "slots", "db", "dx", "migrate_cap"))
    mesh = S.make_spatial_mesh(db, dx, "cpu")
    lay = S.SpatialLayout(g, k, db=db, dx=dx, migrate_cap=cap)
    opts = SolverOptions(engine="dense", budget_mode="off", dense_rebin="step",
                         dense_grid_dim=g, dense_slots=k)
    state = state_from_numpy(
        {f: inputs["state_" + f] for f in
         ("pos", "prev", "vel", "last_pos", "radius", "mass_t", "inv_mass",
          "batch_slot", "color", "count", "batch_target", "batch_radius",
          "batch_used")})
    return mesh, lay, opts, state


def _save_state(res, prefix, state, mesh):
    from egg_fluid_simulation_tpu_torch.parallel.sharding import unshard_state
    from egg_fluid_simulation_tpu_torch.state import host_view
    for k, v in host_view(unshard_state(state, mesh)).items():
        res[f"{prefix}_{k}"] = v


def _save_stats(res, prefix, stats, info=None):
    for k in ("aabb_min", "aabb_max", "centroid", "last_centroid",
              "max_radius", "max_velocity", "batch_pos_sum", "batch_count"):
        res[f"{prefix}_{k}"] = getattr(stats, k).numpy()
    if info is not None:
        res[f"{prefix}_info"] = info.numpy()


def _gathered(mesh, t):
    """Every rank's ``t`` stacked in rank order."""
    return mesh.all_gather(t[None].contiguous(), "test").numpy()


class LastBinning:
    """While active, keeps the inputs of each population's last resident
    binning on this rank (a wrapper of ``SpatialSteps.bin``): what the
    in-transit count of the call's exit is taken over."""

    def __enter__(self):
        from egg_fluid_simulation_tpu_torch.parallel import spatial as S
        self.S, self.orig, self.last = S, S.SpatialSteps.bin, {}
        orig, last = self.orig, self.last

        def bin(loop, i, pos, vel, mass_t, batch_slot, active):
            last[i] = (pos.clone(), batch_slot.clone())
            return orig(loop, i, pos, vel, mass_t, batch_slot, active)

        S.SpatialSteps.bin = bin
        return self

    def __exit__(self, *exc):
        self.S.SpatialSteps.bin = self.orig

    def save(self, res, prefix, mesh):
        """The last binning's positions and batch slots of both
        populations, the whole layout (``(2, C, ...)``, rank order)."""
        for name, k in (("pos", 0), ("batch_slot", 1)):
            res[f"{prefix}_bin_{name}"] = np.stack([
                mesh.all_gather(self.last[i][k].contiguous(), "test").numpy()
                for i in range(2)])


# ------------------------------------------------------------ programs --

def spatial_program(inputs, res):
    """The 2D layer pieces on a db x dx mesh: redistribute, one binning and
    halo exchange per population, three steps (the first's bytes counted),
    the redistribute of a stepped state, and one step after a particle was
    teleported a band down."""
    from egg_fluid_simulation_tpu_torch.parallel import spatial as S
    from egg_fluid_simulation_tpu_torch.parallel.accounting import \
        measured_collective_bytes
    mesh, lay, opts, state = _spatial_setup(inputs)
    _, _, cfg2 = _configs(inputs)
    cells = [float(c) for c in inputs["cells"]]
    dt, relax = torch.tensor(1 / 60), torch.tensor(1.0)

    st0 = S.redistribute(state, cells, lay, mesh)
    _save_state(res, "redist", st0, mesh)

    # one binning + full halo exchange per population
    band, block = mesh.coords
    sub_dt = dt / opts.n_substeps
    follow_radius = torch.sqrt(torch.clamp(st0.batch_radius, min=0.0))
    from egg_fluid_simulation_tpu_torch.config import population_config
    for i in range(2):
        active = st0.batch_slot[i] >= 0
        env = S._pop_env(population_config(cfg2, i), st0.mass_t[i], active,
                         st0.batch_slot[i], st0.batch_target,
                         follow_radius[i], sub_dt, opts, lay)
        aux_cols = torch.stack([st0.pos[i][:, 0], st0.pos[i][:, 1],
                                st0.vel[i][:, 0], st0.vel[i][:, 1],
                                env["tx"], env["ty"], env["td"]], dim=1)
        planes, aux, slot, in_grid, transit = S._bin_local(
            st0.pos[i], env["inv_mass"], env["radius"], st0.batch_slot[i],
            active, env["cell_size"], band, block, lay, aux_cols)
        res[f"bin_planes_{i}"] = _gathered(mesh, planes)
        res[f"bin_aux_{i}"] = _gathered(mesh, aux)
        res[f"bin_slot_{i}"] = _gathered(mesh, slot)
        res[f"bin_in_grid_{i}"] = _gathered(mesh, in_grid.to(torch.int32))
        res[f"bin_transit_{i}"] = _gathered(mesh, transit.to(torch.int32))
        S._exchange_halos(planes, lay, mesh, "full_halo_exchange")
        S._exchange_halos(aux, lay, mesh, "full_halo_exchange")
        res[f"xch_planes_{i}"] = _gathered(mesh, planes)
        res[f"xch_aux_{i}"] = _gathered(mesh, aux)

    step = S.spatial_step(mesh, lay, opts)
    st = st0
    for s in range(3):
        (st, stats, info), counted = measured_collective_bytes(
            mesh, step, st, cfg2, dt, relax)
        if s == 0:
            for k, v in counted.items():
                res[f"bytes_{k}"] = np.asarray(v)
        _save_state(res, f"step{s}", st, mesh)
        _save_stats(res, f"step{s}", stats, info)
    st_r = S.redistribute(st, cells, lay, mesh, from_spatial=True)
    _save_state(res, "redist_spatial", st_r, mesh)

    # teleport the first live white particle one band down (same block)
    from egg_fluid_simulation_tpu_torch.parallel import sharding
    full = sharding.unshard_state(st0, mesh)
    pos = full.pos.clone()
    j = int(torch.nonzero(full.batch_slot[0] >= 0)[0, 0])
    pos[0, j, 1] += lay.gb * cells[0]
    full = full.replace(pos=pos, prev=pos.clone(),
                        vel=torch.zeros_like(full.vel))
    st_t, _, info_t = step(sharding.shard_state(full, mesh), cfg2, dt, relax)
    res["teleport_j"] = np.asarray(j)
    _save_state(res, "teleport", st_t, mesh)
    res["teleport_info"] = info_t.numpy()


def resident_program(inputs, res):
    """Resident steps and the sharded draw on a db x dx mesh: five resident
    steps in one call against a loop of five steps, two resident steps
    with the first call's episode state, and the draw of a stepped state."""
    from egg_fluid_simulation_tpu_torch.ops import render as R
    from egg_fluid_simulation_tpu_torch.parallel import spatial as S
    from egg_fluid_simulation_tpu_torch.state import StepStats
    mesh, lay, opts, state = _spatial_setup(inputs)
    white, yolk, cfg2 = _configs(inputs)
    cells = [float(c) for c in inputs["cells"]]
    dt, relax = torch.tensor(1 / 60), torch.tensor(1.0)

    st0 = S.redistribute(state, cells, lay, mesh)
    multi = S.spatial_multi_step(mesh, lay, opts)
    S.host_reads = 0
    with LastBinning() as binning:
        st_m, stats_m, info_m, ws = multi(st0, cfg2, dt, relax, 5)
    res["multi_host_reads"] = np.asarray(S.host_reads)
    binning.save(res, "multi", mesh)
    _save_state(res, "multi", st_m, mesh)
    _save_stats(res, "multi", stats_m, info_m)
    res["multi_wide"] = np.asarray([[int(v) for v in w] for w in ws])
    step = S.spatial_step(mesh, lay, opts)
    st_s = st0
    for _ in range(5):
        st_s, stats_s, info_s = step(st_s, cfg2, dt, relax)
    _save_state(res, "loop", st_s, mesh)
    _save_stats(res, "loop", stats_s, info_s)
    st_2, _, _, _ = multi(st0, cfg2, dt, relax, 2, wide_state=ws)
    _save_state(res, "multi2", st_2, mesh)

    from egg_fluid_simulation_tpu_torch.interop import state_from_numpy
    drawn = state_from_numpy({f: inputs["draw_" + f] for f in
                              ("pos", "prev", "vel", "last_pos", "radius",
                               "mass_t", "inv_mass", "batch_slot", "color",
                               "count", "batch_target", "batch_radius",
                               "batch_used")})
    stats = StepStats(**{k: torch.from_numpy(inputs["draw_stats_" + k])
                         for k in ("aabb_min", "aabb_max", "centroid",
                                   "last_centroid", "max_radius",
                                   "max_velocity", "batch_pos_sum",
                                   "batch_count")})
    opts2 = tuple(R.auto_render_options(c, 256) for c in (white, yolk))
    draw = S.spatial_draw(mesh, lay, opts2, (0.0, 0.0, 256, 256), 0.3, 0.01,
                          True)
    frame, audit = draw(S.redistribute(drawn, cells, lay, mesh), stats, cfg2,
                        1.0)
    res["frame"], res["frame_audit"] = frame.numpy(), audit.numpy()


def sharding_program(inputs, res):
    """The 1D particle-sharded step on every rank: one step (its bytes
    counted) and five chained steps; then the dry run's checks
    (``parallel/dryrun.py``) on the same ranks."""
    from egg_fluid_simulation_tpu_torch.interop import state_from_numpy
    from egg_fluid_simulation_tpu_torch.ops.solver import SolverOptions
    from egg_fluid_simulation_tpu_torch.parallel import sharding
    from egg_fluid_simulation_tpu_torch.parallel.accounting import \
        measured_collective_bytes
    from egg_fluid_simulation_tpu_torch.state import host_view
    _, _, cfg2 = _configs(inputs)
    mesh = sharding.make_mesh("cpu")
    opts = SolverOptions(cohesion_mode="literal", table_size=4096,
                         slots_per_cell=32, budget_mode="off")
    state = state_from_numpy({k[6:]: v for k, v in inputs.items()
                              if k.startswith("state_")})
    st = sharding.shard_state(state, mesh)
    step = sharding.sharded_step(mesh, opts)
    dt, relax = torch.tensor(1 / 60), torch.tensor(1.0)
    (new, stats), counted = measured_collective_bytes(mesh, step, st, cfg2,
                                                      dt, relax)
    for k, v in counted.items():
        res[f"bytes_{k}"] = np.asarray(v)
    for k, v in host_view(sharding.unshard_state(new, mesh)).items():
        res[f"step_{k}"] = v
    _save_stats(res, "step", stats)
    for _ in range(4):
        new, stats = step(new, cfg2, dt, relax)
    for k, v in host_view(sharding.unshard_state(new, mesh)).items():
        res[f"steps5_{k}"] = v
    _save_stats(res, "steps5", stats)
    # the dry run's checks on the same ranks (it raises on a failure)
    import torch.distributed as dist
    from egg_fluid_simulation_tpu_torch.parallel import dryrun
    dryrun.check(dist.get_world_size(), "cpu")
    res["dryrun_passed"] = np.asarray(1)


def sharding_graph_program(inputs, res):
    """The sharded step's graph plumbing run eagerly on its static buffers
    (``ShardedGraphs(capture=False)``), the eager ``sharded_step``
    (``step_graph.EAGER``) and the default route of a CPU mesh, each
    ``n_steps`` chained steps from the sharded state: every step's state,
    stats and collective bytes per category. On the graph route the state
    the first step handed out is compared after the last (not overwritten
    by later replays), and the first step is run again with Python-number
    scalars."""
    from egg_fluid_simulation_tpu_torch.interop import state_from_numpy
    from egg_fluid_simulation_tpu_torch.ops.solver import SolverOptions
    from egg_fluid_simulation_tpu_torch.ops.step_graph import EAGER
    from egg_fluid_simulation_tpu_torch.parallel import sharding
    from egg_fluid_simulation_tpu_torch.parallel.accounting import \
        measured_collective_bytes
    from egg_fluid_simulation_tpu_torch.parallel.sharding_graph import \
        ShardedGraphs
    _, _, cfg2 = _configs(inputs)
    mesh = sharding.make_mesh("cpu")
    opts = SolverOptions(**json.loads(str(inputs["options"])))
    state = state_from_numpy({k[6:]: v for k, v in inputs.items()
                              if k.startswith("state_")})
    st0 = sharding.shard_state(state, mesh)
    dt, relax = torch.tensor(1 / 60), torch.tensor(1.0)
    graphs = ShardedGraphs(mesh, opts, capture=False)
    routes = {"eager": sharding.sharded_step(mesh, opts, graphs=EAGER),
              "graphs": sharding.sharded_step(mesh, opts, graphs=graphs),
              "default": sharding.sharded_step(mesh, opts)}
    for route, step in routes.items():
        st = st0
        for k in range(int(inputs["n_steps"])):
            (st, stats), counted = measured_collective_bytes(
                mesh, step, st, cfg2, dt, relax)
            res[f"{route}_{k}_bytes"] = np.asarray(json.dumps(
                counted, sort_keys=True))
            _save_state(res, f"{route}_{k}", st, mesh)
            _save_stats(res, f"{route}_{k}", stats)
            if route == "graphs" and k == 0:
                first = st
        if route == "graphs":
            _save_state(res, "graphs_first_after", first, mesh)
    res["graphs_captures"] = np.asarray(graphs.captures)
    st, stats = routes["graphs"](st0, cfg2, 1 / 60, 1.0)
    _save_state(res, "graphs_floats", st, mesh)
    _save_stats(res, "graphs_floats", stats)


# a packed clump whose cells hold more than K = 4 particles, and a small
# batch away from it that spreads the mean density the automatic render
# budget is sized from, so the clump's render bins overflow it: the
# arguments of each add
CLUMP = ((128.0, 128.0, 12.0, 4.0, None, None, 300, 40),
         (40.0, 40.0, 8.0, 6.0, None, None, 10, 3))
CLUMP_VIEW = (64.0, 64.0, 128, 128)


def handler_program(inputs, res):
    """The SpatialHandler product surface on a db x dx mesh: the flow of
    tests/test_spatial_handler.py, its migration-overflow recovery, a demo
    session, and a live checkpoint (rank 0 writes it)."""
    from egg_fluid_simulation_tpu_torch import checkpoint
    from egg_fluid_simulation_tpu_torch import demo
    from egg_fluid_simulation_tpu_torch.parallel import spatial as S
    from egg_fluid_simulation_tpu_torch.parallel.spatial_handler import \
        SpatialHandler
    from egg_fluid_simulation_tpu_torch.ops.solver import SolverOptions
    white, yolk, _ = _configs(inputs)
    db, dx, g, k = (int(inputs[n]) for n in ("db", "dx", "grid_dim", "slots"))
    options = SolverOptions(engine="dense", budget_mode="off",
                            dense_rebin="step", dense_grid_dim=g,
                            dense_slots=k)

    def spatial(**kw):
        return SpatialHandler(white, yolk, db=db, dx=dx, capacity=1024,
                              max_batches=8, options=options, device="cpu",
                              **kw)

    # ---- the product flow ----
    hs = spatial()
    a = hs.add(60.0, 50.0, 40.0, 12.0, None, None, 40, 10)
    b = hs.add(150.0, 90.0, 40.0, 12.0, None, None, 40, 10)
    hs.set_target_position(a, 120.0, 70.0)
    hs.set_target_position(b, 80.0, 60.0)
    res["flow_ids"] = np.asarray(hs.list_ids())
    res["flow_n0"] = np.asarray(hs.get_n_particles())
    hs.update(3 / 60)
    res["flow_positions"] = np.asarray([hs.get_position(i)
                                        for i in hs.list_ids()])
    res["flow_frame"] = hs.draw(viewport=(0, 0, 256, 256)).numpy()
    hs.run_steps(4)
    res["flow_n_run"] = np.asarray(hs.get_n_particles())
    res["flow_info_run"] = np.asarray(hs.last_migration_info)
    c = hs.add(100.0, 120.0, 30.0, 10.0, None, None, 30, 8)
    hs.update(1 / 60)
    hs.remove(c)
    hs.update(1 / 60)
    res["flow_n_end"] = np.asarray(hs.get_n_particles())
    hs.set_yolk_color(hs.list_ids()[0], 0.9, 0.2, 0.1)
    hs.update(1 / 60)
    _save_state(res, "flow_end", hs.state, hs.mesh)

    # ---- migration overflow: a teleported clump through 1-slot buffers ----
    ho = spatial(migrate_cap=1)
    ho.add(60.0, 50.0, 40.0, 12.0, None, None, 40, 10)
    ho.update(1 / 60)
    res["over_n0"] = np.asarray(ho.get_n_particles())
    band_px = ho.layout.gb * ho._cell_sizes()[0]
    st = ho._sp_state
    pos = st.pos.clone()
    pos[..., 1] = torch.where(st.batch_slot >= 0, pos[..., 1] + band_px,
                              pos[..., 1])
    ho._sp_state = st.replace(pos=pos, prev=pos.clone())
    ho.update(1 / 60)
    res["over_info"] = np.asarray(ho.last_migration_info)
    res["over_redistributed"] = np.asarray(ho._redistribute_count)
    res["over_cells"] = np.asarray(ho._cell_sizes(), np.float32)
    _save_state(res, "over", ho._sp_state, ho.mesh)

    # ---- a packed clump across the four windows: the audited draw (every
    # rank the same boost, nothing dropped), then one step from the
    # redistributed state (the in-transit count) ----
    hc = spatial()
    for args in CLUMP:
        hc.add(*args)
    res["clump_frame"] = hc.draw(viewport=CLUMP_VIEW).numpy()
    res["clump_boosts"] = _gathered(hc.mesh, torch.tensor(
        hc._inner._render_budget.k_boost, dtype=torch.float64))
    res["clump_render_audit"] = hc._inner._render_budget.audit.numpy()
    res["clump_cells"] = np.asarray([cell_size_f32(c) for c in (white, yolk)])
    _save_state(res, "clump_in", hc._sp_state, hc.mesh)
    hc.update(1 / 60)
    res["clump_info"] = np.asarray(hc.last_migration_info)
    res["clump_redistributed"] = np.asarray(hc._redistribute_count)

    # ---- the demo session on the mesh ----
    d = demo.DemoState(capacity=1024, spatial=(db, dx), device="cpu")
    d.spawn_batch()
    d.spawn_batch()
    for _ in range(3):
        d.update()
    res["demo_frame"] = d.draw()
    res["demo_n"] = np.asarray(d.overlay_stats()["n_particles"])

    # ---- a live checkpoint ----
    sh = spatial()
    a = sh.add(60.0, 50.0, 20.0, 6.0, None, None, 40, 10)
    sh.set_target_position(a, 100.0, 70.0)
    sh.run_steps(3)
    checkpoint.save(sh, str(inputs["ckpt_path"]))
    res["ckpt_n"] = np.asarray(sh.get_n_particles())
    res["ckpt_pos"] = sh.state.pos.numpy()     # synced: the prefix layout


def spatial_graph_program(inputs, res):
    """The spatial graphs' parts run eagerly on their static buffers
    (``SpatialGraphs(capture=False)``) against the eager spatial layer, on a
    db x dx mesh: from the redistributed state a step, and resident steps
    that rebin (call ``a``: ``dt`` 1/60); from ``a``'s state and episode
    state resident steps that do not (call ``b``: a tiny ``dt``); a draw of
    ``b``'s state; each call's collective bytes and rebins. Then
    ``SpatialHandler`` with and without the graphs through update,
    run_steps and draw."""
    from egg_fluid_simulation_tpu_torch.ops import render as R
    from egg_fluid_simulation_tpu_torch.parallel import spatial as S
    from egg_fluid_simulation_tpu_torch.parallel.spatial_graph import (
        SpatialGraphs, rebin_route)
    from egg_fluid_simulation_tpu_torch.parallel.spatial_handler import \
        SpatialHandler
    mesh, lay, opts, state = _spatial_setup(inputs)
    white, yolk, cfg2 = _configs(inputs)
    cells = [float(c) for c in inputs["cells"]]
    relax = torch.tensor(1.0)
    dts = {"a": torch.tensor(1 / 60), "b": torch.tensor(float(inputs["dt_b"]))}
    n_steps = {"a": int(inputs["n_a"]), "b": int(inputs["n_b"])}
    opts2 = tuple(R.auto_render_options(c, 128) for c in (white, yolk))
    thickness = tuple(float(c["outline_thickness"]) for c in (white, yolk))
    st0 = S.redistribute(state, cells, lay, mesh)
    res["route"] = np.asarray(rebin_route(mesh))

    for route in ("eager", "graphs"):
        graphs = (SpatialGraphs(mesh, lay, opts, capture=False)
                  if route == "graphs" else None)
        step = S.spatial_step(mesh, lay, opts)
        multi = S.spatial_multi_step(mesh, lay, opts)

        def counted(name, fn):
            mesh.counter.reset()
            S.host_reads = 0
            S.rebins[:] = [0, 0]
            out = fn()
            res[f"{route}_{name}_reads"] = np.asarray(S.host_reads)
            res[f"{route}_{name}_host_rebins"] = np.asarray(S.rebins)
            return out

        if graphs is None:
            st1, stats1, info1 = counted("step", lambda: step(
                st0, cfg2, dts["a"], relax))
        else:
            st1, stats1, info1 = counted("step", lambda: graphs.step(
                st0, cfg2, dts["a"], relax))
        res[f"{route}_step_bytes"] = np.asarray(json.dumps(
            mesh.counter.snapshot(), sort_keys=True))
        _save_state(res, f"{route}_step", st1, mesh)
        _save_stats(res, f"{route}_step", stats1, info1)
        st, ws = st0, None
        for call in ("a", "b"):
            with LastBinning() as binning:
                if graphs is None:
                    st, stats, info, ws = counted(call, lambda: multi(
                        st, cfg2, dts[call], relax, n_steps[call],
                        wide_state=ws))
                    taken = np.asarray(S.rebins)
                else:
                    st, stats, info, ws, taken = counted(
                        call, lambda: graphs.steps(st, cfg2, dts[call], relax,
                                                   n_steps[call], ws))
                    taken = taken.numpy()
                    graphs.count_branches(taken)
            res[f"{route}_{call}_rebins"] = taken
            res[f"{route}_{call}_bytes"] = np.asarray(json.dumps(
                mesh.counter.snapshot(), sort_keys=True))
            binning.save(res, f"{route}_{call}", mesh)
            _save_state(res, f"{route}_{call}", st, mesh)
            _save_stats(res, f"{route}_{call}", stats, info)
            res[f"{route}_{call}_wide"] = np.asarray(
                [[int(v) for v in w] for w in ws])
        # the build's render, then a replay; the eager route once
        for _ in range(1 if graphs is None else 2):
            mesh.counter.reset()
            if graphs is None:
                frame, audit = S.spatial_draw(
                    mesh, lay, opts2, (0.0, 0.0, 128, 96), 0.3, 0.01, True,
                    thickness=thickness)(st, stats, cfg2, 0.5)
            else:
                frame, audit = graphs.draw(
                    st, stats, cfg2, (0.5, 0.3, 0.01, (0.0, 0.0)),
                    opts2=opts2, vw=128, vh=96, use_lighting=True,
                    thickness=thickness)
            res[f"{route}_draw_bytes"] = np.asarray(json.dumps(
                mesh.counter.snapshot(), sort_keys=True))
        res[f"{route}_frame"] = frame.numpy()
        res[f"{route}_frame_audit"] = audit.numpy()

    # ---- the handler, eagerly and through the graphs' parts ----
    for route in ("eager", "graphs"):
        h = SpatialHandler(white, yolk, db=lay.db, dx=lay.dx, capacity=512,
                           max_batches=8, options=opts, device="cpu")
        if route == "graphs":
            h._spatial = SpatialGraphs(h.mesh, h.layout, opts, capture=False)
        a = h.add(60.0, 50.0, 30.0, 10.0, None, None, 80, 12)
        h.set_target_position(a, 110.0, 70.0)
        h.update(1 / 60)
        h.update(3 / 60)
        h.run_steps(2)
        res[f"handler_{route}_frame"] = h.draw(viewport=(0, 0, 160, 120),
                                               background=(0.1, 0.1, 0.1,
                                                           1.0)).numpy()
        res[f"handler_{route}_info"] = np.asarray(h.last_migration_info)
        res[f"handler_{route}_render_audit"] = \
            h._inner._render_budget.audit.numpy()
        _save_state(res, f"handler_{route}", h.state, h.mesh)
        _save_stats(res, f"handler_{route}", h.stats)
