"""The 2D spatial decomposition of the PyTorch port against the JAX
package's (``parallel/spatial.py``), on the CPU.

JAX runs on its 8-device CPU mesh in the test process; the port runs in 4
gloo ranks (``tests/torch_ranks.py``, one spawn for the module), both from
the same JAX handler state. The scene is the JAX tests' fast one (G = 32,
K = 4, two spread batches: no cell over K, so no pair is dropped).

- ``redistribute``: the whole layout bit for bit (1 x 1, 2 x 2 and 4 x 2
  layouts; the host layout at 4 x 2 in the test process), the ownership
  invariant, and after three steps the per-rank live counts of JAX's.
- ``_bin_local`` (slots, planes, aux planes, in-window flags) and one
  ``_exchange_halos`` of planes and aux: bit for bit; the in-transit mask
  against its numpy definition.
- ``_sweep_local``'s plain version (kernel D's) on the very windows JAX's
  ``_bin_local`` + ``_exchange_halos`` build (positions drifted up to 0.4
  cell after binning, so the fresh-cell mask has work), 1 x 1, 2 x 2 and
  4 x 2, window 1 and window 3 with the fresh mask, against JAX's
  ``_sweep_local`` (the golden model) and, at window 1, interpret-mode
  ``_sweep_pallas``: rtol 1e-4, atol 1e-5.
- ``spatial_step`` on 2 x 2 against JAX's on the same mesh, three steps:
  positions and previous positions 1e-3 px, velocities 0.2 px/s, the
  layout (live slots) and the migration-dropped counts equal; the
  in-transit counts held to their definitions (:func:`_hold_info`);
  against the port's
  own single-device dense step: the point-set tolerances of
  ``tests/test_spatial.py`` (1e-3 px, centroid rtol 1e-4 / atol 1e-3,
  batch sums rtol 1e-4 / atol 1e-2, batch counts equal).
- Migration: a particle teleported a band down reaches its new owner's
  slice in one hop, as in JAX; no particle is lost over the steps.
- Collective bytes of one 2 x 2 step, counted at the call sites: equal per
  category to ``SpatialLayout.collective_bytes_per_step``, which is twice
  the JAX package's one-population model.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ranks
from egg_fluid_simulation_tpu import (SimulationHandler,
                                      SolverOptions as JOptions,
                                      default_white_config,
                                      default_yolk_config)
from egg_fluid_simulation_tpu.parallel import spatial as JS
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch.interop import state_from_numpy
from egg_fluid_simulation_tpu_torch.ops import solver as tsolver
from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as tsweep
from egg_fluid_simulation_tpu_torch.ops.solver import SolverOptions
from egg_fluid_simulation_tpu_torch.parallel import spatial as TS

G, K = 32, 4
OPTS = dict(engine="dense", budget_mode="off", dense_rebin="step",
            dense_grid_dim=G, dense_slots=K)
J_OPTIONS = JOptions(use_pallas=False, **OPTS)
POS_TOL, VEL_TOL = 1e-3, 0.2
RTOL, ATOL = 1e-4, 1e-5
FIELDS = ("pos", "prev", "vel", "last_pos", "radius", "mass_t", "inv_mass",
          "batch_slot", "color")
CELLS = [torch_ranks.cell_size_f32(c) for c in (default_white_config(),
                                                default_yolk_config())]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    # the JAX sweeps on their golden model whatever an earlier file set
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    monkeypatch.setattr(jsweep, "FORCE_INTERPRET", False)


def _jax_handler():
    """The JAX tests' fast spread scene (``tests/test_spatial.py``)."""
    h = SimulationHandler(default_white_config(), default_yolk_config(),
                          capacity=1024, max_batches=8, options=J_OPTIONS)
    a = h.add(60.0, 50.0, 40.0, 12.0, None, None, 40, 10)
    b = h.add(150.0, 90.0, 40.0, 12.0, None, None, 40, 10)
    h.set_target_position(a, 120.0, 70.0)
    h.set_target_position(b, 80.0, 60.0)
    h._flush_targets()
    return h


def _cell_sizes(h):
    return [max(1.0, cfg["max_radius"]
                * max(cfg["collision_overlap_factor"],
                      cfg["cohesion_interaction_distance_factor"]))
            for cfg in (h._white_config, h._yolk_config)]


def _inputs(h, db, dx, migrate_cap=64):
    d = {f"state_{k}": v for k, v in host_view(h.state).items()}
    d.update(white_config=json.dumps(h._white_config),
             yolk_config=json.dumps(h._yolk_config),
             cells=np.asarray(_cell_sizes(h), np.float32), grid_dim=G,
             slots=K, db=db, dx=dx, migrate_cap=migrate_cap)
    return d


def _np(x):
    return np.asarray(jax.device_get(x))


def _hold_info(got, want, pos, batch_slot, db, dx, after_slot=None):
    """The port's (dropped, in transit) counts ``got`` against the JAX
    package's ``want`` of the same call, whose (last) binning took ``pos``
    and ``batch_slot`` (whole spatial-layout arrays). The dropped columns
    are equal. In transit the port counts the active particles outside
    their rank's window; the JAX package counts every slot its binning
    left unplaced that is active at the end: those, the particles past rank
    K of their cell, and, after a resident call's final migration, the
    arrivals in slots the binning found empty. Both columns are held to
    the numpy counts of those sets (``torch_ranks.layout_counts``),
    exactly; ``after_slot``: the batch slots after the call."""
    counts = torch_ranks.layout_counts(pos, batch_slot, CELLS, G, K, db, dx,
                                       after_slot=after_slot)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_array_equal(got[:, 1], counts[:, 0])
    np.testing.assert_array_equal(want[:, 1], counts.sum(axis=1))


def _jax_pop_env(st, cfg2, i, lay):
    sub_dt = jnp.float32(1 / 60) / J_OPTIONS.n_substeps
    cfg = jax.tree.map(lambda a: a[i], cfg2)
    follow_radius = jnp.sqrt(jnp.maximum(st.batch_radius, 0.0))
    return JS._pop_env(cfg, st.mass_t[i], st.batch_slot[i] >= 0,
                       st.batch_slot[i], st.batch_target, follow_radius[i],
                       sub_dt, J_OPTIONS, lay)


def _jax_bin(st, cfg2, lay):
    """JAX ``_bin_local`` of every device's slice (eager, outside
    shard_map): per population ``(planes, aux, slot, in_grid)``, stacked
    over devices in mesh order."""
    n_dev = lay.db * lay.dx
    c_loc = st.capacity // n_dev
    out = []
    for i in range(2):
        env = _jax_pop_env(st, cfg2, i, lay)
        per = []
        for d in range(n_dev):
            sl = slice(d * c_loc, (d + 1) * c_loc)
            pos, vel = st.pos[i][sl], st.vel[i][sl]
            aux_cols = jnp.stack([pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1],
                                  env["tx"][sl], env["ty"][sl],
                                  env["td"][sl]], axis=1)
            per.append(JS._bin_local(
                pos, env["inv_mass"][sl], env["radius"][sl],
                st.batch_slot[i][sl], st.batch_slot[i][sl] >= 0,
                env["cell_size"], d // lay.dx, d % lay.dx, lay, aux_cols))
        out.append(tuple(np.stack([_np(p[j]) for p in per]) for j in range(4)))
    return out


def _jax_exchange(stacked, lay, mesh):
    """JAX ``_exchange_halos`` of per-device windows stacked (D, F, R, W),
    through ``shard_map`` on the mesh."""
    from jax.sharding import PartitionSpec as P
    from egg_fluid_simulation_tpu.parallel._compat import shard_map_compat
    arr = jnp.asarray(stacked).reshape((lay.db, lay.dx) + stacked.shape[1:])
    spec = P(JS.BANDS, JS.BLOCKS)

    def body(t):
        return JS._exchange_halos(t[0, 0], lay)[None, None]

    fn = jax.jit(shard_map_compat(body, mesh=mesh, in_specs=(spec,),
                                  out_specs=spec))
    return _np(fn(arr)).reshape(stacked.shape)


def _step_state(res, prefix):
    return {f: res[f"{prefix}_{f}"] for f in FIELDS}


def _jax_steps(h, lay, mesh, n=3):
    step = JS.spatial_step(mesh, lay, J_OPTIONS)
    st = JS.redistribute(h.state, _cell_sizes(h), lay, mesh)
    cfg2 = h._device_cfg2()
    out = []
    for _ in range(n):
        st, stats, info = step(st, cfg2, jnp.float32(1 / 60),
                               jnp.float32(1.0))
        out.append((host_view(st), stats, _np(info)))
    return step, out


@pytest.fixture(scope="module")
def run22(tmp_path_factory):
    """The port's rank set (2 x 2) and JAX's side of the same scenarios."""
    h = _jax_handler()
    ranks = torch_ranks.start("spatial_program", _inputs(h, 2, 2),
                              tmp_path_factory.mktemp("spatial"), 4)
    lay = JS.SpatialLayout(G, K, db=2, dx=2, migrate_cap=64)
    mesh = JS.make_spatial_mesh(2, 2)
    cfg2 = h._device_cfg2()
    st0 = JS.redistribute(h.state, _cell_sizes(h), lay, mesh)
    step, steps = _jax_steps(h, lay, mesh)
    # the teleport scenario of tests/test_spatial.py (one band down)
    pos = np.array(st0.pos)
    j = int(np.nonzero(np.asarray(st0.batch_slot[0]) >= 0)[0][0])
    pos[0, j, 1] += lay.gb * _cell_sizes(h)[0]
    st_t = st0.replace(pos=jnp.asarray(pos), prev=jnp.asarray(pos).copy(),
                       vel=st0.vel * 0.0)
    teleport_in = (np.array(st_t.pos), np.array(st_t.batch_slot))
    st_t, _, info_t = step(st_t, cfg2, jnp.float32(1 / 60), jnp.float32(1.0))
    last = JS.redistribute(
        st0.replace(**{f: jnp.asarray(steps[-1][0][f]) for f in FIELDS}),
        _cell_sizes(h), lay, mesh, from_spatial=True)
    return dict(h=h, lay=lay, mesh=mesh, st0=st0, steps=steps,
                teleport=(j, host_view(st_t), _np(info_t), teleport_in),
                redist_spatial=host_view(last), bins=_jax_bin(st0, cfg2, lay),
                port=ranks.result())


# ------------------------------------------------------------ redistribute --

def _check_invariant(d, cells, lay):
    c_loc = d["pos"].shape[1] // (lay.db * lay.dx)
    for i in range(2):
        live = d["batch_slot"][i] >= 0
        band, block = (x.numpy() for x in TS.owner_of(
            torch.from_numpy(d["pos"][i]), torch.tensor(cells[i]), lay))
        dev = band * lay.dx + block
        idx = np.arange(live.size)
        assert (dev[live] == idx[live] // c_loc).all()


def test_redistribute_2x2_bit_identical(run22):
    want = host_view(run22["st0"])
    for f in FIELDS:
        np.testing.assert_array_equal(run22["port"][f"redist_{f}"], want[f],
                                      err_msg=f)
    _check_invariant(_step_state(run22["port"], "redist"),
                     _cell_sizes(run22["h"]), run22["lay"])


@pytest.mark.parametrize("db,dx", [(1, 1), (4, 2)])
def test_host_layout_bit_identical(db, dx):
    """The host layout every rank computes, at layouts the rank set does
    not run (4 x 2: the JAX test's), against JAX's ``redistribute``."""
    h = _jax_handler()
    cells = _cell_sizes(h)
    lay_j = JS.SpatialLayout(G, K, db=db, dx=dx, migrate_cap=32)
    want = host_view(JS.redistribute(h.state, cells, lay_j,
                                     JS.make_spatial_mesh(db, dx)))
    lay = TS.SpatialLayout(G, K, db=db, dx=dx, migrate_cap=32)
    got = TS._host_layout(state_from_numpy(host_view(h.state)), cells, lay,
                          from_spatial=False)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    _check_invariant(got, cells, lay)
    assert [(got["batch_slot"][i] >= 0).sum() for i in range(2)] == \
        [int(c) for c in host_view(h.state)["count"]]


def test_redistribute_after_steps_counts_match_jax(run22):
    got = _step_state(run22["port"], "redist_spatial")
    want = run22["redist_spatial"]
    lay = run22["lay"]
    _check_invariant(got, _cell_sizes(run22["h"]), lay)
    c_loc = got["pos"].shape[1] // 4
    for i in range(2):
        per = [(got["batch_slot"][i, r * c_loc:(r + 1) * c_loc] >= 0).sum()
               for r in range(4)]
        per_j = [(want["batch_slot"][i, r * c_loc:(r + 1) * c_loc] >= 0).sum()
                 for r in range(4)]
        assert per == per_j


# -------------------------------------------------- binning and the halos --

def test_bin_local_bit_identical(run22):
    port = run22["port"]
    for i in range(2):
        planes, aux, slot, in_grid = run22["bins"][i]
        np.testing.assert_array_equal(port[f"bin_planes_{i}"], planes)
        np.testing.assert_array_equal(port[f"bin_aux_{i}"], aux)
        np.testing.assert_array_equal(port[f"bin_slot_{i}"], slot)
        np.testing.assert_array_equal(port[f"bin_in_grid_{i}"] != 0, in_grid)
        # FIELD_OCC carries the true cell occupancy (counts, not 0/1)
        assert planes[:, 7].max() >= 1.0


def test_bin_local_transit_mask(run22):
    """``_bin_local``'s in-transit mask is the numpy mask of the active
    particles outside the rank's window, and JAX's unplaced slots (not
    ``in_grid``) are exactly those, the particles past rank K of their cell
    and the empty slots (``torch_ranks.window_masks``)."""
    port = run22["port"]
    pos, slot = port["redist_pos"], port["redist_batch_slot"]
    c_loc = pos.shape[1] // 4
    for i in range(2):
        in_grid = run22["bins"][i][3]
        for r in range(4):
            sl = slice(r * c_loc, (r + 1) * c_loc)
            active = slot[i][sl] >= 0
            transit, over = torch_ranks.window_masks(
                pos[i][sl], active, CELLS[i], G, K, 2, 2, r)
            np.testing.assert_array_equal(port[f"bin_transit_{i}"][r] != 0,
                                          transit)
            np.testing.assert_array_equal(~in_grid[r],
                                          transit | over | ~active)


def test_exchange_halos_bit_identical(run22):
    port, lay, mesh = run22["port"], run22["lay"], run22["mesh"]
    for i in range(2):
        planes, aux = run22["bins"][i][:2]
        np.testing.assert_array_equal(port[f"xch_planes_{i}"],
                                      _jax_exchange(planes, lay, mesh))
        np.testing.assert_array_equal(port[f"xch_aux_{i}"],
                                      _jax_exchange(aux, lay, mesh))


@pytest.fixture(scope="module")
def windows():
    """Per layout: JAX's exchanged windows of the white population, drifted
    after binning, and the sweep params JAX's ``_pop_env`` sets."""
    h = _jax_handler()
    cfg2 = h._device_cfg2()
    out = {}
    for db, dx in ((1, 1), (2, 2), (4, 2)):
        lay = JS.SpatialLayout(G, K, db=db, dx=dx, migrate_cap=32)
        mesh = JS.make_spatial_mesh(db, dx)
        st = JS.redistribute(h.state, _cell_sizes(h), lay, mesh)
        planes = _jax_bin(st, cfg2, lay)[0][0].copy()
        occ = planes[:, 7] > 0
        idx = planes[:, 6]
        planes[:, 0] += np.where(occ, 3.2 * np.sin(idx * 0.7), 0.0
                                 ).astype(np.float32)
        planes[:, 1] += np.where(occ, 3.2 * np.cos(idx * 1.3), 0.0
                                 ).astype(np.float32)
        params = _jax_pop_env(st, cfg2, 0, lay)["params"]
        out[(db, dx)] = (lay, _jax_exchange(planes, lay, mesh), params)
    return out


@pytest.mark.parametrize("window", [1, 3])
@pytest.mark.parametrize("db,dx", [(1, 1), (2, 2), (4, 2)])
def test_sweep_local_plain_matches_jax(windows, db, dx, window):
    lay, stacked, params = windows[(db, dx)]
    packed = torch.from_numpy(_np(params.pack()))
    assert float(packed[6]) == G          # the global fresh-cell modulus
    largest = 0.0
    for d in sorted({0, db * dx - 1}):    # the first and the last window
        got = tsweep.sweep_planes_plain(
            torch.from_numpy(stacked[d]), packed, K, cohesion=True,
            ordered_budget=False, window=window, fresh_mask=window == 3)
        want = _np(JS._sweep_local(jnp.asarray(stacked[d]), params, lay, True,
                                   False, wide=window == 3))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        largest = max(largest, float(np.abs(want).max()))
    assert largest > 0.1                  # pairs fire


@pytest.mark.parametrize("db,dx", [(1, 1), (2, 2), (4, 2)])
def test_sweep_local_plain_matches_interpret_kernel(windows, db, dx,
                                                    monkeypatch):
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    monkeypatch.setattr(jsweep, "FORCE_INTERPRET", True)
    lay, stacked, params = windows[(db, dx)]
    packed = torch.from_numpy(_np(params.pack()))
    d = db * dx - 1
    got = tsweep.sweep_planes_plain(torch.from_numpy(stacked[d]), packed, K,
                                    cohesion=True, ordered_budget=False)
    want = _np(JS._sweep_local(jnp.asarray(stacked[d]), params, lay, True,
                               True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------- steps --

def test_spatial_step_2x2_matches_jax(run22):
    port = run22["port"]
    for s, (want, stats, info) in enumerate(run22["steps"]):
        got = _step_state(port, f"step{s}")
        np.testing.assert_array_equal(got["batch_slot"], want["batch_slot"])
        live = want["batch_slot"] >= 0
        for f, tol in (("pos", POS_TOL), ("prev", POS_TOL),
                       ("last_pos", POS_TOL), ("vel", VEL_TOL)):
            np.testing.assert_allclose(got[f][live], want[f][live], rtol=0,
                                       atol=tol, err_msg=f"step {s} {f}")
        before = "redist" if s == 0 else f"step{s - 1}"
        _hold_info(port[f"step{s}_info"], info, port[f"{before}_pos"],
                   port[f"{before}_batch_slot"], 2, 2)
        np.testing.assert_allclose(port[f"step{s}_centroid"],
                                   _np(stats.centroid), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(port[f"step{s}_batch_count"],
                                   _np(stats.batch_count))
        np.testing.assert_allclose(port[f"step{s}_aabb_min"],
                                   _np(stats.aabb_min), atol=1e-3)
        np.testing.assert_allclose(port[f"step{s}_max_velocity"],
                                   _np(stats.max_velocity), rtol=1e-3,
                                   atol=VEL_TOL)


def test_spatial_step_2x2_matches_port_single_device(run22):
    """Against the port's own dense step (the fused path, budget off): the
    point sets of tests/test_spatial.py:118-124 after three steps."""
    h, port = run22["h"], run22["port"]
    state = state_from_numpy(host_view(h.state))
    from egg_fluid_simulation_tpu_torch.config import (device_config_from_dict,
                                                       stack_device_configs)
    cfg2 = stack_device_configs(device_config_from_dict(h._white_config),
                                device_config_from_dict(h._yolk_config))
    opts = SolverOptions(**OPTS)
    for _ in range(3):
        state, stats = tsolver.step(state, cfg2, torch.tensor(1 / 60),
                                    torch.tensor(1.0), opts)
    act = state.active_mask().numpy()
    got = _step_state(port, "step2")
    for i in range(2):
        ref_pos = state.pos[i].numpy()[act[i]]
        sp_pos = got["pos"][i][got["batch_slot"][i] >= 0]
        assert ref_pos.shape == sp_pos.shape
        d = np.linalg.norm(ref_pos[:, None, :] - sp_pos[None, :, :], axis=-1)
        assert d.min(axis=1).max() < 1e-3, f"pop {i}: unmatched particle"
        np.testing.assert_allclose(port["step2_centroid"][i],
                                   stats.centroid[i].numpy(), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(port["step2_batch_pos_sum"][i],
                                   stats.batch_pos_sum[i].numpy(), rtol=1e-4,
                                   atol=1e-2)
        np.testing.assert_allclose(port["step2_batch_count"][i],
                                   stats.batch_count[i].numpy())


def test_migration_one_hop_and_no_particle_lost(run22):
    port, lay = run22["port"], run22["lay"]
    j, want, info_j, (pos_in, slot_in) = run22["teleport"]
    assert int(port["teleport_j"]) == j
    got = _step_state(port, "teleport")
    _hold_info(port["teleport_info"], info_j, pos_in, slot_in, 2, 2)
    assert port["teleport_info"][:, 1].sum() == 1   # the teleported one
    assert port["teleport_info"][:, 0].sum() == 0          # no drops
    np.testing.assert_array_equal(got["batch_slot"], want["batch_slot"])
    live = want["batch_slot"] >= 0
    np.testing.assert_allclose(got["pos"][live], want["pos"][live], rtol=0,
                               atol=POS_TOL)
    redist = _step_state(port, "redist")
    c_loc = got["pos"].shape[1] // 4
    cell = _cell_sizes(run22["h"])[0]
    live2 = got["batch_slot"][0] >= 0
    band2, _ = (x.numpy() for x in TS.owner_of(
        torch.from_numpy(got["pos"][0]), torch.tensor(cell), lay))
    have_b = (np.arange(live2.size)[live2] // c_loc) // lay.dx
    hop = np.minimum(np.mod(band2[live2] - have_b, lay.db),
                     np.mod(have_b - band2[live2], lay.db))
    assert hop.max() <= 1
    # the teleported particle (the live one nearest its new place) now
    # lives in the slice of the band below
    target = redist["pos"][0][j] + np.array([0.0, lay.gb * cell], np.float32)
    near = np.where(live2, np.linalg.norm(got["pos"][0] - target, axis=1),
                    np.inf)
    k = int(np.argmin(near))
    assert near[k] < cell
    assert (k // c_loc) // lay.dx == ((j // c_loc) // lay.dx + 1) % lay.db
    for i in range(2):
        n0 = (redist["batch_slot"][i] >= 0).sum()
        assert (got["batch_slot"][i] >= 0).sum() == n0
        for s in range(3):
            assert (port[f"step{s}_batch_slot"][i] >= 0).sum() == n0


def test_collective_bytes_match_model(run22):
    port = run22["port"]
    lay = TS.SpatialLayout(G, K, db=2, dx=2, migrate_cap=64)
    model = lay.collective_bytes_per_step(SolverOptions(**OPTS))
    passes = J_OPTIONS.n_substeps * J_OPTIONS.n_collision_steps
    assert int(port["bytes_full_halo_exchange"]) == model["full_halo_exchange"]
    assert int(port["bytes_xy_refresh_per_pass"]) == \
        passes * model["xy_refresh_per_pass"]
    assert int(port["bytes_migration"]) == model["migration"]
    counted = (int(port["bytes_full_halo_exchange"])
               + int(port["bytes_xy_refresh_per_pass"])
               + int(port["bytes_migration"]))
    assert counted == model["total_per_step"]
    # the reductions (gate, statistics) are counted beside the model
    assert int(port["bytes_total"]) == counted + int(port["bytes_reductions"])
    # the JAX package's model counts one population
    want = run22["lay"].collective_bytes_per_step(J_OPTIONS)
    for k in model:
        assert model[k] == 2 * want[k], k


def test_spatial_shards_roundtrip(run22):
    """A JAX spatial-layout state becomes the port's per-rank states (rank
    ``b * Dx + x`` holds slice ``b * Dx + x``) and back, bit for bit."""
    from egg_fluid_simulation_tpu_torch.interop import (
        spatial_shards_from_numpy, spatial_shards_to_numpy)
    want = host_view(run22["st0"])
    shards = spatial_shards_from_numpy(want, 4)
    c_loc = want["pos"].shape[1] // 4
    for r, sh in enumerate(shards):
        assert sh.capacity == c_loc
        np.testing.assert_array_equal(sh.pos.numpy(),
                                      want["pos"][:, r * c_loc:(r + 1) * c_loc])
        np.testing.assert_array_equal(sh.batch_target.numpy(),
                                      want["batch_target"])
    back = spatial_shards_to_numpy(shards)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
        assert back[k].dtype == want[k].dtype, k
