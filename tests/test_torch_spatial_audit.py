"""The port's SpatialHandler on one rank, where it departs from the JAX
package's on purpose (both departures repair faults the JAX package keeps):

- **The draw is audited.** ``SpatialHandler.draw`` renders with the inner
  handler's render settings (post mode, peak-density hint, budget boost)
  and runs ``SimulationHandler.draw``'s render-budget audit and boost: a
  packed clump that overflows the automatic per-bin budget draws, after a
  logged boost, a frame that drops nothing. Its frame against the dense
  handlers' ``draw`` of the same particles, the port's and the JAX
  package's: rtol 1e-3, atol 2e-4, the spatial draw's tolerance
  (``tests/test_spatial.py:230``), because the spatial frame combines the
  ranks' canvases through ``1 - exp(sum log(1 - a))``, which rounds
  otherwise than the dense splat's product even on one rank. The boosts
  and the audits are equal. The draw run through the graphs' plumbing
  (``SpatialGraphs(capture=False)``) equals the eager one bit for bit. On a
  heap whose peak bin stays past the budget's cap of 256 the spatial draw
  re-renders once and skips the attempts whose options no longer change,
  the next draw skips all three, with the JAX handler's boost and an
  unchanged frame.
- **In transit means outside the rank's window.** A particle over its
  cell's budget integrates without collision, but it is in the window, so
  it is no longer counted in transit: on one rank, with cells over K, the
  count is 0 and no host redistribute runs. On the step's own inputs the
  port's column equals the numpy count of active particles outside the
  window, and the JAX package's that count plus the numpy count of the
  in-window particles past rank K of their cell (``torch_ranks.
  window_masks``), exactly: the eager step, the resident steps (eager and
  through the graphs' plumbing) and the handler.
- Per-particle colour is refused at the spatial draw.

Scenes: ``torch_ranks.CLUMP`` (300 white, 40 yolk particles packed into
cells of K = 4 on a G = 32 grid, and a small batch away from them), the
same clump of 900 white particles (``HEAP``) and the spread scene of
``tests/test_torch_spatial.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
import torch_ranks
from egg_fluid_simulation_tpu.parallel import spatial as JS
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch.interop import state_from_numpy
from egg_fluid_simulation_tpu_torch.ops import render as trender
from egg_fluid_simulation_tpu_torch.parallel import spatial as TS
from egg_fluid_simulation_tpu_torch.parallel.spatial_graph import SpatialGraphs
from egg_fluid_simulation_tpu_torch.state import StepStats

G, K = 32, 4
OPTS = dict(engine="dense", budget_mode="off", dense_rebin="step",
            dense_grid_dim=G, dense_slots=K)
FRAME_RTOL, FRAME_ATOL = 1e-3, 2e-4
VIEW = torch_ranks.CLUMP_VIEW
SPREAD = [(60.0, 50.0, 40.0, 12.0, None, None, 40, 10),
          (150.0, 90.0, 40.0, 12.0, None, None, 40, 10)]
SPREAD_VIEW = (0.0, 0.0, 256, 192)
N_CLUMP = 353        # the clump's particles, both populations
# the clump with 900 white particles: a peak bin past the budget's cap
HEAP = ((128.0, 128.0, 12.0, 4.0, None, None, 900, 40),) + torch_ranks.CLUMP[1:]
# resident steps that never rebin: the drift count cannot pass every
# live particle, so the enter's binning of the call's input is the last
NO_REBIN = 1.0
N_STEPS = 2          # resident steps a call


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    monkeypatch.setattr(jsweep, "FORCE_INTERPRET", False)


def _port(adds=torch_ranks.CLUMP, **kw):
    h = T.SimulationHandler(T.default_white_config(), T.default_yolk_config(),
                            capacity=1024, max_batches=8,
                            options=T.SolverOptions(**OPTS), device="cpu",
                            **kw)
    for args in adds:
        h.add(*args)
    return h


def _jax(adds=torch_ranks.CLUMP):
    h = J.SimulationHandler(J.default_white_config(), J.default_yolk_config(),
                            capacity=1024, max_batches=8,
                            options=J.SolverOptions(use_pallas=False, **OPTS))
    for args in adds:
        h.add(*args)
    return h


def _take_jax_state(hj, ht):
    """``ht`` (the port's) takes the JAX handler's state and stats."""
    ht._state = state_from_numpy(host_view(hj.state))
    ht._stats = StepStats(**{
        f.name: torch.from_numpy(np.array(getattr(hj.stats, f.name)))
        for f in dataclasses.fields(StepStats)})
    return ht


def _cells():
    return [torch_ranks.cell_size_f32(c) for c in (T.default_white_config(),
                                                   T.default_yolk_config())]


def _counts(state, after=None):
    """``torch_ranks.layout_counts`` of a 1 x 1 spatial-layout state."""
    return torch_ranks.layout_counts(
        state.pos.numpy(), state.batch_slot.numpy(), _cells(), G, K, 1, 1,
        after_slot=None if after is None else after.batch_slot.numpy())


# ------------------------------------------------------------------ draw --

@pytest.fixture(scope="module")
def clump_draws():
    """The clump drawn by the JAX handler, the port's dense handler and
    the port's spatial handler (eagerly and through the graphs' plumbing),
    all from the JAX handler's state; each handler's first draw."""
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    saved = jsweep.FORCE_INTERPRET
    jsweep.FORCE_INTERPRET = False
    try:
        hj = _jax()
        frame_j = np.asarray(hj.draw(viewport=VIEW))
    finally:
        jsweep.FORCE_INTERPRET = saved
    hd = _take_jax_state(hj, _port())
    out = dict(jax=(frame_j, list(hj._render_k_boost),
                    list(hj._render_peak_density)),
               dense=(hd.draw(viewport=VIEW).numpy(),
                      hd._render_budget.k_boost,
                      hd._render_budget.peak_density,
                      hd._render_budget.audit.numpy()))
    for route in ("eager", "graphs"):
        hs = T.SpatialHandler.from_handler(_take_jax_state(hj, _port()))
        if route == "graphs":
            hs._spatial = SpatialGraphs(hs.mesh, hs.layout, hs._options,
                                        capture=False)
        reads = trender.host_reads
        frame = hs.draw(viewport=VIEW).numpy()
        out[route] = (frame, hs._inner._render_budget.k_boost,
                      hs._inner._render_budget.peak_density,
                      hs._inner._render_budget.audit.numpy(),
                      trender.host_reads - reads, hs)
    return out


def test_spatial_draw_boosts_until_nothing_drops(clump_draws, capfd):
    frame, boost, _, audit, reads, hs = clump_draws["eager"]
    assert boost[0] > 1.0                     # the white budget was boosted
    assert audit[:, 0].tolist() == [0, 0]     # the frame drops nothing
    assert audit[0, 1] > 8                    # a bin past the default budget
    assert reads == 4       # stats + audit, twice: the frame drawn again
    assert np.isfinite(frame).all() and frame[..., 3].max() > 0.5
    # the boost persists: the next draw needs no boost
    capfd.readouterr()
    reads = trender.host_reads
    again = hs.draw(viewport=VIEW).numpy()
    assert trender.host_reads - reads == 2
    assert hs._inner._render_budget.k_boost == boost
    assert "render budget overflow" not in capfd.readouterr().out
    np.testing.assert_array_equal(again, frame)


def test_spatial_draw_logs_the_boost(capfd):
    hs = T.SpatialHandler.from_handler(_port())
    hs.draw(viewport=VIEW)
    out = capfd.readouterr()
    assert "render budget overflow" in out.out + out.err


def test_spatial_draw_matches_dense_draws(clump_draws):
    """The same boost and peak-density hint as the dense handlers' (the JAX
    handler keeps no audit), the same audit as the port's, and the frame."""
    frame, boost, peak, audit, _, _ = clump_draws["eager"]
    np.testing.assert_array_equal(audit, clump_draws["dense"][3])
    for name in ("dense", "jax"):
        want, want_boost, want_peak = clump_draws[name][:3]
        assert boost == want_boost, name
        assert peak == want_peak, name
        np.testing.assert_allclose(frame, want, rtol=FRAME_RTOL,
                                   atol=FRAME_ATOL, err_msg=name)


def test_spatial_draw_graph_plumbing_matches_eager(clump_draws):
    eager, graphs = clump_draws["eager"], clump_draws["graphs"]
    np.testing.assert_array_equal(graphs[0], eager[0])
    assert graphs[1:3] == eager[1:3]
    np.testing.assert_array_equal(graphs[3], eager[3])
    assert graphs[4] == eager[4] == 4
    assert graphs[5]._spatial.captures == 2   # the boost is a new draw key


@pytest.fixture(scope="module")
def heap_jax():
    """The heap drawn by the JAX handler (four renders): the frame, the
    boost and the hint."""
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    saved = jsweep.FORCE_INTERPRET
    jsweep.FORCE_INTERPRET = False
    try:
        hj = _jax(HEAP)
        frame = np.asarray(hj.draw(viewport=VIEW))
    finally:
        jsweep.FORCE_INTERPRET = saved
    return hj, frame


@pytest.mark.parametrize("route", ["eager", "graphs"])
def test_spatial_draw_skips_rerenders_on_a_capped_heap(heap_jax, route):
    hj, frame_j = heap_jax
    hs = T.SpatialHandler.from_handler(_take_jax_state(hj, _port(HEAP)))
    if route == "graphs":
        hs._spatial = SpatialGraphs(hs.mesh, hs.layout, hs._options,
                                    capture=False)
    frames = []
    for rerenders in (1, 0):
        trender.host_reads = trender.rerenders = 0
        trender.rerenders_skipped = 0
        frames.append(hs.draw(viewport=VIEW).numpy())
        assert trender.rerenders == rerenders
        assert trender.rerenders_skipped == 3 - rerenders
        assert trender.host_reads == 2 + 2 * rerenders
        assert hs._inner._render_budget.k_boost == hj._render_k_boost
        assert (hs._inner._render_budget.peak_density
                == hj._render_peak_density)
        assert hs._inner._frame_options(hs.stats)[0].tile_capacity == 256
        assert int(hs._inner._render_budget.audit[0, 0]) > 0   # over the cap
    np.testing.assert_array_equal(frames[1], frames[0])
    np.testing.assert_allclose(frames[0], frame_j, rtol=FRAME_RTOL,
                               atol=FRAME_ATOL)
    if route == "graphs":
        assert hs._spatial.captures == 2      # K 256 once, then replays


def test_post_mode_reaches_the_spatial_draw():
    """A handler made with ``render_post_mode="full"``, adopted through
    ``from_handler``, renders its spatial frame in the full mode."""
    full = _port(SPREAD, render_post_mode="full")
    coarse = _port(SPREAD)
    hs = T.SpatialHandler.from_handler(_port(SPREAD, render_post_mode="full"))
    got = hs.draw(viewport=SPREAD_VIEW).numpy()
    want = full.draw(viewport=SPREAD_VIEW).numpy()
    np.testing.assert_allclose(got, want, rtol=FRAME_RTOL, atol=FRAME_ATOL)
    assert np.abs(got - coarse.draw(viewport=SPREAD_VIEW).numpy()).max() > 0.1


def test_peak_density_and_boost_reach_the_spatial_options():
    dense = _port(SPREAD)
    hs = T.SpatialHandler.from_handler(_port(SPREAD))
    plain = hs._inner._frame_options(hs.stats)
    for h in (dense, hs._inner):
        h._render_budget.peak_density = [0.25, None]
        h._render_budget.k_boost = [1.0, 3.0]
    want = dense._frame_options()
    got = hs._inner._frame_options(hs.stats)
    assert got == want
    assert [o.tile_capacity for o in got] != [o.tile_capacity for o in plain]
    hs.draw(viewport=SPREAD_VIEW)
    drawn_opts = next(reversed(hs._draw_cache))[0]
    assert drawn_opts == want


def test_spatial_draw_refuses_particle_colour():
    hs = T.SpatialHandler(T.default_white_config(), T.default_yolk_config(),
                          capacity=1024, max_batches=8,
                          options=T.SolverOptions(**OPTS), device="cpu")
    hs._inner._use_particle_color = True
    hs.add(*SPREAD[0])
    with pytest.raises(ValueError, match="per-particle colour"):
        hs.draw(viewport=SPREAD_VIEW)


# ------------------------------------------------------ in-transit count --

@pytest.fixture(scope="module")
def packed():
    """From the clump's 1 x 1 layout (the JAX handler's state): one step and
    ``N_STEPS`` resident steps that do not rebin, the port's (eager and
    through the graphs' plumbing) and the JAX package's; and the port's
    resident steps that do rebin, with their last binning kept."""
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    saved = jsweep.FORCE_INTERPRET
    jsweep.FORCE_INTERPRET = False
    try:
        hj = _jax()
        hj._flush_targets()
        jcells = [float(c) for c in _cells()]
        lay_j = JS.SpatialLayout(G, K, db=1, dx=1, migrate_cap=64)
        jmesh = JS.make_spatial_mesh(1, 1)
        jst = JS.redistribute(hj.state, jcells, lay_j, jmesh)
        cfg2 = hj._device_cfg2()
        dt, relax = jnp.float32(1 / 60), jnp.float32(1.0)
        jopts = J.SolverOptions(use_pallas=False, rebin_tolerance=NO_REBIN,
                                **OPTS)
        jax_out = {
            "step": np.asarray(JS.spatial_step(jmesh, lay_j, jopts)(
                jst, cfg2, dt, relax)[2]),
            "steps": np.asarray(JS.spatial_multi_step(jmesh, lay_j, jopts)(
                jst, cfg2, dt, relax, jnp.int32(N_STEPS))[2])}
    finally:
        jsweep.FORCE_INTERPRET = saved
    ht = _port()
    mesh = TS.make_spatial_mesh(1, 1, "cpu")
    lay = TS.SpatialLayout(G, K, db=1, dx=1, migrate_cap=64)
    st0 = TS.redistribute(state_from_numpy(host_view(hj.state)), _cells(),
                          lay, mesh)
    cfg2 = ht._device_cfg2()
    dt, relax = torch.tensor(1 / 60), torch.tensor(1.0)
    calm = T.SolverOptions(rebin_tolerance=NO_REBIN, **OPTS)
    port = {}
    graphs = SpatialGraphs(mesh, lay, calm, capture=False)
    port["step", "eager"] = TS.spatial_step(mesh, lay, calm)(
        st0, cfg2, dt, relax)[2].numpy()
    port["step", "graphs"] = graphs.step(st0, cfg2, dt, relax)[2].numpy()
    TS.rebins[:] = [0, 0]
    out = TS.spatial_multi_step(mesh, lay, calm)(st0, cfg2, dt, relax,
                                                 N_STEPS)
    port["steps", "eager"] = out[2].numpy()
    assert TS.rebins == [0, 0]
    out = graphs.steps(st0, cfg2, dt, relax, N_STEPS)
    port["steps", "graphs"] = out[2].numpy()
    assert out[4].tolist() == [0, 0]
    # rebinning resident steps: the count is taken over the last binning
    rebinning = {}
    for route in ("eager", "graphs"):
        opts = T.SolverOptions(**OPTS)
        with torch_ranks.LastBinning() as binning:
            if route == "eager":
                TS.rebins[:] = [0, 0]
                st, _, info, _ = TS.spatial_multi_step(mesh, lay, opts)(
                    st0, cfg2, dt, relax, N_STEPS)
                rebins = list(TS.rebins)
            else:
                st, _, info, _, taken = SpatialGraphs(
                    mesh, lay, opts, capture=False).steps(
                    st0, cfg2, dt, relax, N_STEPS)
                rebins = taken.tolist()
        res = {}
        binning.save(res, "last", mesh)
        rebinning[route] = (info.numpy(), rebins, torch_ranks.layout_counts(
            res["last_bin_pos"], res["last_bin_batch_slot"], _cells(), G, K,
            1, 1, after_slot=st.batch_slot.numpy()))
    return dict(jax=jax_out, port=port, counts=_counts(st0),
                rebinning=rebinning)


def test_packed_scene_has_cells_over_budget(packed):
    counts = packed["counts"]
    assert counts[:, 0].tolist() == [0, 0]   # one rank: every cell's window
    # past the handler's 5% rule, which the JAX count sets off
    assert counts[:, 1].sum() > 0.05 * N_CLUMP


@pytest.mark.parametrize("kind", ["step", "steps"])
@pytest.mark.parametrize("route", ["eager", "graphs"])
def test_transit_count_identities(packed, kind, route):
    """The port's column = the numpy out-of-window count; JAX's = that + the
    numpy over-budget count; the dropped column equal (on the call's
    input: the resident steps here do not rebin)."""
    got, want = packed["port"][kind, route], packed["jax"][kind]
    counts = packed["counts"]
    np.testing.assert_array_equal(got[:, 1], counts[:, 0])
    np.testing.assert_array_equal(want[:, 1], counts[:, 0] + counts[:, 1])
    np.testing.assert_array_equal(got[:, 0], want[:, 0])


@pytest.mark.parametrize("route", ["eager", "graphs"])
def test_transit_count_over_the_last_binning(packed, route):
    """Resident steps that rebin: the count equals the numpy out-of-window
    count over the last binning; the over-budget count there is what the
    JAX package's count adds (no particle arrives on one rank)."""
    info, rebins, counts = packed["rebinning"][route]
    assert sum(rebins) > 0
    np.testing.assert_array_equal(info[:, 1], counts[:, 0])
    assert counts[:, 2].tolist() == [0, 0]
    assert info[:, 0].tolist() == [0, 0]


@pytest.mark.parametrize("route", ["eager", "graphs"])
def test_packed_handler_does_not_redistribute(route):
    hs = T.SpatialHandler.from_handler(_port())
    if route == "graphs":
        hs._spatial = SpatialGraphs(hs.mesh, hs.layout, hs._options,
                                    capture=False)
    hs._ensure_spatial()
    assert _counts(hs.state)[:, 1].sum() > 0.05 * N_CLUMP
    # one step, then resident steps (update(n / 60) and step_once take
    # the same two routes)
    for call in (lambda: hs.update(1 / 60), lambda: hs.run_steps(N_STEPS)):
        call()
        assert hs.last_migration_info[:, 1].tolist() == [0, 0]
        assert hs._redistribute_count == 0
