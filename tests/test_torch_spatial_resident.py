"""Resident steps, the sharded draw and the 1 x 1 mesh of the port's 2D
spatial layer against the JAX package's, on the CPU (the scene and the rank
set as in ``tests/test_torch_spatial.py``).

- ``spatial_step`` on a 1 x 1 mesh (a one-rank gloo group in the test
  process: every halo a copy, no collective) against JAX's 1 x 1 step,
  three steps: positions and previous positions 1e-3 px, velocities 0.2
  px/s, the layout and the migration-dropped counts equal, the in-transit
  counts held to their definitions (``test_torch_spatial._hold_info``).
- ``spatial_multi_step`` (5 resident steps, one call) on 2 x 2 against
  JAX's: the whole-step tolerances above, the layout equal, the counts as
  above (the in-transit ones over each rank's last binning);
  against the port's own loop of five ``spatial_step``: the envelope of
  ``tests/test_spatial.py::test_spatial_multi_step_matches_stepwise``
  (centroids within 1 px, mean spread within 8%, centroid statistics rtol
  1e-2 / atol 1 px); a second call continues the episode state. Host reads
  of the rebin decision: one per population and step.
- ``spatial_draw`` on 2 x 2 (per-rank splats combined by one log-space sum)
  against JAX's ``spatial_draw`` and against the port's single-device frame
  of the same state: rtol 1e-3, atol 2e-4 (``tests/test_spatial.py:230``).
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ranks
from egg_fluid_simulation_tpu.ops import render as jrender
from egg_fluid_simulation_tpu.parallel import spatial as JS
from egg_fluid_simulation_tpu.state import ParticleState as JState
from egg_fluid_simulation_tpu.state import StepStats as JStats
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch.config import (device_config_from_dict,
                                                   stack_device_configs)
from egg_fluid_simulation_tpu_torch.interop import state_from_numpy
from egg_fluid_simulation_tpu_torch.ops import render as trender
from egg_fluid_simulation_tpu_torch.ops import solver as tsolver
from egg_fluid_simulation_tpu_torch.ops.solver import SolverOptions
from egg_fluid_simulation_tpu_torch.parallel import spatial as TS
from test_torch_spatial import (FIELDS, G, J_OPTIONS, K, OPTS, POS_TOL,
                                VEL_TOL, _cell_sizes, _hold_info, _inputs,
                                _jax_handler, _jax_steps, _np, _step_state)

STATS = ("aabb_min", "aabb_max", "centroid", "last_centroid", "max_radius",
         "max_velocity", "batch_pos_sum", "batch_count")


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


def _port_cfg2(h):
    return stack_device_configs(device_config_from_dict(h._white_config),
                                device_config_from_dict(h._yolk_config))


def _assert_steps_match(got, want):
    np.testing.assert_array_equal(got["batch_slot"], want["batch_slot"])
    live = want["batch_slot"] >= 0
    for f, tol in (("pos", POS_TOL), ("prev", POS_TOL), ("last_pos", POS_TOL),
                   ("vel", VEL_TOL)):
        np.testing.assert_allclose(got[f][live], want[f][live], rtol=0,
                                   atol=tol, err_msg=f)


@pytest.fixture(scope="module")
def resident(tmp_path_factory):
    h = _jax_handler()
    # the drawn state: three of the port's own single-device steps
    cfg2 = _port_cfg2(h)
    drawn, dstats = tsolver.multi_step(
        state_from_numpy(host_view(h.state)), cfg2, torch.tensor(1 / 60),
        torch.tensor(1.0), SolverOptions(**OPTS), 3)
    inputs = _inputs(h, 2, 2)
    inputs.update({f"draw_{k}": v.numpy() for k, v in
                   vars(drawn).items()})
    inputs.update({f"draw_stats_{k}": getattr(dstats, k).numpy()
                   for k in STATS})
    ranks = torch_ranks.start("resident_program", inputs,
                              tmp_path_factory.mktemp("resident"), 4)

    lay = JS.SpatialLayout(G, K, db=2, dx=2, migrate_cap=64)
    mesh = JS.make_spatial_mesh(2, 2)
    st0 = JS.redistribute(h.state, _cell_sizes(h), lay, mesh)
    jcfg2 = h._device_cfg2()
    multi = JS.spatial_multi_step(mesh, lay, J_OPTIONS)
    st_m, stats_m, info_m, ws = multi(st0, jcfg2, jnp.float32(1 / 60),
                                      jnp.float32(1.0), jnp.int32(5))
    st_2 = multi(st0, jcfg2, jnp.float32(1 / 60), jnp.float32(1.0),
                 jnp.int32(2), wide_state=ws)[0]

    jdrawn = JState(**{k: jnp.asarray(v.numpy()) for k, v in
                       vars(drawn).items()})
    jstats = JStats(**{k: jnp.asarray(getattr(dstats, k).numpy())
                       for k in STATS})
    opts2 = tuple(jrender.auto_render_options(c, 256)
                  for c in (h._white_config, h._yolk_config))
    draw = JS.spatial_draw(mesh, lay, opts2, (0.0, 0.0, 256, 256), 0.3, 0.01,
                           True)
    frame = _np(draw(JS.redistribute(jdrawn, _cell_sizes(h), lay, mesh),
                     jstats, jcfg2, jnp.float32(1.0)))
    return dict(h=h, multi=(host_view(st_m), stats_m, _np(info_m), ws),
                multi2=host_view(st_2), frame=frame, drawn=(drawn, dstats),
                port=ranks.result())


def test_spatial_step_1x1_matches_jax():
    """The degenerate mesh the card runs: no collective, halos are the
    torus wrap."""
    h = _jax_handler()
    lay_j = JS.SpatialLayout(G, K, db=1, dx=1, migrate_cap=64)
    _, steps = _jax_steps(h, lay_j, JS.make_spatial_mesh(1, 1))
    mesh = TS.make_spatial_mesh(1, 1, "cpu")
    assert mesh.size == 1 and mesh.coords == (0, 0)
    lay = TS.SpatialLayout(G, K, db=1, dx=1, migrate_cap=64)
    step = TS.spatial_step(mesh, lay, SolverOptions(**OPTS))
    st = TS.redistribute(state_from_numpy(host_view(h.state)),
                         _cell_sizes(h), lay, mesh)
    mesh.counter.reset()
    cfg2 = _port_cfg2(h)
    for want, stats, info in steps:
        before = st
        st, got_stats, got_info = step(st, cfg2, torch.tensor(1 / 60),
                                       torch.tensor(1.0))
        got = {f: getattr(st, f).numpy() for f in FIELDS}
        _assert_steps_match(got, want)
        _hold_info(got_info.numpy(), info, before.pos.numpy(),
                   before.batch_slot.numpy(), 1, 1)
        np.testing.assert_allclose(got_stats.centroid.numpy(),
                                   _np(stats.centroid), rtol=1e-4, atol=1e-3)
    assert mesh.counter.snapshot() == {}      # no collective on 1 x 1


def test_spatial_multi_step_matches_jax(resident):
    port = resident["port"]
    want, stats, info, ws = resident["multi"]
    _assert_steps_match(_step_state(port, "multi"), want)
    _hold_info(port["multi_info"], info, port["multi_bin_pos"],
               port["multi_bin_batch_slot"], 2, 2,
               after_slot=port["multi_batch_slot"])
    np.testing.assert_allclose(port["multi_centroid"], _np(stats.centroid),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(
        port["multi_wide"], [[int(v) for v in w] for w in ws])
    # one host read of the rebin decision per population and step
    assert int(port["multi_host_reads"]) == 2 * 5
    _assert_steps_match(_step_state(port, "multi2"), resident["multi2"])


def test_spatial_multi_step_matches_stepwise(resident):
    port = resident["port"]
    assert port["multi_info"][:, 0].sum() == 0
    m, s = _step_state(port, "multi"), _step_state(port, "loop")
    for i in range(2):
        m_live, s_live = m["batch_slot"][i] >= 0, s["batch_slot"][i] >= 0
        assert m_live.sum() == s_live.sum()
        pm, ps = m["pos"][i][m_live], s["pos"][i][s_live]
        cm, cs = pm.mean(axis=0), ps.mean(axis=0)
        assert np.abs(cm - cs).max() < 1.0, (i, cm, cs)
        sm = np.linalg.norm(pm - cm, axis=1).mean()
        ss = np.linalg.norm(ps - cs, axis=1).mean()
        assert abs(sm - ss) / max(ss, 1e-6) < 0.08, (i, sm, ss)
        np.testing.assert_allclose(port["multi_centroid"][i],
                                   port["loop_centroid"][i], rtol=1e-2,
                                   atol=1.0)


def test_spatial_draw_matches_jax_and_single_device(resident):
    got = resident["port"]["frame"]
    want = resident["frame"]
    assert got.shape == want.shape == (256, 256, 4)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    h = resident["h"]
    drawn, dstats = resident["drawn"]
    opts2 = tuple(trender.auto_render_options(c, 256)
                  for c in (h._white_config, h._yolk_config))
    f32 = dict(dtype=torch.float32)
    single, _, _ = trender._render_frame(
        drawn, dstats, _port_cfg2(h), torch.tensor(1.0, **f32),
        torch.tensor(0.3, **f32), torch.tensor(0.01, **f32),
        torch.tensor([0.0, 0.0], **f32), opts2, True, 256, 256)
    np.testing.assert_allclose(got, single.numpy(), rtol=1e-3, atol=2e-4)
    assert got[..., 3].max() > 0.1
