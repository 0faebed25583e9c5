"""``SimulationHandler.draw`` of the port against the JAX handler's, on the
scenes of the JAX package's render suites:

- ``tests/test_overflow.py``: the clustered scene overflows its
  density-sized render budget; both handlers auto-bump the budget boost
  (the JAX handler's ``_render_k_boost``, the port's ``_render_budget``)
  to the same multipliers and the same peak-density hint, and a render at
  the boosted options drops nothing; the uniform scene needs no boost;
  a heap whose peak bin stays past the budget's cap of 256: the JAX draw
  renders four times, the port's skips each re-render whose options equal
  those just drawn (two reads when nothing changes), with the same boosts,
  the same hint and the frame of a render at the options drawn;
- ``tests/test_interpolation.py``: a draw at a fractional
  ``interpolation_alpha`` (the quads at ``mix(last_pos, pos, alpha)``, the
  canvases at the interpolated centroid);
- ``tests/test_post_modes.py``: the coarse, full and super post modes, with
  and without particle colour.

The JAX handler steps (pinned to its CPU plane path) and the port's handler,
built with the same calls, takes its state and stats, so both draw the same
inputs; frames and density canvases within 1e-4 per channel (the port's
frame tolerance, ``tests/test_torch_render.py``). The port draws eagerly
and through ``RenderGraphs(capture=False)``, the plumbing of its captured
render; the two agree bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu.ops import render as jrender
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch.interop import state_from_numpy
from egg_fluid_simulation_tpu_torch.ops import render as trender
from egg_fluid_simulation_tpu_torch.ops import render_graph as RG
from egg_fluid_simulation_tpu_torch.state import StepStats

FRAME_TOL = 1e-4
VIEW = (0.0, 0.0, 256, 256)


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    # pin the JAX step to its CPU path (the plane path) whatever interpret
    # switch an earlier test file set for the whole run
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    monkeypatch.setattr(jsweep, "FORCE_INTERPRET", False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(opts, adds, **kw):
    """A JAX and a port handler built alike, with the same batches added."""
    hj = J.SimulationHandler(J.default_white_config(), J.default_yolk_config(),
                             options=J.SolverOptions(**opts), **kw)
    ht = T.SimulationHandler(T.default_white_config(), T.default_yolk_config(),
                             options=T.SolverOptions(**opts), device="cpu",
                             **kw)
    for args in adds:
        assert hj.add(*args) == ht.add(*args)
    return hj, ht


def _take_jax_state(hj, ht, route):
    """The port handler takes the JAX handler's state, stats and
    interpolation alpha; ``route`` "graph" renders through the graph
    plumbing."""
    ht._state = state_from_numpy(host_view(hj.state))
    ht._stats = StepStats(**{
        f.name: torch.from_numpy(np.array(getattr(hj.stats, f.name)))
        for f in dataclasses.fields(StepStats)})
    ht._interpolation_alpha = hj.interpolation_alpha
    ht._use_particle_color = hj._use_particle_color
    ht._frames = None
    if route == "graph":
        ht._render_graphs = RG.RenderGraphs(capture=False)


def _assert_frames_close(ft, fj, ht, hj):
    fj = np.asarray(jax.block_until_ready(fj))
    assert ft.shape == fj.shape
    assert fj[..., 3].max() > 0.5
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0, atol=FRAME_TOL)
    assert len(ht._canvases) == len(hj._canvases) == 2
    for ct, cj in zip(ht._canvases, hj._canvases):
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                                   atol=FRAME_TOL)


# ------------------------------------------------- tests/test_overflow.py --

BASE_OVERFLOW = dict(engine="dense", budget_mode="off", dense_rebin="step",
                     dense_grid_dim=32, dense_slots=8, use_pallas=False,
                     adaptive_rebin=False)


@pytest.fixture(scope="module")
def clustered():
    """The clustered scene, stepped once by the JAX handler, and its first
    draw: the auto-bump's boosts and the frame."""
    hj, _ = _pair(BASE_OVERFLOW, [(200.0, 200.0, 20.0, 8.0, None, None, 400,
                                   20),
                                  (5000.0, 5000.0, 8.0, 4.0, None, None, 10,
                                   3)],
                  capacity=1024, max_batches=8, canvas_size=1024)
    hj.step_once()
    opts2 = jrender.frame_options(hj)
    frame = hj.draw(viewport=VIEW, check_overflow=True)
    return dict(hj=hj, opts2=opts2, frame=frame,
                boost=list(hj._render_k_boost),
                peak=list(hj._render_peak_density))


def _port_clustered(clustered, route):
    _, ht = _pair(BASE_OVERFLOW, [(200.0, 200.0, 20.0, 8.0, None, None, 400,
                                   20),
                                  (5000.0, 5000.0, 8.0, 4.0, None, None, 10,
                                   3)],
                  capacity=1024, max_batches=8, canvas_size=1024)
    _take_jax_state(clustered["hj"], ht, route)
    return ht


def test_clustered_scene_overflows_then_autobumps_as_jax(clustered):
    """Through the graph plumbing only: its overflow draw is the eager
    one's bit for bit (``tests/test_torch_render_graph.py``), and a render
    at this budget is slow on the CPU."""
    hj = clustered["hj"]
    ht = _port_clustered(clustered, "graph")
    opts2 = ht._frame_options()
    assert ([dataclasses.asdict(o) for o in opts2]
            == [dataclasses.asdict(o) for o in clustered["opts2"]])
    frame = ht.draw(viewport=VIEW, check_overflow=True)
    assert max(ht._render_budget.k_boost) > 1.0
    assert ht._render_budget.k_boost == clustered["boost"]
    for got, want in zip(ht._render_budget.peak_density, clustered["peak"]):
        assert (got is None) == (want is None)
        assert want is None or got == pytest.approx(want, rel=1e-6)
    assert ht._render_graphs.captures >= 2      # the boost was a new key
    # both kept the canvases of their last render, at the final boost
    _assert_frames_close(frame, clustered["frame"], ht, hj)
    # tests/test_overflow.py's gate: a render at the boosted options drops
    # nothing, and both audits agree
    opts2b = ht._frame_options()
    assert opts2b[0].tile_capacity > opts2[0].tile_capacity
    _, _, ov_j = jrender._render_frame(
        hj.state, hj.stats, hj._device_cfg2(), jnp.float32(1.0),
        jnp.float32(0.3), jnp.float32(0.01), jnp.asarray([0.0, 0.0],
                                                         jnp.float32),
        jrender.frame_options(hj), True, 256, 256,
        pop_caps=hj._options.pop_caps)
    _, _, ov_t = ht._render(opts2b, VIEW, alpha=1.0)
    assert int(ov_t[:, 0].sum()) == 0
    np.testing.assert_array_equal(ov_t.numpy(), np.asarray(ov_j))


@pytest.mark.parametrize("route", ["eager", "graph"])
def test_uniform_scene_needs_no_boost_as_jax(route):
    adds = [(150.0, 150.0, 40.0, 12.0, None, None, 150, 15)]
    hj, ht = _pair(BASE_OVERFLOW, adds, capacity=1024, max_batches=8)
    hj.step_once()
    fj = hj.draw(viewport=VIEW, check_overflow=True)
    _take_jax_state(hj, ht, route)
    ft = ht.draw(viewport=VIEW, check_overflow=True)
    assert ht._render_budget.k_boost == hj._render_k_boost == [1.0, 1.0]
    assert int(ht.render_audit[:, 0].sum()) == 0
    _assert_frames_close(ft, fj, ht, hj)


# the clump sits half a bin off the canvas centre, so one bin holds most of
# it (a peak of 316 splats); the far batch, off the canvas, widens the AABB,
# so the first draw's density-sized budget is small
HEAP = [(128.0, 128.0, 20.0, 8.0, None, None, 400, 20),
        (784.0, 784.0, 8.0, 4.0, None, None, 10, 3)]
HEAP_KW = dict(capacity=1024, max_batches=8, canvas_size=256)


@pytest.fixture(scope="module")
def heap():
    """The heap, stepped once by the JAX handler, and its two draws: the
    frame, the boosts, the hint and the renders each draw ran."""
    hj, _ = _pair(BASE_OVERFLOW, HEAP, **HEAP_KW)
    hj.step_once()
    renders = []
    real = jrender._render_frame

    def counted(*a, **k):
        renders.append(1)
        return real(*a, **k)

    draws = []
    jrender._render_frame = counted
    try:
        for _ in range(2):
            hj._frames = None
            del renders[:]
            frame = np.asarray(hj.draw(viewport=VIEW, check_overflow=True))
            draws.append(dict(frame=frame, renders=len(renders),
                              boost=list(hj._render_k_boost),
                              peak=list(hj._render_peak_density)))
    finally:
        jrender._render_frame = real
    return hj, draws


@pytest.mark.parametrize("route", ["eager", "graph"])
@pytest.mark.parametrize("draw,rerenders", [(0, 1), (1, 0)],
                         ids=["raised", "capped"])
def test_capped_heap_skips_rerenders_as_jax(heap, route, draw, rerenders):
    """``raised``: the first draw's re-render lifts the budget to its cap
    and the frame still drops splats; ``capped``: the next draw starts at
    the cap. The JAX draw renders four times either way."""
    hj, draws = heap
    want = draws[draw]
    assert want["renders"] == 4
    _, ht = _pair(BASE_OVERFLOW, HEAP, **HEAP_KW)
    _take_jax_state(hj, ht, route)
    for _ in range(draw):
        ht.draw(viewport=VIEW)
        ht._frames = None
    trender.host_reads = trender.rerenders = 0
    trender.rerenders_skipped = 0
    frame = ht.draw(viewport=VIEW)
    assert trender.rerenders == rerenders
    assert trender.rerenders_skipped == 3 - rerenders
    assert trender.host_reads == 2 + 2 * rerenders
    assert ht._render_budget.k_boost == want["boost"]
    assert ht._render_budget.peak_density == want["peak"]
    opts2 = ht._frame_options()
    assert opts2[0].tile_capacity == 256
    assert int(ht.render_audit[0, 0]) > 0      # still over the cap
    np.testing.assert_allclose(frame.numpy(), want["frame"], rtol=0,
                               atol=FRAME_TOL)
    # what the skipped re-renders would have drawn
    again, canvases, audit = ht._render(opts2, VIEW)
    assert torch.equal(again, frame)
    for got, kept in zip(canvases, ht._canvases):
        assert torch.equal(got, kept)
    assert torch.equal(audit, ht._render_budget.audit)


# -------------------------------------------- tests/test_interpolation.py --

BASE_MODES = dict(engine="dense", budget_mode="off", dense_rebin="step",
                  dense_grid_dim=32, dense_slots=4, use_pallas=False)


@pytest.fixture(scope="module")
def interpolated():
    hj, _ = _pair(dict(BASE_MODES, adaptive_rebin=True),
                  [(80.0, 60.0, 25.0, 8.0, None, None, 50, 12)],
                  capacity=512, max_batches=8)
    hj.set_target_position(1, 130.0, 95.0)
    hj.step_once()
    hj.step_once()
    hj.update(0.4 / 60)            # accumulates, no step: alpha 0.4
    return hj, hj.draw(viewport=VIEW)


@pytest.mark.parametrize("route", ["eager", "graph"])
def test_draw_at_fractional_alpha_as_jax(interpolated, route):
    hj, fj = interpolated
    assert 0.39 < hj.interpolation_alpha < 0.41
    _, ht = _pair(dict(BASE_MODES, adaptive_rebin=True),
                  [(80.0, 60.0, 25.0, 8.0, None, None, 50, 12)],
                  capacity=512, max_batches=8)
    ht.set_target_position(1, 130.0, 95.0)
    _take_jax_state(hj, ht, route)
    assert ht.interpolation_alpha == hj.interpolation_alpha
    moved = np.abs(host_view(hj.state)["pos"]
                   - host_view(hj.state)["last_pos"]).max()
    assert moved > 0.1
    ft = ht.draw(viewport=VIEW)
    _assert_frames_close(ft, fj, ht, hj)
    # the interpolated frame differs from the frame at alpha 1
    ht._interpolation_alpha = 1.0
    assert np.abs(ht.draw(viewport=VIEW).numpy() - ft.numpy()).max() > 1e-3


# ---------------------------------------------- tests/test_post_modes.py --

@pytest.fixture(scope="module")
def post_mode_frames():
    """JAX frames of the post-mode scene in each mode, with and without
    particle colour, keyed ``(mode, colour)``: ``(hj, frame)``."""
    out = {}
    for mode in ("coarse", "full", "super"):
        for colour in (False, True):
            hj, _ = _pair(dict(BASE_MODES, adaptive_rebin=False),
                          [(128.0, 128.0, 30.0, 10.0, None, None, 60, 14)],
                          capacity=512, max_batches=8, canvas_size=256,
                          render_post_mode=mode)
            if colour:
                hj._use_particle_color = True
                hj.set_white_color(1, 0.9, 0.55, 0.3)
                hj.set_yolk_color(1, 0.2, 0.6, 1.0)
            hj.step_once()
            out[mode, colour] = (hj, hj.draw(viewport=VIEW))
    return out


@pytest.mark.parametrize("colour", [False, True], ids=["alpha", "colour"])
@pytest.mark.parametrize("mode", ["coarse", "full", "super"])
def test_post_modes_draw_as_jax(post_mode_frames, mode, colour):
    hj, fj = post_mode_frames[mode, colour]
    frames = {}
    for route in ("eager", "graph"):
        _, ht = _pair(dict(BASE_MODES, adaptive_rebin=False),
                      [(128.0, 128.0, 30.0, 10.0, None, None, 60, 14)],
                      capacity=512, max_batches=8, canvas_size=256,
                      render_post_mode=mode)
        _take_jax_state(hj, ht, route)
        frames[route] = ht.draw(viewport=VIEW)
        _assert_frames_close(frames[route], fj, ht, hj)
    assert torch.equal(frames["eager"], frames["graph"])
