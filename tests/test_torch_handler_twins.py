"""The port's handler against the JAX package's on the resident route.

Both handlers take the same calls (construction, ``add``, a target, a state
set from outside) and run ``run_steps`` (the resident ``multi_step``; the
port's replayed-graph plumbing too, ``ResidentGraphs(capture=False)``) or
``multi_step_frames``; their results are compared with each other, on the
scenes of ``tests/test_solver_honesty.py`` and ``tests/test_interpolation.py``:

- a packed scene (batches tiled at 2.2 batch radii, at test scale) after the
  resident steps: the collision-budget audit (drops, cell occupancy) equal;
- a stack of whites collapsed onto one point (only collision can move
  them): it starts to disperse alike, the audit and the farthest particle's
  distance from the point equal (the break-up is chaotic: which members
  leave first differs by rounding, so positions are not compared);
- two coincident whites: the tie-break separates them along its axis,
  alike;
- the rotating binning places ``min(count, slots)`` a cell: the same slots;
- ``multi_step_frames``' ``last_pos`` (and ``pos``).

Every handler has one shape and one set of options (the interpolation
test's, capacity 512), so the JAX package compiles its resident loop once
for the module; the JAX step is pinned to its CPU plane path, the port runs
its fused variant (they agree to rounding, ``tests/test_torch_resident.py``).
Tolerances: whole-step pos 1e-3 px, vel 0.2 px/s; host-decided counts (the
audit, the placement) bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu.ops import dense as jdense
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu.utils.profiling import \
    collision_drop_stats as j_drop_stats
from egg_fluid_simulation_tpu_torch.interop import state_to_numpy
from egg_fluid_simulation_tpu_torch.ops import dense as tdense
from egg_fluid_simulation_tpu_torch.ops import solver as tsolver
from egg_fluid_simulation_tpu_torch.ops.resident_graph import ResidentGraphs
from egg_fluid_simulation_tpu_torch.utils.profiling import \
    collision_drop_stats as t_drop_stats

BASE = dict(engine="dense", budget_mode="off", dense_rebin="step",
            dense_grid_dim=32, dense_slots=4, adaptive_rebin=True)
STEPS = 2           # run_steps of every scene: one compile of JAX's loop


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel
    monkeypatch.setattr(sweep_kernel, "FORCE_INTERPRET", False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _handler(P, graphs: bool = False):
    dev = {} if P is J else dict(device="cpu")
    opts = dict(use_pallas=False) if P is J else {}
    h = P.SimulationHandler(P.default_white_config(), P.default_yolk_config(),
                            capacity=512, max_batches=8,
                            options=P.SolverOptions(**BASE, **opts), **dev)
    if graphs:
        h._resident = ResidentGraphs(capture=False)
    return h


def _twins(build):
    """The JAX handler, the port's eager one and the port's on the graph
    plumbing, each built by ``build(handler)``."""
    hs = [_handler(J), _handler(T), _handler(T, graphs=True)]
    for h in hs:
        build(h)
    return hs


def _set_state(h, **fields):
    """Set state fields from host arrays, in either package."""
    if isinstance(h, J.SimulationHandler):
        h._state = h.state.replace(**{k: jnp.asarray(v)
                                      for k, v in fields.items()})
    else:
        h._state = h.state.replace(**{k: torch.from_numpy(v)
                                      for k, v in fields.items()})
    h._frames = None


def _host(h):
    if isinstance(h, J.SimulationHandler):
        return host_view(h.state)
    return state_to_numpy(h.state)


def _assert_ports_equal(hts):
    for ht in hts[1:]:
        for f in dataclasses.fields(ht.state):
            assert torch.equal(getattr(ht.state, f.name),
                               getattr(hts[0].state, f.name)), f.name


def _assert_twins(hj, *hts):
    """The port's handlers equal each other bit for bit, and the JAX
    handler at the step tolerances."""
    a = _host(hj)
    b = _host(hts[0])
    _assert_ports_equal(hts)
    for f, tol in (("pos", 1e-3), ("prev", 1e-3), ("last_pos", 1e-3),
                   ("vel", 0.2)):
        np.testing.assert_allclose(b[f], a[f], rtol=0, atol=tol, err_msg=f)


def test_packed_scene_audit_matches():
    def build(h):
        for b in range(4):
            h.add(88.0 * (b % 2) + 88.0, 88.0 * (b // 2) + 88.0, 40.0, 12.0,
                  None, None, 100, 10)
    hs = _twins(build)
    for h in hs:
        h.run_steps(STEPS)
    _assert_twins(*hs)
    audits = [j_drop_stats(hs[0])] + [t_drop_stats(h) for h in hs[1:]]
    assert audits[0]["white"]["max_cell_occupancy"] >= 2     # packed
    for pop in ("white", "yolk"):
        for got in audits[1:]:
            assert got[pop] == pytest.approx(audits[0][pop], abs=1e-9)
    assert hs[2]._resident.captures == 1


def test_coincident_stack_disperses_alike():
    point = np.array([80.0, 80.0], np.float32)

    def build(h):
        a = h.add(80.0, 80.0, 25.0, 8.0, None, None, 120, 4)
        h.set_target_position(a, 80.0, 80.0)
        d = _host(h)
        act = d["count"][:, None] > np.arange(d["pos"].shape[1])[None]
        stacked = np.where(act[..., None], point, d["pos"]).astype(np.float32)
        _set_state(h, pos=stacked, prev=stacked.copy(),
                   last_pos=stacked.copy(), vel=np.zeros_like(d["vel"]))
    hs = _twins(build)
    before = [j_drop_stats(hs[0])] + [t_drop_stats(h) for h in hs[1:]]
    for h in hs:
        h.run_steps(STEPS)
    _assert_ports_equal(hs[1:])
    after = [j_drop_stats(hs[0])] + [t_drop_stats(h) for h in hs[1:]]
    reach = [np.linalg.norm(_host(h)["pos"][0, :120] - point, axis=1).max()
             for h in hs]
    for b, a in zip(before, after):
        assert b["white"]["max_cell_occupancy"] == 120
        assert a["white"] == pytest.approx(after[0]["white"], abs=1e-9)
    assert after[0]["white"]["max_cell_occupancy"] < 120       # dispersing
    np.testing.assert_allclose(reach[1:], [reach[0]] * 2, rtol=0, atol=1e-3)


def test_coincident_pair_tiebreak_separates_alike():
    point = np.array([200.0, 200.0], np.float32)

    def build(h):
        a = h.add(200.0, 200.0, 4.0, 4.0, None, None, 2, 2)
        h.set_target_position(a, 200.0, 200.0)
        d = _host(h)
        pos = d["pos"].copy()
        pos[0, :2] = point
        _set_state(h, pos=pos, prev=pos.copy(), last_pos=pos.copy(),
                   vel=np.zeros_like(d["vel"]))
    hs = _twins(build)
    for h in hs:
        h.run_steps(STEPS)
    _assert_twins(*hs)
    for h in hs:
        sep = _host(h)["pos"][0, 0] - _host(h)["pos"][0, 1]
        assert np.abs(sep).min() > 0.1
        np.testing.assert_allclose(sep[1] / sep[0], jdense.TIE_Y
                                   / jdense.TIE_X, rtol=1e-4)


def test_rotation_places_min_of_count_and_slots_alike():
    g, k = 32, 4
    rng = np.random.default_rng(7)
    pos = np.concatenate([
        np.full((40, 2), 100.0) + rng.uniform(-2, 2, (40, 2)),
        rng.uniform(0, 200, (30, 2))]).astype(np.float32)
    n = pos.shape[0]
    args = (pos, np.ones((n,), np.float32), np.full((n,), 4.0, np.float32),
            np.zeros((n,), np.int32), np.ones((n,), bool))
    bj = jdense.bin_to_planes(*map(jnp.asarray, args), jnp.float32(8.0),
                              grid_dim=g, slots_per_cell=k, rotate=True)
    bt = tdense.bin_to_planes(*map(torch.from_numpy, args),
                              torch.tensor(8.0), grid_dim=g,
                              slots_per_cell=k, rotate=True)
    slots = np.asarray(bj.slot)
    np.testing.assert_array_equal(bt.slot.numpy(), slots)
    placed = slots < g * g * k
    assert 0 < placed.sum() < n


def _zero(state, stats):
    return jnp.float32(0.0) if isinstance(state.pos, jnp.ndarray) \
        else torch.zeros(())


def test_multi_step_frames_last_pos_alike():
    def build(h):
        a = h.add(80.0, 60.0, 25.0, 8.0, None, None, 50, 12)
        h.set_target_position(a, 130.0, 95.0)
        h._flush_targets()
    hs = _twins(build)
    outs = []
    for h, graphs in zip(hs, (None, None, ResidentGraphs(capture=False))):
        cfg2 = h._device_cfg2()
        dt, relax = h._step_scalars(1 / 60)
        kw = {} if graphs is None else dict(graphs=graphs)
        h._state, _ = (jsolver if h is hs[0] else tsolver).multi_step_frames(
            h.state, cfg2, dt, relax, h._options, 3, _zero, **kw)
        outs.append(_host(h))
    _assert_twins(*hs)
    moved = np.abs(outs[0]["last_pos"] - outs[0]["pos"]).max()
    assert moved > 1e-4
    np.testing.assert_array_equal(outs[2]["last_pos"], outs[1]["last_pos"])
