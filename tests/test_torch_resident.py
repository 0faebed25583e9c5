"""Multi-step residency of the PyTorch port against the JAX package.

``solver.multi_step``, ``solver.multi_step_frames`` and the handler's
``run_steps`` / ``warmup`` on the CPU, at small sizes (G=64, K=4).

Scenes: the lattice of ``tests/test_torch_step.py`` (17 px hex lattice,
collision and cohesion reach 16 px) with the follow pull switched off by a
dead zone wider than the scene, and a seeded velocity field:

- ``rebin``: uniform random velocities of up to 120 px/s. Neighbours close
  in and collide; the relative drift passes a quarter cell within a few
  steps, so the resident path rebins (its counter is > 0);
- ``calm``: one uniform velocity with a 1 px/s jitter. Relative drift stays
  far below a quarter cell: no rebin (the counter stays 0).

(The lattice pulled to its targets, as ``test_torch_step.py`` runs it,
moves 120 px in 4 steps; after 6 steps the fused and plane paths drift
apart by up to 5e-3 px, past the tolerance below.)

Off the TPU the JAX ``multi_step`` takes its plane-resident variant (the
session-wide interpret switch of ``tests/test_fused_path.py`` is pinned off
here), the port its fused variant unless ``sweep_symmetric``: algorithms
that agree to rounding. Tolerances are the fused-vs-plane ones of
``tests/test_fused_path.py``, as in ``test_torch_step.py``: positions and
previous positions atol 1e-3 px, velocities atol 0.2 px/s, centroid / AABB
atol 1e-3 px, in-grid sets equal. Frame totals of ``multi_step_frames``:
rtol 1e-4 (the render tests' per-channel 1e-4, summed). Equalities within
the port (``run_steps(1)`` and ``step_once``, the non-resident routes and a
loop of steps) are bit for bit: the same operations run in the same order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu import state as jstate
from egg_fluid_simulation_tpu.ops import render as jrender
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch.interop import (state_from_numpy,
                                                    state_to_numpy)
from egg_fluid_simulation_tpu_torch.ops import render as trender
from egg_fluid_simulation_tpu_torch.ops import solver as tsolver
from test_torch_step import _configs, _in_grid, lattice_state

G, K = 64, 4
BASE = dict(engine="dense", budget_mode="off", dense_rebin="step",
            dense_grid_dim=G, dense_slots=K)


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


@pytest.fixture(autouse=True)
def _zero_counters():
    tsolver.rebins[:] = [0, 0]
    tsolver.host_syncs = 0


def scene(kind: str):
    """Host state of the lattice scene ``kind`` ("rebin" or "calm")."""
    d = lattice_state()
    d["batch_radius"][:, :2] = 65536.0     # follow dead zone 512 px: off
    rng = np.random.RandomState(1)
    for pop in (0, 1):
        n = int(d["count"][pop])
        if kind == "rebin":
            v = rng.uniform(-120.0, 120.0, (n, 2))
        else:
            v = np.array([30.0, -20.0]) + rng.uniform(-1.0, 1.0, (n, 2))
        d["vel"][pop, :n] = v.astype(np.float32)
    return d


def run_both(d, n_steps, **kw):
    """``multi_step`` of both packages from the host state ``d``; returns
    the host states, the stats and the wide-gate states."""
    oj, ot = jsolver.SolverOptions(**{**BASE, **kw}), tsolver.SolverOptions(**{**BASE, **kw})
    cj, ct = _configs()
    sj = jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()})
    sj, stats_j, wj = jsolver.multi_step(
        sj, cj, jnp.float32(1 / 60), jnp.float32(1.0), oj, n_steps,
        wide_state=(jsolver.wide_state_init(oj),) * 2)
    st, stats_t, wt = tsolver.multi_step(
        state_from_numpy(d), ct, torch.tensor(1 / 60), torch.tensor(1.0), ot,
        n_steps, wide_state=(tsolver.wide_state_init(ot),) * 2)
    a = {k: np.asarray(jax.block_until_ready(v)) for k, v in vars(sj).items()}
    return a, state_to_numpy(st), stats_j, stats_t, wj, wt


def assert_states_close(a, b, stats_j=None, stats_t=None):
    """Port state ``b`` against JAX state ``a`` at the module tolerances."""
    for pop in (0, 1):
        np.testing.assert_array_equal(_in_grid(b["pos"], b["count"], pop),
                                      _in_grid(a["pos"], a["count"], pop))
    np.testing.assert_allclose(b["pos"], a["pos"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(b["prev"], a["prev"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(b["vel"], a["vel"], rtol=0, atol=0.2)
    np.testing.assert_allclose(b["last_pos"], a["last_pos"], rtol=0,
                               atol=1e-3)
    if stats_j is not None:
        for f, tol in (("centroid", 1e-3), ("last_centroid", 1e-3),
                       ("aabb_min", 1e-3), ("aabb_max", 1e-3),
                       ("max_velocity", 0.2), ("batch_count", 0.0)):
            np.testing.assert_allclose(getattr(stats_t, f).numpy(),
                                       np.asarray(getattr(stats_j, f)),
                                       rtol=0, atol=tol, err_msg=f)


@pytest.mark.parametrize("n_steps", [4, 6])
@pytest.mark.parametrize("wide", [0, 240], ids=["wide_off", "wide_240"])
@pytest.mark.parametrize("kind", ["rebin", "calm"])
def test_multi_step_matches_jax(kind, wide, n_steps):
    d = scene(kind)
    a, b, stats_j, stats_t, wj, wt = run_both(d, n_steps,
                                              wide_budget_substeps=wide)
    assert_states_close(a, b, stats_j, stats_t)
    assert np.abs(b["pos"] - d["pos"]).max() > 1.0          # it moved
    for pop in (0, 1):
        assert [int(x) for x in wt[pop]] == [int(x) for x in wj[pop]]
    # one rebin decision per population per resident step, read on the
    # host, but none on the first (its layout was just binned)
    assert tsolver.host_syncs == 2 * (n_steps - 2)
    if kind == "rebin":
        assert min(tsolver.rebins) > 0
    else:
        assert tsolver.rebins == [0, 0]


def test_drift_reference_is_a_copy():
    """The plane-resident variant writes its planes in place: a drift
    reference kept as a view of them would read zero drift and never
    rebin. On the scene that must rebin, both populations rebin and the
    result matches JAX."""
    d = scene("rebin")
    a, b, stats_j, stats_t, _, _ = run_both(d, 6, sweep_symmetric=True,
                                            wide_budget_substeps=0)
    assert min(tsolver.rebins) > 0
    assert_states_close(a, b, stats_j, stats_t)


def _handler(P, **kw):
    """A handler of package ``P`` (the port's on the CPU) with two sparse
    spawns (spacing above the 16 px collision reach)."""
    dev = {} if P is J else dict(device="cpu")
    h = P.SimulationHandler(P.default_white_config(), P.default_yolk_config(),
                            capacity=2048, max_batches=4,
                            options=P.SolverOptions(**{**BASE, **kw}), **dev)
    h.add_many([dict(x=120.0, y=110.0, white_radius=64.0, yolk_radius=16.0,
                     white_n_particles=40, yolk_n_particles=4),
                dict(x=300.0, y=160.0, white_radius=48.0, yolk_radius=16.0,
                     white_n_particles=24, yolk_n_particles=4)])
    return h


def _assert_handlers_equal(ha, hb):
    """Two port handlers hold the same state, stats and gate, bit for bit."""
    for f in dataclasses.fields(ha.state):
        assert torch.equal(getattr(ha.state, f.name),
                           getattr(hb.state, f.name)), f.name
    for f in dataclasses.fields(ha.stats):
        assert torch.equal(getattr(ha.stats, f.name),
                           getattr(hb.stats, f.name)), f.name
    for wa, wb in zip(ha._wide_state, hb._wide_state):
        assert all(torch.equal(x, y) for x, y in zip(wa, wb))


def test_run_steps_one_equals_step_once():
    ha = _handler(T, wide_budget_substeps=240)
    hb = _handler(T, wide_budget_substeps=240)
    ha.run_steps(1)
    hb.step_once()
    _assert_handlers_equal(ha, hb)
    assert tsolver.host_syncs == 0


@pytest.mark.parametrize("kw", [dict(adaptive_rebin=False),
                                dict(budget_mode="ordered")],
                         ids=["adaptive_off", "ordered"])
def test_non_resident_run_steps_equals_step_loop(kw):
    """Without residency ``run_steps`` is a loop of steps, bit for bit."""
    ha = _handler(T, wide_budget_substeps=240, **kw)
    hb = _handler(T, wide_budget_substeps=240, **kw)
    ha.run_steps(4)
    for _ in range(4):
        hb.step_once()
    _assert_handlers_equal(ha, hb)
    assert tsolver.host_syncs == 0 and tsolver.rebins == [0, 0]


def test_run_steps_nonpositive_is_a_noop():
    h = _handler(T)
    before = h.state
    h.run_steps(0)
    h.run_steps(-3)
    assert h.state is before


def test_handler_run_steps_and_warmup_match_jax():
    hj, ht = (_handler(P, wide_budget_substeps=240) for P in (J, T))
    before = ht.state
    hj.update(0.5 / 60)
    ht.update(0.5 / 60)                        # alpha 0.5, no step
    for h in (hj, ht):
        h.warmup()
    # warmup restores the state, the time accumulator and the alpha ...
    assert ht.state is before and ht.interpolation_alpha == 0.5
    assert ht._elapsed == hj._elapsed and ht._frames is None
    np.testing.assert_array_equal(state_to_numpy(ht.state)["pos"],
                                  host_view(hj.state)["pos"])
    # ... and, as the JAX package does, keeps the step's wide-gate state
    for wj, wt in zip(hj._wide_state, ht._wide_state):
        assert [int(x) for x in wt] == [int(x) for x in wj]
    for h in (hj, ht):
        h.run_steps(4)
    assert_states_close(host_view(hj.state), state_to_numpy(ht.state),
                        hj.stats, ht.stats)
    for wj, wt in zip(hj._wide_state, ht._wide_state):
        assert [int(x) for x in wt] == [int(x) for x in wj]


def test_auto_options_keep_residency_fields():
    """A re-size of the automatic options keeps ``adaptive_rebin`` and
    ``rebin_tolerance``, as the JAX handler does."""
    hs = []
    for P in (J, T):
        kw = {} if P is J else dict(device="cpu")
        h = P.SimulationHandler(P.default_white_config(),
                                P.default_yolk_config(), capacity=32768,
                                max_batches=4, **kw)
        h._options = dataclasses.replace(h._options, adaptive_rebin=False,
                                         rebin_tolerance=0.05)
        caps = h._options.pop_caps
        h.add(200.0, 200.0, white_radius=200.0, white_n_particles=3000)
        assert h._options.pop_caps != caps          # re-sized
        hs.append(h._options)
    for opts in hs:
        assert (opts.adaptive_rebin, opts.rebin_tolerance) == (False, 0.05)


def test_multi_step_frames_matches_jax():
    """Three resident frames with a 256 px ``_render_frame`` at alpha 0.5
    (which reads ``last_pos``) as ``frame_fn``. ``last_pos`` tracks the
    previous step: after 3 frames it is the position after 2, bit for bit."""
    d = scene("rebin")
    oj = jsolver.SolverOptions(**BASE, wide_budget_substeps=0)
    ot = tsolver.SolverOptions(**BASE, wide_budget_substeps=0)
    cj, ct = _configs()
    cfgs = (J.default_white_config(), J.default_yolk_config())
    opts_j = tuple(jrender.auto_render_options(c, 256, density=0.02)
                   for c in cfgs)
    opts_t = tuple(trender.auto_render_options(c, 256, density=0.02)
                   for c in cfgs)
    origin = np.array([100.0, 120.0], np.float32)

    def frame_j(state, stats):
        f, _, _ = jrender._render_frame(
            state, stats, cj, jnp.float32(0.5), jnp.float32(0.3),
            jnp.float32(0.01), jnp.asarray(origin), opts_j, True, 256, 256)
        return jnp.sum(f)

    sums = []

    def frame_t(state, stats, t):
        f, _, audits = trender._render_frame(
            state, stats, ct, torch.tensor(0.5), torch.tensor(0.3),
            torch.tensor(0.01), torch.from_numpy(origin), opts_t, True, 256,
            256)
        assert int(audits[:, 0].sum()) == 0
        sums.append((t, float(f.sum())))
        return torch.sum(f)

    sj = jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()})
    sj3, acc_j = jsolver.multi_step_frames(sj, cj, jnp.float32(1 / 60),
                                           jnp.float32(1.0), oj, 3, frame_j)
    st = state_from_numpy(d)
    st3, acc_t = tsolver.multi_step_frames(st, ct, torch.tensor(1 / 60),
                                           torch.tensor(1.0), ot, 3, frame_t)
    assert [t for t, _ in sums] == [0, 1, 2]
    assert float(acc_t) > 0.0
    np.testing.assert_allclose(float(acc_t), float(acc_j), rtol=1e-4)
    a = {k: np.asarray(v) for k, v in vars(sj3).items()}
    b = state_to_numpy(st3)
    assert_states_close(a, b)
    assert sum(tsolver.rebins) > 0
    # last_pos is the previous frame's position, not the pre-loop snapshot
    st2, _ = tsolver.multi_step_frames(st, ct, torch.tensor(1 / 60),
                                       torch.tensor(1.0), ot, 2,
                                       lambda s, stats: torch.zeros(()))
    assert torch.equal(st3.last_pos, st2.pos)
    assert np.abs(b["last_pos"] - d["pos"]).max() > 1.0
    assert np.abs(b["pos"] - b["last_pos"]).max() > 1e-4
    # the input state is not modified
    np.testing.assert_array_equal(state_to_numpy(st)["pos"], d["pos"])


def test_multi_step_frames_requires_resident_options():
    ot = tsolver.SolverOptions(**{**BASE, "budget_mode": "ordered"})
    _, ct = _configs()
    with pytest.raises(ValueError):
        tsolver.multi_step_frames(state_from_numpy(scene("calm")), ct,
                                  torch.tensor(1 / 60), torch.tensor(1.0), ot,
                                  1, lambda s, stats: torch.zeros(()))
