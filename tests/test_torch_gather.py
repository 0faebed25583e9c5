"""The gather engine of the PyTorch port against the JAX package's.

Inputs are built from a numpy seed and fed to both packages as the same
arrays (``interop.state_from_numpy`` on the JAX state's host view).

- One ``solve_pairs`` pass (a fresh hash grid and the exact candidate
  sweep), both budget modes, both cohesion modes, in one chunk and in many,
  on a packed scene where the ordered 0.05 n^2 budget binds and on a loose
  one where it does not: atol 1e-4 px (candidate sums in another order).
- Whole steps: 3 ``step`` calls and one ``multi_step(3)`` on a lattice
  pulled toward its targets: in-grid positions and previous positions atol
  1e-3 px, velocities 0.2 px/s, centroid and AABB 1e-3 px (the whole-step
  tolerances of ``tests/test_torch_step.py``). Both packages round alike
  but for XLA's fused multiply-adds, about one ulp of position a step.
- A default-options handler pair at capacity 4096 (the gather engine with
  the JAX package's table size), 10 ``update`` calls at the same
  tolerances; ``run_steps`` on the gather engine passes the episode state
  through; ``n_collision_steps=0`` on each route of both engines.

The per-batch follow tables are gathered exactly here and through a bf16
hi/lo one-hot product in the JAX package (~16 significant bits), so every
scene's targets and batch radii are exact in 16 bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu import config as jconfig
from egg_fluid_simulation_tpu import state as jstate
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch import config as tconfig
from egg_fluid_simulation_tpu_torch.interop import (state_from_numpy,
                                                    state_to_numpy)
from egg_fluid_simulation_tpu_torch.ops import solver as tsolver

# the calm lattice of the dense-engine twins: 600 whites on a 17 px hex
# lattice and 60 yolks, targets and radii exact in 16 bits
from test_torch_step import _configs, lattice_state

POS_TOL = 1e-3     # px
VEL_TOL = 0.2      # px/s
PASS_TOL = 1e-4    # px, one pass


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    # pin the JAX dense step to its CPU plane path whatever interpret switch
    # an earlier test file set for the session
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel
    monkeypatch.setattr(sweep_kernel, "FORCE_INTERPRET", False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _white_cfgs():
    return (jconfig.device_config_from_dict(jconfig.default_white_config()),
            tconfig.device_config_from_dict(tconfig.default_white_config()))


def _pass_scene(scene):
    """(N=512) arrays of one population: ``packed``, 240 live particles in a
    50 px square (the ordered budget binds: 0.05 * 240^2 = 2880 pairs of
    ~5500 in the true 3x3 cells); ``loose``, 400 in a 400 px square (it does
    not). Three batches, masses and radii seeded, the tail inactive."""
    rng = np.random.default_rng(7)
    n = 512
    live, span = (240, 50.0) if scene == "packed" else (400, 400.0)
    pos = rng.uniform(-span / 2, span / 2, (n, 2)).astype(np.float32)
    return dict(pos=pos,
                inv=rng.uniform(0.55, 1.0, n).astype(np.float32),
                rad=rng.uniform(3.0, 4.0, n).astype(np.float32),
                batch=rng.integers(0, 3, n).astype(np.int32),
                act=np.arange(n) < live)


@pytest.mark.parametrize("chunk", [1 << 15, 128, 100],
                         ids=["one_chunk", "chunked", "ragged_chunks"])
@pytest.mark.parametrize("cohesion", ["spacing", "literal"])
@pytest.mark.parametrize("budget", ["ordered", "off"])
@pytest.mark.parametrize("scene", ["packed", "loose"])
def test_solve_pairs_matches_jax(scene, budget, cohesion, chunk):
    """The JAX package reshapes its chunks, so it needs ``pair_chunk`` to
    divide N; the port slices them, and a ragged last chunk (512 = 5 x 100
    + 12) is held against JAX's unchunked pass."""
    d = _pass_scene(scene)
    kw = dict(table_size=256, slots_per_cell=16, budget_mode=budget,
              cohesion_mode=cohesion, pair_chunk=chunk)
    cj, ct = _white_cfgs()
    comp = (1e-3, 4e-3, 1.0)     # collision, cohesion compliance, relaxation
    kw_j = dict(kw, pair_chunk=1 << 15) if 512 % chunk else kw
    want = np.asarray(jsolver.solve_pairs(
        jnp.asarray(d["pos"]), jnp.asarray(d["inv"]), jnp.asarray(d["rad"]),
        jnp.asarray(d["batch"]), jnp.asarray(d["act"]), cj,
        *(jnp.float32(c) for c in comp), jsolver.SolverOptions(**kw_j)))
    got = tsolver.solve_pairs(
        torch.from_numpy(d["pos"]), torch.from_numpy(d["inv"]),
        torch.from_numpy(d["rad"]), torch.from_numpy(d["batch"]),
        torch.from_numpy(d["act"]), ct, *(torch.tensor(c) for c in comp),
        tsolver.SolverOptions(**kw)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PASS_TOL)
    assert np.abs(got - d["pos"]).max() > 1.0          # the pass moved them
    np.testing.assert_array_equal(got[~d["act"]], d["pos"][~d["act"]])
    # the scene is what its name says: the ordered budget binds when packed
    grid, cand, valid = tsolver._pair_candidates(
        torch.from_numpy(d["pos"]), torch.from_numpy(d["act"]),
        torch.tensor(8.0), tsolver.SolverOptions(**kw))
    new_pairs, cum, max_pairs = tsolver._ordered_budget(
        grid, cand, valid, torch.from_numpy(d["act"]))
    assert (float(new_pairs.sum()) > float(max_pairs)) == (scene == "packed")


def _assert_states_close(a, b, moved_from=None):
    """Host views ``a`` (JAX) and ``b`` (port) at the whole-step tolerances."""
    np.testing.assert_allclose(b["pos"], a["pos"], rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(b["prev"], a["prev"], rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(b["vel"], a["vel"], rtol=0, atol=VEL_TOL)
    np.testing.assert_allclose(b["last_pos"], a["last_pos"], rtol=0,
                               atol=POS_TOL)
    for f in ("count", "batch_slot"):
        np.testing.assert_array_equal(b[f], a[f], err_msg=f)
    # 1 / mass: XLA's compiled division may differ from IEEE by one ulp
    for f in ("inv_mass", "radius"):
        np.testing.assert_allclose(b[f], a[f], rtol=2.5e-7, atol=0, err_msg=f)
    if moved_from is not None:
        assert np.abs(b["pos"] - moved_from).max() > 1.0


def _assert_stats_close(stats_t, stats_j):
    for f, tol in (("centroid", POS_TOL), ("last_centroid", POS_TOL),
                   ("aabb_min", POS_TOL), ("aabb_max", POS_TOL),
                   ("max_velocity", VEL_TOL), ("max_radius", 0.0),
                   ("batch_count", 0.0)):
        np.testing.assert_allclose(getattr(stats_t, f).numpy(),
                                   np.asarray(getattr(stats_j, f)),
                                   rtol=0, atol=tol, err_msg=f)


GATHER = dict(table_size=4096, slots_per_cell=16, pop_caps=(1024, 1024))


@pytest.mark.parametrize("mode", [dict(), dict(cohesion_mode="literal",
                                               budget_mode="off")],
                         ids=["spacing_ordered", "literal_off"])
def test_gather_steps_match_jax(mode):
    oj = jsolver.SolverOptions(**GATHER, **mode)
    ot = tsolver.SolverOptions(**GATHER, **mode)
    d = lattice_state()
    sj = jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()})
    st = state_from_numpy(d)
    cj, ct = _configs()
    wj = (jsolver.wide_state_init(oj),) * 2
    wt = (tsolver.wide_state_init(ot),) * 2
    for _ in range(3):
        sj, stats_j, wj = jsolver.step(sj, cj, jnp.float32(1 / 60),
                                       jnp.float32(1.0), oj, wide_state=wj)
        st, stats_t, wt = tsolver.step(st, ct, torch.tensor(1 / 60),
                                       torch.tensor(1.0), ot, wide_state=wt)
    jax.block_until_ready(sj.pos)
    _assert_states_close(host_view(sj), state_to_numpy(st), d["pos"])
    _assert_stats_close(stats_t, stats_j)
    # the gather engine has no wide machinery: the episode state passes
    # through untouched in both packages
    for pop in (0, 1):
        assert [int(x) for x in wt[pop]] == [int(x) for x in wj[pop]] \
            == [0, ot.wide_budget_substeps, 0]


def test_gather_multi_step_matches_jax():
    """``multi_step(3)`` (a loop of steps on the gather engine, stats of the
    last) against JAX's, and bit for bit against three port steps."""
    oj, ot = jsolver.SolverOptions(**GATHER), tsolver.SolverOptions(**GATHER)
    d = lattice_state()
    cj, ct = _configs()
    sj, stats_j = jsolver.multi_step(
        jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()}),
        cj, jnp.float32(1 / 60), jnp.float32(1.0), oj, 3)
    st, stats_t = tsolver.multi_step(state_from_numpy(d), ct,
                                     torch.tensor(1 / 60), torch.tensor(1.0),
                                     ot, 3)
    jax.block_until_ready(sj.pos)
    _assert_states_close(host_view(sj), state_to_numpy(st), d["pos"])
    _assert_stats_close(stats_t, stats_j)
    s3 = state_from_numpy(d)
    for _ in range(3):
        s3, stats3 = tsolver.step(s3, ct, torch.tensor(1 / 60),
                                  torch.tensor(1.0), ot)
    for f in ("pos", "prev", "vel", "last_pos"):
        assert torch.equal(getattr(s3, f), getattr(st, f)), f
    assert torch.equal(stats3.centroid, stats_t.centroid)


def test_multi_step_frames_refuses_the_gather_engine():
    d = lattice_state()
    with pytest.raises(ValueError, match="engine='dense'"):
        tsolver.multi_step_frames(state_from_numpy(d), _configs()[1],
                                  torch.tensor(1 / 60), torch.tensor(1.0),
                                  tsolver.SolverOptions(**GATHER), 2,
                                  lambda state, stats: torch.zeros(()))


@pytest.mark.parametrize("capacity", [256, 4096, 8192, 16384, 32768])
def test_auto_options_match_jax(capacity):
    """The handler's automatic options are the JAX handler's at every
    capacity: the gather engine and its table size below 16384, the dense
    engine at and above, re-sized alike as particles arrive."""
    hj = J.SimulationHandler(J.default_white_config(), J.default_yolk_config(),
                             capacity=capacity, max_batches=8)
    ht = T.SimulationHandler(T.default_white_config(), T.default_yolk_config(),
                             capacity=capacity, max_batches=8, device="cpu")
    names = [f.name for f in dataclasses.fields(jsolver.SolverOptions)]
    for n_white in (0, 100, min(capacity // 2, 3000)):
        if n_white:
            for h in (hj, ht):
                h.add(100.0, 100.0, 64.0, 16.0, None, None, n_white, 10)
        assert ({f: getattr(ht._options, f) for f in names}
                == {f: getattr(hj._options, f) for f in names})
    assert ht._options.engine == ("dense" if capacity >= 16384 else "gather")


def test_default_handler_pair_follows_jax():
    """``SimulationHandler(cfg)`` (capacity 4096): the gather engine with the
    JAX package's table size, and 10 ``update`` calls of two spawned eggs,
    one dragged, within the whole-step tolerances. The follow pull is set a
    little softer (0.99) in both, a scene whose spawn transient stays calm
    enough that one-ulp differences do not grow past the tolerance."""
    hj = J.SimulationHandler(J.default_white_config(), J.default_yolk_config())
    ht = T.SimulationHandler(T.default_white_config(), T.default_yolk_config(),
                             device="cpu")
    names = [f.name for f in dataclasses.fields(jsolver.SolverOptions)]
    assert ({f: getattr(ht._options, f) for f in names}
            == {f: getattr(hj._options, f) for f in names})
    assert (ht._options.engine, ht._options.table_size) == ("gather", 2048)
    for h in (hj, ht):
        h.set_white_config({"follow_strength": 0.99})
        h.set_yolk_config({"follow_strength": 0.99})
        a = h.add(100.0, 100.0, 64.0, 16.0, None, None, 30, 5)
        h.add(300.0, 120.0, 64.0, 16.0, None, None, 30, 5)
        h.set_target_position(a, 130.0, 110.0)
    start = host_view(hj.state)["pos"]
    for _ in range(10):
        hj.update(1 / 60)
        ht.update(1 / 60)
    _assert_states_close(host_view(hj.state), state_to_numpy(ht.state), start)
    _assert_stats_close(ht.stats, hj.stats)
    assert ht.get_position(a) == pytest.approx(hj.get_position(a), abs=POS_TOL)


def test_run_steps_gather_engine_threads_wide_state():
    """Twin of tests/test_handler.py: ``run_steps`` on the gather engine
    keeps the episode state's structure and budget (no wide machinery)."""
    h = T.SimulationHandler(T.default_white_config(), T.default_yolk_config(),
                            capacity=256, max_batches=4, device="cpu",
                            options=T.SolverOptions(engine="gather",
                                                    table_size=1024,
                                                    slots_per_cell=8))
    h.add(10.0, 10.0, 15.0, 5.0, None, None, 20, 5)
    ws0 = [[int(x) for x in w] for w in h._wide_or_init()]
    h.run_steps(3)
    assert torch.isfinite(h.state.pos).all()
    ws1 = h._wide_state
    assert len(ws1) == 2 and all(len(w) == 3 for w in ws1)
    assert [[int(x) for x in w] for w in ws1] == ws0


ZERO_PASS_ROUTES = {
    "gather": dict(**GATHER),
    # the fused path turns itself off without a pass (JAX solver.py:676):
    # the plane path runs it
    "fused": dict(engine="dense", budget_mode="off", dense_grid_dim=64,
                  dense_slots=4, pop_caps=(1024, 1024)),
    "plane": dict(engine="dense", budget_mode="ordered", dense_grid_dim=64,
                  dense_slots=4, pop_caps=(1024, 1024)),
    "pass": dict(engine="dense", budget_mode="ordered", dense_rebin="pass",
                 dense_grid_dim=64, dense_slots=4, pop_caps=(1024, 1024)),
}


@pytest.mark.parametrize("route", sorted(ZERO_PASS_ROUTES))
def test_zero_collision_steps_match_jax(route):
    """``n_collision_steps=0``: damped integration and the follow pull only,
    two steps, on every route, against JAX ``step``."""
    kw = dict(ZERO_PASS_ROUTES[route], n_collision_steps=0)
    oj, ot = jsolver.SolverOptions(**kw), tsolver.SolverOptions(**kw)
    assert not tsolver._fused_component_path(ot)
    d = lattice_state()
    rng = np.random.RandomState(3)
    d["vel"][:, :700] = rng.uniform(-60.0, 60.0, (2, 700, 2))
    sj = jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()})
    st = state_from_numpy(d)
    cj, ct = _configs()
    for _ in range(2):
        sj, stats_j = jsolver.step(sj, cj, jnp.float32(1 / 60),
                                   jnp.float32(1.0), oj)
        st, stats_t = tsolver.step(st, ct, torch.tensor(1 / 60),
                                   torch.tensor(1.0), ot)
    jax.block_until_ready(sj.pos)
    a, b = host_view(sj), state_to_numpy(st)
    _assert_states_close(a, b, d["pos"])
    _assert_stats_close(stats_t, stats_j)
    # no pass ran: lattice neighbours 17 px apart came closer than the
    # collision distance (16 px) without being pushed back
    p = b["pos"][0, :600]
    gap = np.sqrt(((p[:, None] - p[None]) ** 2).sum(-1))
    assert gap[np.triu_indices(600, 1)].min() < 16.0


def test_post_solve_matches_jax():
    """``post_solve``: the true velocity and the centroid / max-speed
    aggregates (reference :1669-1718), against JAX's on a seeded state."""
    rng = np.random.default_rng(11)
    pos = rng.uniform(0, 300, (512, 2)).astype(np.float32)
    prev = (pos - rng.uniform(-2, 2, (512, 2))).astype(np.float32)
    act = np.arange(512) < 400
    slot = rng.integers(0, 4, 512).astype(np.int32)
    want = jsolver.post_solve(jnp.asarray(pos), jnp.asarray(prev),
                              jnp.asarray(act), jnp.asarray(slot),
                              jnp.float32(1 / 120), 4)
    got = tsolver.post_solve(torch.from_numpy(pos), torch.from_numpy(prev),
                             torch.from_numpy(act), torch.from_numpy(slot),
                             torch.tensor(1 / 120), 4)
    for g, w, tol in zip(got, want, (0.0, 1e-4, 1e-3)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=tol)
    assert (got[0].numpy()[~act] == 0).all()
