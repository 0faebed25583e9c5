"""The plane-resident dense step of the PyTorch port against the JAX package.

Both packages start from the same state and run 3 steps of ``step`` with
the JAX default ``budget_mode="ordered"`` (the port's plane path: ordered
binning, kernel F's count, kernel D's sweep), on the lattice scene of
``tests/test_torch_step.py`` and dense grid G = 64, K = 4 (K = 2 for the
modes, see ``test_plane_modes_three_steps_match_jax``):

- with the wide sweep statically off and with the violence gate at its
  default;
- on a small packed scene (100 whites in one batch) where the reference's
  0.05 n^2 examined-pair cutoff binds;
- with ``dense_rebin="substep"`` (a binning per substep) and
  ``dense_rebin="pass"`` (the per-pass route: ``substep`` /
  ``solve_pairs_dense``);
- with ``sweep_symmetric=True``: off the TPU the JAX package runs its
  one-sided golden model there, the port its symmetric sweep (kernel E's
  plain version), the same sums to rounding;
- with ``stale_hash_compat=True`` (plane path, and the fused path with the
  budget off) and ``cohesion_mode="literal"``.

The JAX step is pinned to its CPU plane path (the session-wide interpret
switch of ``tests/test_fused_path.py`` is turned off here). Tolerances are
those of ``tests/test_torch_step.py``: in-grid sets equal, positions and
previous positions atol 1e-3 px, velocities atol 0.2 px/s.

Also: a handler pair stepping with ``budget_mode="ordered"`` through
``update`` (positions atol 1e-3 px).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu import state as jstate
from egg_fluid_simulation_tpu.ops import dense as jdense
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch.interop import (state_from_numpy,
                                                    state_to_numpy)
from egg_fluid_simulation_tpu_torch.ops import solver as tsolver
from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as tsweep

from test_torch_step import _configs, lattice_state

G, K = 64, 4
CELL = (8.0, 12.0)      # default white / yolk cell size (px)


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


def packed_state(cap=2048, n_batches=4, seed=1):
    """100 whites and 16 yolks jittered on 5 / 7 px lattices in one batch,
    pulled toward its centre: the examined-pair count exceeds 0.05 n^2."""
    rng = np.random.RandomState(seed)
    d = {k: np.array(v) for k, v in
         vars(jstate.zeros_state(cap, n_batches)).items()}
    for pop, (m, s) in enumerate(((10, 5.0), (4, 7.0))):
        ij = np.stack(np.meshgrid(np.arange(m), np.arange(m)), -1)
        p = (ij.reshape(-1, 2) * s + 100.0
             + rng.uniform(-1.0, 1.0, (m * m, 2))).astype(np.float32)
        n = len(p)
        for f in ("pos", "prev", "last_pos"):
            d[f][pop, :n] = p
        d["mass_t"][pop, :n] = rng.uniform(0.0, 1.0, n)
        d["radius"][pop, :n] = 4.0
        d["count"][pop] = n
    d["batch_target"][0] = [130.0, 130.0]
    d["batch_radius"][:, 0] = [64.0, 16.0]
    d["batch_used"][0] = True
    return d


def _in_grid(pos, count, pop, rotate, k):
    """Per-particle in-grid flags of the JAX binning of ``pos``."""
    n = int(count[pop])
    b = jdense.bin_to_planes(
        jnp.asarray(pos[pop]), jnp.ones(pos.shape[1]), jnp.ones(pos.shape[1]),
        jnp.zeros(pos.shape[1], jnp.int32), jnp.arange(pos.shape[1]) < n,
        jnp.float32(CELL[pop]), grid_dim=G, slots_per_cell=k, rotate=rotate)
    return np.asarray(b.slot)[:n] < G * G * k


def _strong(ws):
    """The JAX gate state with weak types dropped, so the next step call
    reuses the compiled step."""
    return tuple(tuple(jnp.asarray(v, dtype=v.dtype) for v in w) for w in ws)


def run_both(d, n_steps=3, **kw):
    kw = dict(dict(engine="dense", dense_grid_dim=G, dense_slots=K,
                   wide_budget_substeps=0), **kw)
    oj, ot = jsolver.SolverOptions(**kw), tsolver.SolverOptions(**kw)
    sj = jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()})
    st = state_from_numpy(d)
    cj, ct = _configs()
    wj = (jsolver.wide_state_init(oj),) * 2
    wt = (tsolver.wide_state_init(ot),) * 2
    for _ in range(n_steps):
        sj, _, wj = jsolver.step(sj, cj, jnp.float32(1 / 60),
                                 jnp.float32(1.0), oj, wide_state=wj)
        wj = _strong(wj)
        st, _, wt = tsolver.step(st, ct, torch.tensor(1 / 60),
                                 torch.tensor(1.0), ot, wide_state=wt)
    a = {k: np.asarray(jax.block_until_ready(v)) for k, v in vars(sj).items()}
    b = state_to_numpy(st)
    for pop in (0, 1):
        assert [int(x) for x in wt[pop]] == [int(x) for x in wj[pop]]
    return a, b, ot


def assert_states_match(a, b, d, ot):
    rotate, k = ot.budget_mode == "off", ot.dense_slots[0]
    for pop in (0, 1):
        np.testing.assert_array_equal(
            _in_grid(b["pos"], b["count"], pop, rotate, k),
            _in_grid(a["pos"], a["count"], pop, rotate, k))
    np.testing.assert_allclose(b["pos"], a["pos"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(b["prev"], a["prev"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(b["vel"], a["vel"], rtol=0, atol=0.2)
    assert np.abs(b["pos"] - d["pos"]).max() > 1.0      # the scene moved


@pytest.mark.parametrize("wide_budget", [0, 240],
                         ids=["wide_off", "wide_default"])
def test_ordered_budget_three_steps_match_jax(wide_budget):
    d = lattice_state()
    before = tsweep.count_launches
    a, b, ot = run_both(d, wide_budget_substeps=wide_budget)
    assert ot.budget_mode == "ordered"
    assert not tsolver._fused_component_path(ot)
    assert tsweep.count_launches == before    # CPU: plain versions only
    assert_states_match(a, b, d, ot)


def test_ordered_cutoff_binds_on_packed_scene():
    d = packed_state()
    # the JAX count of examined pairs of the first binning exceeds the
    # reference's 0.05 n^2 budget in both populations
    for pop in (0, 1):
        n = int(d["count"][pop])
        b = jdense.bin_to_planes(
            jnp.asarray(d["pos"][pop]), jnp.ones(d["pos"].shape[1]),
            jnp.full(d["pos"].shape[1], 4.0),
            jnp.zeros(d["pos"].shape[1], jnp.int32),
            jnp.arange(d["pos"].shape[1]) < n, jnp.float32(CELL[pop]),
            grid_dim=G, slots_per_cell=K)
        total = float(jnp.sum(jdense.count_planes_jnp(b.planes, K)))
        assert total > 0.05 * n * n, (pop, total, n)
    a, b, ot = run_both(d)
    assert_states_match(a, b, d, ot)


@pytest.mark.parametrize("kw", [
    dict(dense_rebin="substep"),
    dict(dense_rebin="pass"),
    dict(sweep_symmetric=True),
    dict(stale_hash_compat=True),
    pytest.param(dict(stale_hash_compat=True, budget_mode="off"),
                 marks=pytest.mark.slow),
    dict(cohesion_mode="literal"),
], ids=["rebin_substep", "rebin_pass", "symmetric", "stale_hash_ordered",
        "stale_hash_fused", "cohesion_literal"])
def test_plane_modes_three_steps_match_jax(kw):
    """K = 2 here: the JAX step unrolls 4K - 1 lane offsets per sweep, and
    K = 2 halves its compile time; the sweeps at K = 4 are held to JAX in
    test_torch_plane_sweep.py and by the ordered-budget runs above."""
    d = lattice_state()
    a, b, ot = run_both(d, dense_slots=2, **kw)
    assert tsolver._fused_component_path(ot) == (
        kw.get("budget_mode") == "off")
    assert_states_match(a, b, d, ot)


def test_handler_pair_steps_with_ordered_budget():
    # the capacities and options of the lattice runs above, so the JAX
    # step's compilation is shared
    opts = dict(engine="dense", budget_mode="ordered", dense_rebin="step",
                dense_grid_dim=G, dense_slots=K, wide_budget_substeps=0)
    hj = J.SimulationHandler(J.default_white_config(), J.default_yolk_config(),
                             capacity=2048, max_batches=4,
                             options=J.SolverOptions(**opts))
    ht = T.SimulationHandler(T.default_white_config(), T.default_yolk_config(),
                             capacity=2048, max_batches=4,
                             options=T.SolverOptions(**opts), device="cpu")
    specs = [dict(x=120.0, y=110.0, white_radius=64.0, yolk_radius=16.0,
                  white_n_particles=40, yolk_n_particles=4),
             dict(x=300.0, y=160.0, white_radius=48.0, yolk_radius=16.0,
                  white_n_particles=24, yolk_n_particles=4)]
    for h in (hj, ht):
        h.add_many(specs)
        h.set_target_position(1, 130.0, 120.0)
        h.update(1 / 60)
        h.step_once()
    a, b = host_view(hj.state), state_to_numpy(ht.state)
    np.testing.assert_allclose(b["pos"], a["pos"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(b["prev"], a["prev"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(b["vel"], a["vel"], rtol=0, atol=0.2)
    assert np.abs(b["pos"] - b["last_pos"]).max() > 0.1
