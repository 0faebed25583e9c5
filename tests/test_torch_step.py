"""Whole solver step of the PyTorch port against the JAX package.

Both packages start from the same state (``interop.state_from_numpy`` on
the JAX state's host view) and run 3 steps with
``SolverOptions(engine="dense", budget_mode="off", dense_rebin="step",
dense_grid_dim=64, dense_slots=4)``, with the wide sweep statically off
(``wide_budget_substeps=0``) and at its default (240, the violence gate).

Off the TPU the JAX ``step`` runs the legacy plane path (pinned here: the
session-wide interpret switch of ``tests/test_fused_path.py`` is turned off
for these tests), the port the fused component path: algorithms that agree
to rounding. The scene is a lattice pulled toward its targets without
spawn overlap, so rounding differences are not amplified chaotically.
Tolerances are those of ``tests/test_fused_path.py`` (fused vs plane path):
in-grid sets equal, positions and previous positions atol 1e-3 px,
velocities atol 0.2 px/s. The step stats (centroid, AABB) atol 1e-3 px;
``max_velocity`` is a maximum of speeds and carries the velocity tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egg_fluid_simulation_tpu import config as jconfig
from egg_fluid_simulation_tpu import state as jstate
from egg_fluid_simulation_tpu.ops import dense as jdense
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu_torch import config as tconfig
from egg_fluid_simulation_tpu_torch.interop import (state_from_numpy,
                                                    state_to_numpy)
from egg_fluid_simulation_tpu_torch.ops import solver as tsolver

G, K = 64, 4


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


def lattice_state(cap=2048, n_batches=4, seed=0):
    """600 whites on a 17 px hex lattice and 60 yolks on a 25 px grid, at
    rest, two batches with integer targets (exact in the JAX package's
    16-bit per-batch table gather) and radii whose square roots are exact."""
    rng = np.random.RandomState(seed)
    d = {k: np.array(v) for k, v in
         vars(jstate.zeros_state(cap, n_batches)).items()}
    nw, ny, s = 600, 60, 17.0
    m = int(np.ceil(np.sqrt(nw)))
    ij = np.stack(np.meshgrid(np.arange(m), np.arange(m)), -1).reshape(-1, 2)
    pw = (ij[:nw] * s + 40.0 + (ij[:nw, 1:2] % 2) * np.array([s / 2, 0.0]))
    ij = np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1).reshape(-1, 2)
    py = ij[:ny] * 25.0 + 150.0
    for pop, p in ((0, pw.astype(np.float32)), (1, py.astype(np.float32))):
        n = len(p)
        for f in ("pos", "prev", "last_pos"):
            d[f][pop, :n] = p
        d["mass_t"][pop, :n] = rng.uniform(0.0, 1.0, n)
        d["radius"][pop, :n] = 4.0
        d["batch_slot"][pop, :n] = rng.randint(0, 2, n)
    d["count"] = np.array([nw, ny], np.int32)
    d["batch_target"][:2] = [[200.0, 200.0], [150.0, 230.0]]
    d["batch_radius"][:, :2] = [[64.0, 64.0], [16.0, 16.0]]
    d["batch_used"][:2] = True
    return d


def _configs():
    j = jconfig.stack_device_configs(
        jconfig.device_config_from_dict(jconfig.default_white_config()),
        jconfig.device_config_from_dict(jconfig.default_yolk_config()))
    t = tconfig.stack_device_configs(
        tconfig.device_config_from_dict(tconfig.default_white_config()),
        tconfig.device_config_from_dict(tconfig.default_yolk_config()))
    return j, t


def _in_grid(pos, count, pop):
    """Per-particle in-grid flags of the JAX binning of ``pos``."""
    n = int(count[pop])
    b = jdense.bin_to_planes(
        jnp.asarray(pos[pop]), jnp.ones(pos.shape[1]), jnp.ones(pos.shape[1]),
        jnp.zeros(pos.shape[1], jnp.int32), jnp.arange(pos.shape[1]) < n,
        jnp.float32(8.0 if pop == 0 else 12.0), grid_dim=G, slots_per_cell=K,
        rotate=True)
    return np.asarray(b.slot)[:n] < G * G * K


@pytest.mark.parametrize("wide_budget", [0, 240], ids=["wide_off", "wide_default"])
def test_three_steps_match_jax(wide_budget):
    kw = dict(engine="dense", budget_mode="off", dense_rebin="step",
              dense_grid_dim=G, dense_slots=K, wide_budget_substeps=wide_budget)
    oj, ot = jsolver.SolverOptions(**kw), tsolver.SolverOptions(**kw)
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
    a = {k: np.asarray(jax.block_until_ready(v)) for k, v in vars(sj).items()}
    b = state_to_numpy(st)
    for pop in (0, 1):
        np.testing.assert_array_equal(_in_grid(b["pos"], b["count"], pop),
                                      _in_grid(a["pos"], a["count"], pop))
    np.testing.assert_allclose(b["pos"], a["pos"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(b["prev"], a["prev"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(b["vel"], a["vel"], rtol=0, atol=0.2)
    np.testing.assert_array_equal(b["last_pos"] != 0, a["last_pos"] != 0)
    for f, tol in (("centroid", 1e-3), ("last_centroid", 1e-3),
                   ("aabb_min", 1e-3), ("aabb_max", 1e-3),
                   ("max_velocity", 0.2), ("max_radius", 0.0),
                   ("batch_count", 0.0)):
        np.testing.assert_allclose(getattr(stats_t, f).numpy(),
                                   np.asarray(getattr(stats_j, f)),
                                   rtol=0, atol=tol, err_msg=f)
    # the particles moved, and the violence gate agrees step by step
    assert np.abs(b["pos"] - d["pos"]).max() > 1.0
    for pop in (0, 1):
        assert [int(x) for x in wt[pop]] == [int(x) for x in wj[pop]]
    if wide_budget:
        assert int(wt[0][1]) < wide_budget   # the wide sweep ran


def test_take_batch_rows_and_segment_sums():
    rng = np.random.RandomState(0)
    table = rng.randint(0, 4000, (16, 3)).astype(np.float32)
    idx = rng.randint(0, 16, 5000).astype(np.int32)
    got = tsolver.take_batch_rows(torch.from_numpy(table), torch.from_numpy(idx))
    want = jsolver.take_batch_rows(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pos = rng.uniform(0, 512, (5000, 2)).astype(np.float32)
    act = rng.rand(5000) < 0.8
    s_t, c_t = tsolver.batch_segment_sums(torch.from_numpy(pos),
                                          torch.from_numpy(act),
                                          torch.from_numpy(idx), 16)
    s_j, c_j = jsolver.batch_segment_sums(jnp.asarray(pos), jnp.asarray(act),
                                          jnp.asarray(idx), 16)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    # the JAX sums keep ~16 bits per term (bf16 hi/lo one-hot product);
    # the port's index_add_ is float32: relative 1e-4
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4)


def test_unported_options_raise():
    """Every engine and mode of the JAX package builds in the port, the
    gather engine's JAX-written calls included; the values the JAX package
    refuses (an unknown mode, a table size that is not a power of two, the
    stale-hash emulation off the dense engine) the port refuses too, with
    ``ValueError``. ``n_collision_steps=0`` builds (zero passes)."""
    for kw in (dict(engine="gather"), dict(engine="dense"),
               dict(table_size=4096, slots_per_cell=32,
                    cohesion_mode="literal"),
               dict(budget_mode="off", pair_chunk=1024),
               dict(engine="dense", dense_rebin="substep"),
               dict(engine="dense", dense_rebin="pass"),
               dict(engine="dense", sweep_symmetric=True),
               dict(engine="dense", stale_hash_compat=True),
               dict(n_collision_steps=0),
               dict(engine="dense", n_collision_steps=0)):
        j, t = jsolver.SolverOptions(**kw), tsolver.SolverOptions(**kw)
        assert all(getattr(t, f) == getattr(j, f) == v for f, v in kw.items())
    for kw in (dict(engine="grid"), dict(budget_mode="none"),
               dict(dense_rebin="frame"), dict(cohesion_mode="off"),
               dict(table_size=3000), dict(stale_hash_compat=True),
               dict(engine="gather", stale_hash_compat=True)):
        with pytest.raises(AssertionError):
            jsolver.SolverOptions(**kw)
        with pytest.raises(ValueError):
            tsolver.SolverOptions(**kw)


def test_shared_option_defaults_match_jax():
    """One constructor call builds the same solver in both packages: the
    port has every field of the JAX SolverOptions, in the same order, and
    every default is the JAX package's, ``engine`` (the gather engine)
    included."""
    import dataclasses
    jf = [(f.name, f.default) for f in dataclasses.fields(jsolver.SolverOptions)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tsolver.SolverOptions)]
    assert tf == jf
    assert dict(tf)["engine"] == "gather"
    names = [n for n, _ in jf]
    j, t = jsolver.SolverOptions(), tsolver.SolverOptions()
    assert {f: getattr(t, f) for f in names} == \
        {f: getattr(j, f) for f in names}


@pytest.mark.parametrize("kw", [
    dict(engine="dense", use_pallas=False, budget_mode="off",
         dense_grid_dim=32, dense_slots=4, pop_caps=512),
    dict(engine="dense", use_pallas=True, budget_mode="ordered",
         dense_rebin="substep", dense_grid_dim=(64, 32), dense_slots=(4, 2),
         wide_budget_substeps=0, sweep_symmetric=True),
], ids=["pallas_off", "pallas_on"])
def test_jax_written_options_build_in_both_packages(kw):
    """A keyword set written for the JAX package (``use_pallas`` included)
    builds the port's options too, and every field the two share takes the
    same value. ``use_pallas`` has no effect in the port: the tensors'
    device picks kernel or plain version."""
    import dataclasses
    j, t = jsolver.SolverOptions(**kw), tsolver.SolverOptions(**kw)
    shared = ({f.name for f in dataclasses.fields(jsolver.SolverOptions)}
              & {f.name for f in dataclasses.fields(tsolver.SolverOptions)})
    assert set(kw) <= shared
    assert {f: getattr(t, f) for f in shared} == \
        {f: getattr(j, f) for f in shared}
