"""The port's solver pieces against the JAX package's on the cases of
``tests/test_solver_units.py``: the same numpy inputs through both
packages' ``strength_to_compliance``, ``pre_solve``, ``solve_follow``,
``solve_pairs`` (the two-particle cases the JAX file holds to its
``OracleSim``), ``post_solve``, ``batch_segment_sums`` and
``take_batch_rows``, and the wide gate's episode budget across handler
calls. Pieces within rtol 1e-6 / atol 1e-5 of each other (one pass: the
port's sums run in another order); the episode state equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egg_fluid_simulation_tpu import config as jconfig
from egg_fluid_simulation_tpu.ops import solver as JS
from egg_fluid_simulation_tpu_torch import config as tconfig
from egg_fluid_simulation_tpu_torch.ops import solver as TS

import torch_twins as TW

RTOL, ATOL = 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    TW.pin_plane_path(monkeypatch)


def _cfgs(**overrides):
    out = []
    for mod in (jconfig, tconfig):
        d = mod.default_white_config()
        d.update(overrides)
        out.append(mod.device_config_from_dict(d))
    return out


def _close(got, want, rtol=RTOL, atol=ATOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol)


def _pair_of(*arrays):
    """Each numpy array as (jax array, torch tensor)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def test_strength_to_compliance_as_jax():
    for s, dt in ((0.8, 0.01), (1.5, 0.1), (-0.5, 1 / 120), (0.9975, 1 / 120)):
        want = JS.strength_to_compliance(jnp.float32(s), jnp.float32(dt))
        got = TS.strength_to_compliance(torch.tensor(s), torch.tensor(dt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


PRE_SOLVE = {
    "integration": (dict(damping=0.25, min_mass=2.0, max_mass=4.0,
                         min_radius=3.0, max_radius=5.0),
                    [[10.0, 20.0]], [[100.0, -40.0]], [True]),
    "inactive_untouched": (dict(), [[1.0, 2.0]], [[5.0, 5.0]], [False]),
}


@pytest.mark.parametrize("case", sorted(PRE_SOLVE))
def test_pre_solve_as_jax(case):
    """``test_pre_solve_integration_and_damping`` and
    ``test_pre_solve_inactive_untouched``."""
    over, pos, vel, act = PRE_SOLVE[case]
    cj, ct = _cfgs(**over)
    (pj, vj, mj, aj), (pt, vt, mt, at) = _pair_of(
        np.asarray(pos, np.float32), np.asarray(vel, np.float32),
        np.asarray([0.5], np.float32), np.asarray(act))
    want = JS.pre_solve(pj, pj, vj, mj, aj, cj, jnp.float32(0.1))
    got = TS.pre_solve(pt, pt, vt, mt, at, ct, torch.tensor(0.1))
    _close(got, want)


FOLLOW = {
    # (position, inverse mass, follow radius sqrt(batch_radius), compliance)
    "dead_zone": ([[10.0, 0.0]], 1.0, 7.0, 0.0),
    "xpbd_magnitude": ([[10.0, 0.0]], 0.5, 2.0, 1.5),
    "infinite_mass_pinned": ([[50.0, 0.0]], 0.0, 1.0, 0.0),
}


@pytest.mark.parametrize("case", sorted(FOLLOW))
def test_solve_follow_as_jax(case):
    """``test_follow_dead_zone``, ``test_follow_xpbd_magnitude`` and
    ``test_follow_infinite_mass_pinned``."""
    pos, w, frad, alpha = FOLLOW[case]
    (pj, wj, sj, aj, tj, fj), (pt, wt, st, at, tt, ft) = _pair_of(
        np.asarray(pos, np.float32), np.asarray([w], np.float32),
        np.zeros(1, np.int32), np.ones(1, bool), np.zeros((1, 2), np.float32),
        np.asarray([frad], np.float32))
    want = JS.solve_follow(pj, wj, sj, aj, tj, fj, jnp.float32(alpha))
    got = TS.solve_follow(pt, wt, st, at, tt, ft, torch.tensor(alpha))
    _close([got], [want])


# the two-particle cases: (p0, p1, w0, w1, collision strength)
PAIRS = {
    "oracle_enforce_distance": ([0.0, 0.0], [6.0, 0.0], 1.0, 1.0, 0.9975),
    "mass_ratio": ([0.0, 0.0], [6.0, 0.0], 1.0, 3.0, 0.9975),
    "non_overlapping": ([0.0, 0.0], [100.0, 0.0], 1.0, 1.0, 0.9975),
    "coincident_no_nan": ([5.0, 5.0], [5.0, 5.0], 1.0, 1.0, 0.9975),
    "infinite_masses_skipped": ([0.0, 0.0], [6.0, 0.0], 0.0, 0.0, 0.9975),
    "clamped_to_violation": ([0.0, 0.0], [0.5, 0.0], 1.0, 1.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_two_particle_pass_as_jax(case):
    """The six two-particle ``solve_pairs`` cases (r = 4, overlap factor
    2, literal cohesion, one pass at sub_dt 1/120)."""
    p0, p1, w0, w1, strength = PAIRS[case]
    r = 4.0
    cj, ct = _cfgs(collision_strength=strength, collision_overlap_factor=2.0,
                   cohesion_interaction_distance_factor=0.0,
                   min_radius=r, max_radius=r)
    (pj, wj, rj, bj, aj), (pt, wt, rt, bt, at) = _pair_of(
        np.asarray([p0, p1], np.float32), np.asarray([w0, w1], np.float32),
        np.full(2, r, np.float32), np.zeros(2, np.int32), np.ones(2, bool))
    kw = dict(table_size=256, slots_per_cell=8, cohesion_mode="literal")
    sub_dt = 1 / 120
    want = JS.solve_pairs(pj, wj, rj, bj, aj, cj,
                          JS.strength_to_compliance(cj.collision_strength,
                                                    jnp.float32(sub_dt)),
                          jnp.float32(0.0), jnp.float32(1.0),
                          JS.SolverOptions(**kw))
    got = TS.solve_pairs(pt, wt, rt, bt, at, ct,
                         TS.strength_to_compliance(ct.collision_strength,
                                                   torch.tensor(sub_dt)),
                         torch.tensor(0.0), torch.tensor(1.0),
                         TS.SolverOptions(**kw))
    assert np.isfinite(got.numpy()).all()
    _close([got], [want])


def test_post_solve_and_batch_sums_as_jax():
    """``test_post_solve_velocity_and_batch_sums``."""
    (pj, prj, aj, sj), (pt, prt, at, st) = _pair_of(
        np.asarray([[2.0, 0.0], [0.0, 4.0], [9.0, 9.0]], np.float32),
        np.zeros((3, 2), np.float32), np.asarray([True, True, False]),
        np.asarray([0, 1, 1], np.int32))
    want = JS.post_solve(pj, prj, aj, sj, jnp.float32(0.5), 4)
    got = TS.post_solve(pt, prt, at, st, torch.tensor(0.5), 4)
    _close(got, want)
    _close(TS.batch_segment_sums(pt, at, st, 4),
           JS.batch_segment_sums(pj, aj, sj, 4))


def test_take_batch_rows_as_jax():
    """``test_take_batch_rows_exact``: the port's gather is exact; the
    JAX package's bf16 hi/lo product keeps ~16 bits of each value (2^-17
    of 1e4 is 0.08), so the two agree to that."""
    rng = np.random.default_rng(3)
    table = rng.uniform(-1e4, 1e4, (256, 3)).astype(np.float32)
    idx = rng.integers(0, 256, (1000,)).astype(np.int32)
    (tj, ij), (tt, it) = _pair_of(table, idx)
    got = TS.take_batch_rows(tt, it).numpy()
    np.testing.assert_array_equal(got, table[idx])
    np.testing.assert_allclose(got, np.asarray(JS.take_batch_rows(tj, ij)),
                               rtol=2.0 ** -16, atol=0)


WIDE = dict(engine="dense", budget_mode="off", dense_rebin="step",
            dense_grid_dim=32, dense_slots=8, use_pallas=False,
            adaptive_rebin=False, wide_budget_substeps=6,
            wide_rearm_substeps=4)


def _wide(h):
    return [[int(x) for x in w] for w in h._wide_state]


@pytest.mark.slow
def test_wide_episode_budget_and_rearm_as_jax():
    """``test_wide_episode_budget_and_rearm`` (slow, as in the JAX suite:
    ~6 min on one CPU thread, most of it the resident loops of
    ``run_steps``): a violent spawn drains the episode budget across
    ``step_once`` calls; a calm scene keeps it and re-arms a drained one
    over ``run_steps``. Each call starts both handlers from the JAX state
    and episode state; the episode states after it are equal (the dense
    route's positions are not held across several steps: ROADMAP Queue 3
    item 4)."""
    hj, ht = TW.pair(capacity=512, max_batches=8, options=WIDE)
    TW.both(hj, ht, "add", 100.0, 100.0, 18.0, 6.0, None, None, 120, 8)
    for _ in range(3):
        TW.carry(hj, ht)
        hj.step_once()
        ht.step_once()
        assert _wide(ht) == _wide(hj)
    assert _wide(hj)[0][1] < 6
    hj, ht = TW.pair(capacity=512, max_batches=8, options=WIDE)
    TW.both(hj, ht, "add", 100.0, 100.0, 60.0, 6.0, None, None, 30, 4)
    for n, drained in ((5, False), (10, True)):
        if drained:
            hj._wide_state = ((jnp.bool_(False), jnp.int32(0),
                               jnp.int32(0)), hj._wide_state[1])
        TW.carry(hj, ht)
        hj.run_steps(n)
        ht.run_steps(n)
        assert _wide(ht) == _wide(hj)
    assert _wide(hj)[0][1] == 6
