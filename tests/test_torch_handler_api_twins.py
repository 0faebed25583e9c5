"""The port's ``SimulationHandler`` API against the JAX handler's: one twin
for each case of ``tests/test_handler.py``.

Both handlers take the same calls (``torch_twins.both``) and what they
return is compared, not the JAX test's expectations: exceptions of the same
type with the same message (the ``In <file>:<line>:`` call site
normalised), the same warning lines and counts, the host state
(``host_view``) bit for bit where host code decides it, ``get_position``
within 1e-3 px. Updates run step-locked (``torch_twins.step_locked``):
each from the JAX state, pos / prev 1e-3 px, vel 0.2 px/s, or a rounding
flip the harness names.
"""

import numpy as np
import pytest
import torch

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch.interop import state_to_numpy
from egg_fluid_simulation_tpu_torch.utils.lockstep import POS_TOL
from egg_fluid_simulation_tpu_torch.utils.log import SimulationError

import torch_twins as TW

GATHER_256 = dict(engine="gather", table_size=1024, slots_per_cell=8)


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    TW.pin_plane_path(monkeypatch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(**kw):
    kw.setdefault("capacity", 1024)
    kw.setdefault("max_batches", 16)
    return TW.pair(**kw)


def _same_state(hj, ht):
    a, b = host_view(hj.state), state_to_numpy(ht.state)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert b[k].dtype == a[k].dtype, k
    assert ht.list_ids() == hj.list_ids()
    assert ht.get_n_particles() == hj.get_n_particles()


def _same_positions(hj, ht):
    for bid in hj.list_ids():
        np.testing.assert_allclose(ht.get_position(bid), hj.get_position(bid),
                                   rtol=0, atol=POS_TOL)


# --------------------------------------------------------- construction --

@pytest.mark.parametrize("case", ["one_config", "not_a_table"])
def test_constructor_as_jax(case):
    """tests/test_handler.py ``test_constructor_single_config_reused_for_yolk``
    and ``test_constructor_rejects_non_table``."""
    if case == "one_config":
        hj = J.SimulationHandler(J.default_white_config(), capacity=64,
                                 max_batches=4)
        ht = T.SimulationHandler(T.default_white_config(), capacity=64,
                                 max_batches=4, device="cpu")
        assert ht.get_yolk_config() == hj.get_yolk_config()
        assert ht.get_white_config() == hj.get_white_config()
        _same_state(hj, ht)
        return
    _, ej, wj = TW.stderr_lines(lambda: J.SimulationHandler(3))
    _, et, wt = TW.stderr_lines(lambda: T.SimulationHandler(3, device="cpu"))
    assert type(et).__name__ == type(ej).__name__ == "SimulationError"
    assert TW.normalise(str(et)) == TW.normalise(str(ej))
    assert wt == wj


# ------------------------------------------------------------------ add --

ADD_CASES = {
    # test_add_particle_count_estimate
    "count_estimate": [(0.0, 0.0, 50.0, 15.0)],
    # test_add_default_radii
    "default_radii": [(0.0, 0.0)],
    # test_add_explicit_counts_and_errors
    "explicit_and_errors": [
        (10.0, 10.0, 10.0, 3.0, None, None, 20, 15),
        (0.0, 0.0, -5.0, 3.0),
        (0.0, 0.0, 10.0, 3.0, None, None, 1, 5),
        (0.0, 0.0, 10.0, 3.0, [1.0, 0.0, 0.0, float("nan")], None, 20, 15)],
    # test_add_low_count_warns
    "low_count_warns": [(0.0, 0.0, 10.0, 3.0, None, None, 5, 3)],
    # test_fibonacci_layout_within_radius
    "fibonacci_layout": [(100.0, 200.0, 30.0, 8.0, None, None, 40, 10)],
    # test_mass_distribution_butterworth
    "butterworth_masses": [(0.0, 0.0, 20.0, 6.0, None, None, 21, 5)],
}


@pytest.mark.parametrize("case", sorted(ADD_CASES))
def test_add_as_jax(case):
    """Each ``add`` returns the same id or raises the same error, with the
    same warnings, and leaves the same host state: spiral layout,
    butterworth masses, counts."""
    hj, ht = _pair()
    for args in ADD_CASES[case]:
        TW.both(hj, ht, "add", *args)
        _same_state(hj, ht)
    for bid in hj.list_ids():
        TW.both(hj, ht, "get_n_particles", bid)
    TW.both(hj, ht, "get_n_particles")


# --------------------------------------------------------------- remove --

def test_remove_compacts_and_remaps_as_jax():
    """tests/test_handler.py ``test_remove_compacts_and_remaps``."""
    hj, ht = _pair()
    a = TW.both(hj, ht, "add", 0.0, 0.0, 10.0, 3.0, None, None, 20, 15)
    b = TW.both(hj, ht, "add", 500.0, 0.0, 10.0, 3.0, None, None, 10, 8)
    TW.both(hj, ht, "add", 0.0, 500.0, 10.0, 3.0, None, None, 12, 6)
    TW.both(hj, ht, "remove", b)
    _same_state(hj, ht)
    _same_positions(hj, ht)
    TW.both(hj, ht, "get_target_position", a)


@pytest.mark.parametrize("case", ["unknown_warns", "reuse_capacity",
                                  "capacity_fatal"])
def test_remove_and_capacity_as_jax(case):
    """``test_remove_unknown_warns``, ``test_remove_then_add_reuses_capacity``
    and ``test_capacity_exhaustion_fatal``."""
    if case == "unknown_warns":
        hj, ht = _pair()
        TW.both(hj, ht, "remove", 99)
    elif case == "reuse_capacity":
        hj, ht = _pair(capacity=64, max_batches=2)
        for _ in range(5):
            bid = TW.both(hj, ht, "add", 0.0, 0.0, 10.0, 3.0, None, None, 30,
                          20)
            TW.both(hj, ht, "remove", bid)
            _same_state(hj, ht)
        TW.both(hj, ht, "add", 0.0, 0.0, 10.0, 3.0, None, None, 30, 20)
    else:
        hj, ht = _pair(capacity=32, max_batches=4)
        assert isinstance(TW.both(hj, ht, "add", 0.0, 0.0, 10.0, 3.0, None,
                                  None, 40, 5), SimulationError)
    _same_state(hj, ht)


# ------------------------------------------------------ targets, colours --

def test_targets_as_jax():
    """``test_target_roundtrip_and_unknown``."""
    hj, ht = _pair()
    bid = TW.both(hj, ht, "add", 1.0, 2.0, 10.0, 3.0, None, None, 10, 5)
    TW.both(hj, ht, "get_target_position", bid)
    TW.both(hj, ht, "set_target_position", bid, 7.0, 8.0)
    assert TW.both(hj, ht, "get_target_position", bid) == (7.0, 8.0)
    TW.both(hj, ht, "get_target_position", 1234)
    TW.both(hj, ht, "set_target_position", 1234, 0.0, 0.0)
    np.testing.assert_array_equal(ht._host_targets, hj._host_targets)


def test_colours_as_jax():
    """``test_set_colors``."""
    hj, ht = _pair()
    hj._use_particle_color = ht._use_particle_color = True
    bid = TW.both(hj, ht, "add", 0.0, 0.0, 10.0, 3.0, None, None, 10, 5)
    TW.both(hj, ht, "set_yolk_color", bid, 0.2, 0.4, 0.6, 0.8)
    TW.both(hj, ht, "set_white_color", bid, 1.5, -0.5, 0.5)
    TW.both(hj, ht, "set_white_color", 777, 1.0, 1.0, 1.0)
    _same_state(hj, ht)


def test_get_position_as_jax():
    """``test_get_position_mixes_white_and_yolk``."""
    hj, ht = _pair()
    bid = TW.both(hj, ht, "add", 50.0, 60.0, 10.0, 3.0, None, None, 10, 5)
    _same_positions(hj, ht)
    TW.both(hj, ht, "get_position", 123)


# --------------------------------------------------------------- update --

UPDATE_ERRORS = [(0.016, -1.0), (0.016, 1 / 60, 0), (0.016, 1 / 60, 2, 0)]


def test_update_validation_as_jax():
    """``test_update_validation``: the same error for each bad argument,
    and nothing stepped."""
    hj, ht = _pair()
    TW.both(hj, ht, "add", 0.0, 0.0, 10.0, 3.0, None, None, 10, 5)
    for args in UPDATE_ERRORS:
        assert isinstance(TW.both(hj, ht, "update", *args),
                          SimulationError)
    _same_state(hj, ht)


# (update arguments, calls): test_update_fixed_timestep_accumulator,
# test_update_death_spiral_cap, test_float_substep_counts_ceiled
ACCUMULATOR_CASES = {
    "accumulator": ((0.01, 1 / 60), 2),
    "death_spiral": ((10.0, 1 / 60), 1),
    "float_substeps": ((1 / 30, 1 / 60, 1.5, 2.2), 1),
}


@pytest.mark.parametrize("case", sorted(ACCUMULATOR_CASES))
def test_update_fixed_step_as_jax(case):
    """The fixed-step accumulator, the death-spiral cap and ceiled float
    substep counts: the same steps run (step-locked), the same
    interpolation alpha and accumulator, the same options."""
    args, calls = ACCUMULATOR_CASES[case]
    hj, ht = _pair()
    TW.both(hj, ht, "add", 0.0, 0.0, 10.0, 3.0, None, None, 10, 5)
    rep = TW.step_locked(hj, ht, calls, advance=lambda h: h.update(*args),
                         step_delta=args[1])
    assert ht.interpolation_alpha == hj.interpolation_alpha
    assert ht._options.n_substeps == hj._options.n_substeps
    assert ht._options.n_collision_steps == hj._options.n_collision_steps
    assert not rep.flips, TW.flip_lines(rep)


def test_config_hot_reload_as_jax():
    """``test_config_hot_reload_rederives_mass_radius``: radii re-derived
    alike after a config change and one update."""
    hj, ht = _pair()
    TW.both(hj, ht, "add", 0.0, 0.0, 20.0, 6.0, None, None, 20, 10)
    TW.both(hj, ht, "set_white_config", {"min_radius": 8.0, "max_radius": 8.0})
    TW.step_locked(hj, ht, 1, advance=lambda h: h.update(1 / 30))
    np.testing.assert_array_equal(ht.state.radius.numpy(),
                                  np.asarray(hj.state.radius))


def test_get_config_copies_as_jax():
    """``test_get_config_is_isolated_copy``."""
    hj, ht = _pair()
    for h in (hj, ht):
        cfg = h.get_white_config()
        cfg["damping"] = 0.999
        cfg["color"][0] = 0.0
    assert ht.get_white_config() == hj.get_white_config()
    assert ht.get_yolk_config() == hj.get_yolk_config()


@pytest.mark.parametrize("case", ["fluid_swap", "dragged_target"])
def test_updates_step_locked_as_jax(case):
    """``test_fluid_config_swap_runs`` (5 updates after both configs are
    swapped for ``fluid_config``) and ``test_simulation_stays_finite_with_
    motion`` (30 updates, the target dragged each), step-locked."""
    hj, ht = _pair()
    if case == "fluid_swap":
        TW.both(hj, ht, "add", 0.0, 0.0, 20.0, 6.0, None, None, 30, 10)
        TW.both(hj, ht, "set_white_config", J.fluid_config())
        TW.both(hj, ht, "set_yolk_config", J.fluid_config())
        assert ht.get_white_config() == hj.get_white_config()
        rep = TW.step_locked(hj, ht, 5)
    else:
        bid = TW.both(hj, ht, "add", 0.0, 0.0, 30.0, 9.0, None, None, 60, 15)
        rep = TW.step_locked(hj, ht, 30, drive=lambda h, i: h.set_target_position(
            bid, 10.0 * i, 5.0 * i))
    assert rep.steps == (5 if case == "fluid_swap" else 30)
    assert np.isfinite(ht.state.pos.numpy()).all()


def test_warmup_as_jax():
    """``test_warmup_has_no_side_effects``: state, alpha and accumulator
    as the JAX handler leaves them."""
    hj, ht = _pair(canvas_size=128)
    TW.both(hj, ht, "add", 10.0, 10.0, 10.0, 3.0, None, None, 10, 5)
    TW.both(hj, ht, "warmup", viewport=(0.0, 0.0, 128, 128))
    _same_state(hj, ht)
    assert (ht.interpolation_alpha, ht._elapsed) == \
        (hj.interpolation_alpha, hj._elapsed)


def test_update_kwarg_alternation_as_jax():
    """``test_update_kwarg_alternation_compiles_once_per_variant``: the
    JAX test counts compiles; its twin holds each update of the same
    calls (an update without ``n_substeps`` keeps the last one, in both
    packages)."""
    hj, ht = TW.pair(capacity=256, max_batches=4, options=GATHER_256)
    TW.both(hj, ht, "add", 10.0, 10.0, 15.0, 5.0, None, None, 20, 5)
    calls = [dict(), dict(n_substeps=3)] * 5
    rep = None
    for kw in calls:
        rep = TW.step_locked(hj, ht, 1, advance=lambda h: h.update(1 / 30,
                                                                   **kw),
                             report=rep)
        assert ht._options.n_substeps == hj._options.n_substeps
    assert rep.steps == len(calls)


def test_run_steps_threads_wide_state_as_jax():
    """``test_run_steps_gather_engine_threads_wide_state``: ``run_steps(3)``
    on the gather engine, state within the whole-step tolerances and the
    episode state handed through alike."""
    hj, ht = TW.pair(capacity=256, max_batches=4, options=GATHER_256)
    TW.both(hj, ht, "add", 10.0, 10.0, 15.0, 5.0, None, None, 20, 5)
    TW.step_locked(hj, ht, 1, advance=lambda h: h.run_steps(3))
    assert [[int(x) for x in w] for w in ht._wide_state] == \
        [[int(x) for x in w] for w in hj._wide_state]


# ------------------------------------------------------------- add_many --

SPECS = [dict(x=50.0 + 90 * b, y=60.0, white_radius=30.0, yolk_radius=9.0,
              white_n_particles=40, yolk_n_particles=6) for b in range(3)]


def test_add_many_as_jax():
    """``test_add_many_matches_sequential_add``: ``add_many`` in the port
    against the JAX handler's sequential adds, bit for bit, then 3
    ``run_steps`` step-locked."""
    hj, ht = _pair()
    ids_j = [hj.add(**s) for s in SPECS]
    assert ht.add_many(SPECS) == ids_j
    _same_state(hj, ht)
    TW.step_locked(hj, ht, 1, advance=lambda h: h.run_steps(3))


def test_add_many_after_remove_as_jax():
    """``test_add_many_after_remove_zeroes_stale_rows``."""
    hj, ht = _pair()
    a = TW.both(hj, ht, "add", 100.0, 100.0, 30.0, 9.0, None, None, 40, 6)
    TW.both(hj, ht, "add", 300.0, 100.0, 30.0, 9.0, None, None, 40, 6)
    TW.step_locked(hj, ht, 5, advance=lambda h: h.run_steps(1))
    TW.carry(hj, ht)
    TW.both(hj, ht, "remove", a)
    TW.both(hj, ht, "add_many", [dict(x=500.0, y=100.0, white_radius=30.0,
                                      yolk_radius=9.0, white_n_particles=40,
                                      yolk_n_particles=6)])
    _same_state(hj, ht)


def test_add_many_capacity_error_as_jax():
    """``test_add_many_capacity_error_is_atomic``."""
    hj, ht = _pair()
    big = dict(white_radius=30.0, yolk_radius=9.0, white_n_particles=600,
               yolk_n_particles=6)
    err = TW.both(hj, ht, "add_many", [dict(x=0.0, y=0.0, **big),
                                       dict(x=90.0, y=0.0, **big)])
    assert isinstance(err, SimulationError)
    _same_state(hj, ht)
