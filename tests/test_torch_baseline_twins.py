"""Baseline configs 1-3 of ``tests/test_baseline_scenarios.py`` (the
scenarios of ``BASELINE.json``) in the port against the JAX package, at
that file's sizes, steps, targets and ``Path`` drive
(``egg_fluid_simulation_tpu_torch.scenarios``); configs 4 and 5 are in
``test_torch_baseline_extremes_twins.py``.

- Step-locked (``torch_twins.step_locked``): every update starts both
  handlers from the JAX state; pos / prev 1e-3 px, vel 0.2 px/s, the
  host-decided fields bit for bit, stats 1e-3 px. A step past them passes
  only as a rounding flip that ``lockstep.explain`` names: the first
  collision pass where the two replays part, the same pass agreeing on the
  same input, and a particle's cell ``floor(pos / cell_size)`` whose JAX
  input lies within 4 float32 steps of the border. Free runs of the two
  packages part by tens of px within 60 steps (ROADMAP Queue 3 item 4), so
  they are not compared.
- The port's own free run through the JAX file's checks: ``validate_state``,
  the batch settled within 5 px of its target, the spread, the bounds.
"""

import numpy as np
import pytest
import torch

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu_torch import scenarios
from egg_fluid_simulation_tpu_torch.utils import profiling

import torch_twins as TW


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    TW.pin_plane_path(monkeypatch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def run_step_locked(name):
    """Scenario ``name`` in both packages, step-locked over its updates;
    returns the report (flips printed)."""
    sc = scenarios.SCENARIOS[name]
    hj, ids = scenarios.build(sc, J)
    ht, ids_t = scenarios.build(sc, T, device="cpu")
    assert ids_t == ids
    TW.assert_host_fields(TW.host_view(hj.state),
                          TW.state_to_numpy(ht.state))
    drive = None if sc.drive is None else (
        lambda h, i: sc.drive(h, ids, i))
    rep = TW.step_locked(hj, ht, sc.steps, drive=drive)
    for line in TW.flip_lines(rep):
        print(f"config {name}: {line}")
    assert rep.steps == sc.steps
    return rep, hj, ht


def free_run(name):
    sc = scenarios.SCENARIOS[name]
    h, ids = scenarios.build(sc, T, device="cpu")
    for i in range(sc.steps):
        if sc.drive is not None:
            sc.drive(h, ids, i)
        h.update(1 / 60)
    assert profiling.validate_state(h)
    return h, ids


@pytest.mark.parametrize("name", ["1", "2", "3"])
def test_config_step_locked_to_jax(name):
    rep, _, ht = run_step_locked(name)
    assert rep.pos_err <= TW.POS_TOL and rep.vel_err <= TW.VEL_TOL
    assert profiling.validate_state(ht)


def test_config1_free_run():
    h, (bid,) = free_run("1")
    x, y = h.get_position(bid)
    assert abs(x - 100) < 5 and abs(y - 100) < 5
    n = h._batches[bid]["n_white"]
    p = h.state.pos[0, :n].numpy()
    spread = np.hypot(*(p - p.mean(0)).T).mean()
    assert 10.0 < spread < 120.0


def test_config2_free_run():
    h, ids = free_run("2")
    for j, bid in enumerate(ids):
        x, y = h.get_position(bid)
        assert -100 < x < 700 and -100 < y < 700, f"batch {j} at {(x, y)}"


def test_config3_free_run():
    h, _ = free_run("3")
    p = h.state.pos[0, :8 * 40].numpy()
    assert np.hypot(*(p - p.mean(0)).T).max() < 400.0
