"""Golden-trajectory fidelity gates of the PyTorch port vs the NumPy oracle.

The twins of ``tests/test_fidelity.py``, run on the port's handler (CPU,
the gather engine of ``SolverOptions(table_size=4096, slots_per_cell=32,
cohesion_mode="literal")``) against the sequential oracle
``tests/oracle.py``, each gate at its own tolerance: two-particle scenes
exact to the f32-vs-f64 tolerance, multi-particle scenes on trajectory
envelopes (the solver is Jacobi where the reference is Gauss-Seidel). The
heavy centroid-envelope sweep is ``slow``, as in the JAX package.
"""

import numpy as np
import pytest
import torch

from egg_fluid_simulation_tpu_torch import (SimulationHandler, SolverOptions,
                                            default_white_config,
                                            default_yolk_config, WHITE)

from oracle import OracleSim, OracleConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def build_handler_and_oracle(x, y, white_r, yolk_r, n_white, n_yolk, **cfg_over):
    wc, yc = default_white_config(), default_yolk_config()
    wc.update(cfg_over)
    yc.update(cfg_over)
    h = SimulationHandler(wc, yc, capacity=1024, max_batches=8, device="cpu",
                          options=SolverOptions(table_size=4096, slots_per_cell=32,
                                                cohesion_mode="literal"))
    bid = h.add(x, y, white_r, yolk_r, None, None, n_white, n_yolk)

    ow = OracleConfig(**{k: wc[k] for k in OracleConfig.__dataclass_fields__})
    oy = OracleConfig(**{k: yc[k] for k in OracleConfig.__dataclass_fields__})
    o = OracleSim(ow, oy)
    obid = o.add_batch(x, y, white_r, yolk_r, n_white, n_yolk)
    return h, bid, o, obid


def _white(h, n):
    return h.state.pos[WHITE, :n].numpy()


def _spread(p):
    c = p.mean(axis=0)
    return np.hypot(*(p - c).T).mean()


def test_initial_layout_identical():
    h, _, o, _ = build_handler_and_oracle(100.0, 50.0, 30.0, 9.0, 40, 10)
    assert h._options.engine == "gather"
    np.testing.assert_allclose(_white(h, 40), o.positions("white"),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(h.state.inv_mass[WHITE, :40].numpy(),
                               list(o.white.inv_mass), rtol=1e-5)


def test_single_particle_pair_trajectory_exact():
    """Two overlapping white particles: Jacobi == Gauss-Seidel, per-step exact."""
    h, bid, o, obid = build_handler_and_oracle(0.0, 0.0, 10.0, 3.0, 2, 2)
    for step in range(30):
        h.step_once(1 / 60)
        o.step(1 / 60)
        # identical math; the tolerance grows with the step count because
        # the solver runs f32 where the oracle is f64 and the pair oscillates
        np.testing.assert_allclose(_white(h, 2), o.positions("white"),
                                   atol=0.02 + 0.01 * step,
                                   err_msg=f"diverged at step {step}")


def test_free_particle_damped_drift_exact():
    """A particle with initial velocity, no neighbours: closed-form decay."""
    h, bid, o, obid = build_handler_and_oracle(0.0, 0.0, 10.0, 3.0, 2, 2)
    st = h.state
    pos, prev, vel = st.pos.clone(), st.prev.clone(), st.vel.clone()
    pos[WHITE, 1] = prev[WHITE, 1] = torch.tensor([10000.0, 10000.0])
    vel[WHITE, 0] = torch.tensor([120.0, 0.0])
    far = torch.tensor([[5e5, 5e5], [6e5, 6e5]])
    pos[1, :2] = prev[1, :2] = far
    h._state = st.replace(pos=pos, prev=prev, vel=vel)
    o.white.pos[1] = [10000.0, 10000.0]
    o.white.prev[1] = [10000.0, 10000.0]
    o.white.vel[0] = [120.0, 0.0]
    o.yolk.pos = [[5e5, 5e5], [6e5, 6e5]]
    o.yolk.prev = [[5e5, 5e5], [6e5, 6e5]]
    for _ in range(10):
        h.step_once(1 / 60)
        o.step(1 / 60)
    np.testing.assert_allclose(_white(h, 1)[0], o.positions("white")[0],
                               rtol=1e-4, atol=0.01)


@pytest.mark.slow
@pytest.mark.parametrize("damping", [0.05, 0.1, 0.3])
def test_batch_centroid_trajectory_envelope(damping):
    """One 30-particle egg snapping to a moved target: centroid paths agree."""
    h, bid, o, obid = build_handler_and_oracle(0.0, 0.0, 20.0, 6.0, 30, 8,
                                               damping=damping)
    h.set_target_position(bid, 120.0, 80.0)
    o.targets[obid] = (120.0, 80.0)
    cent_h, cent_o = [], []
    for _ in range(90):
        h.step_once(1 / 60)
        o.step(1 / 60)
        cent_h.append(_white(h, 30).mean(axis=0))
        cent_o.append(o.centroid("white"))
    err = np.hypot(*(np.asarray(cent_h) - np.asarray(cent_o)).T)
    assert err.max() < 6.0, f"max centroid divergence {err.max():.2f}px"
    assert err[-1] < 3.0, f"steady-state divergence {err[-1]:.2f}px"


def test_steady_state_spread_envelope():
    """Blob radius (mean distance to centroid) settles to the same value."""
    h, bid, o, obid = build_handler_and_oracle(0.0, 0.0, 25.0, 8.0, 40, 10)
    for _ in range(120):
        h.step_once(1 / 60)
        o.step(1 / 60)
    s_h, s_o = _spread(_white(h, 40)), _spread(o.positions("white"))
    assert abs(s_h - s_o) / s_o < 0.15, f"spread {s_h:.2f} vs oracle {s_o:.2f}"


@pytest.mark.parametrize("key,value", [
    ("collision_strength", 0.5),
    ("cohesion_strength", 0.999),
    ("collision_overlap_factor", 1.0),
])
def test_parameter_sweep_envelope(key, value):
    """Per-parameter fidelity: envelopes hold across settings."""
    h, bid, o, obid = build_handler_and_oracle(0.0, 0.0, 20.0, 6.0, 25, 6,
                                               **{key: value})
    for _ in range(60):
        h.step_once(1 / 60)
        o.step(1 / 60)
    p_h, p_o = _white(h, 25), o.positions("white")
    assert np.hypot(*(p_h.mean(0) - p_o.mean(0))) < 6.0
    assert abs(_spread(p_h) - _spread(p_o)) / max(_spread(p_o), 1.0) < 0.25


def test_mass_distribution_wide_gap_stable():
    """Parameter extremes: a wide mass gap stays finite and on target."""
    h, bid, o, obid = build_handler_and_oracle(
        0.0, 0.0, 20.0, 6.0, 30, 8,
        min_mass=1 / 20, max_mass=1 - 1 / 20, damping=0.05)
    h.set_target_position(bid, 60.0, 0.0)
    for _ in range(120):
        h.step_once(1 / 60)
    p = _white(h, 30)
    assert np.isfinite(p).all()
    assert np.hypot(*(p.mean(0) - [60.0, 0.0])) < 30.0
