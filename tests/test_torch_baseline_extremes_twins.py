"""Baseline configs 4 and 5 of ``tests/test_baseline_scenarios.py`` in the
port against the JAX package (configs 1-3 and the step-locked rule are in
``test_torch_baseline_twins.py``).

- Config 4, the parameter extremes (damping 0.01; cohesion 1.0 at 3x
  reach; masses 0.02-1.0), 90 updates each, step-locked to the JAX step,
  and the port's own free run through ``validate_state``.
- Config 5, 64 small batches, 5 frames of ``update`` + ``draw`` at 720 x
  720: each update step-locked, then each frame drawn by both handlers from
  the same state, stats and render budget: the frame and both density
  canvases within 1e-4 per channel (the whole-frame tolerance), the budget
  boosts and peak-density hints equal, no splat dropped. The port's own
  free run: every batch visible in its last frame (the JAX file's 9 x 9
  probe), finite values of the frame's shape, five timed frames.
"""

import numpy as np
import pytest
import torch

import jax

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu_torch import scenarios
from egg_fluid_simulation_tpu_torch.utils import profiling

import torch_twins as TW
from test_torch_baseline_twins import free_run, run_step_locked


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    TW.pin_plane_path(monkeypatch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


CONFIG4 = ["4a", "4b", "4c"]


@pytest.mark.parametrize("name", CONFIG4)
def test_config4_step_locked_to_jax(name):
    rep, _, ht = run_step_locked(name)
    assert rep.pos_err <= TW.POS_TOL and rep.vel_err <= TW.VEL_TOL
    assert profiling.validate_state(ht)


@pytest.mark.parametrize("name", CONFIG4)
def test_config4_free_run(name):
    free_run(name)


def test_config5_frames_step_locked_to_jax():
    sc = scenarios.SCENARIOS["5"]
    hj, ids = scenarios.build(sc, J)
    ht, ids_t = scenarios.build(sc, T, device="cpu")
    assert ids_t == ids
    rep = TW.Report()
    for _ in range(sc.frames):
        TW.step_locked(hj, ht, 1, report=rep)
        TW.carry(hj, ht)
        fj = np.asarray(jax.block_until_ready(hj.draw(viewport=sc.viewport)))
        ft = ht.draw(viewport=sc.viewport).numpy()
        assert ft.shape == fj.shape == (720, 720, 4)
        np.testing.assert_allclose(ft, fj, rtol=0, atol=TW.FRAME_TOL)
        for ct, cj in zip(ht._canvases, hj._canvases):
            np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                                       atol=TW.FRAME_TOL)
        assert ht._render_budget.k_boost == hj._render_k_boost
        assert ht._render_budget.peak_density == hj._render_peak_density
        assert int(ht.render_audit[:, 0].sum()) == 0
    assert rep.steps == sc.frames and not rep.flips, TW.flip_lines(rep)


def test_config5_free_run():
    sc = scenarios.SCENARIOS["5"]
    h, _ = scenarios.build(sc, T, device="cpu")
    timer = profiling.StepTimer(device="cpu")
    frame = None
    for _ in range(sc.frames):
        with timer.phase("frame"):
            h.update(1 / 60)
            frame = h.draw(viewport=sc.viewport)
    frame = frame.numpy()
    assert frame.shape == (720, 720, 4) and np.isfinite(frame).all()
    for j, (x, y) in enumerate(scenarios.config5_centres()):
        yy, xx = int(round(y)), int(round(x))
        win = frame[max(yy - 4, 0):yy + 5, max(xx - 4, 0):xx + 5, 3]
        assert win.max() > 0.3, f"batch {j} at ({x},{y}) not visible"
    assert int(h.render_audit[:, 0].sum()) == 0
    assert timer.summary()["frame"]["n"] == 5
