"""Demo harness and checkpoint/resume of the PyTorch port, against the JAX
package's.

- A demo session (seed 0: four batches at the viewport corners on the
  gather engine, targets dragged along the seeded path) runs in both
  packages; the particle state stays within the whole-step tolerances
  (positions and previous positions atol 1e-3 px, velocities 0.2 px/s).
  The session runs 5 frames, not 10: its spawn explosion reaches 4000
  px/s, and XLA's fused multiply-adds round about one ulp of a position
  (6e-5 px at 800 px) differently a step, which the explosion carries past
  1e-3 px at frame 6 (1.2e-3 measured). The JAX demo's per-batch follow
  table is gathered exactly here (``take_batch_rows`` patched for the
  session; the JAX package's bf16 hi/lo product keeps ~16 bits of a target,
  6e-3 px at 400 px, a TPU device the port leaves out by design).
- One drawn demo frame: the JAX session's state, checkpointed and loaded
  into both packages, drawn with the demo's viewport and background. All
  but 1e-4 of the channels agree within 1e-4 (22 of 1.92M do not), and
  every channel within 5e-4 (2.5e-4 measured): the demo's small particles
  overlap nearly opaque, where a few-ulp difference of a gaussian ``g``
  near 1 (XLA's fused multiply-adds and ``exp``) is a large relative one
  of ``1 - g`` in the screen blend; the density canvases (kernel C's
  output, the witness of that cause) agree within 1.1e-5 (yolk; white
  2.4e-7) and are held to 5e-5, and the threshold smoothstep's slope (up
  to 75) carries that to the frame.
- Checkpoints: a port round trip resumes bit for bit against the unbroken
  run (gather and dense engine); files move between the packages both
  ways with the state bit for bit; the ``wide_state`` encoding (budget -1
  for ``None``) and ``render_k_boost`` survive.
- The demo's keys and command line on the port (``--spatial`` refused).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egg_fluid_simulation_tpu import checkpoint as jckpt
from egg_fluid_simulation_tpu import demo as jdemo
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch import checkpoint as tckpt
from egg_fluid_simulation_tpu_torch import demo as tdemo
from egg_fluid_simulation_tpu_torch.interop import state_to_numpy
from egg_fluid_simulation_tpu_torch.ops import render as tR
from egg_fluid_simulation_tpu_torch.state import WHITE

POS_TOL = 1e-3     # px
VEL_TOL = 0.2      # px/s
FRAME_TOL = 1e-4   # per channel, all but FRAME_SHARE of the channels
FRAME_SHARE = 1e-4
FRAME_MAX = 5e-4   # per channel, every channel
CANVAS_TOL = 5e-5  # density canvases of the same frame, every pixel
DEMO_FRAMES = 5    # see the module docstring: 10 breaks POS_TOL by chaos


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def sessions():
    """The JAX and the port demo after ``DEMO_FRAMES`` frames of seed 0, the
    JAX step tracing an exact per-batch table gather."""
    exact = (lambda table, idx, chunk=1 << 16:
             jnp.take(table, idx, axis=0))
    saved = jsolver.take_batch_rows
    jsolver.take_batch_rows = exact
    jsolver.step.clear_cache()
    try:
        dj = jdemo.DemoState(seed=0)
        dt = tdemo.DemoState(seed=0, device="cpu")
        for d in (dj, dt):
            for _ in range(4):
                d.spawn_batch()
        start = host_view(dj.handler.state)["pos"]
        targets = []
        for _ in range(DEMO_FRAMES):
            targets.append((dj.target_position(), dt.target_position()))
            dj.update(1 / 60)
            dt.update(1 / 60)
        jax.block_until_ready(dj.handler.state.pos)
    finally:
        jsolver.take_batch_rows = saved
        jsolver.step.clear_cache()
    return dict(dj=dj, dt=dt, start=start, targets=targets)


def test_demo_session_matches_jax(sessions):
    dj, dt = sessions["dj"], sessions["dt"]
    assert dt.handler._options.engine == dj.handler._options.engine == "gather"
    assert dt.handler._options.table_size == dj.handler._options.table_size
    for tj, tt in sessions["targets"]:
        assert tt == tj                         # the path, bit for bit
    assert dt.batch_ids == dj.batch_ids
    assert dt.handler.get_n_particles() == dj.handler.get_n_particles()
    a, b = host_view(dj.handler.state), state_to_numpy(dt.handler.state)
    np.testing.assert_allclose(b["pos"], a["pos"], rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(b["prev"], a["prev"], rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(b["vel"], a["vel"], rtol=0, atol=VEL_TOL)
    np.testing.assert_allclose(b["last_pos"], a["last_pos"], rtol=0,
                               atol=POS_TOL)
    assert np.abs(b["pos"] - sessions["start"]).max() > 5.0
    stats = dt.overlay_stats()
    assert stats["n_particles"] == dj.overlay_stats()["n_particles"] == 140
    assert np.isfinite(stats["mean_update_ms"])


def test_demo_frame_matches_jax(sessions, tmp_path):
    """JAX session -> JAX checkpoint -> loaded by both packages -> the
    demo's draw (tolerances in the module docstring)."""
    path = str(tmp_path / "demo.npz")
    jckpt.save(sessions["dj"].handler, path)
    hj = jckpt.load(path)
    ht = tckpt.load(path, device="cpu")
    a, b = host_view(hj.state), state_to_numpy(ht.state)
    for f in a:
        np.testing.assert_array_equal(b[f], a[f], err_msg=f)
    kw = dict(viewport=(0.0, 0.0, 800, 600), background=(0.5, 0.5, 0.5, 1.0))
    fj = np.asarray(hj.draw(**kw))
    ft = ht.draw(**kw).numpy()
    assert ft.shape == fj.shape == (600, 800, 4)
    assert fj[..., 3].min() == 1.0 and (fj[..., :3] != 0.5).any()
    np.testing.assert_allclose(ft, fj, rtol=0, atol=FRAME_MAX)
    assert np.mean(np.abs(ft - fj) > FRAME_TOL) < FRAME_SHARE
    assert int(ht.render_audit[:, 0].sum()) == 0
    # the frame's density canvases, as the JAX draw keeps them, agree a
    # decade tighter than the frame: the shading, not the splat, widens it
    # (the port's canvases rendered again at the draw's options and scalars)
    alpha_t, thr, smooth, origin = tR._frame_scalars(ht, kw["viewport"])
    _, canvases, _ = tR._render_frame(
        ht.state, ht.stats, ht._device_cfg2(), alpha_t, thr, smooth, origin,
        tR.frame_options(ht), bool(ht._use_lighting), 800, 600,
        pop_caps=ht._options.pop_caps)
    assert len(canvases) == len(hj._canvases) == 2
    for ct, cj in zip(canvases, hj._canvases):
        assert ct.shape == cj.shape and float(np.max(cj)) > 0.5
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                                   atol=CANVAS_TOL)


def _host_ws(ws):
    return [None if w is None else (bool(w[0]), int(w[1]), int(w[2]))
            for w in ws]


@pytest.mark.parametrize("capacity", [4096, 16384], ids=["gather", "dense"])
def test_checkpoint_roundtrip_resumes_bit_for_bit(capacity, tmp_path):
    d = tdemo.DemoState(capacity=capacity, device="cpu")
    a = d.spawn_batch()
    d.spawn_batch()
    for _ in range(6):
        d.update()
    path = str(tmp_path / "ckpt.npz")
    tckpt.save(d.handler, path)
    r = tckpt.load(path, device="cpu")
    assert r._options == d.handler._options
    assert r._options.engine == ("gather" if capacity < 16384 else "dense")
    assert r.list_ids() == d.handler.list_ids()
    assert r.get_n_particles() == d.handler.get_n_particles()
    assert r._batches == d.handler._batches
    assert r._elapsed == d.handler._elapsed
    assert _host_ws(r._wide_state) == _host_ws(d.handler._wide_state)
    for f, v in state_to_numpy(d.handler.state).items():
        np.testing.assert_array_equal(state_to_numpy(r.state)[f], v, err_msg=f)
    assert r.get_position(a) == pytest.approx(d.handler.get_position(a),
                                              abs=1e-3)
    # resume == never stopped
    for h in (r, d.handler):
        h.set_target_position(a, 420.0, 260.0)
        h.update(1 / 60)
        h.update(1 / 60)
    for f, v in state_to_numpy(d.handler.state).items():
        np.testing.assert_array_equal(state_to_numpy(r.state)[f], v, err_msg=f)
    assert _host_ws(r._wide_state) == _host_ws(d.handler._wide_state)


def test_checkpoint_port_to_jax(tmp_path):
    """A port checkpoint loads in the JAX package: the same state bit for
    bit, registry and options; one update on each agrees within the step
    tolerances."""
    d = tdemo.DemoState(capacity=4096, device="cpu")
    a = d.spawn_batch()
    d.spawn_batch()
    for _ in range(3):
        d.update()
    path = str(tmp_path / "port.npz")
    tckpt.save(d.handler, path)
    hj = jckpt.load(path)
    ht = d.handler
    b = state_to_numpy(ht.state)
    for f, v in host_view(hj.state).items():
        np.testing.assert_array_equal(v, b[f], err_msg=f)
    assert hj.list_ids() == ht.list_ids() and hj._batches == ht._batches
    assert (hj._options.engine, hj._options.table_size,
            hj._options.pop_caps) == (ht._options.engine,
                                      ht._options.table_size,
                                      ht._options.pop_caps)
    assert hj.get_white_config() == ht.get_white_config()
    assert _host_ws(hj._wide_state) == _host_ws(ht._wide_state)
    hj.set_target_position(a, 100.0, 100.0)
    ht.set_target_position(a, 100.0, 100.0)
    hj.update(1 / 60)
    ht.update(1 / 60)
    aj, at = host_view(hj.state), state_to_numpy(ht.state)
    np.testing.assert_allclose(at["pos"], aj["pos"], rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(at["vel"], aj["vel"], rtol=0, atol=VEL_TOL)


def test_checkpoint_jax_to_port_dense_wide_state(tmp_path):
    """A JAX checkpoint of a dense-engine handler (capacity 16384) loads in
    the port: state, registry, configs and the episode tuples."""
    from egg_fluid_simulation_tpu import (SimulationHandler,
                                          default_white_config,
                                          default_yolk_config)
    hj = SimulationHandler(default_white_config(), default_yolk_config(),
                           capacity=16384, max_batches=8)
    hj.add(200.0, 150.0)
    hj.add(400.0, 250.0, 40.0, 10.0)
    hj.set_white_config({"damping": 0.3})
    hj._wide_state = ((jnp.bool_(True), jnp.int32(17), jnp.int32(3)),
                      (jnp.bool_(False), jnp.int32(240), jnp.int32(9)))
    hj._elapsed = 0.004
    path = str(tmp_path / "jax.npz")
    jckpt.save(hj, path)
    ht = tckpt.load(path, device="cpu")
    b = state_to_numpy(ht.state)
    for f, v in host_view(hj.state).items():
        np.testing.assert_array_equal(b[f], v, err_msg=f)
        assert b[f].dtype == v.dtype, f
    assert ht._options.engine == "dense"
    assert ht._options.pop_caps == hj._options.pop_caps
    assert ht._options.dense_grid_dim == hj._options.dense_grid_dim
    assert ht._batches == hj._batches and ht._free_slots == hj._free_slots
    assert ht.get_white_config() == hj.get_white_config()
    assert ht._elapsed == 0.004
    assert _host_ws(ht._wide_state) == [(True, 17, 3), (False, 240, 9)]
    np.testing.assert_array_equal(ht._host_targets, hj._host_targets)


def test_checkpoint_wide_state_none_and_render_k_boost(tmp_path):
    """``None`` episode entries (budget -1 in the file) and the render
    budget multipliers survive, whichever package writes and reads."""
    d = tdemo.DemoState(capacity=4096, device="cpu")
    d.spawn_batch()
    d.update()
    h = d.handler
    h._wide_state = (None, tuple(torch.tensor(v) for v in (True, 5, 2)))
    h._render_k_boost = [2.0, 1.5]
    path = str(tmp_path / "none.npz")
    tckpt.save(h, path)
    assert np.load(path)["wide_state"].tolist() == [[0, -1, 0], [1, 5, 2]]
    for r in (tckpt.load(path, device="cpu"), jckpt.load(path)):
        assert _host_ws(r._wide_state) == [None, (True, 5, 2)]
        assert r._render_k_boost == [2.0, 1.5]
    # and back: a JAX file with a None entry
    hj = jckpt.load(path)
    path2 = str(tmp_path / "none_jax.npz")
    jckpt.save(hj, path2)
    r = tckpt.load(path2, device="cpu")
    assert _host_ws(r._wide_state) == [None, (True, 5, 2)]
    assert r._render_k_boost == [2.0, 1.5]
    r.update(1 / 60)                    # a None entry steps (gather engine)
    assert torch.isfinite(r.state.pos).all()


def test_checkpoint_preserves_configs(tmp_path):
    d = tdemo.DemoState(capacity=4096, device="cpu")
    d.spawn_batch()
    d.swap_config()                     # fluid config active
    path = str(tmp_path / "ckpt.npz")
    tckpt.save(d.handler, path)
    restored = tckpt.load(path, device="cpu")
    assert restored.get_white_config()["damping"] == pytest.approx(0.05)
    assert restored.get_white_config()["follow_strength"] == pytest.approx(0.8)


def test_demo_spawn_remove_cycle():
    d = tdemo.DemoState(capacity=4096, device="cpu")
    for _ in range(4):
        d.spawn_batch()
    assert len(d.handler.list_ids()) == 4
    d.update()
    d.remove_batch()
    d.remove_batch()
    assert len(d.handler.list_ids()) == 2
    d.update()
    assert d.handler.get_n_particles() == (40, 30)


def test_demo_path_follows_and_config_swap_stable():
    d = tdemo.DemoState(capacity=4096, device="cpu")
    d.spawn_batch()
    x0, y0 = d.target_position()
    for _ in range(5):
        d.update()
    d.swap_config()
    assert not d.current_config_solid
    for _ in range(5):
        d.update()
    d.swap_config()
    assert d.current_config_solid
    assert d.target_position() != (x0, y0)
    assert torch.isfinite(d.handler.state.pos[WHITE, :20]).all()


def test_demo_renders_frame():
    d = tdemo.DemoState(width=256, height=256, capacity=4096,
                        canvas_size=128, device="cpu",
                        use_particle_color=True)
    d.spawn_batch()
    d.update()
    frame = d.draw()
    assert isinstance(frame, np.ndarray) and frame.shape == (256, 256, 4)
    assert np.isfinite(frame).all()
    assert int(d.handler.render_audit[:, 0].sum()) == 0


def test_demo_command_line(tmp_path, capsys):
    out = tmp_path / "frames"
    assert tdemo.main(["--frames", "1", "--out", str(out), "--device", "cpu",
                       "--capacity", "1024", "--seed", "3"]) == 0
    assert sorted(p.name for p in out.iterdir()) == ["frame_0000.png"]
    assert (out / "frame_0000.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "n_particles" in capsys.readouterr().out
    assert tdemo.main(["--spatial", "2x2", "--device", "cpu"]) != 0
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "not ported" in err[0]
    with pytest.raises(NotImplementedError):
        tdemo.DemoState(spatial=(2, 2), device="cpu")
