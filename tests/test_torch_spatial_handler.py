"""The port's SpatialHandler — the multi-device product surface — on a 2 x 2
mesh of 4 gloo ranks (``tests/torch_ranks.py``): the twins of
``tests/test_spatial_handler.py`` and of the spatial cases of
``tests/test_demo_checkpoint.py``, plus the edges of a mesh without its
process group.

- The product flow (add, targets, ``update(3/60)``, ``draw``, ``run_steps``,
  add / remove and recolour mid-flight): batch positions after the update
  within 0.5 px of the single-device handler's, the port's and the JAX
  package's (the resident envelope of the JAX test), ids and counts equal,
  no particle lost, a real frame.
- Migration overflow (``migrate_cap=1``, a teleported clump): the backlog
  fires the automatic redistribute, after which the ownership invariant
  holds and no particle is lost.
- The demo session on the mesh: a finite 600 x 800 frame.
- A live SpatialHandler checkpoint (synced, written by rank 0) resumes on a
  1 x 1 mesh in the test process: the same particles (positions 1e-5 px
  as sets), then steps and draws.
- A packed clump split over the four ranks: ``draw`` boosts the render
  budget alike on every rank (the audit is combined over the mesh), drops
  nothing, and its frame equals the 1 x 1 handler's within the spatial
  draw's rtol 1e-3, atol 2e-4 (``tests/test_spatial.py:230``). One step
  of its redistributed state: the in-transit count is the numpy count of
  the particles outside their rank's window (none), the JAX package's
  ``spatial_step`` of the same state counts the particles past rank K of
  their cell besides, the dropped counts are equal, and no redistribute
  runs (``torch_ranks.layout_counts``; the departure of the port).
- A 2 x 2 handler without a 4-rank process group raises; ``demo --spatial
  1x1`` runs alone; ``demo --spatial ... --particle-color`` refuses at
  startup with one line and exit code 1.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
import torch_ranks
from egg_fluid_simulation_tpu_torch import checkpoint as tckpt
from egg_fluid_simulation_tpu_torch import demo as tdemo
from egg_fluid_simulation_tpu.parallel import spatial as JS
from egg_fluid_simulation_tpu.state import ParticleState as JState
from egg_fluid_simulation_tpu_torch.parallel import spatial as TS

G, K = 32, 4
OPTS = dict(engine="dense", budget_mode="off", dense_rebin="step",
            dense_grid_dim=G, dense_slots=K)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    monkeypatch.setattr(jsweep, "FORCE_INTERPRET", False)


def _flow_single(h):
    a = h.add(60.0, 50.0, 40.0, 12.0, None, None, 40, 10)
    b = h.add(150.0, 90.0, 40.0, 12.0, None, None, 40, 10)
    h.set_target_position(a, 120.0, 70.0)
    h.set_target_position(b, 80.0, 60.0)
    h.update(3 / 60)
    return np.asarray([h.get_position(i) for i in h.list_ids()])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("handler")
    white, yolk = T.default_white_config(), T.default_yolk_config()
    ckpt = str(tmp / "spatial_ckpt.npz")
    ranks = torch_ranks.start(
        "handler_program",
        dict(white_config=json.dumps(white), yolk_config=json.dumps(yolk),
             db=2, dx=2, grid_dim=G, slots=K, ckpt_path=ckpt), tmp, 4)
    hj = J.SimulationHandler(J.default_white_config(), J.default_yolk_config(),
                             capacity=1024, max_batches=8,
                             options=J.SolverOptions(use_pallas=False, **OPTS))
    ht = T.SimulationHandler(white, yolk, capacity=1024, max_batches=8,
                             options=T.SolverOptions(**OPTS), device="cpu")
    # the clump on a 1 x 1 mesh in the test process
    h1 = T.SpatialHandler(white, yolk, capacity=1024, max_batches=8,
                          options=T.SolverOptions(**OPTS), device="cpu")
    for args in torch_ranks.CLUMP:
        h1.add(*args)
    clump_1x1 = (h1.draw(viewport=torch_ranks.CLUMP_VIEW).numpy(),
                 h1._inner._render_budget.audit.numpy())
    flows = dict(jax=_flow_single(hj), single=_flow_single(ht))
    port = ranks.result()
    # the JAX package's step of the ranks' redistributed clump
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    saved = jsweep.FORCE_INTERPRET
    jsweep.FORCE_INTERPRET = False
    try:
        lay = JS.SpatialLayout(G, K, db=2, dx=2, migrate_cap=64)
        step = JS.spatial_step(JS.make_spatial_mesh(2, 2), lay,
                               J.SolverOptions(use_pallas=False, **OPTS))
        state = JState(**{f.name: jnp.asarray(port[f"clump_in_{f.name}"])
                          for f in dataclasses.fields(JState)})
        clump_jax_info = np.asarray(step(state, hj._device_cfg2(),
                                         jnp.float32(1 / 60),
                                         jnp.float32(1.0))[2])
    finally:
        jsweep.FORCE_INTERPRET = saved
    return dict(ckpt=ckpt, port=port, clump_1x1=clump_1x1,
                clump_jax_info=clump_jax_info, **flows)


def test_full_product_flow_matches_single_device(run):
    port = run["port"]
    assert port["flow_ids"].tolist() == [1, 2]
    assert port["flow_n0"].tolist() == [80, 20]
    np.testing.assert_allclose(port["flow_positions"], run["single"],
                               atol=0.5)
    np.testing.assert_allclose(port["flow_positions"], run["jax"], atol=0.5)
    frame = port["flow_frame"]
    assert frame.shape == (256, 256, 4)
    assert np.isfinite(frame).all() and frame[..., 3].max() > 0.1
    assert port["flow_n_run"].tolist() == [80, 20]
    assert port["flow_info_run"][:, 0].sum() == 0
    assert port["flow_n_end"].tolist() == [80, 20]
    slot = port["flow_end_batch_slot"]
    assert [(slot[i] >= 0).sum() for i in range(2)] == [80, 20]
    assert np.isfinite(port["flow_end_pos"]).all()


def test_migration_overflow_triggers_auto_redistribute(run):
    port = run["port"]
    info = port["over_info"]
    assert info[:, 1].sum() > 0            # the clump backs up in transit
    assert int(port["over_redistributed"]) >= 1
    slot, pos = port["over_batch_slot"], port["over_pos"]
    lay = TS.SpatialLayout(G, K, db=2, dx=2, migrate_cap=1)
    c_loc = slot.shape[1] // 4
    for i in range(2):
        live = slot[i] >= 0
        assert live.sum() == port["over_n0"][i]
        band, block = (x.numpy() for x in TS.owner_of(
            torch.from_numpy(pos[i]), torch.tensor(port["over_cells"][i]),
            lay))
        dev = band * lay.dx + block
        idx = np.arange(slot[i].size)
        assert (dev[live] == idx[live] // c_loc).all()


def test_clump_draw_same_boost_on_every_rank(run):
    port = run["port"]
    slot = port["clump_in_batch_slot"][0]
    c_loc = slot.size // 4
    assert all((slot[r * c_loc:(r + 1) * c_loc] >= 0).any()
               for r in range(4))           # the clump is split four ways
    boosts = port["clump_boosts"]
    assert (boosts == boosts[0]).all()      # every rank the same boost
    assert boosts[0, 0] > 1.0               # the white budget was boosted
    assert port["clump_render_audit"][:, 0].tolist() == [0, 0]
    frame, audit = run["clump_1x1"]
    assert audit[:, 0].tolist() == [0, 0]
    np.testing.assert_allclose(port["clump_frame"], frame, rtol=1e-3,
                               atol=2e-4)
    assert port["clump_frame"][..., 3].max() > 0.5


def test_clump_transit_counts_outside_the_window(run):
    port, want = run["port"], run["clump_jax_info"]
    counts = torch_ranks.layout_counts(
        port["clump_in_pos"], port["clump_in_batch_slot"],
        port["clump_cells"], G, K, 2, 2)
    live = int((port["clump_in_batch_slot"] >= 0).sum())
    assert counts[:, 1].sum() > 0.05 * live    # JAX's count passes the 5%
    got = port["clump_info"]
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_array_equal(got[:, 1], counts[:, 0])
    np.testing.assert_array_equal(want[:, 1], counts[:, 0] + counts[:, 1])
    assert int(port["clump_redistributed"]) == 0


def test_demo_spatial_session_runs(run):
    frame = run["port"]["demo_frame"]
    assert frame.shape == (600, 800, 4)
    assert np.isfinite(frame).all()
    assert int(run["port"]["demo_n"]) > 0


def test_checkpoint_spatial_roundtrip(run):
    """Resume a live 2 x 2 checkpoint on another mesh shape (1 x 1 here)."""
    port = run["port"]
    inner = tckpt.load(run["ckpt"], options=T.SolverOptions(**OPTS),
                       device="cpu")
    sh2 = T.SpatialHandler.from_handler(inner, db=1, dx=1)
    assert list(sh2.get_n_particles()) == port["ckpt_n"].tolist()
    n0 = int(port["ckpt_n"][0])
    p_live = np.sort(port["ckpt_pos"][0][:n0], axis=0)
    p2 = np.sort(sh2.state.pos[0].numpy()[:n0], axis=0)
    np.testing.assert_allclose(p2, p_live, atol=1e-5)
    sh2.run_steps(2)
    frame = sh2.draw(viewport=(0.0, 0.0, 128, 128))
    assert np.isfinite(frame.numpy()).all()
    assert list(sh2.get_n_particles()) == port["ckpt_n"].tolist()


def test_multi_rank_mesh_without_its_group_raises():
    with pytest.raises(RuntimeError, match="4 ranks"):
        T.SpatialHandler(T.default_white_config(), T.default_yolk_config(),
                         db=2, dx=2, capacity=1024, device="cpu")


def test_demo_command_line_spatial_1x1(tmp_path, capsys):
    out = tmp_path / "frames"
    assert tdemo.main(["--frames", "1", "--out", str(out), "--device", "cpu",
                       "--capacity", "1024", "--spatial", "1x1"]) == 0
    assert sorted(p.name for p in out.iterdir()) == ["frame_0000.png"]
    assert "n_particles" in capsys.readouterr().out


def test_demo_command_line_spatial_refuses_particle_colour(tmp_path):
    """``--spatial`` with ``--particle-color`` stops at startup with one
    line on stderr and exit code 1, before any frame."""
    out = tmp_path / "frames"
    proc = subprocess.run(
        [sys.executable, "-m", "egg_fluid_simulation_tpu_torch.demo",
         "--frames", "1", "--out", str(out), "--device", "cpu",
         "--capacity", "1024", "--spatial", "1x1", "--particle-color"],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 1
    lines = proc.stderr.strip().splitlines()
    assert len(lines) == 1 and "--particle-color" in lines[0]
    assert not out.exists()
