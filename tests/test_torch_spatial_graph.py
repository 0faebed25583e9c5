"""The spatial layer's graphs (``parallel/spatial_graph.py``) on the CPU,
where ``SpatialGraphs(capture=False)`` runs their parts eagerly on the
static buffers a card replays from (the scene and the rank sets of
``tests/test_torch_spatial.py``; a 1 x 1 mesh on one gloo rank, a 2 x 2
mesh on four).

- Against the eager spatial layer from one state, bit for bit: a
  ``spatial_step``; ``spatial_multi_step`` in a call that takes the rebin
  branch (call ``a``, 1/60 s steps) and one that does not (call ``b``, 1/480
  s steps, ``a``'s episode state); ``spatial_draw``; every state field the
  steps write, the stats, ``info``, the wide-gate state and the frame; and
  ``SpatialHandler`` through ``update``, ``run_steps`` and ``draw`` with
  and without the graphs.
- Both branches taken: the graphs' device rebin counter equals the eager
  loop's host decisions (call ``a`` rebins, ``b`` does not). Host reads of
  the decision: one per population and step on the ``if_node`` route run
  eagerly (1 x 1), one per step on ``host_flag`` (2 x 2: both flags in one
  read).
- Collective bytes: the graphs' tallies (each part's, the branch's per
  rebin) equal, per category and call, what the eager layer's call sites
  count (2 x 2; none on 1 x 1).
- Against the JAX package's ``spatial_multi_step`` (calls ``a`` and ``b``
  from the same states) at the whole-step tolerances of
  ``tests/test_torch_spatial_resident.py``: positions 1e-3 px, velocities
  0.2 px/s, the layout and the migration-dropped counts equal, the
  in-transit counts held to their definitions over each rank's last
  binning (``test_torch_spatial._hold_info``), the wide-gate state equal;
  the 2 x 2 frame against JAX's ``spatial_draw`` of the same state: rtol
  1e-3, atol 2e-4.
- The draw's audit (dropped splats summed over the mesh, the peak bin
  occupancy its maximum) bit for bit between the routes; its all-reduces
  are counted under ``render`` beside the frame's log-space sums.
- ``_place_migrants`` (its scatter now through a dump row) against the JAX
  package's, bit for bit, on receive buffers that overflow the free slots
  and on ones that fit.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_ranks
from egg_fluid_simulation_tpu.parallel import spatial as JS
from egg_fluid_simulation_tpu.state import ParticleState as JState
from egg_fluid_simulation_tpu.state import StepStats as JStats
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch.parallel import spatial as TS
from test_torch_spatial import (FIELDS, G, J_OPTIONS, K, _cell_sizes,
                                _hold_info, _inputs, _jax_handler, _np,
                                _step_state)
from test_torch_spatial_resident import STATS, _assert_steps_match

MESHES = ("1x1", "2x2")
CALLS = {"a": (3, 1 / 60), "b": (2, 1 / 480)}   # steps, step_delta
FRAME_RTOL, FRAME_ATOL = 1e-3, 2e-4
STATE_KEYS = ("pos", "prev", "vel", "last_pos", "radius", "mass_t",
              "inv_mass", "batch_slot", "color", "count", "batch_target",
              "batch_radius", "batch_used")


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    monkeypatch.setattr(jsweep, "FORCE_INTERPRET", False)


def _shape(mesh: str):
    db, dx = (int(c) for c in mesh.split("x"))
    return db, dx


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank sets started first; JAX's calls ``a`` and ``b`` on each
    mesh meanwhile; then the JAX draw of the port's 2 x 2 state."""
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    saved = jsweep.FORCE_INTERPRET
    jsweep.FORCE_INTERPRET = False
    try:
        h = _jax_handler()
        ranks = {}
        for mesh in MESHES:
            db, dx = _shape(mesh)
            inputs = _inputs(h, db, dx)
            inputs.update(n_a=CALLS["a"][0], n_b=CALLS["b"][0],
                          dt_b=CALLS["b"][1])
            ranks[mesh] = torch_ranks.start(
                "spatial_graph_program", inputs,
                tmp_path_factory.mktemp(f"graph{mesh}"), db * dx)
        jax_out = {}
        cfg2 = h._device_cfg2()
        for mesh in MESHES:
            db, dx = _shape(mesh)
            lay = JS.SpatialLayout(G, K, db=db, dx=dx, migrate_cap=64)
            jmesh = JS.make_spatial_mesh(db, dx)
            multi = JS.spatial_multi_step(jmesh, lay, J_OPTIONS)
            st = JS.redistribute(h.state, _cell_sizes(h), lay, jmesh)
            ws = None
            for call, (n, dt) in CALLS.items():
                st, stats, info, ws = multi(st, cfg2, jnp.float32(dt),
                                            jnp.float32(1.0), jnp.int32(n),
                                            wide_state=ws)
                jax_out[mesh, call] = (host_view(st), stats, _np(info),
                                       [[int(v) for v in w] for w in ws])
        port = {mesh: r.result() for mesh, r in ranks.items()}

        # JAX's draw of the port's 2 x 2 state after call b
        p = port["2x2"]
        lay = JS.SpatialLayout(G, K, db=2, dx=2, migrate_cap=64)
        from egg_fluid_simulation_tpu.ops import render as jrender
        opts2 = tuple(jrender.auto_render_options(c, 128)
                      for c in (h._white_config, h._yolk_config))
        draw = JS.spatial_draw(JS.make_spatial_mesh(2, 2), lay, opts2,
                               (0.0, 0.0, 128, 96), 0.3, 0.01, True)
        state = JState(**{k: jnp.asarray(p[f"graphs_b_{k}"])
                          for k in STATE_KEYS})
        stats = JStats(**{k: jnp.asarray(p[f"graphs_b_{k}"]) for k in STATS})
        frame = _np(draw(state, stats, cfg2, jnp.float32(0.5)))
    finally:
        jsweep.FORCE_INTERPRET = saved
    return dict(port=port, jax=jax_out, frame=frame)


def _pairs(res, prefix_a, prefix_b):
    """``(key, a, b)`` of every result ``prefix_a*`` with its ``prefix_b``
    twin."""
    for k in sorted(res):
        if k.startswith(prefix_a):
            yield k, res[k], res[prefix_b + k[len(prefix_a):]]


@pytest.mark.parametrize("mesh", MESHES)
def test_graph_parts_match_eager(runs, mesh):
    port = runs["port"][mesh]
    assert str(port["route"]) == ("if_node" if mesh == "1x1"
                                  else "host_flag")
    unequal = [k for k, a, b in _pairs(port, "eager_", "graphs_")
               if not k.endswith("_reads") and not np.array_equal(a, b)]
    assert unequal == []
    assert port["graphs_frame"][..., 3].max() > 0.1
    # host reads of the rebin decision: per population and step when the
    # IF node's branch runs eagerly, per step on the host_flag route
    per = 1 if mesh == "1x1" else 2
    for call, (n, _) in CALLS.items():
        assert int(port[f"eager_{call}_reads"]) == 2 * n
        assert int(port[f"graphs_{call}_reads"]) == 2 * n // per
    assert int(port["eager_step_reads"]) == int(port["graphs_step_reads"]) == 0


@pytest.mark.parametrize("mesh", MESHES)
def test_handler_graphs_match_eager(runs, mesh):
    port = runs["port"][mesh]
    unequal = [k for k, a, b in _pairs(port, "handler_eager_",
                                       "handler_graphs_")
               if not np.array_equal(a, b)]
    assert unequal == []
    assert port["handler_graphs_frame"][..., 3].max() > 0.1


@pytest.mark.parametrize("mesh", MESHES)
def test_both_branches_taken(runs, mesh):
    """The device counter of the graphs' rebins equals the eager loop's host
    decisions; call a takes the branch, call b does not."""
    port = runs["port"][mesh]
    for call in CALLS:
        np.testing.assert_array_equal(port[f"graphs_{call}_rebins"],
                                      port[f"eager_{call}_rebins"])
        np.testing.assert_array_equal(port[f"graphs_{call}_rebins"],
                                      port[f"eager_{call}_host_rebins"])
    assert port["graphs_a_rebins"].min() > 0
    assert port["graphs_b_rebins"].max() == 0


@pytest.mark.parametrize("mesh", MESHES)
def test_byte_tallies_match_eager_counter(runs, mesh):
    port = runs["port"][mesh]
    for call in ("step", *CALLS):
        got = json.loads(str(port[f"graphs_{call}_bytes"]))
        want = json.loads(str(port[f"eager_{call}_bytes"]))
        assert got == want, call
        if mesh == "1x1":
            assert got == {}          # no collective on one rank
        else:
            assert set(got) == {"full_halo_exchange", "xy_refresh_per_pass",
                                "migration", "reductions"}, call
    if mesh == "2x2":
        # the rebins of call a add full halo exchanges and migrations
        a = json.loads(str(port["graphs_a_bytes"]))
        b = json.loads(str(port["graphs_b_bytes"]))
        assert a["full_halo_exchange"] > b["full_halo_exchange"]
        assert a["migration"] > b["migration"]


@pytest.mark.parametrize("mesh", MESHES)
def test_graphs_match_jax(runs, mesh):
    port = runs["port"][mesh]
    for call in CALLS:
        want, stats, info, wide = runs["jax"][mesh, call]
        got = _step_state(port, f"graphs_{call}")
        _assert_steps_match(got, {f: want[f] for f in FIELDS})
        _hold_info(port[f"graphs_{call}_info"], info,
                   port[f"graphs_{call}_bin_pos"],
                   port[f"graphs_{call}_bin_batch_slot"], *_shape(mesh),
                   after_slot=port[f"graphs_{call}_batch_slot"])
        np.testing.assert_allclose(port[f"graphs_{call}_centroid"],
                                   _np(stats.centroid), rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(port[f"graphs_{call}_wide"], wide)


def test_draw_bytes_count_the_audit(runs):
    """The draw's collective bytes a rank: each population's log-space sum
    of its effective canvas (float32) and the audit's sum and max of two
    int32 a population; nothing on one rank."""
    import egg_fluid_simulation_tpu_torch as T
    from egg_fluid_simulation_tpu_torch.ops import render as trender
    opts2 = [trender.auto_render_options(c, 128)
             for c in (T.default_white_config(), T.default_yolk_config())]
    canvases = sum(o.eff_size ** 2 * 4 for o in opts2)
    got = json.loads(str(runs["port"]["2x2"]["graphs_draw_bytes"]))
    assert got == {"render": canvases + 2 * 2 * 4}
    assert json.loads(str(runs["port"]["1x1"]["graphs_draw_bytes"])) == {}
    for mesh in MESHES:
        audit = runs["port"][mesh]["graphs_frame_audit"]
        assert audit.shape == (2, 2) and audit[:, 1].min() > 0


def test_graph_draw_matches_jax(runs):
    got = runs["port"]["2x2"]["graphs_frame"]
    assert got.shape == runs["frame"].shape == (96, 128, 4)
    np.testing.assert_allclose(got, runs["frame"], rtol=FRAME_RTOL,
                               atol=FRAME_ATOL)


@pytest.mark.parametrize("n_free", (5, 30))
def test_place_migrants_matches_jax(n_free):
    """Two receive buffers of 12 rows, ~10 valid each, into a slice of 64
    with ``n_free`` free slots: 5 overflow (rows dropped and counted), 30
    take every row."""
    rng = np.random.default_rng(n_free)
    n, cap, width = 64, 12, TS._MIG_FIELDS + 1
    active = np.ones(n, bool)
    active[rng.choice(n, n_free, replace=False)] = False
    fields = rng.standard_normal((n, width)).astype(np.float32)
    bufs = []
    for _ in range(2):
        valid = rng.random(cap) < 0.8
        rows = np.where(valid[:, None],
                        rng.standard_normal((cap, width)), 0.0)
        bufs.append(np.concatenate([rows, valid[:, None]], axis=1)
                    .astype(np.float32))
    jf, ja, jd = JS._place_migrants(jnp.asarray(fields), jnp.asarray(active),
                                    tuple(jnp.asarray(b) for b in bufs),
                                    2 * cap)
    tf, ta, td = TS._place_migrants(torch.from_numpy(fields),
                                    torch.from_numpy(active),
                                    tuple(torch.from_numpy(b) for b in bufs),
                                    2 * cap)
    np.testing.assert_array_equal(tf.numpy(), _np(jf))
    np.testing.assert_array_equal(ta.numpy(), _np(ja))
    assert int(td) == int(jd)
    n_valid = int(sum(b[:, -1].sum() for b in bufs))
    assert int(td) == max(0, n_valid - n_free)
    assert (int(td) > 0) == (n_free == 5)
