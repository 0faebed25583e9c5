"""The captured fixed step (``ops/step_graph.py``) on the CPU.

On a CUDA device the handler replays ``solver.step`` from a CUDA graph; on
the CPU it steps eagerly. ``StepGraphs(capture=False)`` replays by running
the step eagerly on the graph's static buffers, so the plumbing a capture
relies on (the key, the copy-in of changed inputs, the copy-back of the
carried state between replays, the clone handed out) runs here as it runs
on the card:

- what recaptures (a new key: options, capacity, batch slots) and what
  only copies in (targets, configs, particles added or removed, a state
  set from outside), and that nothing unchanged is copied;
- every engine's route (gather, dense fused, plane, per pass) through
  ``update`` (one and several steps), ``step_once`` and ``run_steps``,
  with add, remove, a target change, a config reload and a checkpoint load
  between updates, bit for bit against a handler that steps eagerly;
- a state, stats and gate state handed out before are not overwritten by
  later replays;
- the Python launch counters: a replay moves none of them (it runs no
  Python); the write-back of outputs that alias the inputs.
"""

import os
import tempfile

import pytest
import torch

import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu_torch import checkpoint
from egg_fluid_simulation_tpu_torch.ops import solver as S
from egg_fluid_simulation_tpu_torch.ops import step_graph as SG
from egg_fluid_simulation_tpu_torch.ops.kernels import gather_kernel as GK
from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK

FIELDS = ("pos", "prev", "vel", "last_pos", "inv_mass", "radius", "mass_t",
          "batch_slot", "color", "count", "batch_target", "batch_radius",
          "batch_used")

DENSE = dict(engine="dense", dense_grid_dim=16, dense_slots=4,
             pop_caps=(256, 256))
ROUTES = {
    "gather": None,                                   # automatic options
    "fused": dict(DENSE, budget_mode="off"),
    "plane": dict(DENSE, budget_mode="ordered"),
    "pass": dict(DENSE, budget_mode="ordered", dense_rebin="pass"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _handler(route, graph: bool):
    opts = ROUTES[route]
    h = T.SimulationHandler(
        T.default_white_config(), T.default_yolk_config(), capacity=256,
        max_batches=8, device="cpu",
        options=None if opts is None else T.SolverOptions(**opts))
    if graph:
        h._step_graphs = SG.StepGraphs(capture=False)
    return h


def _assert_same(a, b, what):
    """Handler ``b`` (graph) holds ``a``'s (eager) state, stats and gate
    state bit for bit."""
    for f in FIELDS:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), \
            f"{what}: state.{f}"
    for f in ("aabb_min", "aabb_max", "centroid", "last_centroid",
              "max_radius", "max_velocity", "batch_pos_sum", "batch_count"):
        assert torch.equal(getattr(a.stats, f), getattr(b.stats, f)), \
            f"{what}: stats.{f}"
    assert ([[int(v) for v in w] for w in a._wide_state]
            == [[int(v) for v in w] for w in b._wide_state]), what


def _load(h, g):
    """Copy the handler's current inputs into graph ``g``: the count of
    inputs copied."""
    dt, relax = h._step_scalars(1 / 60)
    return g.load(h.state, h._device_cfg2(), dt, relax, h._wide_or_init())


def _only_graph(h) -> SG.StepGraph:
    (g,) = h._step_graphs._graphs.values()
    return g


def test_graph_key():
    h = _handler("gather", graph=False)
    h.add(100.0, 100.0, 20.0, 6.0, None, None, 30, 5)
    o = h._options
    key = SG.graph_key(h.state, o)
    moved = h.state.replace(pos=h.state.pos + 1.0)
    assert SG.graph_key(moved, o) == key                 # values: no
    assert SG.graph_key(h.state, o) != SG.graph_key(
        h.state, S.SolverOptions(**{**vars(o), "n_substeps": 3}))
    other = T.SimulationHandler(T.default_white_config(), capacity=512,
                                max_batches=8, device="cpu")
    assert SG.graph_key(other.state, o) != key           # capacity
    other = T.SimulationHandler(T.default_white_config(), capacity=256,
                                max_batches=4, device="cpu")
    assert SG.graph_key(other.state, o) != key           # batch slots


def test_what_recaptures_and_what_copies_in():
    h = _handler("gather", graph=True)
    a = h.add(100.0, 100.0, 20.0, 6.0, None, None, 30, 5)
    h.update(1 / 60)
    assert h._step_graphs.captures == 1
    g = _only_graph(h)
    assert _load(h, g) == 0              # the replay left everything held
    h.update(1 / 60)
    h.set_target_position(a, 140.0, 90.0)
    h._flush_targets()
    assert _load(h, g) == 1              # state.batch_target
    h.update(1 / 60)
    h.set_white_config({"follow_strength": 0.5})
    assert _load(h, g) == len(vars(h._device_cfg2()))   # the config fields
    h.update(1 / 60)
    h.add(150.0, 120.0, 20.0, 6.0, None, None, 30, 5)   # same options
    assert _load(h, g) > 0
    h.update(1 / 60)
    h.remove(a)
    h.update(3 / 60)                     # three steps, replayed
    assert h._step_graphs.captures == 1
    h.update(1 / 60, n_substeps=3)       # new options: a new capture
    assert h._step_graphs.captures == 2
    h.step_once()
    h.update(1 / 60, n_substeps=2)       # back to the first key, kept
    assert h._step_graphs.captures == 2


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_replay_matches_eager_steps(route):
    eager, graph = _handler(route, False), _handler(route, True)
    hs = (eager, graph)
    ids = [h.add(100.0, 100.0, 20.0, 6.0, None, None, 40, 6) for h in hs]
    for h in hs:
        h.update(1 / 60)
    _assert_same(*hs, "first update (the build)")
    for h in hs:
        h.update(1 / 60)
        h.update(3 / 60)                 # three steps in one call
    _assert_same(*hs, "replays")
    for h in hs:
        h.add(150.0, 110.0, 20.0, 6.0, None, None, 40, 6)
        h.step_once()
    _assert_same(*hs, "add")
    for h, a in zip(hs, ids):
        h.set_target_position(a, 130.0, 80.0)
        h.update(1 / 60)
    _assert_same(*hs, "target change")
    for h in hs:
        h.set_yolk_config({"cohesion_strength": 0.3})
        h.update(1 / 60)
    _assert_same(*hs, "config reload")
    for h, a in zip(hs, ids):
        h.remove(a)
        h.update(1 / 60)
    _assert_same(*hs, "remove")
    for h in hs:
        h.run_steps(2)
    _assert_same(*hs, "run_steps")
    # a checkpoint load: the loaded handler takes the same captured step,
    # whose every input is then copied in
    with tempfile.TemporaryDirectory() as tmp:
        loaded = []
        for i, h in enumerate(hs):
            path = os.path.join(tmp, f"{i}.npz")
            checkpoint.save(h, path)
            loaded.append(checkpoint.load(path, options=h._options,
                                          device="cpu"))
    loaded[1]._step_graphs = graph._step_graphs
    for h in loaded:
        h.update(1 / 60)
    _assert_same(*loaded, "checkpoint load")
    assert graph._step_graphs.captures == 1
    assert float((loaded[1].state.pos - loaded[1].state.last_pos)
                 .abs().max()) > 0.0


def test_handed_out_state_is_not_overwritten():
    h = _handler("fused", graph=True)
    h.add(100.0, 100.0, 20.0, 6.0, None, None, 40, 6)
    h.update(1 / 60)
    state, stats, wide = h.state, h.stats, h._wide_state
    kept = ({f: getattr(state, f).clone() for f in FIELDS},
            {f: v.clone() for f, v in vars(stats).items()},
            [[v.clone() for v in w] for w in wide])
    for _ in range(3):
        h.update(1 / 60)
    assert not torch.equal(h.state.pos, state.pos)       # it moved on
    for f, v in kept[0].items():
        assert torch.equal(getattr(state, f), v), f
    for f, v in kept[1].items():
        assert torch.equal(getattr(stats, f), v), f
    for w, k in zip(wide, kept[2]):
        assert all(torch.equal(a, b) for a, b in zip(w, k))
    # the handed-out tensors are not the graph's own buffers
    g = _only_graph(h)
    for buf in (g._in_flat, g._stats_flat):
        for t in (state.pos, stats.centroid):
            assert t.untyped_storage().data_ptr() != \
                buf.untyped_storage().data_ptr()


def _counters():
    return (GK.launches, GK.count_launches, SK.launches, SK.sweep_launches,
            SK.count_launches, S.host_syncs, list(S.rebins))


def test_replay_moves_no_counter():
    """A replay runs the recorded launches without Python: the wrappers'
    counters (and the solver's) stay as the capture left them."""
    h = _handler("gather", graph=True)
    h.add(100.0, 100.0, 20.0, 6.0, None, None, 30, 5)
    h.update(1 / 60)
    g = _only_graph(h)

    class _Graph:                        # a captured graph that runs nothing
        replays = 0

        def replay(self):
            _Graph.replays += 1

    g._graph = _Graph()
    before = _counters()
    h.update(3 / 60)
    h.run_steps(2)
    assert _Graph.replays == 5
    assert _counters() == before


def test_write_back_copies_handed_through_inputs_first():
    """``last_pos`` is the step's input ``pos``: it is copied before ``pos``
    is written; an output that is its own buffer is skipped."""
    buf = torch.arange(6, dtype=torch.float32)
    pos, last = buf[0:3], buf[3:6]
    new_pos = torch.full((3,), 9.0)
    SG._write_back([(pos, new_pos), (last, pos)])
    assert buf.tolist() == [9.0, 9.0, 9.0, 0.0, 1.0, 2.0]
    SG._write_back([(pos, pos)])
    assert buf.tolist() == [9.0, 9.0, 9.0, 0.0, 1.0, 2.0]


def test_cpu_handler_steps_eagerly():
    """A CPU handler captures nothing; ``_step_graphs = step_graph.EAGER``
    (how a measurement runs the eager step) turns the graph route off on
    any device."""
    h = T.SimulationHandler(T.default_white_config(), capacity=256,
                            max_batches=4, device="cpu")
    h.add(100.0, 100.0, 20.0, 6.0, None, None, 30, 5)
    h.update(1 / 60)
    h.run_steps(2)
    assert h._step_graphs is None and h._graphs() is None
    h._step_graphs = SG.EAGER
    assert h._graphs() is None
    h.update(1 / 60)
    assert h._step_graphs is SG.EAGER
