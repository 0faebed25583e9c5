"""The port's spans and counters (``utils/profiling.py``), on the CPU.

- ``span`` is one shared no-op without a profiler: ``update``, ``draw`` and
  ``run_steps`` make no ``record_function`` then, and read the device no
  more than ``render.host_reads`` counts;
- under ``profiling.trace`` the spans of ``update``, ``draw`` (the eager
  render and the render graphs' plumbing) and ``run_steps`` (the resident
  graphs' plumbing, and the gather engine's loop of steps) are in the
  trace, each inside the span the table of ``PERF.md`` gives it, graph
  builds and the library's load included;
- the draw's counters on the overflowing cluster of
  ``tests/test_torch_render_graph.py``: ``rerenders``, ``rerenders_skipped``
  and ``dropped`` count, and ``host_reads`` reads 2 + 2 r; the cluster that
  stays over the budget's cap re-renders once, then skips the two attempts
  whose options no longer change; a clean scene re-renders nothing and
  reads twice;
- ``step_graph.capture_seconds`` and each cache's ``captures`` rise on a
  graph build and not on a replay (``capture=False``: the plumbing, no
  graph); ``graph_census``, ``resident_rebins`` and ``counters``;
- ``library.load_seconds`` and its span; the demo overlay times ``update``
  with ``StepTimer``.
"""

import json
import time
from collections import OrderedDict

import pytest
import torch

import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu_torch.demo import DemoState
from egg_fluid_simulation_tpu_torch.ops import render as R
from egg_fluid_simulation_tpu_torch.ops import render_graph as RG
from egg_fluid_simulation_tpu_torch.ops import step_graph as SG
from egg_fluid_simulation_tpu_torch.ops.kernels import library
from egg_fluid_simulation_tpu_torch.ops.resident_graph import ResidentGraphs
from egg_fluid_simulation_tpu_torch.utils import profiling

OPTS = dict(engine="dense", budget_mode="off", dense_rebin="step",
            dense_grid_dim=32, dense_slots=8)
VIEW = (0.0, 0.0, 160, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _handler(graphs: bool, capacity=256, canvas_size=256):
    h = T.SimulationHandler(T.default_white_config(), T.default_yolk_config(),
                            capacity=capacity, max_batches=8,
                            canvas_size=canvas_size,
                            options=T.SolverOptions(**OPTS), device="cpu")
    if graphs:
        h._step_graphs = SG.StepGraphs(capture=False)
        h._render_graphs = RG.RenderGraphs(capture=False)
        h._resident = ResidentGraphs(capture=False)
    return h


def _spawned(graphs: bool):
    h = _handler(graphs)
    h.add(120.0, 100.0, 30.0, 10.0, None, None, 60, 12)
    return h


def _clustered(white: int):
    """``tests/test_torch_render_graph.py``'s cluster: a dense clump in a
    huge AABB whose first draw overflows the density-sized budget; 300
    white particles drop nothing after one boost, 400 crowd one bin past
    the budget's cap of 256 and keep dropping."""
    h = _handler(False, capacity=1024, canvas_size=1024)
    h.add(200.0, 200.0, 20.0, 8.0, None, None, white, 20)
    h.add(5000.0, 5000.0, 8.0, 4.0, None, None, 10, 3)
    h.step_once()
    return h


def _frame(h, bid, t):
    """One frame of an app: a target, ``update``, ``draw``."""
    h.set_target_position(bid, 120.0 + t, 100.0)
    h.update(1 / 60)
    h.draw(viewport=VIEW)


# --------------------------------------------------------------- off ----

def test_span_off_is_one_shared_noop():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("egg.a"), profiling.span("egg.b")
    assert a is b
    with a, b:                                # re-entrant
        pass


def test_no_record_function_and_no_extra_read_without_a_profiler(
        monkeypatch):
    h = _spawned(True)
    bid = next(iter(h._batches))
    _frame(h, bid, 0)                         # the graphs built
    h.run_steps(3)

    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    reads = []
    real_cpu = torch.Tensor.cpu

    def counted_cpu(self, *a, **k):
        reads.append(1)
        return real_cpu(self, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    R.host_reads = 0
    for t in range(1, 3):
        _frame(h, bid, t)
        h.run_steps(3)
    # every read of the device draw makes is one render.host_reads counts
    assert R.host_reads == 4 and len(reads) == R.host_reads


# ---------------------------------------------------------------- on ----

def _spans(trace_dir):
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e.get("name", "").startswith("egg.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parents(spans):
    """name -> the set of names of the innermost spans holding it."""
    out = {}
    for i, (name, a, b) in enumerate(spans):
        holders = [s for j, s in enumerate(spans)
                   if j != i and s[1] <= a and b <= s[2]]
        inner = min(holders, key=lambda s: s[2] - s[1])[0] if holders \
            else None
        out.setdefault(name, set()).add(inner)
    return out


def test_spans_nest_under_a_trace(tmp_path):
    h = _spawned(True)
    bid = next(iter(h._batches))
    with profiling.trace(str(tmp_path)):
        _frame(h, bid, 0)                     # builds the step and render
        _frame(h, bid, 1)                     # replays them
        h.draw(viewport=VIEW)                 # the cached frame
        h.run_steps(4)                        # builds the resident loop
        h.run_steps(4)
    parents = _parents(_spans(tmp_path))
    assert parents == {
        "egg.update": {None},
        "egg.update.targets": {"egg.update"},
        "egg.update.step": {"egg.update"},
        "egg.graph.capture.step": {"egg.update.step"},
        "egg.draw": {None},
        "egg.draw.read_stats": {"egg.draw"},
        "egg.draw.render": {"egg.draw"},
        "egg.graph.capture.render": {"egg.draw.render"},
        "egg.draw.read_audit": {"egg.draw"},
        "egg.run_steps": {None},
        "egg.run_steps.load": {"egg.run_steps"},
        "egg.graph.capture.resident": {"egg.run_steps.load"},
        "egg.run_steps.replay": {"egg.run_steps"},
        "egg.run_steps.final": {"egg.run_steps"},
        "egg.graph.capture.final": {"egg.run_steps.final"},
    }
    spans = _spans(tmp_path)
    count = {n: sum(1 for s in spans if s[0] == n) for n in parents}
    assert count["egg.draw"] == 3 and count["egg.draw.render"] == 2
    assert count["egg.run_steps.replay"] == 2
    assert count["egg.graph.capture.resident"] == 1


def test_a_gather_run_steps_loop_under_a_trace(tmp_path):
    """A gather handler's ``run_steps`` is a loop of steps from the step
    cache: its span ``egg.run_steps.loop`` sits in ``egg.run_steps`` (not
    in ``update``'s ``egg.update.step``) and holds the cache's first
    build."""
    h = T.SimulationHandler(T.default_white_config(),
                            T.default_yolk_config(), capacity=256,
                            max_batches=8, device="cpu",
                            options=T.SolverOptions(engine="gather"))
    h._step_graphs = SG.StepGraphs(capture=False)
    h.add(120.0, 100.0, 30.0, 10.0, None, None, 60, 12)
    with profiling.trace(str(tmp_path)):
        h.run_steps(3)                        # builds the step
        h.run_steps(3)                        # replays it
    spans = _spans(tmp_path)
    assert _parents(spans) == {
        "egg.run_steps": {None},
        "egg.run_steps.loop": {"egg.run_steps"},
        "egg.graph.capture.step": {"egg.run_steps.loop"},
    }
    count = {n: sum(1 for s in spans if s[0] == n)
             for n in ("egg.run_steps.loop", "egg.graph.capture.step")}
    assert count == {"egg.run_steps.loop": 2, "egg.graph.capture.step": 1}


def test_an_eager_draw_and_its_rerenders_under_a_trace(tmp_path):
    h = _clustered(300)
    with profiling.trace(str(tmp_path)):
        h.draw(viewport=(0, 0, 256, 256))
    spans = _spans(tmp_path)
    parents = _parents(spans)
    assert parents["egg.draw.rerender"] == {"egg.draw"}
    assert parents["egg.draw.read_stats"] == {"egg.draw",
                                              "egg.draw.rerender"}
    assert parents["egg.draw.render"] == {"egg.draw", "egg.draw.rerender"}
    assert parents["egg.draw.read_audit"] == {"egg.draw",
                                              "egg.draw.rerender"}
    assert "egg.graph.capture.render" not in parents       # eager


# ----------------------------------------------------------- counters ----

@pytest.mark.parametrize("white,rerenders,skipped", [(300, 1, 0),
                                                     (400, 1, 2)],
                         ids=["300-1", "400-1"])
def test_overflow_counts_rerenders_and_drops(white, rerenders, skipped):
    """300: one re-render cleans the frame. 400: one re-render raises the
    budget to its cap of 256 and the frame still drops splats; the other
    two attempts would draw at the same options, so they are skipped."""
    h = _clustered(white)
    R.host_reads = R.rerenders = R.rerenders_skipped = R.dropped = 0
    h.draw(viewport=(0, 0, 256, 256), check_overflow=True)
    assert R.rerenders == rerenders
    assert R.rerenders_skipped == skipped
    assert R.host_reads == 2 + 2 * rerenders
    assert R.dropped > 0
    dirty = int(h._render_budget.audit[:, 0].sum()) > 0
    assert dirty == (skipped > 0)
    if dirty:                                 # three attempts in all
        assert R.rerenders + R.rerenders_skipped == 3
        assert [o.tile_capacity for o in h._frame_options()][0] == 256


def test_a_clean_scene_rerenders_nothing():
    h = _spawned(False)
    h.update(1 / 60)
    R.host_reads = R.rerenders = R.rerenders_skipped = R.dropped = 0
    h.draw(viewport=VIEW)
    assert (R.host_reads, R.rerenders, R.rerenders_skipped,
            R.dropped) == (2, 0, 0, 0)


def test_captures_and_capture_seconds_rise_on_a_build_only():
    h = _spawned(True)
    bid = next(iter(h._batches))
    census0 = h.graph_census
    assert all(v == {"kept": 0, "captures": 0} for v in census0.values())
    s0 = SG.capture_seconds
    _frame(h, bid, 0)
    s1 = SG.capture_seconds
    assert s1 > s0
    census = h.graph_census
    assert census["step"] == {"kept": 1, "captures": 1}
    assert census["render"] == {"kept": 1, "captures": 1}
    for t in range(1, 3):                     # replays
        _frame(h, bid, t)
    assert SG.capture_seconds == s1 and h.graph_census == census
    h.run_steps(4)
    s2 = SG.capture_seconds
    assert s2 > s1
    census = h.graph_census
    assert census["resident"] == {"kept": 1, "captures": 1}
    assert census["final"] == {"kept": 1, "captures": 1}
    h.run_steps(4)
    assert SG.capture_seconds == s2 and h.graph_census == census


def test_cpu_handler_census_and_rebins_are_empty():
    h = _spawned(False)
    h.update(1 / 60)
    h.draw(viewport=VIEW)
    h.run_steps(4)
    assert all(v == {"kept": 0, "captures": 0}
               for v in h.graph_census.values())
    assert h.resident_rebins is None
    h._step_graphs = SG.EAGER
    h._render_graphs = RG.EAGER
    assert h.graph_census["step"] == {"kept": 0, "captures": 0}


def test_counters_read_the_resident_rebins_as_a_copy():
    h = _spawned(True)
    assert h.resident_rebins is None
    h.run_steps(6)
    got = profiling.counters(h)
    rebins = got["resident_rebins"]
    assert rebins.shape == (2,) and rebins.dtype == torch.int32
    assert torch.equal(rebins, h._resident.rebins)
    assert rebins.data_ptr() != h._resident.rebins.data_ptr()
    assert got["captures"] == {k: v["captures"]
                               for k, v in h.graph_census.items()}
    for key in ("host_reads", "rerenders", "rerenders_skipped", "dropped",
                "host_syncs", "rebins", "capture_seconds", "load_seconds"):
        assert key in got
    assert "captures" not in profiling.counters()


def test_a_library_load_inside_a_build_is_not_capture_time(monkeypatch):
    def slow_open():
        time.sleep(0.3)
        return object()

    def make():
        library.load()
        time.sleep(0.02)
        return "graph"

    monkeypatch.setattr(library, "_lib", None)
    monkeypatch.setattr(library, "open_build", slow_open)
    s0, l0 = SG.capture_seconds, library.load_seconds
    cache = OrderedDict()
    assert SG.kept(cache, "k", make, 1, "step") == ("graph", True)
    assert SG.kept(cache, "k", make, 1, "step") == ("graph", False)
    assert library.load_seconds - l0 >= 0.3
    assert 0.02 <= SG.capture_seconds - s0 < 0.3


# ------------------------------------------------------------ library ----

def test_library_load_is_timed_and_a_span(monkeypatch, tmp_path):
    assert not hasattr(library, "last_build_seconds")
    lib = object()
    monkeypatch.setattr(library, "_lib", None)
    monkeypatch.setattr(library, "open_build", lambda: lib)
    before = library.load_seconds
    with profiling.trace(str(tmp_path)):
        assert library.load() is lib
        assert library.load() is lib          # loaded: no second span
    assert library.load_seconds > before
    assert [s[0] for s in _spans(tmp_path)] == ["egg.library.load"]


# --------------------------------------------------------------- demo ----

def test_demo_overlay_times_update_with_the_step_timer():
    demo = DemoState(capacity=1024, device="cpu")
    demo.spawn_batch()
    assert demo.overlay_stats()["mean_update_ms"] == 0.0
    for _ in range(3):
        demo.update(1 / 60)
    ms = demo.timer.samples("update")
    assert len(ms) == 3 and all(m > 0 for m in ms)
    stats = demo.overlay_stats()
    assert stats["mean_update_ms"] == pytest.approx(sum(ms) / 3)
    assert stats["frame_usage_pct"] == pytest.approx(
        demo.timer.frame_usage_pct("update"))
