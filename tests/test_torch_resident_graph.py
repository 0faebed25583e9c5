"""The resident loops run as graph parts (``ops/resident_graph.py``) on the
CPU.

On a CUDA device ``multi_step``'s resident route and ``multi_step_frames``
replay captured parts (enter, step or frame, exit) with the rebin in an IF
node of the graph; on the CPU they run eagerly. ``ResidentGraphs(capture=
False)`` runs the same parts eagerly on the graphs' static buffers, so the
plumbing a capture relies on (the split into parts over carried buffers,
the copy-in, the key, the rebin branch writing only into buffers made
before it, the device rebin counter, the fresh state handed to each frame)
runs here as it runs on the card:

- replayed-plumbing ``multi_step`` (n = 1, 2, 5) against the eager one, bit
  for bit: fused and plane-resident variants, the wide gate on and off, a
  scene that rebins and one that does not; equal rebin counts;
- a second call copies in without a new capture, a new key captures;
- ``_rebin_if`` runs its branch exactly when the flag is true, and the
  branch writes into the loop's buffers only;
- ``multi_step_frames`` bit for bit, ``last_pos`` and the frame totals
  included; each frame's state is fresh (a render graph's ``copy_in`` skips
  a tensor object whose version is unchanged);
- one case of each loop against the JAX package at
  ``tests/test_torch_resident.py``'s tolerances, the JAX step pinned to its
  plane path as there.

Scenes and tolerances: ``tests/test_torch_resident.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egg_fluid_simulation_tpu import state as jstate
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu_torch.interop import state_from_numpy
from egg_fluid_simulation_tpu_torch.interop import state_to_numpy
from egg_fluid_simulation_tpu_torch.ops import solver as S
from egg_fluid_simulation_tpu_torch.ops import step_graph as SG
from egg_fluid_simulation_tpu_torch.ops.resident_graph import (
    ResidentGraphs, resident_key)
from test_torch_resident import BASE, assert_states_close, scene
from test_torch_step import _configs

DT, RELAX = torch.tensor(1 / 60), torch.tensor(1.0)
_, CFG = _configs()


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel
    monkeypatch.setattr(sweep_kernel, "FORCE_INTERPRET", False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _zero_counters():
    S.rebins[:] = [0, 0]
    S.host_syncs = 0


def _opts(**kw):
    return S.SolverOptions(**{**BASE, **kw})


def _wide(opts):
    return (S.wide_state_init(opts),) * 2


def _steps(d, opts, n, graphs=None):
    return S.multi_step(state_from_numpy(d), CFG, DT, RELAX, opts, n,
                        wide_state=_wide(opts), graphs=graphs)


def _assert_equal(a, b):
    """Two ``(state, stats or None, wide_state)``, bit for bit."""
    for f in dataclasses.fields(a[0]):
        assert torch.equal(getattr(a[0], f.name), getattr(b[0], f.name)), \
            f.name
    if a[1] is not None:
        for f in dataclasses.fields(a[1]):
            assert torch.equal(getattr(a[1], f.name),
                               getattr(b[1], f.name)), f.name
    for wa, wb in zip(a[2], b[2]):
        assert all(torch.equal(x, y) for x, y in zip(wa, wb))


@pytest.mark.parametrize("n,kw,wide,kind", [
    (5, {}, 0, "rebin"), (5, {}, 240, "calm"),
    (5, dict(sweep_symmetric=True), 240, "rebin"),
    (5, dict(sweep_symmetric=True), 0, "calm"),
    (2, {}, 240, "rebin"), (1, {}, 0, "rebin")],
    ids=["fused-wide_off-rebin-5", "fused-wide_240-calm-5",
         "plane-wide_240-rebin-5", "plane-wide_off-calm-5",
         "fused-wide_240-rebin-2", "fused-wide_off-rebin-1"])
def test_steps_replay_equals_eager(n, kw, wide, kind):
    d = scene(kind)
    opts = _opts(wide_budget_substeps=wide, **kw)
    want = _steps(d, opts, n)
    eager_rebins = list(S.rebins)
    S.rebins[:] = [0, 0]
    graphs = ResidentGraphs(capture=False)
    _assert_equal(_steps(d, opts, n, graphs), want)
    assert list(S.rebins) == eager_rebins
    if n > 1:
        assert graphs.rebins.tolist() == eager_rebins
        assert graphs.captures == 1
    if kind == "calm":
        assert eager_rebins == [0, 0]
    elif n == 5:
        assert min(eager_rebins) > 0


def test_second_call_copies_in_and_a_new_key_captures():
    opts = _opts(wide_budget_substeps=240)
    graphs = ResidentGraphs(capture=False)
    st = state_from_numpy(scene("rebin"))
    s1, _, w1 = S.multi_step(st, CFG, DT, RELAX, opts, 3,
                             wide_state=_wide(opts), graphs=graphs)
    got = S.multi_step(s1, CFG, DT, RELAX, opts, 3, wide_state=w1,
                       graphs=graphs)
    _assert_equal(got, S.multi_step(s1, CFG, DT, RELAX, opts, 3,
                                    wide_state=w1))
    assert graphs.captures == 1
    g = graphs._graphs[resident_key("steps", st, opts)]
    # the carried state and the gate state are new values; the rest is
    # held at its version, so nothing else copies in
    assert g.load(got[0], CFG, DT, RELAX, got[2]) == 6 + 6
    assert g.load(got[0], CFG, DT, RELAX, got[2]) == 0
    # a new key: other options, or the frame loop of the same options
    S.multi_step(st, CFG, DT, RELAX, _opts(sweep_symmetric=True), 3,
                 wide_state=_wide(opts), graphs=graphs)
    assert graphs.captures == 2
    S.multi_step_frames(st, CFG, DT, RELAX, opts, 1,
                        lambda s, stats: torch.zeros(()),
                        wide_state=_wide(opts), graphs=graphs)
    assert graphs.captures == 3
    assert len(graphs._graphs) == ResidentGraphs.MAX_GRAPHS
    assert resident_key("steps", st, opts) not in graphs._graphs


def test_rebin_if_runs_the_branch_exactly_when_true():
    runs, nodes = [], []

    def fn():
        runs.append(1)
    S._rebin_if(torch.tensor(True), 1, fn)
    S._rebin_if(torch.tensor(False), 0, fn)
    assert (len(runs), S.host_syncs, S.rebins) == (1, 2, [0, 1])
    # forced: no host read, nothing counted on the host
    S._rebin_if(torch.tensor(False), 0, fn, force=True)
    S._rebin_if(torch.tensor(True), 0, fn, force=False)
    assert (len(runs), S.host_syncs, S.rebins) == (2, 2, [0, 1])
    # a graph's capture records the branch instead of running it
    S._rebin_if(torch.tensor(True), 0, fn,
                cond=lambda pred, i: nodes.append((bool(pred), i)))
    assert (len(runs), S.host_syncs, nodes) == (2, 2, [(True, 0)])


@pytest.mark.parametrize("loop_cls", [S.ResidentSteps, S.FrameLoop])
def test_rebin_writes_only_into_the_loop_buffers(loop_cls):
    """Forced rebins every step: the layout, slots, drift references,
    fallback arrays and gate state stay the tensors made at the enter, at
    the same addresses, and take new values; the device counter counts."""
    opts = _opts(wide_budget_substeps=240)
    counter = torch.zeros((2,), dtype=torch.int32)
    loop = loop_cls(state_from_numpy(scene("rebin")), CFG, DT, RELAX, opts,
                    _wide(opts), counter=counter)

    def buffers():
        return [t for r in loop.pops
                for t in (*r.grid, r.slot, *r.fb, r.ref_p, r.ref_xy,
                          *r.ws)]
    before = buffers()
    ptrs = [t.data_ptr() for t in before]
    refs = [r.ref_p.clone() for r in loop.pops]
    for _ in range(3):
        if loop_cls is S.ResidentSteps:
            loop.step(force=True)
        else:
            loop.frame(force=True)
    after = buffers()
    assert all(a is b for a, b in zip(after, before))
    assert [t.data_ptr() for t in after] == ptrs
    assert counter.tolist() == [3, 3]
    assert S.host_syncs == 0
    for r, ref in zip(loop.pops, refs):
        assert not torch.equal(r.ref_p, ref)        # rebinned


def _frames(d, opts, n, graphs=None):
    seen = []

    def frame_fn(state, stats, t):
        seen.append((t, state, stats))
        return torch.sum(stats.centroid) + torch.sum(state.last_pos)
    out = S.multi_step_frames(state_from_numpy(d), CFG, DT, RELAX, opts, n,
                              frame_fn, wide_state=_wide(opts),
                              graphs=graphs)
    return out, seen


def test_frames_replay_equals_eager():
    d, opts = scene("rebin"), _opts(wide_budget_substeps=240)
    (st_e, tot_e, w_e), seen_e = _frames(d, opts, 4)
    eager_rebins = list(S.rebins)
    graphs = ResidentGraphs(capture=False)
    (st_g, tot_g, w_g), seen_g = _frames(d, opts, 4, graphs)
    _assert_equal((st_g, None, w_g), (st_e, None, w_e))
    assert torch.equal(tot_g, tot_e)
    assert min(eager_rebins) > 0
    assert graphs.rebins.tolist() == eager_rebins
    for (t, a, sa), (u, b, sb) in zip(seen_g, seen_e):
        assert t == u
        _assert_equal((a, sa, ()), (b, sb, ()))
    # last_pos is the previous frame's position
    assert torch.equal(seen_g[-1][1].last_pos, seen_g[-2][1].pos)


def test_each_frame_state_is_fresh():
    """A frame_fn that copies its inputs into static buffers through
    ``step_graph.copy_in`` (as the render graph does) copies every frame:
    each frame hands out new tensors, never the loop's buffers, and their
    values are that frame's."""
    d, opts = scene("rebin"), _opts(wide_budget_substeps=240)
    static = [torch.zeros_like(state_from_numpy(d).pos) for _ in range(2)]
    static_c = torch.zeros((2, 2))
    held, copied, views, handed = {}, [], [], []

    def frame_fn(state, stats):
        copied.append(SG.copy_in(held, [
            ("pos", static[0], state.pos),
            ("last_pos", static[1], state.last_pos),
            ("centroid", static_c, stats.centroid)]))
        views.append(static[0].clone())
        handed.append(state.pos)
        return torch.zeros(())
    graphs = ResidentGraphs(capture=False)
    S.multi_step_frames(state_from_numpy(d), CFG, DT, RELAX, opts, 3,
                        frame_fn, wide_state=_wide(opts), graphs=graphs)
    loop = next(iter(graphs._graphs.values())).loop
    assert copied == [3, 3, 3]
    assert len({id(t) for t in handed}) == 3
    assert all(t is not b for t in handed for b in loop.buf)
    (_, _, _), seen = _frames(d, opts, 3)
    for v, (_, state, _) in zip(views, seen):
        assert torch.equal(v, state.pos)


def test_replayed_loops_match_jax():
    d = scene("rebin")
    kw = dict(BASE, wide_budget_substeps=240)
    oj, ot = jsolver.SolverOptions(**kw), S.SolverOptions(**kw)
    cj, _ = _configs()
    sj = jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()})
    sj6, stats_j, wj = jsolver.multi_step(
        sj, cj, jnp.float32(1 / 60), jnp.float32(1.0), oj, 6,
        wide_state=(jsolver.wide_state_init(oj),) * 2)
    graphs = ResidentGraphs(capture=False)
    st6, stats_t, wt = _steps(d, ot, 6, graphs)
    a = {k: np.asarray(jax.block_until_ready(v)) for k, v in vars(sj6).items()}
    assert_states_close(a, state_to_numpy(st6), stats_j, stats_t)
    for pop in (0, 1):
        assert [int(x) for x in wt[pop]] == [int(x) for x in wj[pop]]
    assert min(graphs.rebins.tolist()) > 0

    def frame_j(state, stats):
        return jnp.sum(stats.centroid)
    sj3, acc_j = jsolver.multi_step_frames(sj, cj, jnp.float32(1 / 60),
                                           jnp.float32(1.0), oj, 3, frame_j)
    st3, acc_t, _ = S.multi_step_frames(
        state_from_numpy(d), CFG, DT, RELAX, ot, 3,
        lambda state, stats: torch.sum(stats.centroid),
        wide_state=_wide(ot), graphs=graphs)
    assert_states_close({k: np.asarray(v) for k, v in vars(sj3).items()},
                        state_to_numpy(st3))
    # 3 frames of 4 centroid components, each within 1e-3 px
    np.testing.assert_allclose(float(acc_t), float(acc_j), rtol=0,
                               atol=12e-3)
