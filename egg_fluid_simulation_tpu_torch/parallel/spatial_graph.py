"""The spatial layer's step, resident steps and draw captured in CUDA graphs
and replayed: how a CUDA :class:`~.spatial_handler.SpatialHandler` runs
``update``, ``step_once``, ``run_steps`` and ``draw``.

The JAX package compiles each of ``spatial_step``, ``spatial_multi_step``
and ``spatial_draw`` as one ``jax.jit`` of a ``shard_map`` body; its
resident loop takes the rebin decision in a ``lax.cond`` on psum'd
predicates, on the device. Here each is split into parts that read and
write buffers made once, each part captured once and replayed (the model of
``ops/step_graph.py``, ``ops/resident_graph.py`` and
``ops/render_graph.py``):

- ``step``: one part, :func:`.spatial.spatial_step` on the static inputs;
- ``steps``: the *enter* (bin both populations, fill the halos), the *step*
  (the substeps with their halo refreshes, the fallback, the mesh-summed
  drift count as a device flag, the rebin branch on it) and the *exit* (the
  final migration, the stats) of
  :class:`.spatial.SpatialSteps`; ``run_steps(n)`` replays enter, ``n``
  steps and exit;
- the draw: :func:`.spatial.draw_frame` (:class:`SpatialDrawGraph`), its
  outputs the frame and the render-budget audit, combined over the mesh in
  the graph (the handler reads the audit once a frame, as ``render.draw``
  does, and re-renders with a boosted budget when splats dropped).

Each population's rebin branch (``_SpatialPop.rebin``: migrate, bin, the
full halo exchange, all written into the loop's buffers) is captured first
into a graph in a pool of its own. The (2,) int32 device counter
``rebins`` adds one per population and taken branch. How the step takes
the branch is fixed by the mesh (:func:`rebin_route`):

- ``if_node`` (one rank): the step's capture adds an IF node on the
  mesh-summed flag whose body is a copy of the branch's graph
  (``csrc/graph_cond.cu``, ``egg_if_node``). No part reads the device: a
  call reads it once, for the migration counters and the rebins of the
  call together (the handler's ``_after_step``), as the JAX handler reads
  its migration counters.
- ``host_flag`` (more ranks): the branch holds NCCL's point-to-point work
  (the migration's ring shifts, the full halo exchange), and its capture
  holds event record and wait nodes besides the kernels, which CUDA does
  not allow in a conditional body: the IF node's capture fails
  (``cudaErrorInvalidValue`` at the end of the capture, CUDA 12.8). So the
  step writes both populations' flags into a buffer, the host reads it
  once a step (``spatial.host_reads``), and each population's branch that
  is due replays as a graph of its own after the step (the populations'
  steps are independent, so the order is immaterial: the results are the
  eager loop's bit for bit).

Collectives stay what :class:`~.mesh.Mesh` makes them: on a one-rank axis a
ring shift is a copy and on a one-rank mesh an all-reduce is nothing, so the
1 x 1 graphs hold no NCCL work. On more than one rank the ring shifts and
all-reduces are NCCL work inside the graphs; every communicator starts in
the eager warm-up, before any capture, and the captures use
``capture_error_mode="thread_local"``, so the process group's watchdog
thread, which queries events, does not fail them.

Collective bytes: :class:`~.mesh.CollectiveCounter` adds at each call site,
on the host, and a replay runs no Python. So each part's bytes are tallied
once, in the warm-up (``tally``), and added at each run of the part; a
branch's bytes are added per rebin the device counter shows
(:meth:`SpatialGraphs.count_branches`, from the call's one read).

Keyed by the kind and the state's shapes and device (the mesh, layout and
options are the handler's own); ``MAX_GRAPHS`` kept of each. The first call
of a key runs every part once eagerly, the rebin forced, under
``torch.cuda.set_sync_debug_mode("error")`` (a device read there raises,
naming the op), then captures. A failed capture raises: nothing falls back
to the eager loop. ``SpatialGraphs(capture=False)`` runs the same parts
eagerly on the static buffers, reading the rebin flag on the host
(``spatial.host_reads``; per population and step on the ``if_node``
route, once a step on ``host_flag``): the plumbing on any device (how it is
tested on the CPU).
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict

import torch

from ..config import DeviceConfig
from ..ops import solver as solver_ops
from ..ops.render_graph import RenderGraph
from ..ops.resident_graph import LoopGraph
from ..ops.step_graph import kept, measured, sync_errors
from ..state import ParticleState, StepStats
from . import spatial as S
from .mesh import CAPTURE_ERROR_MODE, Mesh

__all__ = ["SpatialGraph", "SpatialGraphs", "SpatialDrawGraph",
           "spatial_key", "rebin_route", "CAPTURE_ERROR_MODE"]

KINDS = ("step", "steps")
# the state fields a step writes (spatial._unpack's)
STATE_OUT = ("pos", "prev", "vel", "last_pos", "radius", "mass_t",
             "inv_mass", "batch_slot", "color")


def rebin_route(mesh: Mesh) -> str:
    """How a replayed resident step takes its rebin branch, fixed by the
    mesh: ``"if_node"`` on one rank (an IF node of the step's graph on the
    device flag, no read), ``"host_flag"`` on more (see the module)."""
    return "if_node" if mesh.size == 1 else "host_flag"


def spatial_key(kind: str, state: ParticleState):
    """What changes the captured work of a handler's step or steps."""
    return (kind, state.capacity, state.max_batches, str(state.device))


def _clone_stats(stats: StepStats) -> StepStats:
    return StepStats(**{k: v.clone() for k, v in vars(stats).items()})


class SpatialGraph(LoopGraph):
    """One spatial step (``kind`` "step") or resident loop ("steps"), its
    parts captured (or, with ``capture=False``, run eagerly) on static
    buffers; see the module. Built from the first call's inputs, which it
    copies in; it warms up (and captures) but runs nothing for the call."""

    CAPTURE_ERROR_MODE = CAPTURE_ERROR_MODE

    def __init__(self, kind: str, mesh: Mesh, lay: S.SpatialLayout,
                 options: solver_ops.SolverOptions, state: ParticleState,
                 cfg2: DeviceConfig, step_delta, relaxation, wide_state,
                 counter: torch.Tensor, *, capture: bool):
        if kind not in KINDS:
            raise ValueError(f"spatial graph kind {kind!r}: expected one of "
                             f"{KINDS}")
        super().__init__(state, cfg2)
        self.kind, self.mesh, self.lay, self.options = kind, mesh, lay, options
        self.counter = counter
        if kind == "steps":
            S.SpatialSteps.check(lay, options)
        self._step_fn = (S.spatial_step(mesh, lay, options) if kind == "step"
                         else None)
        self.route = rebin_route(mesh)
        # host_flag: each population's rebin flag, written by the step
        self._flags = torch.zeros((2,), dtype=torch.bool, device=state.device)
        self._out = None           # the step's or the exit's outputs
        self.tally = {}            # part -> collective bytes a run
        self.load(state, cfg2, step_delta, relaxation,
                  wide_state if kind == "steps" else None)
        self._warm_up(capture)
        if capture:
            self._capture(state.device)

    # ------------------------------------------------------------- parts --

    def _step(self) -> None:
        new, stats, info = self._step_fn(self._state, self._cfg,
                                         *self._scalars)
        self._out = ({f: getattr(new, f) for f in STATE_OUT}, stats, info)

    def _enter(self) -> None:
        self.loop = S.SpatialSteps(self.mesh, self.lay, self.options,
                                   self._state, self._cfg, *self._scalars,
                                   self._wide, counter=self.counter)

    def _advance(self, cond=None) -> None:
        self.loop.step(cond=cond)

    def _advance_part(self) -> None:
        """The step part run eagerly: the flags kept (``host_flag``) or read
        at once (``if_node``)."""
        self._advance(cond=self._flag if self.route == "host_flag" else None)

    def _flag(self, pred, pop_index: int) -> None:
        self._flags[pop_index].copy_(pred)

    def _exit(self) -> None:
        self._out = self.loop.exit()

    def _counted(self, name: str, body) -> None:
        """``body()`` with its collective bytes recorded as ``name``'s tally
        and kept out of the mesh counter."""
        with self.mesh.counter.uncounted() as diff:
            body()
        self.tally[name] = diff

    def _warm_branch(self, pred, pop_index: int) -> None:
        self._counted(f"rebin.{pop_index}", self.loop.pops[pop_index].rebin)

    def _warm_up(self, capture: bool) -> None:
        """Every part once, eagerly, each branch taken, the bytes of each
        tallied; on a card with any read of the device an error (and NCCL's
        communicators started before a capture). The rebin counter is
        restored."""
        saved = self.counter.clone()
        with sync_errors() if capture else contextlib.nullcontext():
            if self.kind == "step":
                self._counted("step", self._step)
            else:
                self._counted("enter", self._enter)
                self._counted("advance",
                              lambda: self._advance(cond=self._warm_branch))
                self._counted("exit", self._exit)
        self.counter.copy_(saved)

    def _capture(self, dev) -> None:
        """Record the parts in CUDA graphs: a step alone, or the loop's parts
        (:meth:`LoopGraph._capture_loop`), each population's rebin branch the
        body of the step's IF node or, on the ``host_flag`` route, a graph
        replayed after the step. Raises if a capture fails."""
        with self.mesh.counter.uncounted():
            if self.kind == "step":
                with measured(self, dev):
                    self._capture_part("step", self._step)
                return
            if_node = self.route == "if_node"
            self._capture_loop(
                dev, self._enter,
                lambda: self._advance(
                    cond=self._if_node if if_node else self._flag),
                self._exit, branch_graphs=not if_node)

    def _run(self, name: str, body) -> None:
        """:meth:`LoopGraph._run` with the part's tallied bytes added to the
        mesh counter."""
        with self.mesh.counter.uncounted():
            super()._run(name, body)
        self.mesh.counter.add_all(self.tally[name])

    # ------------------------------------------------------------ calls --

    def step(self):
        """One step of what the static buffers hold: ``(fields, stats,
        info)`` cloned out, ``fields`` the state fields the step wrote."""
        self._run("step", self._step)
        fields, stats, info = self._out
        return ({f: t.clone() for f, t in fields.items()},
                _clone_stats(stats), info.clone())

    def enter(self) -> None:
        """Bin from what the static buffers hold."""
        self._run("enter", self._enter)

    def advance(self) -> None:
        """One resident step. On the ``host_flag`` route the two flags are
        read on the host after the step part (one read, ``spatial.
        host_reads``) and each population's branch that is due runs after
        it (its bytes are counted from the device counter, as the IF
        node's)."""
        self._run("advance", self._advance_part)
        if self.route != "host_flag":
            return
        flags = self._flags.tolist()
        S.host_reads += 1
        for i, due in enumerate(flags):
            if not due:
                continue
            S.rebins[i] += 1
            graph = self._graphs.get(f"rebin.{i}")
            if graph is None:
                with self.mesh.counter.uncounted():
                    self.loop.pops[i].rebin()
            else:
                graph.replay()

    def exit(self):
        """``(fields, stats, info, wide_state)`` of the steps, cloned out of
        the exit's outputs."""
        self._run("exit", self._exit)
        fields, stats, info, wide = self._out
        return ({f: t.clone() for f, t in fields.items()},
                _clone_stats(stats), info.clone(),
                tuple(tuple(t.clone() for t in w) for w in wide))


class SpatialDrawGraph(RenderGraph):
    """One sharded frame and its audit (:func:`.spatial.draw_frame`),
    captured (or run eagerly) on static buffers as
    :class:`~..ops.render_graph.RenderGraph` captures ``_render_frame``; a
    replay adds the render's collective bytes (the frame's log-space sums
    and the audit's sum and max), tallied at each eager render, to the mesh
    counter."""

    STATE_READ = ("pos", "last_pos", "vel", "radius", "color", "batch_slot")
    CAPTURE_ERROR_MODE = CAPTURE_ERROR_MODE

    def __init__(self, mesh: Mesh, static: dict, state, stats, cfg2, scalars,
                 *, capture: bool):
        self.mesh = mesh
        self.tally = {}
        super().__init__(static, state, stats, cfg2, scalars, capture=capture)

    def _body(self):
        before = self.mesh.counter.snapshot()
        out = S.draw_frame(self.mesh, self._state, self._stats, self._cfg,
                           self._alpha, self._thr, self._smooth,
                           self._origin, **self.static)
        self.tally = self.mesh.counter.since(before)
        return out

    def _capture(self, dev):
        with self.mesh.counter.uncounted():
            return super()._capture(dev)

    def replay(self) -> None:
        super().replay()
        if self._graph is not None:
            self.mesh.counter.add_all(self.tally)

    def result(self, clone: bool = True):
        """``(frame, audits)`` of the last replay, cloned unless ``clone``
        is false."""
        return tuple(t.clone() for t in self._out) if clone else self._out


class SpatialGraphs:
    """A spatial handler's captured steps, resident loops and draws, the
    ``MAX_GRAPHS`` most recently used kept of each; ``rebins`` is the device
    counter of the rebins the resident loops took, per population (made at
    the first call, on its device; it only grows)."""

    MAX_GRAPHS = 2      # the step and the resident loop; two draw keys

    def __init__(self, mesh: Mesh, lay: S.SpatialLayout,
                 options: solver_ops.SolverOptions, *, capture: bool = True):
        self.mesh, self.lay, self.options = mesh, lay, options
        self.capture = capture
        self._graphs: "OrderedDict[tuple, SpatialGraph]" = OrderedDict()
        self._draws: "OrderedDict[tuple, SpatialDrawGraph]" = OrderedDict()
        self.captures = 0          # graphs built (steps, loops and draws)
        self.rebins = None
        self._last = None          # the loop of the last steps call

    def _graph(self, kind, state, cfg2, step_delta, relaxation,
               wide_state) -> SpatialGraph:
        """The key's graph with the call's inputs loaded."""
        if self.rebins is None:
            self.rebins = torch.zeros((2,), dtype=torch.int32,
                                      device=state.device)
        g, made = kept(
            self._graphs, spatial_key(kind, state),
            lambda: SpatialGraph(kind, self.mesh, self.lay, self.options,
                                 state, cfg2, step_delta, relaxation,
                                 wide_state, self.rebins,
                                 capture=self.capture),
            self.MAX_GRAPHS, "spatial")
        if made:
            self.captures += 1
        else:
            g.load(state, cfg2, step_delta, relaxation,
                   wide_state if kind == "steps" else None)
        return g

    def step(self, state: ParticleState, cfg2: DeviceConfig, step_delta,
             relaxation):
        """:func:`.spatial.spatial_step` of ``state``: ``(state, stats,
        info)``."""
        g = self._graph("step", state, cfg2, step_delta, relaxation, None)
        fields, stats, info = g.step()
        return state.replace(**fields), stats, info

    def steps(self, state: ParticleState, cfg2: DeviceConfig, step_delta,
              relaxation, n_steps: int, wide_state=None):
        """``n_steps`` resident steps (:func:`.spatial.spatial_multi_step`):
        ``(state, stats, info, wide_state, taken)``, ``taken`` the (2,)
        int32 device tensor of the rebins this call took (read it with the
        call's other counters, then :meth:`count_branches`)."""
        if wide_state is None:
            wide_state = tuple(solver_ops.wide_state_init(self.options,
                                                          state.device)
                               for _ in range(2))
        g = self._graph("steps", state, cfg2, step_delta, relaxation,
                        wide_state)
        self._last = g
        before = self.rebins.clone()
        g.enter()
        for _ in range(int(n_steps)):
            g.advance()
        fields, stats, info, wide = g.exit()
        return (state.replace(**fields), stats, info, wide,
                self.rebins - before)

    def count_branches(self, taken) -> None:
        """Add the rebin branches' collective bytes to the mesh counter,
        ``taken[i]`` times population ``i``'s (host integers: the rebins of
        the last :meth:`steps` call)."""
        for i, n in enumerate(taken):
            for category, nbytes in self._last.tally[f"rebin.{i}"].items():
                self.mesh.counter.add(category, int(n) * nbytes)

    def draw(self, state: ParticleState, stats: StepStats, cfg2: DeviceConfig,
             scalars, *, opts2, vw: int, vh: int, use_lighting: bool,
             thickness, clone: bool = True):
        """:func:`.spatial.draw_frame` of ``state``: ``(frame (vh, vw, 4),
        audits (2, 2))``; ``scalars`` is ``(alpha, threshold, smoothness,
        (x, y))`` as :meth:`RenderGraph.load` takes them."""
        S.check_draw_options(opts2)
        static = dict(opts2=tuple(opts2), vw=int(vw), vh=int(vh),
                      use_lighting=bool(use_lighting),
                      thickness=tuple(thickness))
        key = (*sorted(static.items()), state.capacity, state.max_batches,
               str(state.device))
        g, made = kept(self._draws, key, lambda: SpatialDrawGraph(
            self.mesh, static, state, stats, cfg2, scalars,
            capture=self.capture), self.MAX_GRAPHS, "spatial_draw")
        if made:
            self.captures += 1
            out = g.first                    # the build rendered it
            g.first = None
            return out
        g.load(state, stats, cfg2, scalars)
        g.replay()
        return g.result(clone)

    def pool_bytes(self) -> int:
        """The kept graphs' private memory pools, in bytes."""
        return (sum(g.pool_bytes for g in self._graphs.values())
                + sum(g.pool_bytes for g in self._draws.values()))
