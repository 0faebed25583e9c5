"""The resident loops of :func:`.solver.multi_step` and
:func:`.solver.multi_step_frames` captured in CUDA graphs and replayed: how
a CUDA handler's ``run_steps`` runs on the resident route, and how the
bench runs its frame loop.

The JAX package jits ``multi_step`` (a ``fori_loop``) and scans
``multi_step_frames``; each takes the rebin decision inside a ``lax.cond``,
on the device. Here each loop is split into parts that read and write
buffers made once (:class:`.solver.ResidentSteps`,
:class:`.solver.FrameLoop`), each part captured once and replayed:

- ``steps``: an *enter* graph (bin both populations from the state), a
  *step* graph (drift count, the rebin in an IF node of the graph on the
  device flag, the substeps), an *exit* graph (merge). ``multi_step(n)``
  replays enter, ``n - 1`` steps and exit, then the final full step through
  a :class:`.step_graph.StepGraphs` of its own;
- ``frames``: an enter graph and a *frame* graph (substeps, extract and
  merge, the drift count, the rebin in an IF node, the centroid); between
  two frame replays the caller's ``frame_fn`` runs from Python on a state
  and stats cloned out of the loop's buffers (a frame's tensors are fresh,
  so a render graph copies them in: ``step_graph.copy_in`` skips a tensor
  object whose ``_version`` is unchanged, and a replay does not bump it).

No part reads the device, so a loop of replays goes from the first launch
to the result without a wait. Each population's rebin branch
(``_ResidentPop.rebin``, which writes every result into the loop's buffers)
is captured first as a graph of its own; where :func:`.solver._rebin_if`
decides, the step's capture adds an IF node on the device flag whose body
is a copy of that graph (``csrc/graph_cond.cu``, ``egg_if_node``: this
PyTorch has no conditional nodes of its own, CUDA has them since 12.4). A
(2,) int32 device counter, ``rebins``, adds one per population and taken
branch: the count of record on the card (the Python ``solver.rebins`` and
``solver.host_syncs`` count eager decisions only).

Keyed (:func:`resident_key`) by the loop kind and :func:`.step_graph.
graph_key`; ``MAX_GRAPHS`` kept. The first call of a key warms both
branches up eagerly under ``torch.cuda.set_sync_debug_mode("error")`` (the
enter, one step or frame with the rebin forced, and the exit, so that lazy
initialisation is not first met inside a capture), then captures the
branches into one memory pool and the parts into another, then replays the
parts from the call's inputs. A failed capture raises: nothing falls back to
the eager loop.

``ResidentGraphs(capture=False)`` runs the same parts eagerly on the static
buffers, reading the rebin flag on the host: the plumbing on any device,
no graph (how it is tested on the CPU).

:class:`LoopGraph` (the capture of a loop's parts, the IF node) is shared
with the spatial layer's graphs (``parallel/spatial_graph.py``); every cache
builds through :func:`.step_graph.kept`. ``steps`` opens the spans
``egg.run_steps.load``, ``.replay`` and ``.final``.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..config import DeviceConfig
from ..state import ParticleState
from . import solver
from ..utils.profiling import span
from .step_graph import (StaticInputs, StepGraphs, graph_key, kept, measured,
                         sync_errors)

__all__ = ["LoopGraph", "ResidentGraph", "ResidentGraphs", "resident_key"]

KINDS = ("steps", "frames")


def resident_key(kind: str, state: ParticleState,
                 options: solver.SolverOptions):
    """What changes the captured work of a resident loop."""
    return (kind, *graph_key(state, options))


class LoopGraph(StaticInputs):
    """A loop's parts on static buffers, each captured as a CUDA graph and
    replayed, or run eagerly where nothing was captured: the *enter* (which
    makes ``loop``, whose ``pops[i].rebin`` is population ``i``'s rebin
    branch), the *advance* (one step, its rebin an IF node on the device
    flag: :meth:`_if_node`) and the *exit*. ``_graphs`` maps a part's name
    to its graph; ``rebin.<i>`` are the branches. What
    :class:`ResidentGraph` and the spatial layer's graphs share."""

    CAPTURE_ERROR_MODE = "global"      # torch.cuda.graph's default

    def __init__(self, state: ParticleState, cfg2: DeviceConfig):
        super().__init__(state, cfg2)
        self.loop = None           # the parts' buffers, made by the enter
        self._graphs = {}          # part -> torch.cuda.CUDAGraph
        self.capture_seconds = 0.0
        self.pool_bytes = 0        # the parts' private memory pools

    def _if_node(self, pred, pop_index: int) -> None:
        """The rebin of population ``pop_index`` in an IF node on ``pred``
        of the graph being captured on the current stream."""
        from .kernels import library
        err = library.load().egg_if_node(
            library.stream_handle(pred.device), pred.data_ptr(),
            self._graphs[f"rebin.{pop_index}"].raw_cuda_graph())
        library.check("egg_if_node", err)

    def _capture_part(self, name: str, body, pool=None, body_only=False):
        """``body`` captured as part ``name``; the graph is kept (its nodes
        can be counted) and instantiated unless it is only an IF node's
        body."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode=self.CAPTURE_ERROR_MODE):
            body()
        if not body_only:
            graph.instantiate()
        self._graphs[name] = graph
        return graph

    def _capture_loop(self, dev, enter, advance, exit=None, *,
                      branch_graphs: bool = False) -> None:
        """Record the loop's parts. The enter, the advance and the exit
        share one memory pool: the buffers the enter makes stay live for the
        others. Each population's rebin branch is captured after the enter,
        into a pool of its own (its temporaries must not alias the
        advance's, inside which it runs): kept as the body of the advance's
        IF node, or with ``branch_graphs`` instantiated, to be replayed on
        its own. Raises if a capture fails."""
        with measured(self, dev):
            pool = self._capture_part("enter", enter).pool()
            rebin_pool = None
            for i, p in enumerate(self.loop.pops):
                rebin_pool = self._capture_part(
                    f"rebin.{i}", p.rebin, pool=rebin_pool,
                    body_only=not branch_graphs).pool()
            self._capture_part("advance", advance, pool=pool)
            if exit is not None:
                self._capture_part("exit", exit, pool=pool)

    def _run(self, name: str, body) -> None:
        """Part ``name``: its graph replayed, or ``body()`` if none."""
        graph = self._graphs.get(name)
        if graph is None:
            body()
        else:
            graph.replay()


class ResidentGraph(LoopGraph):
    """One resident loop of ``kind`` ("steps" or "frames"), its parts
    captured (or, with ``capture=False``, run eagerly) on static buffers;
    see the module. Built from the first call's inputs, which it copies in;
    it runs nothing for the call."""

    def __init__(self, kind: str, state: ParticleState, cfg2: DeviceConfig,
                 step_delta, relaxation, options: solver.SolverOptions,
                 wide_state, counter: torch.Tensor, *, capture: bool):
        if kind not in KINDS:
            raise ValueError(f"resident loop kind {kind!r}: expected one of "
                             f"{KINDS}")
        super().__init__(state, cfg2)
        self.kind, self.options, self.counter = kind, options, counter
        self._merged = None        # the exit's outputs
        self.load(state, cfg2, step_delta, relaxation, wide_state)
        if capture:
            self._warm_up()
            self._capture_loop(
                state.device, self._enter,
                lambda: self._advance(cond=self._if_node),
                self._exit if self.kind == "steps" else None)

    # ------------------------------------------------------------- parts --

    def _enter(self) -> None:
        make = (solver.ResidentSteps if self.kind == "steps"
                else solver.FrameLoop)
        self.loop = make(self._state, self._cfg, *self._scalars, self.options,
                         self._wide, counter=self.counter)

    def _advance(self, force=None, cond=None) -> None:
        if self.kind == "steps":
            self.loop.step(force=force, cond=cond)
        else:
            self.loop.frame(force=force, cond=cond)

    def _exit(self) -> None:
        self._merged = self.loop.exit()

    def _warm_up(self) -> None:
        """Every part once, eagerly, with any read of the device an error,
        the rebin forced: both branches have run on this key's shapes before
        the capture (the kernel library loaded, lazily made state made). The
        counter is restored."""
        saved = self.counter.clone()
        with sync_errors():
            self._enter()
            self._advance(force=True)
            if self.kind == "steps":
                self._exit()
        self.counter.copy_(saved)

    def enter(self) -> None:
        """Bin from what the static buffers hold."""
        self._run("enter", self._enter)

    def advance(self) -> None:
        """One resident step (or frame)."""
        self._run("advance", self._advance)

    def exit(self):
        """The merged state fields and the wide-gate state of the steps
        (``kind`` "steps"), cloned out of the exit's outputs."""
        self._run("exit", self._exit)
        fields, wide = self._merged
        return ({f: t.clone() for f, t in fields.items()},
                tuple(tuple(t.clone() for t in w) for w in wide))


class ResidentGraphs:
    """A handler's captured resident loops, one per :func:`resident_key`,
    the ``MAX_GRAPHS`` most recently used kept; ``final`` holds the final
    full step of ``multi_step``; ``rebins`` is the device counter of the
    rebins the replayed loops took, per population (made at the first call,
    on its device; it only grows)."""

    MAX_GRAPHS = 2      # run_steps and the frame loop of one handler

    def __init__(self, *, capture: bool = True):
        self.capture = capture
        self._graphs: "OrderedDict[tuple, ResidentGraph]" = OrderedDict()
        self.captures = 0          # resident loops built
        self.final = StepGraphs(capture=capture, name="final")
        self.rebins = None

    def _graph(self, kind, state, cfg2, step_delta, relaxation, options,
               wide_state) -> ResidentGraph:
        """The key's loop with the call's inputs loaded (the span
        ``egg.run_steps.load``)."""
        if self.rebins is None:
            self.rebins = torch.zeros((2,), dtype=torch.int32,
                                      device=state.device)
        with span("egg.run_steps.load"):
            g, made = kept(self._graphs, resident_key(kind, state, options),
                           lambda: ResidentGraph(kind, state, cfg2,
                                                 step_delta, relaxation,
                                                 options, wide_state,
                                                 self.rebins,
                                                 capture=self.capture),
                           self.MAX_GRAPHS, "resident")
            if made:
                self.captures += 1
            else:
                g.load(state, cfg2, step_delta, relaxation, wide_state)
        return g

    def steps(self, state: ParticleState, cfg2: DeviceConfig, step_delta,
              relaxation, options: solver.SolverOptions, n_steps: int,
              wide_state):
        """The resident route of ``multi_step`` (``n_steps`` steps from
        ``state``): ``(state, stats, wide_state)``. Spans: the loop's
        ``egg.run_steps.load``, its enter, advances and exit in one
        ``egg.run_steps.replay``, the final step's ``egg.run_steps.final``."""
        if int(n_steps) > 1:
            g = self._graph("steps", state, cfg2, step_delta, relaxation,
                            options, wide_state)
            with span("egg.run_steps.replay"):
                g.enter()
                for _ in range(int(n_steps) - 1):
                    g.advance()
                fields, wide_state = g.exit()
            state = state.replace(**fields)
        with span("egg.run_steps.final"):
            return self.final.run(state, cfg2, step_delta, relaxation,
                                  options, wide_state)

    def frames(self, state: ParticleState, cfg2: DeviceConfig, step_delta,
               relaxation, options: solver.SolverOptions, wide_state):
        """The frame loop of ``multi_step_frames`` entered from ``state``:
        ``(loop, advance)``, its :class:`.solver.FrameLoop` (what a frame
        reads) and the call that advances it one frame."""
        g = self._graph("frames", state, cfg2, step_delta, relaxation,
                        options, wide_state)
        g.enter()
        return g.loop, g.advance

    def pool_bytes(self) -> int:
        """The kept loops' private memory pools, in bytes (the final step's
        not included)."""
        return sum(g.pool_bytes for g in self._graphs.values())
