"""The fixed step of :func:`.solver.step` captured once in a CUDA graph and
replayed: how a CUDA handler runs ``update``, ``step_once`` and the routes
of ``run_steps`` that are a loop of steps.

The JAX package compiles a step into one program; eager PyTorch issues one
launch per tensor op (hundreds a step). A step never reads the device back
(the violence gate's flag stays on the device, every kernel launches on the
current stream), so its launches can be recorded once and replayed as one.

A :class:`StepGraph` is one captured step. It owns static buffers for
everything the step reads: the :class:`~..state.ParticleState` fields, the
(2,)-leading :class:`~..config.DeviceConfig`, the step scalars and the
wide-gate state. Before a replay it copies in only the inputs that are not
the tensors it last held (a change of value never recaptures). At the end
of the graph the new carried state (positions, previous positions,
velocities, inverse masses, radii, last positions) and gate state are
written over the input buffers and the stats into a static stats buffer, so
``n`` replays are ``n`` steps. After the replays the carried state, the
stats and the gate state are cloned once and handed out as views of the
clones: a state or stats the caller holds is never overwritten by a later
replay.

It is keyed (:func:`graph_key`) by what changes the captured work: the
:class:`~.solver.SolverOptions` (the populations' caps among them), the
capacity, the number of batch slots and the device. The first call of a
key runs the step eagerly (its result is that call's first step; under
``torch.cuda.set_sync_debug_mode("error")``, so a step that reads the
device fails there with the op's name) and then captures it. A failed
capture raises: nothing falls back to the eager step.

Python-side counters (the kernel wrappers' ``launches``, ``solver.host_syncs``
and ``solver.rebins``) move only where Python runs: in an eager step and
while a step is captured (the wrappers run once, recording their launches).
A replay runs the recorded launches without Python and moves none of them;
the launches of replayed steps are counted from a profiler trace, by kernel
symbol (``chip_smoke.launches_run``).

``StepGraph(..., capture=False)`` replays by running the step eagerly on
the static buffers: the same copy-in / copy-out plumbing on any device, no
graph (how the plumbing is tested on the CPU).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from ..config import DeviceConfig
from ..state import ParticleState, StepStats
from . import solver

__all__ = ["EAGER", "StepGraph", "StepGraphs", "graph_key"]

# a handler's ``_step_graphs`` set to this runs its fixed steps eagerly on
# any device (how a measurement times the eager step beside the replayed one)
EAGER = "eager"

# state fields the step writes, carried from one replay to the next
CARRIED = ("pos", "prev", "vel", "inv_mass", "radius", "last_pos")
_STATS = tuple(f.name for f in dataclasses.fields(StepStats))


def graph_key(state: ParticleState, options: solver.SolverOptions):
    """What changes the captured work of a step."""
    return (options, state.capacity, state.max_batches, str(state.device))


def _views(flat: torch.Tensor, layout):
    """``{name: view}`` of a flat buffer laid out as ``[(name, shape)]``."""
    out, at = {}, 0
    for name, shape in layout:
        n = 1
        for s in shape:
            n *= s
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` view the same elements."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the memory spans of ``a`` and ``b`` overlap."""
    if a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr():
        return False
    a0, b0 = a.data_ptr(), b.data_ptr()
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a0 < b1 and b0 < a1


def _write_back(pairs) -> None:
    """``dst.copy_(src)`` for each ``(dst, src)``, where a source may be one
    of the destinations (the step hands an input through: ``last_pos`` is
    the input ``pos``, the gather engine's gate state its input). A source
    that is its own destination is skipped; a source that overlaps another
    destination is copied before the destinations are written."""
    pairs = [(d, s) for d, s in pairs if not _same(d, s)]
    dsts = [d for d, _ in pairs]
    for d, s in sorted(pairs, key=lambda p: not any(_overlaps(p[1], x)
                                                    for x in dsts)):
        d.copy_(s)


class StepGraph:
    """One step, captured (or, with ``capture=False``, run eagerly) on static
    buffers; see the module. Built from the first call's inputs, which it
    copies in, and runs once: that run is the call's first step."""

    def __init__(self, state: ParticleState, cfg2: DeviceConfig, step_delta,
                 relaxation, options: solver.SolverOptions, wide_state, *,
                 capture: bool):
        self.options = options
        dev = state.device
        self._carried = [(f, tuple(getattr(state, f).shape)) for f in CARRIED]
        self._in_flat = torch.empty(
            sum(getattr(state, f).numel() for f in CARRIED),
            dtype=torch.float32, device=dev)
        self._state = state.replace(**_views(self._in_flat, self._carried), **{
            f.name: torch.empty_like(getattr(state, f.name))
            for f in dataclasses.fields(ParticleState)
            if f.name not in CARRIED})
        self._cfg = DeviceConfig(**{
            f.name: torch.empty_like(getattr(cfg2, f.name))
            for f in dataclasses.fields(DeviceConfig)})
        self._scalars = (torch.empty((), dtype=torch.float32, device=dev),
                         torch.empty((), dtype=torch.float32, device=dev))
        self._in_trip = torch.empty((2,), dtype=torch.bool, device=dev)
        self._in_count = torch.empty((2, 2), dtype=torch.int32, device=dev)
        self._wide = tuple((self._in_trip[i], self._in_count[i, 0],
                            self._in_count[i, 1]) for i in range(2))
        self._held = {}            # input name -> (tensor, version) held
        self._stats_flat = None    # the last step's stats, laid out as
        self._stats_layout = None  # [(name, shape)]
        self._graph = None
        self.load(state, cfg2, step_delta, relaxation, wide_state)
        if capture:
            # the first step eagerly, with any read of the device an error,
            # then the capture (it runs nothing)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._body()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            self._capture()
        else:
            self._body()

    # ------------------------------------------------------------ inputs --

    def _inputs(self, state, cfg2, step_delta, relaxation, wide_state):
        """``(name, static buffer, source)`` of every input."""
        for f in dataclasses.fields(ParticleState):
            yield ("state." + f.name, getattr(self._state, f.name),
                   getattr(state, f.name))
        for f in dataclasses.fields(DeviceConfig):
            yield ("cfg." + f.name, getattr(self._cfg, f.name),
                   getattr(cfg2, f.name))
        yield "step_delta", self._scalars[0], step_delta
        yield "relaxation", self._scalars[1], relaxation
        for i in range(2):
            for j, name in enumerate(("trip", "budget", "calm")):
                yield f"wide.{i}.{name}", self._wide[i][j], wide_state[i][j]

    def load(self, state, cfg2, step_delta, relaxation, wide_state) -> int:
        """Copy into the static buffers every input (all tensors) that is
        not the tensor, at the version, they last held; returns the number
        copied."""
        copied = 0
        for name, static, src in self._inputs(state, cfg2, step_delta,
                                              relaxation, wide_state):
            held = self._held.get(name)
            if held is not None and held[0] is src \
                    and held[1] == src._version:
                continue
            static.copy_(src)
            self._held[name] = (src, src._version)
            copied += 1
        return copied

    # -------------------------------------------------------------- step --

    def _body(self) -> None:
        """One step on the static buffers: the carried state and the gate
        state written over the inputs, the stats into the stats buffer."""
        new, stats, wide = solver.step(self._state, self._cfg,
                                       *self._scalars, self.options,
                                       wide_state=self._wide)
        parts = [getattr(stats, f) for f in _STATS]
        if self._stats_layout is None:
            self._stats_layout = [(n, tuple(p.shape))
                                  for n, p in zip(_STATS, parts)]
            self._stats_flat = torch.cat([p.reshape(-1) for p in parts])
        else:
            torch.cat([p.reshape(-1) for p in parts], out=self._stats_flat)
        _write_back([(getattr(self._state, f), getattr(new, f))
                     for f in CARRIED]
                    + [(self._wide[i][j], wide[i][j])
                       for i in range(2) for j in range(3)])

    def _capture(self) -> None:
        """Record :meth:`_body` in a CUDA graph. Raises if the capture
        fails."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body()
        self._graph = graph

    def replay(self, n: int = 1) -> None:
        """``n`` more steps on what the static buffers hold."""
        for _ in range(n):
            if self._graph is None:
                self._body()
            else:
                self._graph.replay()

    def result(self, state: ParticleState):
        """``(state, stats, wide_state)`` of the last step, cloned out of the
        static buffers: ``state`` gives the fields the step does not write
        (the tensors the caller passed in)."""
        out = _views(self._in_flat.clone(), self._carried)
        stats = _views(self._stats_flat.clone(), self._stats_layout)
        trip = self._in_trip.clone()
        count = self._in_count.clone()
        wide = tuple((trip[i], count[i, 0], count[i, 1]) for i in range(2))
        # the input buffers hold these values
        for f in CARRIED:
            self._held["state." + f] = (out[f], out[f]._version)
        for i in range(2):
            for j, name in enumerate(("trip", "budget", "calm")):
                t = wide[i][j]
                self._held[f"wide.{i}.{name}"] = (t, t._version)
        return (state.replace(**out), StepStats(**stats), wide)


class StepGraphs:
    """A handler's captured steps, one per :func:`graph_key`, the
    ``MAX_GRAPHS`` most recently used kept."""

    MAX_GRAPHS = 2      # a caller alternating two options keeps both

    def __init__(self, *, capture: bool = True):
        self.capture = capture
        self._graphs: "OrderedDict[tuple, StepGraph]" = OrderedDict()
        self.captures = 0          # graphs built (each one capture)

    def run(self, state: ParticleState, cfg2: DeviceConfig, step_delta,
            relaxation, options: solver.SolverOptions, wide_state,
            n_steps: int = 1):
        """``n_steps >= 1`` fixed steps from ``state``: ``(state, stats,
        wide_state)`` as ``n_steps`` calls of :func:`.solver.step` give
        them."""
        key = graph_key(state, options)
        g = self._graphs.get(key)
        if g is None:
            g = StepGraph(state, cfg2, step_delta, relaxation, options,
                          wide_state, capture=self.capture)
            self.captures += 1
            self._graphs[key] = g
            while len(self._graphs) > self.MAX_GRAPHS:
                self._graphs.popitem(last=False)
            n_steps -= 1               # the build ran the first step
        else:
            self._graphs.move_to_end(key)
            g.load(state, cfg2, step_delta, relaxation, wide_state)
        g.replay(n_steps)
        return g.result(state)
