"""The 1D particle-sharded step captured in a CUDA graph and replayed: how
:func:`.sharding.sharded_step` runs on a CUDA mesh.

The JAX package compiles its sharded step into one program
(``jax.jit(shard_map(...))``); eager PyTorch issues every op from Python:
per population and substep, each collision pass's all-gather of the pair
fields, kernel H's front, the slot table's sort, rank and scatter and H's
sweep of the owned range, then the statistics' two all-reduces (hundreds of
launches a step). None of it reads the device, so the step is recorded once
and replayed as one launch.

A :class:`ShardedGraph` is the step of :class:`~..ops.step_graph.StepGraph`
with :func:`.sharding.shard_body` in place of ``solver.step``: static
buffers for the rank's slice of the state, the (2,)-leading config and the
two step scalars, copied in only when the caller's tensor object (or its
``_version``) changed; the carried state written over its input buffers at
the end of the graph and cloned once a call. The first call of a key runs
the step eagerly under ``torch.cuda.set_sync_debug_mode("error")`` (its
result is that call's; NCCL's communicators start there, before any
capture), then captures it with ``capture_error_mode="thread_local"`` (the
process group's watchdog queries events while the step is captured). A
failed capture raises: nothing falls back to the eager step.

On more than one rank the all-gathers and all-reduces are NCCL work in the
graph; on one rank :class:`~.mesh.Mesh` makes them nothing (the gather
returns its input), so the graph holds none. The step has no branch, so no
IF node.

Collective bytes: :class:`~.mesh.CollectiveCounter` adds at each call
site, on the host, and a replay runs no Python. The eager first step
counts its bytes there and keeps them as the graph's ``tally``; the capture
counts nothing; each replay adds the tally (6 floats a particle a pass
under ``all_gather``, the statistics' sum and max under ``reductions``).

Keyed (:func:`sharded_key`) by the options, the particles a rank, the
batch slots, the mesh's size and this rank, and the device; ``MAX_GRAPHS``
kept. ``ShardedGraphs(..., capture=False)`` runs the same plumbing eagerly
on the static buffers (how it is tested on the CPU).
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..config import DeviceConfig
from ..ops.solver import SolverOptions
from ..ops.step_graph import StepGraph, kept, measured
from ..state import ParticleState
from .mesh import CAPTURE_ERROR_MODE, Mesh
from .sharding import shard_body

__all__ = ["ShardedGraph", "ShardedGraphs", "sharded_key"]


def sharded_key(mesh: Mesh, options: SolverOptions, state: ParticleState):
    """What changes the captured work of a rank's sharded step: the owned
    range (``mesh.rank`` times the particles a rank) and every shape."""
    return (options, state.pos.shape[1], state.max_batches, mesh.size,
            mesh.rank, str(state.device))


class ShardedGraph(StepGraph):
    """One rank's sharded step, captured (or, with ``capture=False``, run
    eagerly) on static buffers; see the module. Built from the first call's
    inputs, which it copies in, and runs once: that run is the call's
    step."""

    def __init__(self, mesh: Mesh, state: ParticleState, cfg2: DeviceConfig,
                 step_delta, relaxation, options: SolverOptions, *,
                 capture: bool):
        self.mesh = mesh
        self.capture_seconds = 0.0
        self.pool_bytes = 0        # the graph's private memory pool
        before = mesh.counter.snapshot()
        super().__init__(state, cfg2, step_delta, relaxation, options, None,
                         capture=capture)
        self.tally = mesh.counter.since(before)   # the eager step's bytes

    def _step(self):
        new, stats = shard_body(self.mesh, self.options, self._state,
                                self._cfg, *self._scalars)
        return new, stats, self._wide          # no gate state: handed through

    def _capture(self) -> None:
        """Record the step in a CUDA graph, kept (its nodes can be counted)
        and instantiated; its collectives count nothing. Raises if the
        capture fails."""
        dev = self._in_flat.device
        with self.mesh.counter.uncounted(), measured(self, dev):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph,
                                  capture_error_mode=CAPTURE_ERROR_MODE):
                self._body()
            graph.instantiate()
        self._graph = graph

    def replay(self, n: int = 1) -> None:
        """:meth:`StepGraph.replay`, each replay adding the tally to the mesh
        counter (an eager run counts at its call sites)."""
        for _ in range(n):
            super().replay()
            if self._graph is not None:
                self.mesh.counter.add_all(self.tally)


class ShardedGraphs:
    """A rank's captured sharded steps for one mesh and options, one per
    :func:`sharded_key`, the ``MAX_GRAPHS`` most recently used kept."""

    MAX_GRAPHS = 2

    def __init__(self, mesh: Mesh, options: SolverOptions, *,
                 capture: bool = True):
        self.mesh, self.options, self.capture = mesh, options, capture
        self._graphs: "OrderedDict[tuple, ShardedGraph]" = OrderedDict()
        self.captures = 0          # graphs built (each one capture)

    def run(self, state: ParticleState, cfg2: DeviceConfig,
            step_delta: torch.Tensor, relaxation: torch.Tensor):
        """One step of this rank's slice ``state``: ``(state, stats)`` as
        :func:`.sharding.shard_body` gives them. ``step_delta`` and
        ``relaxation`` are 0-d float32 tensors on the state's device."""
        g, made = kept(self._graphs, sharded_key(self.mesh, self.options,
                                                 state),
                       lambda: ShardedGraph(self.mesh, state, cfg2,
                                            step_delta, relaxation,
                                            self.options,
                                            capture=self.capture),
                       self.MAX_GRAPHS, "sharded")
        if made:
            self.captures += 1         # the build ran the call's step
        else:
            g.load(state, cfg2, step_delta, relaxation, None)
            g.replay()
        new, stats, _ = g.result(state)
        return new, stats

    def graph(self) -> ShardedGraph:
        """The most recently used graph."""
        return next(reversed(self._graphs.values()))

    def pool_bytes(self) -> int:
        """The kept graphs' private memory pools, in bytes."""
        return sum(g.pool_bytes for g in self._graphs.values())
