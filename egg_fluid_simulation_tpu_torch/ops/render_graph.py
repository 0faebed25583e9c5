"""A frame render, :func:`.render._render_frame`, captured once in a CUDA
graph and replayed: how a CUDA handler's ``draw`` renders.

The JAX package jits ``_render_frame`` with its options, flags, viewport
size and population caps static. Eager PyTorch launches hundreds of kernels
a frame, so the render is recorded once per such key and replayed, on the
model of :mod:`.step_graph`. The render reads nothing back from the device
(the paste lands at a device offset, the bin counts have a fixed size, the
outline offsets come from the host config), so its launches can be
recorded.

A :class:`RenderGraph` owns static buffers for everything the render
reads: the state fields (positions, last positions, velocities, radii,
colours, counts), the stats' centroid and last centroid, the (2,)-leading
:class:`~..config.DeviceConfig` and the four scalars (interpolation alpha,
threshold, smoothness, viewport origin). Before a replay it copies in only
the tensors it does not hold at their version (:func:`.step_graph.copy_in`)
and fills a scalar buffer only when its float changed (a fill is a launch,
not a copy from the host). The outputs (the frame, the two raw canvases,
the (2, 2) audit) are cloned once a call, so a frame the caller holds is
never overwritten by a later replay; a caller that reduces the frame at
once may take the static outputs (``clone=False``).

It is keyed (:func:`render_key`) by what changes the captured work: the
JAX package's static arguments (``opts2``, ``use_lighting``, ``vw``,
``vh``, ``pop_caps``), the outline thicknesses (host floats: the outline's
sample offsets are formed from them on the host), the capacity, the number
of batch slots and the device. The first call of a key renders eagerly
under ``torch.cuda.set_sync_debug_mode("error")`` (a device read or a
synchronising host copy there raises, naming the op) and then captures. A
failed capture raises: nothing falls back to the eager render.

A replay moves no Python counter: kernel C's ``launches`` and kernel I's
``launches`` and ``upsample_launches`` count eager renders and captures
(two composites and two splats a render, an upsample a canvas evaluated
below its size); replayed launches are counted from a profiler trace by
kernel symbol.

``RenderGraph(..., capture=False)`` replays by running the render eagerly
and copying its outputs into the static outputs: the same plumbing on any
device, no graph (how it is tested on the CPU).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from ..config import DeviceConfig
from ..state import ParticleState, StepStats
from . import render as R
from .step_graph import EAGER, copy_in, kept, sync_errors

__all__ = ["EAGER", "RenderGraph", "RenderGraphs", "render_key"]

# the state and stats fields _render_frame reads; the others are not held
STATE_READ = ("pos", "last_pos", "vel", "radius", "color", "count")
STATS_READ = ("centroid", "last_centroid")
_SCALARS = ("alpha", "threshold", "smoothness", "origin.x", "origin.y")


def render_key(state: ParticleState, opts2, use_lighting: bool, vw: int,
               vh: int, pop_caps, thickness):
    """What changes the captured work of a render: ``_render_frame``'s
    static arguments and the state's shapes and device."""
    return (opts2, use_lighting, vw, vh, pop_caps, thickness,
            state.capacity, state.max_batches, str(state.device))


class RenderGraph:
    """One render, captured (or, with ``capture=False``, run eagerly) on
    static buffers; see the module. ``static`` holds ``_render_frame``'s
    static arguments by name. Built from the first call's inputs, which it
    copies in, and renders once: ``first`` holds that render's outputs.
    ``STATE_READ``: the state fields the render reads."""

    STATE_READ = STATE_READ
    CAPTURE_ERROR_MODE = "global"      # torch.cuda.graph's default

    def __init__(self, static: dict, state: ParticleState, stats: StepStats,
                 cfg2: DeviceConfig, scalars, *, capture: bool):
        self.static = static
        dev = state.device
        nothing = torch.empty((0,), device=dev)
        self._state = ParticleState(**{
            f.name: (torch.empty_like(getattr(state, f.name))
                     if f.name in self.STATE_READ else nothing)
            for f in dataclasses.fields(ParticleState)})
        self._stats = StepStats(**{
            f.name: (torch.empty_like(getattr(stats, f.name))
                     if f.name in STATS_READ else nothing)
            for f in dataclasses.fields(StepStats)})
        self._cfg = DeviceConfig(**{
            f.name: torch.empty_like(getattr(cfg2, f.name))
            for f in dataclasses.fields(DeviceConfig)})
        f32 = dict(dtype=torch.float32, device=dev)
        self._alpha = torch.empty((), **f32)
        self._thr = torch.empty((), **f32)
        self._smooth = torch.empty((), **f32)
        self._origin = torch.empty((2,), **f32)
        self._held = {}            # input name -> (tensor, version) or
        #                            (float, None) held
        self._graph = None
        self.pool_bytes = 0        # the capture's private memory pool
        self.load(state, stats, cfg2, scalars)
        if capture:
            # the first render eagerly, with any read of the device an
            # error, then the capture (it runs nothing)
            with sync_errors():
                self.first = self._body()
            self._out = self._capture(dev)
        else:
            self.first = self._body()
            self._out = tuple(t.clone() for t in self.first)

    # ------------------------------------------------------------ inputs --

    def load(self, state, stats, cfg2, scalars) -> int:
        """Bring the static buffers to the call's inputs: a tensor is
        copied unless the buffer holds it at its version, a float filled
        unless the buffer holds it. ``scalars`` is ``(alpha, threshold,
        smoothness, (x, y))``, the alpha a float or a 0-dim device tensor.
        Returns the number of buffers written."""
        alpha, thr, smooth, (x, y) = scalars
        tensors = [("state." + f, getattr(self._state, f), getattr(state, f))
                   for f in self.STATE_READ]
        tensors += [("stats." + f, getattr(self._stats, f), getattr(stats, f))
                    for f in STATS_READ]
        tensors += [("cfg." + f.name, getattr(self._cfg, f.name),
                     getattr(cfg2, f.name))
                    for f in dataclasses.fields(DeviceConfig)]
        values = zip(_SCALARS, (self._alpha, self._thr, self._smooth,
                                self._origin[0], self._origin[1]),
                     (alpha, thr, smooth, x, y))
        floats = []
        for name, static, v in values:
            if isinstance(v, torch.Tensor):
                tensors.append((name, static, v))
            else:
                floats.append((name, static, float(v)))
        written = copy_in(self._held, tensors)
        for name, static, v in floats:
            h = self._held.get(name)
            if h is None or h[1] is not None or h[0] != v:
                static.fill_(v)
                self._held[name] = (v, None)
                written += 1
        return written

    # ------------------------------------------------------------ render --

    def _body(self):
        """One render of the static buffers: ``(frame, white canvas, yolk
        canvas, audits)``."""
        frame, canvases, audits = R._render_frame(
            self._state, self._stats, self._cfg, self._alpha, self._thr,
            self._smooth, self._origin, **self.static)
        return (frame, *canvases, audits)

    def _capture(self, dev):
        """Record :meth:`_body` in a CUDA graph; returns its static outputs.
        Raises if the capture fails."""
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph,
                              capture_error_mode=self.CAPTURE_ERROR_MODE):
            out = self._body()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - before
        self._graph = graph
        return out

    def replay(self) -> None:
        """One render of what the static buffers hold, into the static
        outputs."""
        if self._graph is not None:
            self._graph.replay()
            return
        for static, t in zip(self._out, self._body()):
            static.copy_(t)

    def result(self, clone: bool = True):
        """``(frame, canvases, audits)`` of the last replay, cloned out of
        the static outputs unless ``clone`` is false (then valid until the
        next replay of this graph)."""
        out = tuple(t.clone() for t in self._out) if clone else self._out
        return out[0], out[1:3], out[3]


class RenderGraphs:
    """A handler's captured renders, one per :func:`render_key`, the
    ``MAX_GRAPHS`` most recently used kept."""

    MAX_GRAPHS = 2      # a budget boost keeps the frame before it

    def __init__(self, *, capture: bool = True):
        self.capture = capture
        self._graphs: "OrderedDict[tuple, RenderGraph]" = OrderedDict()
        self.captures = 0          # graphs built (each one capture)

    def run(self, state, stats, cfg2, scalars, *, opts2, use_lighting: bool,
            vw: int, vh: int, pop_caps, thickness, clone: bool = True):
        """``_render_frame(state, stats, cfg2, *scalars, opts2, ...)``:
        ``(frame, canvases, audits)``; ``scalars`` as
        :meth:`RenderGraph.load` takes them."""
        static = dict(opts2=opts2, use_lighting=use_lighting, vw=vw, vh=vh,
                      pop_caps=pop_caps, thickness=thickness)
        g, made = kept(self._graphs, render_key(state, **static),
                       lambda: RenderGraph(static, state, stats, cfg2,
                                           scalars, capture=self.capture),
                       self.MAX_GRAPHS, "render")
        if made:
            self.captures += 1
            frame, *canvases, audits = g.first     # the build rendered it
            g.first = None                         # the caller's now
            return frame, tuple(canvases), audits
        g.load(state, stats, cfg2, scalars)
        g.replay()
        return g.result(clone)

    def pool_bytes(self) -> int:
        """The kept captures' private memory pools, in bytes."""
        return sum(g.pool_bytes for g in self._graphs.values())
