"""Profiling and state audits.

``StepTimer`` (rolling phase timings), ``span`` (the port's named ranges,
recorded only while a profiler runs), ``trace`` (a ``torch.profiler``
trace, the spans in it) and ``counters`` (the port's counters in one
read), what ran on the card (``kernel_launches``: a trace's launches of
named kernels; ``graph_node_types``: a captured CUDA graph's nodes), then
the collision-budget drop rate and the NaN guard: host-side numpy over a
handler's current state, as in ``egg_fluid_simulation_tpu/utils/profiling.py``.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import statistics
import subprocess
import time
from typing import Dict, List, Union

import numpy as np
import torch

from . import log

__all__ = ["StepTimer", "span", "trace", "counters", "kernel_launches",
           "graph_node_types", "nvidia_smi",
           "validate_state", "collision_drop_stats"]


class StepTimer:
    """Rolling window of phase timings (the demo overlay's instrument).

    On a CUDA device a phase is timed with CUDA events recorded on the
    current stream, so it measures the device work the phase enqueued; the
    events are read (and the device waited for) only when a summary is
    asked for. On the CPU a phase is timed with the host clock. Usage::

        timer = StepTimer(window=100)          # device="cuda"
        with timer.phase("step"):
            handler.update(1 / 60)
        timer.summary()  # {"step": {"p50_ms": ..., "mean_ms": ..., ...}}
    """

    def __init__(self, window: int = 100, device="cuda"):
        self.window = window
        self.device = torch.device(device)
        self._samples: Dict[str, List[Union[float, tuple]]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._add(name, (start, end))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._add(name, (time.perf_counter() - t0) * 1000)

    def _add(self, name: str, sample) -> None:
        bucket = self._samples.setdefault(name, [])
        bucket.append(sample)
        if len(bucket) > self.window:
            bucket.pop(0)

    def _ms(self, name: str) -> List[float]:
        out = []
        for x in self._samples.get(name, []):
            if isinstance(x, tuple):
                x[1].synchronize()
                x = x[0].elapsed_time(x[1])
            out.append(float(x))
        self._samples[name] = list(out)
        return out

    def samples(self, name: str) -> List[float]:
        """The window's ms of phase ``name``, oldest first (on a CUDA device
        this waits for the recorded events)."""
        return self._ms(name)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name in self._samples:
            xs = self._ms(name)
            out[name] = {"p50_ms": statistics.median(xs),
                         "mean_ms": statistics.fmean(xs),
                         "max_ms": max(xs), "n": len(xs)}
        return out

    def frame_usage_pct(self, name: str, frame_s: float = 1 / 60) -> float:
        """Mean phase time as % of a frame (the reference overlay's metric)."""
        xs = self._ms(name) or [0.0]
        return statistics.fmean(xs) / (frame_s * 1000) * 100


_OFF = contextlib.nullcontext()


def span(name: str):
    """A named range of the port's host work (``egg.<...>``): a
    ``torch.profiler.record_function`` while a profiler records, so it lands
    in the trace on the clock of the device activity and nests in the spans
    open around it; otherwise one shared no-op context, which costs a check
    of the profiler's state and makes, reads and allocates nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(dir_path: str):
    """Wrap a block in a ``torch.profiler`` trace (CPU activity, and CUDA
    activity where a card is present), written to ``dir_path/trace.json``
    in the Chrome trace format; the port's spans (:func:`span`) are its
    ``user_annotation`` events named ``egg.*``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(dir_path, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dir_path, "trace.json"))


def counters(handler=None) -> dict:
    """The port's counters, read from the host without a read of the
    device: the draw's device reads (``host_reads``), re-renders, re-renders
    skipped at unchanged options and splats found dropped (``rerenders``,
    ``rerenders_skipped``, ``dropped``; ``ops/render.py``), the eager
    resident loops' rebin-flag reads and rebins (``host_syncs``,
    ``rebins``; ``ops/solver.py``), the host seconds of every graph build
    and of the kernel library's loads (``capture_seconds``,
    ``load_seconds``), and the ordered budget's cut counter
    (``budget_cuts``, ``gather_kernel.cut_counts``: a (2, 2) int32 device
    tensor, not read, ``[cut passes, budgeted passes]`` of white and yolk,
    of the handler's device or else of the last budgeted pass's; None
    before any). With ``handler``: its graphs built by cache
    (``captures``, :attr:`~..handler.SimulationHandler.graph_census`) and
    the replayed resident loops' rebin counter (``resident_rebins``, a
    device tensor, not read; None before the first replayed loop)."""
    from ..ops import render, solver, step_graph
    from ..ops.kernels import gather_kernel, library
    out = {"host_reads": render.host_reads, "rerenders": render.rerenders,
           "rerenders_skipped": render.rerenders_skipped,
           "dropped": render.dropped, "host_syncs": solver.host_syncs,
           "rebins": list(solver.rebins),
           "capture_seconds": step_graph.capture_seconds,
           "load_seconds": library.load_seconds,
           "budget_cuts": gather_kernel.cut_counts(
               None if handler is None else handler.state.pos.device)}
    if handler is not None:
        out["captures"] = {k: v["captures"]
                           for k, v in handler.graph_census.items()}
        out["resident_rebins"] = handler.resident_rebins
    return out


def kernel_launches(prof, symbols: Dict[str, str]) -> Dict[str, int]:
    """Launches of each kernel ``name`` of ``symbols`` (name -> symbol)
    among a ``torch.profiler`` trace's CUDA kernel events, matched by symbol
    as a word (the library's kernels sit in an anonymous namespace): what
    ran on the card, the kernels of replayed CUDA graphs included."""
    by_symbol = {v: k for k, v in symbols.items()}
    pattern = re.compile(r"(?<![\w])(" + "|".join(by_symbol) + r")(?![\w])")
    counts = dict.fromkeys(symbols, 0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = pattern.search(e.name)
            if m:
                counts[by_symbol[m.group(1)]] += 1
    return counts


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` reports them (the first
    card's line)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except FileNotFoundError:
        return "nvidia-smi not found"
    if out.returncode != 0 or not out.stdout.strip():
        return f"nvidia-smi failed: {out.stderr.strip()}"
    return out.stdout.strip().splitlines()[0]


NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 4: "child_graph",
              13: "conditional"}


def graph_node_types(raw: int) -> Dict[str, int]:
    """The top-level nodes of the CUDA graph ``raw`` (a ``cudaGraph_t``, as
    ``CUDAGraph.raw_cuda_graph()`` gives it) by type, counted with libcuda's
    ``cuGraphGetNodes``."""
    cu = ctypes.CDLL("libcuda.so.1")
    num = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(num)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * num.value)()
    cu.cuGraphGetNodes(ctypes.c_void_p(raw), nodes, ctypes.byref(num))
    out = dict.fromkeys(NODE_TYPES.values(), 0)
    out["other"] = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        out[NODE_TYPES.get(kind.value, "other")] += 1
    return out


def collision_drop_stats(handler) -> dict:
    """Collision-budget audit of the handler's CURRENT state.

    Dense engine (host-side numpy): per population, the share of live
    particles past the per-cell slot budget K in their torus cell
    ``floor(pos / cell) mod G`` — the count the dense engine drops from
    collision at this binning. Keys: ``drop_pct`` (of live),
    ``max_cell_occupancy``, ``mean_cell_occupancy``.

    Gather engine (one pass's grid on the state's device): ``drop_pct`` is
    the share of live particles past the K slots of their hash bucket and
    the occupancies are of buckets; ``budget_pairs`` counts the pass's
    unique pairs in the true 3x3 cells and ``budget_dropped_pairs`` those
    past the ordered 0.05 n^2 budget (0 with the budget off).
    """
    if handler._options.engine == "gather":
        return _gather_drop_stats(handler)
    state = handler.state
    options = handler._options
    active = state.active_mask().cpu().numpy()
    pos_all = state.pos.cpu().numpy()
    out = {}
    for pop, name in ((0, "white"), (1, "yolk")):
        cfg = handler._white_config if pop == 0 else handler._yolk_config
        cell = max(1.0, cfg["max_radius"]
                   * max(cfg["collision_overlap_factor"],
                         cfg["cohesion_interaction_distance_factor"]))
        g = options.dense_grid_dim[pop]
        k = options.dense_slots[pop]
        pos = pos_all[pop][active[pop]]
        n = pos.shape[0]
        if n == 0:
            out[name] = dict(drop_pct=0.0, max_cell_occupancy=0,
                             mean_cell_occupancy=0.0)
            continue
        c = np.mod(np.floor(pos / cell).astype(np.int64), g)
        counts = np.bincount(c[:, 1] * g + c[:, 0], minlength=g * g)
        dropped = np.maximum(counts - k, 0).sum()
        occ = counts[counts > 0]
        out[name] = dict(drop_pct=100.0 * dropped / n,
                         max_cell_occupancy=int(counts.max()),
                         mean_cell_occupancy=float(occ.mean()))
    return out


def _gather_drop_stats(handler) -> dict:
    from ..config import population_config
    from ..ops import grid as grid_ops
    from ..ops import solver as solver_ops
    state, options = handler.state, handler._options
    caps = solver_ops._pop_caps(options, state.capacity)
    active = state.active_mask()
    out = {}
    for pop, name in ((0, "white"), (1, "yolk")):
        cfg = population_config(handler._device_cfg2(), pop)
        cell = torch.clamp(cfg.max_radius
                           * torch.maximum(cfg.collision_overlap_factor,
                                           cfg.cohesion_interaction_distance_factor),
                           min=1.0)
        pos, act = state.pos[pop, :caps[pop]], active[pop, :caps[pop]]
        n = int(act.sum())
        grid, cand, valid = solver_ops._pair_candidates(pos, act, cell,
                                                        options)
        new_pairs, cum, max_pairs = solver_ops._ordered_budget(grid, cand,
                                                               valid, act)
        past = (cum >= max_pairs) if options.budget_mode == "ordered" else \
            torch.zeros_like(cum, dtype=torch.bool)
        bucket = grid_ops._bucket_of(grid.cell_xy[:, 0], grid.cell_xy[:, 1],
                                     options.table_size)[act]
        counts = torch.bincount(bucket.to(torch.int64),
                                minlength=options.table_size)
        in_slots = int((grid.table[:options.table_size] >= 0).sum())
        occ = counts[counts > 0]
        out[name] = dict(
            drop_pct=100.0 * (n - in_slots) / max(n, 1),
            max_cell_occupancy=int(counts.max()) if n else 0,
            mean_cell_occupancy=float(occ.float().mean()) if n else 0.0,
            budget_pairs=int(new_pairs.sum()),
            budget_dropped_pairs=int(new_pairs[past].sum()))
    return out


def validate_state(handler, *, fatal: bool = True) -> bool:
    """NaN/overflow guard: True when every active particle is finite;
    otherwise raises (or warns when ``fatal=False``) naming the population."""
    state = handler.state
    active = state.active_mask().cpu().numpy()
    pos_all = state.pos.cpu().numpy()
    vel_all = state.vel.cpu().numpy()
    ok = True
    for pop, name in ((0, "white"), (1, "yolk")):
        pos = pos_all[pop][active[pop]]
        vel = vel_all[pop][active[pop]]
        if not (np.isfinite(pos).all() and np.isfinite(vel).all()):
            ok = False
            msg = ("validate_state: population `", name,
                   "` has non-finite positions or velocities — the solver "
                   "likely diverged (check damping >= 0.05 and strengths < 1)")
            if fatal:
                log.error(*msg)
            log.warning(*msg)
    return ok
