"""Profiling and state audits.

``StepTimer`` (rolling phase timings) and ``trace`` (a ``torch.profiler``
trace), then the collision-budget drop rate and the NaN guard: host-side
numpy over a handler's current state, as in
``egg_fluid_simulation_tpu/utils/profiling.py``.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Dict, List, Union

import numpy as np
import torch

from . import log

__all__ = ["StepTimer", "trace", "validate_state", "collision_drop_stats"]


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


@contextlib.contextmanager
def trace(dir_path: str):
    """Wrap a block in a ``torch.profiler`` trace (CPU activity, and CUDA
    activity where a card is present), written to ``dir_path/trace.json``
    in the Chrome trace format."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(dir_path, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dir_path, "trace.json"))


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
