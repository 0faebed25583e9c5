"""Twin harness: a JAX handler and the port's handler (``device="cpu"``)
given the same calls, and the step-locked run that holds the port's step to
the JAX package's one step at a time.

- :func:`pair` builds both handlers from one set of arguments, and
  :func:`both` makes the same call on both (results, exception types and
  messages, and warning texts, the ``In <file>:<line>:`` call sites
  normalised);
- :func:`carry` copies into the port's handler everything its next
  ``update`` reads from the JAX handler: the state (through
  ``interop.state_from_numpy(host_view(...))``), the wide gate's episode
  state, the stats, the fixed-step accumulator and the render budget;
- :func:`step_locked` runs ``n`` updates: each starts both handlers from
  the JAX state, steps both, holds the host-decided fields bit for bit and
  ``pos`` / ``prev`` / ``vel`` of live particles at the whole-step
  tolerances (1e-3 px, 0.2 px/s). A step past them passes only as a
  rounding flip, which ``egg_fluid_simulation_tpu_torch.utils.lockstep.
  explain`` shows by replaying the step pass by pass through both
  packages' pieces (:class:`JaxSide` and the port's ``PortSide``).

The JAX step is pinned to its CPU plane path (:func:`pin_plane_path`):
``tests/test_fused_path.py`` sets ``EGG_SWEEP_INTERPRET=1`` for the whole
test run when it is collected.
"""

from __future__ import annotations

import dataclasses
import io
import re
from contextlib import redirect_stderr
from typing import Callable, List, Optional

import numpy as np
import torch

import jax
import jax.numpy as jnp

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu.ops import grid as jgrid
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu.utils.mathx import EPS
from egg_fluid_simulation_tpu_torch.interop import (state_from_numpy,
                                                    state_to_numpy)
from egg_fluid_simulation_tpu_torch.state import StepStats
from egg_fluid_simulation_tpu_torch.utils import lockstep
from egg_fluid_simulation_tpu_torch.utils.lockstep import (HOST_FIELDS,
                                                           POS_TOL, VEL_TOL,
                                                           PortSide)

STATS_TOL = 1e-3   # px, centroid, AABB and batch centroids after a step
FRAME_TOL = 1e-4   # per channel, a whole frame drawn from the same inputs


_OPTION_NAMES = [f.name for f in dataclasses.fields(jsolver.SolverOptions)]


def pin_plane_path(monkeypatch) -> None:
    """Pin the JAX step to its CPU plane path for one test."""
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    monkeypatch.setattr(jsweep, "FORCE_INTERPRET", False)


def pair(white=None, yolk=None, **kw):
    """A JAX handler and a port handler on the CPU, built alike. ``white``
    / ``yolk``: config overrides applied to the defaults in both; ``kw``
    the constructor's keywords (``options`` a dict, built in each
    package)."""
    opts = kw.pop("options", None)
    handlers = []
    for pkg, extra in ((J, {}), (T, {"device": "cpu"})):
        wc, yc = pkg.default_white_config(), pkg.default_yolk_config()
        wc.update(white or {})
        yc.update(yolk or {})
        handlers.append(pkg.SimulationHandler(
            wc, yc, options=None if opts is None else pkg.SolverOptions(**opts),
            **kw, **extra))
    return tuple(handlers)


_SITE = re.compile(r"In \S+:\d+: ")


def normalise(text: str) -> str:
    """``text`` without its ``In <file>:<line>:`` call sites."""
    return _SITE.sub("", text)


def stderr_lines(fn):
    """``(result, exception, lines)`` of ``fn()``: its stderr lines with the
    ``In <file>:<line>:`` call sites dropped (they name each package's own
    source)."""
    buf = io.StringIO()
    result = exc = None
    with redirect_stderr(buf):
        try:
            result = fn()
        except Exception as e:          # compared by the caller
            exc = e
    return result, exc, [normalise(line)
                         for line in buf.getvalue().splitlines()]


def both(hj, ht, name: str, *args, **kw):
    """Call ``name`` on both handlers with the same arguments; assert the
    same exception (type name and message, call sites normalised) or the same
    result, and the same warning lines. Returns the port's result."""
    rj, ej, wj = stderr_lines(lambda: getattr(hj, name)(*args, **kw))
    rt, et, wt = stderr_lines(lambda: getattr(ht, name)(*args, **kw))
    assert wt == wj, (name, wt, wj)
    # each package raises its own SimulationError
    assert type(et).__name__ == type(ej).__name__, (name, et, ej)
    if ej is not None:
        assert normalise(str(et)) == normalise(str(ej)), (et, ej)
        return et
    assert rt == rj, (name, rt, rj)
    return rt


def stats_to_torch(stats_j) -> StepStats:
    return StepStats(**{f.name: torch.from_numpy(
        np.array(getattr(stats_j, f.name))) for f in
        dataclasses.fields(StepStats)})


def carry(hj, ht) -> None:
    """Everything the port's next step reads, taken from the JAX handler."""
    ht._state = state_from_numpy(host_view(hj.state))
    ht._stats = stats_to_torch(hj.stats)
    ht._wide_state = tuple(
        tuple(torch.tensor(np.array(x)) for x in w)
        for w in hj._wide_or_init())
    ht._elapsed = hj._elapsed
    ht._interpolation_alpha = hj.interpolation_alpha
    ht._render_k_boost = list(hj._render_k_boost)
    ht._render_peak_density = list(hj._render_peak_density)
    ht._frames = None


def assert_host_fields(a, b) -> None:
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(b[f], a[f], err_msg=f)


def assert_stats_close(ht, hj) -> None:
    """The port's step stats against the JAX step's at :data:`STATS_TOL`,
    and ``get_position`` of every batch against the float64 centroid of
    the JAX state's members (the JAX handler sums them through a bf16
    hi/lo product, ~2^-18 of each position: 1.1e-3 px at x = 560)."""
    for f in ("centroid", "aabb_min", "aabb_max"):
        np.testing.assert_allclose(getattr(ht.stats, f).numpy(),
                                   np.asarray(getattr(hj.stats, f)),
                                   rtol=0, atol=STATS_TOL, err_msg=f)
    v = host_view(hj.state)
    for bid in ht.list_ids():
        slot = ht._batches[bid]["slot"]
        members = np.concatenate([
            v["pos"][p, :n][v["batch_slot"][p, :n] == slot]
            for p, n in enumerate(v["count"].tolist())]).astype(np.float64)
        np.testing.assert_allclose(ht.get_position(bid), members.mean(0),
                                   rtol=0, atol=STATS_TOL)


class JaxSide:
    """The JAX package's gather-step pieces (``ops/solver.py``
    ``pre_solve``, ``solve_follow``, ``solve_pairs``, ``post_solve``;
    ``ops/grid.py`` ``build_grid`` for the cells), run eagerly, numpy in
    and out: the reference side of ``lockstep.explain``."""

    def __init__(self, hj):
        self.options = hj._options
        cfg2 = hj._device_cfg2()
        self._cfg = [jax.tree.map(lambda a, i=i: a[i], cfg2)
                     for i in range(2)]

    def _sub_dt(self, step_delta):
        return jnp.maximum(jnp.float32(step_delta) / self.options.n_substeps,
                           EPS)

    def cell_size(self, pop):
        cfg = self._cfg[pop]
        return float(jnp.maximum(1.0, cfg.max_radius * jnp.maximum(
            cfg.collision_overlap_factor,
            cfg.cohesion_interaction_distance_factor)))

    def pre_solve(self, pop, pos, prev, vel, mass_t, act, step_delta):
        out = jsolver.pre_solve(*map(jnp.asarray, (pos, prev, vel, mass_t,
                                                   act)),
                                self._cfg[pop], self._sub_dt(step_delta))
        return tuple(np.array(a) for a in out)

    def solve_follow(self, pop, pos, inv, slot, act, target, batch_radius,
                     step_delta):
        cfg = self._cfg[pop]
        c = jsolver.strength_to_compliance(cfg.follow_strength,
                                           self._sub_dt(step_delta))
        fr = jnp.sqrt(jnp.maximum(jnp.asarray(batch_radius), 0.0))
        return np.array(jsolver.solve_follow(
            *map(jnp.asarray, (pos, inv, slot, act, target)), fr, c))

    def solve_pairs(self, pop, pos, inv, rad, slot, act, step_delta,
                    relaxation):
        cfg, sub_dt = self._cfg[pop], self._sub_dt(step_delta)
        return np.array(jsolver.solve_pairs(
            *map(jnp.asarray, (pos, inv, rad, slot, act)), cfg,
            jsolver.strength_to_compliance(cfg.collision_strength, sub_dt),
            jsolver.strength_to_compliance(cfg.cohesion_strength, sub_dt),
            jnp.float32(relaxation), self.options))

    def post_solve(self, pos, prev, act, slot, step_delta, max_batches):
        vel, _, _ = jsolver.post_solve(*map(jnp.asarray, (pos, prev, act,
                                                          slot)),
                                       self._sub_dt(step_delta), max_batches)
        return np.array(vel)

    def cells(self, pop, pos, inv, rad, slot, act):
        grid = jgrid.build_grid(jnp.asarray(pos), jnp.asarray(act),
                                jnp.float32(self.cell_size(pop)),
                                table_size=self.options.table_size,
                                slots_per_cell=self.options.slots_per_cell)
        return np.array(grid.cell_xy)


@dataclasses.dataclass
class Report:
    """What a step-locked run saw: steps, the worst live ``pos`` / ``prev``
    and ``vel`` errors of the steps within tolerance, and each flip with
    its step index."""
    steps: int = 0
    pos_err: float = 0.0
    vel_err: float = 0.0
    flips: List[tuple] = dataclasses.field(default_factory=list)


def step_locked(hj, ht, n: int, drive: Optional[Callable] = None,
                advance: Optional[Callable] = None, step_delta: float = 1 / 60,
                report: Optional[Report] = None) -> Report:
    """``n`` calls of ``advance(h)`` (default ``h.update(step_delta)``) on
    both handlers, each from the JAX state (module doc). ``drive(h, i)``,
    if given, is called on both handlers before call ``i`` (targets,
    colours). A call past the tolerances must be one step whose departure
    is a rounding flip (``lockstep.explain``, at ``step_delta``), else
    ``lockstep.Departure`` propagates."""
    rep = report or Report()
    if advance is None:
        def advance(h):
            h.update(step_delta)
    for i in range(n):
        if drive is not None:
            drive(hj, i)
            drive(ht, i)
        np.testing.assert_array_equal(ht._host_targets, hj._host_targets)
        hj._flush_targets()     # the step's input holds the new targets
        carry(hj, ht)
        before = host_view(hj.state)
        _, ej, wj = stderr_lines(lambda: advance(hj))
        _, et, wt = stderr_lines(lambda: advance(ht))
        assert ej is None and et is None, (ej, et)
        assert wt == wj, (wt, wj)
        assert {f: getattr(ht._options, f) for f in _OPTION_NAMES} == \
            {f: getattr(hj._options, f) for f in _OPTION_NAMES}
        assert (ht.interpolation_alpha, ht._elapsed) == \
            (hj.interpolation_alpha, hj._elapsed)
        a, b = host_view(hj.state), state_to_numpy(ht.state)
        assert_host_fields(a, b)
        err = lockstep.live_errors(a, b)
        rep.steps += 1
        if max(err["pos"], err["prev"], err["last_pos"]) <= POS_TOL and \
                err["vel"] <= VEL_TOL:
            rep.pos_err = max(rep.pos_err, err["pos"], err["prev"])
            rep.vel_err = max(rep.vel_err, err["vel"])
            assert_stats_close(ht, hj)
            continue
        flip = lockstep.explain(JaxSide(hj), PortSide(ht._device_cfg2(),
                                                      ht._options, "cpu"),
                                before, step_delta)
        rep.flips.append((i, flip))
    return rep


def flip_lines(rep: Report) -> List[str]:
    return [f"step {i}: {f.describe()}" for i, f in rep.flips]


__all__ = ["pin_plane_path", "pair", "both", "normalise", "stderr_lines",
           "carry",
           "stats_to_torch", "assert_host_fields", "assert_stats_close",
           "JaxSide", "Report", "step_locked", "flip_lines",
           "host_view", "state_to_numpy",
           "POS_TOL", "VEL_TOL", "STATS_TOL", "FRAME_TOL", "HOST_FIELDS"]
