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
  packages' pieces (:class:`JaxSide` and the port's ``PortSide``); on the
  dense engine ``lockstep.explain_dense`` does, from the JAX step traced
  as it runs (:class:`JaxTrace`, :class:`JaxDenseSide`) and the port's
  step run again with its recorders, each held to the step that ran;
- :func:`resident_locked` holds ``run_steps`` on the resident route: the
  port's ``multi_step`` run again with its recorders, its rebins step by
  step against the JAX loop's as traced.

The JAX step is pinned to its CPU plane path (:func:`pin_plane_path`):
``tests/test_fused_path.py`` sets ``EGG_SWEEP_INTERPRET=1`` for the whole
test run when it is collected.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import re
from contextlib import redirect_stderr
from typing import Callable, List, Optional

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu.ops import dense as jdense
from egg_fluid_simulation_tpu.ops import grid as jgrid
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu.utils.mathx import EPS, jnp_mix
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
    ht._render_budget.k_boost = list(hj._render_k_boost)
    ht._render_budget.peak_density = list(hj._render_peak_density)
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


# the JAX binnings the trace is held to, jitted once per static shape and
# option
_bin_to_planes = jax.jit(jdense.bin_to_planes,
                         static_argnames=("grid_dim", "slots_per_cell",
                                          "use_placement", "rotate"))
_bin_components = jax.jit(jsolver._bin_components,
                          static_argnums=(11, 12, 13),
                          static_argnames=("occ_cap",))


class JaxTrace:
    """The JAX package's dense step recorded as it runs: for the life of
    the fixture that :meth:`install` s it (:func:`jax_trace`), the module
    attributes the JAX
    step looks its substep and gate through up at trace time
    (``solver._plane_run`` and ``_plane_drift_over``, or on the fused path
    ``_fused_run`` and ``_comp_drift_over``) are wrappers that call them and
    hand their inputs and outputs to the host with an ordered
    ``jax.debug.callback``; ``dense.bin_to_planes`` and
    ``solver._bin_components`` are counted the same way. The JAX package's
    files are not touched, and its jit caches are cleared on the way in and
    out, so each handler traces its step through the wrappers. Events come
    in program order: per population, per substep, ``("in", wide, first,
    n_sub)`` (its input state), ``("out",)`` and, with the gate on,
    ``("drift",)`` (the count, the mean, the per-slot ``rel2`` and the
    displacement)."""

    def __init__(self):
        self.events: List[tuple] = []

    def _sink(self, tag, *arrays):
        self.events.append((tag, [np.asarray(a) for a in arrays]))

    def _note(self, tag, *arrays):
        jax.debug.callback(functools.partial(self._sink, tag), *arrays,
                           ordered=True)

    def install(self, monkeypatch) -> None:
        run_p, drift_p = jsolver._plane_run, jsolver._plane_drift_over
        run_f, drift_f = jsolver._fused_run, jsolver._comp_drift_over
        bin_p, bin_f = jdense.bin_to_planes, jsolver._bin_components
        rp = jdense.ROW_PAD

        def plane_run(planes, aux, damp, follow_c, params, sub_dt,
                      relaxation, options, g, k, n_sub, *, wide=False,
                      first_substep=True, **kw):
            self._note(("in", bool(wide), first_substep, n_sub),
                       planes[:2, rp:rp + g],
                       aux[jsolver.AUX_PX:jsolver.AUX_PY + 1, rp:rp + g],
                       planes[jdense.FIELD_OCC, rp:rp + g],
                       aux[jsolver.AUX_VX:jsolver.AUX_VY + 1, rp:rp + g]
                       * sub_dt)
            out = run_p(planes, aux, damp, follow_c, params, sub_dt,
                        relaxation, options, g, k, n_sub, wide=wide,
                        first_substep=first_substep, **kw)
            self._note(("out",), out[0][:2, rp:rp + g])
            return out

        def plane_drift(planes, ref_xy, g, thresh2):
            out = drift_p(planes, ref_xy, g, thresh2)
            occ = jnp.minimum(planes[jdense.FIELD_OCC, rp:rp + g], 1.0)
            disp = planes[:2, rp:rp + g] - ref_xy[:2, rp:rp + g]
            self._note(("drift",), out[0], out[2], _rel2(disp, occ, out[2]),
                       disp)
            return out

        def fused_run(xy, prev, stat, follow, *a, wide=False,
                      first_substep=True, **kw):
            self._note(("in", bool(wide), first_substep, a[-1]), xy, prev,
                       stat[3], xy - prev)
            out = run_f(xy, prev, stat, follow, *a, wide=wide,
                        first_substep=first_substep, **kw)
            self._note(("out",), out[0])
            return out

        def fused_drift(xy, occ, ref_xy, thresh2):
            out = drift_f(xy, occ, ref_xy, thresh2)
            disp = xy - ref_xy
            self._note(("drift",), out[0], out[2],
                       _rel2(disp, jnp.minimum(occ, 1.0), out[2]), disp)
            return out

        def binned(fn):
            def wrapper(*a, **kw):
                out = fn(*a, **kw)
                self._note(("bin",), jnp.zeros(()))
                return out
            return wrapper

        for name, fn in (("_plane_run", plane_run),
                         ("_plane_drift_over", plane_drift),
                         ("_fused_run", fused_run),
                         ("_comp_drift_over", fused_drift),
                         ("_bin_components", binned(bin_f))):
            monkeypatch.setattr(jsolver, name, fn)
        monkeypatch.setattr(jdense, "bin_to_planes", binned(bin_p))
        jax.clear_caches()

    def take(self) -> List[tuple]:
        """The events since the last call, once the device has run them."""
        jax.effects_barrier()
        out, self.events = self.events, []
        return out


def _rel2(disp, occ, mean):
    """``_plane_drift_over`` / ``_comp_drift_over``'s per-slot ``rel2``
    from their mean."""
    dxp, dyp = disp[0] * occ, disp[1] * occ
    return (dxp - mean[0] * occ) ** 2 + (dyp - mean[1] * occ) ** 2


@pytest.fixture(scope="module")
def jax_trace():
    """A :class:`JaxTrace` installed for one test module (its tests share
    the JAX step's compiled executables; a test that changes how the JAX
    step traces, ``FORCE_INTERPRET``, clears the caches itself)."""
    with pytest.MonkeyPatch.context() as mp:
        trace = JaxTrace()
        trace.install(mp)
        yield trace
    jax.clear_caches()


class JaxDenseSide:
    """The JAX package's dense step as it ran (a :class:`JaxTrace`), as the
    first side of ``lockstep.explain_dense``: its binning (``ops/dense.py``
    ``bin_to_planes(rotate=True)``, or ``solver._bin_components`` on the
    fused path, ``FORCE_INTERPRET``) run again here for the slot vector,
    and held bit for bit to the positions the step's first substep read."""

    def __init__(self, hj, step_delta: float = 1 / 60,
                 relaxation: float = 1.0):
        self.options = hj._options
        cfg2 = hj._device_cfg2()
        self._cfg = [jax.tree.map(lambda a, i=i: a[i], cfg2)
                     for i in range(2)]
        self.fused = jsolver._fused_component_path(self.options)
        self.sub_dt = jnp.maximum(jnp.float32(step_delta)
                                  / self.options.n_substeps, EPS)
        self.relaxation = jnp.float32(relaxation)

    def population(self, pop, before):
        """The step constants of ``_population_step_dense`` for ``pop``."""
        opts, cfg = self.options, self._cfg[pop]
        cap_all = before["pos"].shape[1]
        cap = min((opts.pop_caps or (cap_all, cap_all))[pop], cap_all)
        act = jnp.arange(cap) < int(before["count"][pop])
        mass_t = jnp.asarray(before["mass_t"][pop, :cap])
        batch_slot = jnp.asarray(before["batch_slot"][pop, :cap])
        mass = jnp_mix(cfg.min_mass, cfg.max_mass, mass_t)
        inv_mass = jnp.where(act, 1.0 / jnp.maximum(mass, jnp.float32(1e-12)),
                             0.0)
        radius = jnp.where(act, jnp_mix(cfg.min_radius, cfg.max_radius,
                                        mass_t), 0.0)
        sub_dt = self.sub_dt
        follow_c = jsolver.strength_to_compliance(cfg.follow_strength, sub_dt)
        cell_size, params = jsolver._dense_params(
            cfg, act, jsolver.strength_to_compliance(cfg.collision_strength,
                                                     sub_dt),
            jsolver.strength_to_compliance(cfg.cohesion_strength, sub_dt),
            opts)
        follow_radius = jnp.sqrt(jnp.maximum(
            jnp.asarray(before["batch_radius"][pop]), 0.0))
        table = jnp.concatenate([jnp.asarray(before["batch_target"]),
                                 follow_radius[:, None]], axis=1)
        rows = jsolver.take_batch_rows(table, batch_slot)
        return dict(pop=pop, cap=cap, act=act, batch_slot=batch_slot,
                    inv_mass=inv_mass, radius=radius,
                    damp=1.0 - jnp.clip(cfg.damping, 0.0, 1.0),
                    follow_c=follow_c, cell_size=cell_size, params=params,
                    tx=rows[:, 0], ty=rows[:, 1], td=2.0 * rows[:, 2],
                    rows=rows,
                    g=opts.dense_grid_dim[pop], k=opts.dense_slots[pop])

    def bin(self, pop, before):
        P = self.population(pop, before)
        cap = P["cap"]
        return self._bin_arrays(P, jnp.asarray(before["pos"][pop, :cap]),
                                jnp.asarray(before["vel"][pop, :cap]))

    def _bin_arrays(self, P, p, v):
        if self.fused:
            xy, prev, stat, follow, slot = _bin_components(
                p, v, P["inv_mass"], P["radius"], P["batch_slot"], P["act"],
                P["cell_size"], P["tx"], P["ty"], P["td"], self.sub_dt,
                P["g"], P["k"], False, occ_cap=self.options.occ_pressure_cap)
            return (P, [xy, prev, stat, follow]), np.array(slot)
        aux_cols = jnp.stack([p[:, 0], p[:, 1], v[:, 0], v[:, 1],
                              P["tx"], P["ty"], P["td"]], axis=1)
        b = _bin_to_planes(p, P["inv_mass"], P["radius"], P["batch_slot"],
                           P["act"], P["cell_size"], grid_dim=P["g"],
                           slots_per_cell=P["k"], aux_cols=aux_cols,
                           use_placement=False, rotate=True)
        return (P, [b.planes, b.aux]), np.array(b.slot)

    def gate_thresh2(self, layout):
        """``_adaptive_substep_run``'s ``thresh2``."""
        return np.float32((self.options.wide_threshold_cells
                           * layout[0]["cell_size"]) ** 2)

    def _core(self, P, t):
        rp = jdense.ROW_PAD
        return t[..., rp:rp + P["g"], :]

    def occupancy(self, layout):
        P, grid = layout
        if self.fused:
            return np.array(grid[2][3])
        return np.array(self._core(P, grid[0][jdense.FIELD_OCC]))

    def positions(self, layout):
        P, grid = layout
        if self.fused:
            return np.array(grid[0])
        return np.array(self._core(P, grid[0][:2]))

    def _extract(self, layout, slot):
        P, grid = layout
        g, lanes = P["g"], P["g"] * P["k"]
        if self.fused:
            return jsolver._comp_extract(grid[0], grid[1], grid[2],
                                         jnp.asarray(slot), g, lanes,
                                         self.sub_dt)
        return jsolver._plane_extract(grid[0], grid[1], jnp.asarray(slot), g,
                                      lanes, sub_dt=self.sub_dt)

    def _predicted(self, pred, occ, thresh2, limit):
        """The gate's velocity-predicted evaluation before substep 0, from
        the displacement the trace gave (``_adaptive_substep_run`` /
        ``_fused_adaptive_run`` take it inline, so it is computed here with
        their expressions)."""
        occ01 = jnp.minimum(jnp.asarray(occ), 1.0)
        n_occ = jnp.maximum(jnp.sum(occ01), 1.0)
        disp = jnp.asarray(pred) * occ01
        mean = jnp.stack([jnp.sum(disp[0]) / n_occ,
                          jnp.sum(disp[1]) / n_occ])
        rel2 = np.array(_rel2(disp, occ01, mean))
        n = int(np.count_nonzero(rel2 > thresh2))
        return lockstep.GateRecord(0, rel2, np.array(disp), np.array(mean),
                                   n, bool(np.float32(n) > limit))

    def traced(self, before, events, after, wide_after
               ) -> List[lockstep.PopReplay]:
        """Both populations' step as the JAX package ran it from
        ``before``: the :class:`JaxTrace` ``events`` of one step, the host
        view ``after`` of its result and its episode state ``wide_after``.
        Each substep's window, input state and output come from the trace,
        the gate evaluations after each substep too (count, mean, ``rel2``);
        the slot vector, occupancy and ``in_grid`` from the binning run
        here, held bit for bit to the positions and occupancy the step's
        first substep read; the merged arrays and episode state are the
        step's. The last substep's positions must be the step's at every
        binned particle. Raises ``lockstep.Departure``."""
        opts = self.options
        gate_on = opts.wide_budget_substeps != 0
        ev = iter([e for e in events if e[0][0] != "bin"])
        out = []
        for pop in range(2):
            name = f"JAX {('white', 'yolk')[pop]}"
            layout, slot = self.bin(pop, before)
            occ = self.occupancy(layout)
            thresh2 = self.gate_thresh2(layout)
            limit = lockstep.gate_limit(opts.wide_tolerance,
                                        int(before["count"][pop]))
            gates, subs = [], []
            for s in range(opts.n_substeps):
                tag, (xy, prev, occ_in, pred) = next(ev)
                if tag[0] != "in" or tag[2] != (s == 0) or tag[3] != 1:
                    raise lockstep.Departure(f"{name}: substep {s}'s trace "
                                             f"{tag} is not a gated step's")
                if s == 0:
                    if not (np.array_equal(xy, self.positions(layout))
                            and np.array_equal(occ_in, occ)):
                        raise lockstep.Departure(
                            f"{name}: the step's first substep did not read "
                            f"the binning made here")
                    if gate_on:
                        gates.append(self._predicted(pred, occ, thresh2,
                                                     limit))
                tag_out, (xy_out,) = next(ev)
                subs.append(lockstep.SubstepRecord(
                    s, tag[1], xy, xy_out, None if s == 0 else (xy, prev)))
                if gate_on:
                    tag_d, (n, mean, rel2, disp) = next(ev)
                    gates.append(lockstep.GateRecord(
                        s + 1, rel2, disp, mean, int(n),
                        bool(np.float32(int(n)) > limit)))
            P = layout[0]
            in_grid = np.array(self._extract(layout, slot)[3] & P["act"])
            cap = P["cap"]
            res = {f: after[f][pop, :cap] for f in ("pos", "prev", "vel")}
            lanes = xy_out.shape[2]
            at = slot[in_grid]
            if not np.array_equal(xy_out[:, at // lanes, at % lanes].T,
                                  res["pos"][in_grid]):
                raise lockstep.Departure(f"{name}: the last substep's "
                                         f"positions are not the step's")
            out.append(lockstep.PopReplay(
                pop, slot, occ, thresh2, limit, gates, subs,
                tuple(wide_after[pop]), dict(res, in_grid=in_grid)))
        if next(ev, None) is not None:
            raise lockstep.Departure("the JAX trace holds more than one "
                                     "step")
        return out

    def resident_rebins(self, events, n_steps: int) -> List[List[bool]]:
        """Per population, whether each of ``n_steps`` resident steps of the
        JAX package's ``multi_step`` (``_population_multi_dense``) rebinned:
        the :class:`JaxTrace` ``events`` of one call (the enter's binning,
        then per step a binning where it rebinned and the substeps)."""
        per_sub = 3 if self.options.wide_budget_substeps != 0 else 2
        ev = iter(events)
        out = []
        for pop in range(2):
            if next(ev)[0][0] != "bin":
                raise lockstep.Departure("the JAX resident loop does not "
                                         "bin at its enter")
            taken = []
            for _ in range(n_steps):
                tag = next(ev)[0]
                taken.append(tag[0] == "bin")
                if taken[-1]:
                    tag = next(ev)[0]
                if tag[0] != "in":
                    raise lockstep.Departure(f"JAX resident step: {tag}")
                for _ in range(per_sub * self.options.n_substeps - 1):
                    next(ev)
            out.append(taken)
        return out


@dataclasses.dataclass
class Report:
    """What a step-locked run saw: steps, the worst live ``pos`` / ``prev``
    and ``vel`` errors of the steps within tolerance, each flip with its
    step index, the JAX handler's wide-gate episode state after each
    step (per population ``(trip, budget, calm)``), on the dense engine
    the windows the JAX step's substeps ran (per population, True for
    window 3), and the rebins of each resident call."""
    steps: int = 0
    pos_err: float = 0.0
    vel_err: float = 0.0
    flips: List[tuple] = dataclasses.field(default_factory=list)
    wide: List[list] = dataclasses.field(default_factory=list)
    windows: List[list] = dataclasses.field(default_factory=list)
    rebins: List[list] = dataclasses.field(default_factory=list)


def step_locked(hj, ht, n: int, drive: Optional[Callable] = None,
                advance: Optional[Callable] = None, step_delta: float = 1 / 60,
                report: Optional[Report] = None,
                trace: Optional[JaxTrace] = None) -> Report:
    """``n`` calls of ``advance(h)`` (default ``h.update(step_delta)``) on
    both handlers, each from the JAX state (module doc). ``drive(h, i)``,
    if given, is called on both handlers before call ``i`` (targets,
    colours). A call past the tolerances must be one step whose departure
    is a rounding flip (``lockstep.explain``, at ``step_delta``), else
    ``lockstep.Departure`` propagates. On the dense engine the JAX step is
    recorded as it runs (``trace``, the :func:`jax_trace` fixture's) and
    read back every step (:meth:`JaxDenseSide.traced`); a step past the
    tolerances must be explained by ``lockstep.explain_dense`` from that
    record and the port's step run again with its recorders, each held to
    the step that ran."""
    rep = report or Report()
    if ht._options.engine == "dense" and trace is None:
        raise ValueError("a dense step is held through the JAX trace")
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
        wide_in = lockstep.wide_host(hj._wide_or_init())
        if trace is not None:
            trace.take()
        _, ej, wj = stderr_lines(lambda: advance(hj))
        events = trace.take() if trace is not None else None
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
        dense = ht._options.engine == "dense"
        wide = [lockstep.wide_host(h._wide_or_init()) for h in (hj, ht)]
        rep.wide.append(wide[0])
        if dense:
            js = JaxDenseSide(hj, step_delta)
            jr = js.traced(before, events, a, wide[0])
            rep.windows.append([[sub.wide for sub in r.substeps]
                                for r in jr])
        if max(err["pos"], err["prev"], err["last_pos"]) <= POS_TOL and \
                err["vel"] <= VEL_TOL and wide[0] == wide[1]:
            rep.pos_err = max(rep.pos_err, err["pos"], err["prev"])
            rep.vel_err = max(rep.vel_err, err["vel"])
            assert_stats_close(ht, hj)
            continue
        if dense:
            ps = lockstep.DensePortSide(ht._device_cfg2(), ht._options,
                                        "cpu", step_delta)
            pr = lockstep.replay_dense(ps, before, wide_in)
            rep.flips.extend((i, f) for f in lockstep.explain_dense(
                js, ps, before, wide_in,
                ((a, wide[0], None), (b, wide[1], None)), replays=(jr, pr)))
            continue
        flip = lockstep.explain(JaxSide(hj), PortSide(ht._device_cfg2(),
                                                      ht._options, "cpu"),
                                before, step_delta)
        rep.flips.append((i, flip))
    return rep


def port_resident(ht, before, wide_in, n_steps: int,
                  step_delta: float = 1 / 60):
    """The port's ``solver.multi_step`` (the code ``run_steps`` runs on the
    CPU) from ``before`` with a ``lockstep.Recorder`` on each resident
    step: ``(state, wide_out, decisions)``, ``decisions[pop]`` the rebin
    decisions of resident steps 1 on (step 0's layout was just binned)."""
    from egg_fluid_simulation_tpu_torch.ops import solver as tsolver
    opts, cfg2 = ht._options, ht._device_cfg2()
    dt, relax = ht._step_scalars(step_delta)
    side = lockstep.DensePortSide(cfg2, opts, "cpu", step_delta)
    recs = {}

    def record(i, pop):
        return recs.setdefault((i, pop), lockstep.Recorder(side))

    ws = tuple(tuple(torch.tensor(np.array(x)) for x in w) for w in wide_in)
    state, _, ws = tsolver.multi_step(state_from_numpy(before), cfg2, dt,
                                      relax, opts, n_steps, wide_state=ws,
                                      record=record)
    decisions = [[recs[(i, pop)].decision for i in range(1, n_steps - 1)]
                 for pop in range(2)]
    return state_to_numpy(state), lockstep.wide_host(ws), decisions


def resident_locked(hj, ht, calls: int, n_steps: int, trace: JaxTrace,
                    step_delta: float = 1 / 60,
                    report: Optional[Report] = None) -> Report:
    """``calls`` calls of ``run_steps(n_steps)`` on both handlers (the
    resident route of the dense engine), each from the JAX state. Held per
    call: the host fields bit for bit; the port's ``multi_step`` run again
    with its recorders (:func:`port_resident`) bit for bit to the port's
    call, and its rebins to the count the call took (``solver.rebins``);
    each resident step's rebin equal to the JAX loop's as it ran
    (``trace``: a binning in ``_population_multi_dense``'s step,
    :meth:`JaxDenseSide.resident_rebins`); pos / prev / vel at the step
    tolerances and the episode states equal. The report's ``rebins`` holds
    each call's per-population counts."""
    from egg_fluid_simulation_tpu_torch.ops import solver as tsolver
    rep = report or Report()
    n_res = n_steps - 1
    for i in range(calls):
        carry(hj, ht)
        before = host_view(hj.state)
        wide_in = lockstep.wide_host(hj._wide_or_init())
        start = list(tsolver.rebins)
        trace.take()
        hj.run_steps(n_steps, step_delta)
        jax_taken = JaxDenseSide(hj, step_delta).resident_rebins(
            trace.take(), n_res)
        ht.run_steps(n_steps, step_delta)
        taken = [b - a for a, b in zip(start, tsolver.rebins)]
        a, b = host_view(hj.state), state_to_numpy(ht.state)
        wide = [lockstep.wide_host(h._wide_or_init()) for h in (hj, ht)]
        p_state, p_wide, pd = port_resident(ht, before, wide_in, n_steps,
                                            step_delta)
        tsolver.rebins[:] = [x + y for x, y in zip(start, taken)]
        for f in ("pos", "prev", "vel", "last_pos"):
            np.testing.assert_array_equal(
                p_state[f], b[f], err_msg=f"the port's replay of {f}")
        assert p_wide == wide[1], (p_wide, wide[1])
        port_taken = [[False] + [d.trip for d in ds] for ds in pd]
        assert [sum(t) for t in port_taken] == taken, (port_taken, taken)
        if port_taken != jax_taken:
            raise lockstep.Departure(f"run_steps call {i}: rebins by step "
                                     f"{port_taken} against JAX's "
                                     f"{jax_taken}")
        rep.rebins.append(taken)
        assert_host_fields(a, b)
        err = lockstep.live_errors(a, b)
        rep.steps += 1
        rep.wide.append(wide[0])
        if not (max(err["pos"], err["prev"], err["last_pos"]) <= POS_TOL
                and err["vel"] <= VEL_TOL and wide[0] == wide[1]):
            raise lockstep.Departure(
                f"run_steps call {i} parts ({err}, wide {wide}) with every "
                f"rebin decision equal")
        rep.pos_err = max(rep.pos_err, err["pos"], err["prev"])
        rep.vel_err = max(rep.vel_err, err["vel"])
    return rep


def flip_lines(rep: Report) -> List[str]:
    return [f"step {i}: {f.describe()}" for i, f in rep.flips]


__all__ = ["pin_plane_path", "pair", "both", "normalise", "stderr_lines",
           "carry",
           "stats_to_torch", "assert_host_fields", "assert_stats_close",
           "JaxSide", "JaxTrace", "jax_trace", "JaxDenseSide", "Report",
           "step_locked",
           "port_resident", "resident_locked", "flip_lines",
           "host_view", "state_to_numpy",
           "POS_TOL", "VEL_TOL", "STATS_TOL", "FRAME_TOL", "HOST_FIELDS"]
