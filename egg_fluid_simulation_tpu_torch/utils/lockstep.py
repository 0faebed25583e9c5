"""Step-locked comparison of two runs of the fixed step, and the flip rules:
the gather engine's here, the dense engine's in the section of that name
(:func:`explain_dense`, the resident loop's :func:`drift_flip` and
:func:`hold_resident_step`).

Two implementations of the fixed step (the JAX package's and this one's on
the CPU, or this one's on a card and on the CPU) are held one step at a
time: both start each step from the same state, and their results must
agree within the whole-step tolerances (:data:`POS_TOL`, :data:`VEL_TOL`,
on live particles). A step that parts further passes only as a **rounding
flip**, which :func:`explain` shows:

1. it replays the step pass by pass (``pre_solve``, ``solve_follow``, each
   ``solve_pairs``, ``post_solve``'s velocity, both populations) through
   both sides' public pieces, from the step's common input state;
2. it finds the first pass whose output positions part by more than its
   input positions did plus :func:`pass_tol` (:data:`PASS_TOL` and one
   ulp of the largest coordinate); that pass must be a ``solve_pairs``
   pass;
3. it runs the second side's pass on the first side's input: the two
   outputs must agree within :func:`pass_tol`, so the pass is the same
   function on both sides and only its input differs;
4. it names the discrete decision that differs between the two inputs: a
   particle's cell ``floor(pos / cell_size)``, the first side's within
   :data:`FLIP_ULPS` float32 steps of the cell border that gives the
   second side's cell. The bucket, the slot rank against
   ``slots_per_cell`` and the ordered budget's prefix are functions of the
   cells and the particle order, so equal cells give equal decisions.

Anything else raises :class:`Departure`. A side is an object with the
methods of :class:`PortSide` (numpy in, numpy out); the first side of
:func:`explain` is the reference whose input the ulps are counted on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import population_config
from ..ops import dense as dense_ops
from ..ops import solver as solver_ops
from ..ops.kernels import gather_kernel
from .mathx import EPS

__all__ = ["POS_TOL", "VEL_TOL", "PASS_TOL", "FLIP_ULPS", "HOST_FIELDS",
           "Departure",
           "Flip", "PassRecord", "PortSide", "live_errors", "replay", "pass_tol",
           "cell_ulps", "explain",
           "GATE_ULPS", "ENVELOPE_NUDGES", "ENVELOPE_FACTOR", "DenseFlip",
           "Amplified", "GateRecord", "SubstepRecord", "PopReplay",
           "Recorder", "DensePortSide", "gate_limit", "float_steps",
           "replay_dense", "step_tol", "reproduces", "threshold_flip",
           "nudge", "envelope", "explain_dense", "explain_pop", "drift_flip",
           "wide_host", "resident_carry", "load_resident_carry",
           "ResidentStep", "resident_step", "carry_parts",
           "hold_resident_step"]

POS_TOL = 1e-3    # px, positions and previous positions after a step
VEL_TOL = 0.2     # px/s, velocities after a step
PASS_TOL = 1e-4   # px, one pass
FLIP_ULPS = 4     # float32 steps between an input and its cell border
# the fields host code decides (spawn, compaction, targets, colours) and a
# step hands through: equal bit for bit after every step
HOST_FIELDS = ("count", "batch_slot", "batch_used", "batch_target",
               "batch_radius", "color", "mass_t")


class Departure(AssertionError):
    """A step parted beyond the tolerances and the flip rule does not
    explain it."""


@dataclasses.dataclass
class Flip:
    """A rounding flip: the pass where the two sides part, the particles
    whose cell differs between the sides' inputs, the most float32 steps
    any of those inputs lies from the border (the first side's), how far
    the pass's outputs part, and the particles that moved apart."""
    pop: int
    substep: int
    pass_index: int
    particles: List[int]
    ulps: int
    part_px: float
    moved: List[int]
    decision: str = "cell floor(pos / cell_size)"

    def describe(self) -> str:
        pops = ("white", "yolk")
        return (f"{pops[self.pop]} substep {self.substep} pass "
                f"{self.pass_index}: {self.decision} of particles "
                f"{self.particles} within {self.ulps} ulps of the border, "
                f"{len(self.moved)} particles part by {self.part_px:.4g} px")


@dataclasses.dataclass
class PassRecord:
    """One pass of a replayed step: its name (``pre_solve``,
    ``solve_follow``, ``solve_pairs``, ``post_solve``), where it ran, its
    input and output positions (``post_solve``: velocities out) and, for a
    ``solve_pairs`` pass, the other fields the pass reads."""
    pop: int
    substep: int
    name: str
    pass_index: int
    pos_in: np.ndarray
    out: np.ndarray
    fields: Optional[Tuple[np.ndarray, ...]] = None


def live_errors(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]
                ) -> Dict[str, float]:
    """Largest absolute difference of ``pos``, ``prev``, ``last_pos`` and
    ``vel`` over the live particles of two host views (``count`` from
    ``a``)."""
    out = {}
    for f in ("pos", "prev", "last_pos", "vel"):
        out[f] = max((float(np.abs(a[f][p, :n] - b[f][p, :n]).max())
                      for p, n in enumerate(np.asarray(a["count"]).tolist())
                      if n), default=0.0)
    return out


class PortSide:
    """This package's gather-step pieces on ``device`` (kernel H on a card,
    its plain versions on the CPU), numpy in and out. ``cfg2`` is a
    handler's stacked :class:`DeviceConfig` (moved to ``device``)."""

    def __init__(self, cfg2, options: solver_ops.SolverOptions, device):
        self.device = torch.device(device)
        self.options = options
        self._cfg = [population_config(
            type(cfg2)(**{f.name: getattr(cfg2, f.name).to(self.device)
                          for f in dataclasses.fields(cfg2)}), i)
            for i in range(2)]

    def _t(self, a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    def _sub_dt(self, step_delta):
        return torch.clamp(torch.tensor(step_delta, dtype=torch.float32,
                                        device=self.device)
                           / self.options.n_substeps, min=EPS)

    def cell_size(self, pop: int) -> float:
        cfg = self._cfg[pop]
        return float(torch.clamp(cfg.max_radius * torch.maximum(
            cfg.collision_overlap_factor,
            cfg.cohesion_interaction_distance_factor), min=1.0))

    def pre_solve(self, pop, pos, prev, vel, mass_t, act, step_delta):
        out = solver_ops.pre_solve(self._t(pos), self._t(prev), self._t(vel),
                                   self._t(mass_t), self._t(act),
                                   self._cfg[pop], self._sub_dt(step_delta))
        return tuple(t.cpu().numpy() for t in out)

    def solve_follow(self, pop, pos, inv, slot, act, target, batch_radius,
                     step_delta):
        cfg = self._cfg[pop]
        c = solver_ops.strength_to_compliance(cfg.follow_strength,
                                              self._sub_dt(step_delta))
        fr = torch.sqrt(torch.clamp(self._t(batch_radius), min=0.0))
        return solver_ops.solve_follow(
            self._t(pos), self._t(inv), self._t(slot), self._t(act),
            self._t(target), fr, c).cpu().numpy()

    def solve_pairs(self, pop, pos, inv, rad, slot, act, step_delta,
                    relaxation):
        cfg, sub_dt = self._cfg[pop], self._sub_dt(step_delta)
        return solver_ops.solve_pairs(
            self._t(pos), self._t(inv), self._t(rad), self._t(slot),
            self._t(act), cfg,
            solver_ops.strength_to_compliance(cfg.collision_strength, sub_dt),
            solver_ops.strength_to_compliance(cfg.cohesion_strength, sub_dt),
            torch.tensor(relaxation, dtype=torch.float32, device=self.device),
            self.options).cpu().numpy()

    def post_solve(self, pos, prev, act, slot, step_delta, max_batches):
        vel, _, _ = solver_ops.post_solve(
            self._t(pos), self._t(prev), self._t(act), self._t(slot),
            self._sub_dt(step_delta), max_batches)
        return vel.cpu().numpy()

    def cells(self, pop, pos, inv, rad, slot, act):
        """(N, 2) cells of the pass's front: kernel H's record on a card,
        ``grid.cells_and_buckets`` through the plain front on the CPU."""
        record, _ = gather_kernel.gather_front(
            self._t(pos), self._t(inv), self._t(rad), self._t(slot),
            self._t(act), torch.tensor(self.cell_size(pop),
                                       dtype=torch.float32,
                                       device=self.device),
            self.options.table_size)
        return gather_kernel.record_cells(record).cpu().numpy()


def replay(side, before: Dict[str, np.ndarray], step_delta: float,
           relaxation: float = 1.0) -> List[PassRecord]:
    """The gather step from the host view ``before``, pass by pass through
    ``side``'s pieces: the records of both populations in order."""
    opts = side.options
    if opts.engine != "gather":
        raise ValueError("replay steps the gather engine only")
    cap_all = before["pos"].shape[1]
    caps = opts.pop_caps or (cap_all, cap_all)
    max_batches = before["batch_target"].shape[0]
    recs: List[PassRecord] = []
    for pop in range(2):
        cap = min(caps[pop], cap_all)
        act = np.arange(cap) < int(before["count"][pop])
        pos, prev, vel = (before[f][pop, :cap] for f in ("pos", "prev", "vel"))
        mass_t = before["mass_t"][pop, :cap]
        slot = before["batch_slot"][pop, :cap]
        for sub in range(opts.n_substeps):
            x = pos
            pos, prev, vel, inv, rad = side.pre_solve(pop, pos, prev, vel,
                                                      mass_t, act, step_delta)
            recs.append(PassRecord(pop, sub, "pre_solve", 0, x, pos))
            x = pos
            pos = side.solve_follow(pop, pos, inv, slot, act,
                                    before["batch_target"],
                                    before["batch_radius"][pop], step_delta)
            recs.append(PassRecord(pop, sub, "solve_follow", 0, x, pos))
            for p in range(opts.n_collision_steps):
                x = pos
                pos = side.solve_pairs(pop, pos, inv, rad, slot, act,
                                       step_delta, relaxation)
                recs.append(PassRecord(pop, sub, "solve_pairs", p, x, pos,
                                       (inv, rad, slot, act)))
            vel = side.post_solve(pos, prev, act, slot, step_delta,
                                  max_batches)
            recs.append(PassRecord(pop, sub, "post_solve", 0, pos, vel))
    return recs


def pass_tol(pos: np.ndarray) -> float:
    """:data:`PASS_TOL` plus one float32 ulp of the largest coordinate
    of ``pos``: a pass's sums in another order round a position that far
    apart (an ulp is 6.1e-5 px from 512 px up)."""
    return PASS_TOL + float(np.spacing(np.float32(
        np.abs(pos).max(initial=0.0))))


def cell_ulps(x: float, cell_size: float, want: int, limit: int = 64) -> int:
    """Float32 steps from ``x`` to the nearest value whose cell
    ``floor(x / cell_size)`` (float32 division) is ``want``; ``limit + 1``
    when none lies within ``limit`` steps."""
    x = np.float32(x)
    cs = np.float32(cell_size)
    have = int(np.floor(x / cs))
    if have == want:
        return 0
    toward = np.float32(np.inf if want > have else -np.inf)
    for k in range(1, limit + 1):
        x = np.nextafter(x, toward, dtype=np.float32)
        if int(np.floor(x / cs)) == want:
            return k
    return limit + 1


def explain(ref, other, before: Dict[str, np.ndarray], step_delta: float,
            relaxation: float = 1.0) -> Flip:
    """Show that a step which parted is a rounding flip (the module's
    rule), or raise :class:`Departure`. ``ref`` is the side whose inputs the
    ulps are counted on."""
    ra = replay(ref, before, step_delta, relaxation)
    rb = replay(other, before, step_delta, relaxation)
    for a, b in zip(ra, rb):
        if a.name == "post_solve":
            continue
        live = np.arange(a.out.shape[0]) < int(before["count"][a.pop])
        part = np.abs(a.out[live] - b.out[live]).max(initial=0.0)
        tol = pass_tol(a.pos_in[live])
        if part <= np.abs(a.pos_in[live] - b.pos_in[live]).max(
                initial=0.0) + tol:
            continue
        where = (f"{('white', 'yolk')[a.pop]} substep {a.substep} "
                 f"{a.name} {a.pass_index}")
        if a.name != "solve_pairs":
            raise Departure(f"the step parts by {part:.4g} px at {where}, "
                            f"not a collision pass")
        inv, rad, slot, act = a.fields
        same = other.solve_pairs(a.pop, a.pos_in, inv, rad, slot, act,
                                 step_delta, relaxation)
        err = np.abs(same[act] - a.out[act]).max(initial=0.0)
        if err > tol:
            raise Departure(f"at {where} the second side's pass on the "
                            f"first side's input parts by {err:.4g} px: "
                            f"the pass itself differs")
        ca = ref.cells(a.pop, a.pos_in, inv, rad, slot, act)
        cb = other.cells(b.pop, b.pos_in, inv, rad, slot, act)
        cs = ref.cell_size(a.pop)
        with np.errstate(divide="ignore", invalid="ignore"):
            floor_a = np.floor(a.pos_in / np.float32(cs)).astype(np.int64)
        if not (floor_a[act] == ca[act]).all():
            raise Departure(f"at {where} the first side's cells are not "
                            f"floor(pos / cell_size)")
        differ = np.nonzero(act & (ca != cb).any(axis=1))[0]
        if differ.size == 0:
            raise Departure(f"the step parts by {part:.4g} px at {where} "
                            f"with every cell equal")
        ulps = max(cell_ulps(a.pos_in[p, ax], cs, int(cb[p, ax]))
                   for p in differ for ax in range(2) if ca[p, ax] != cb[p, ax])
        if ulps > FLIP_ULPS:
            raise Departure(f"at {where} particles {differ.tolist()} change "
                            f"cell {ulps} float32 steps from the border "
                            f"(more than {FLIP_ULPS})")
        moved = np.nonzero(act & (np.abs(a.out - b.out) > PASS_TOL).any(1))[0]
        return Flip(a.pop, a.substep, a.pass_index, differ.tolist(), ulps,
                    float(part), moved.tolist())
    raise Departure("no pass of the replayed step parts by more than its "
                    "input did and the pass tolerance")


# ------------------------------------------------------- the dense engine --
#
# The dense engine (``engine="dense"``, ``dense_rebin="step"``) bins each
# population once a step, so two sides that start a step from the same
# bits place every particle in the same slot (the rotating winner hash
# reads the position bits); what can part them is arithmetic and two
# threshold decisions: the violence gate, which picks window 1 or 3 (with
# the fresh-cell mask) for each substep from the count of occupied slots
# whose relative displacement passes ``(wide_threshold_cells * cell)^2``,
# and, in the resident loop, the drift rebin at ``(cell / 4)^2``. Both
# counts compare a per-slot ``rel2`` against the threshold after a mean
# displacement is taken off, and that mean is a sum whose order differs
# between devices and packages: a slot within a few float32 steps of the
# threshold can be counted on one side only.
#
# This package's replay of a step is the step's own code: the gated
# substeps of ``solver._Population.substeps`` and the rebin decision of
# ``solver._ResidentPop.step``, watched through their ``record`` hook
# (:class:`Recorder`). A replay explains nothing until it reproduces the
# step that ran (:func:`reproduces`: bit for bit on one device, within the
# pass tolerance between a captured graph and its eager replay).

GATE_ULPS = 8     # float32 steps of the threshold a gate's rel2 may lie
#                   from it and still be counted on one side only
ENVELOPE_NUDGES = 4     # seeded 1-ulp nudges of a substep's input that
#                         measure each slot's rounding envelope
ENVELOPE_FACTOR = 2.0   # a slot's same-input error may pass the pass
#                         tolerance by this many times its own envelope


class DenseFlip(Flip):
    """A flip of one of the dense engine's threshold decisions (the
    violence gate's trip before substep ``substep``, or the resident drift
    rebin): the slots (``particles``: slot indices) counted on one side
    only, the most float32 steps any of them lies from the threshold
    beyond what its inputs' difference explains (``ulps``), how far the
    substep that ran different windows parts (``part_px``; 0 where the
    decision did not part the step), and the counts of both sides against
    the limit."""

    def __init__(self, pop, substep, decision, slots, ulps, part_px, moved,
                 counts, limit):
        super().__init__(pop, substep, 0, slots, ulps, part_px, moved,
                         decision)
        self.counts, self.limit = counts, limit

    def describe(self) -> str:
        pops = ("white", "yolk")
        return (f"{pops[self.pop]} {self.decision} before substep "
                f"{self.substep}: slots {self.particles[:8]}"
                f"{' ...' if len(self.particles) > 8 else ''} within "
                f"{self.ulps} ulps of the threshold, counts {self.counts} "
                f"against {self.limit:.6g}, the step parts by "
                f"{self.part_px:.4g} px")


@dataclasses.dataclass
class GateRecord:
    """One evaluation of a count against a threshold: before substep
    ``substep`` (the gate's predicted trip decides substep 0 with the
    carried trip; the count after substep ``s`` decides ``s + 1``; the
    resident drift decides the step's rebin), the per-slot ``rel2`` (G, L)
    and displacement ``disp`` (2, G, L) the side computed, its mean, the
    count and the decision."""
    substep: int
    rel2: np.ndarray
    disp: np.ndarray
    mean: np.ndarray
    n_over: int
    trip: bool
    extra: Optional[np.ndarray] = None    # the drift's dropped particles
    #                                       (N,) squared drift, -1 if not


@dataclasses.dataclass
class SubstepRecord:
    """One substep of a replayed dense step: its window (``wide``), the
    slot-layout positions before and after, and the side-neutral state it
    started from (``(xy, prev)``, None at the step's first substep, whose
    input is the binning itself)."""
    substep: int
    wide: bool
    xy_in: np.ndarray
    xy_out: np.ndarray
    state_in: Optional[Tuple[np.ndarray, np.ndarray]]


@dataclasses.dataclass
class PopReplay:
    """One population's replayed dense step: the slot vector, occupancy,
    the gate's threshold and limit, every gate evaluation and substep, the
    episode state out, the merged particle arrays with ``in_grid``, and the
    layout the first substep started from (``start``, the side's own; None
    once the replay has left its process)."""
    pop: int
    slot: np.ndarray
    occ: np.ndarray
    thresh2: np.float32
    limit: np.float32
    gates: List[GateRecord]
    substeps: List[SubstepRecord]
    wide_out: Tuple[bool, int, int]
    out: Dict[str, np.ndarray]
    start: object = None


def _np(t) -> np.ndarray:
    """A host copy of tensor ``t`` (never a view of a CPU tensor's
    memory, which a later substep may write in place)."""
    return t.detach().to("cpu", copy=True).numpy()


def _f32(x) -> np.float32:
    return np.float32(x)


def gate_limit(tolerance: float, n_live: int) -> np.float32:
    """``tolerance * n_live`` as both packages form it: a float32 product
    the count is compared with."""
    return _f32(_f32(tolerance) * _f32(max(int(n_live), 1)))


def wide_host(wide_state) -> List[Tuple[bool, int, int]]:
    """Per population ``(trip, budget, calm)`` of an episode state (tensors
    or numpy), as Python values."""
    return [(bool(w[0]), int(w[1]), int(w[2])) for w in wide_state]


class Recorder:
    """The ``record`` hook of ``solver._gated_substeps`` (through
    ``solver._Population.substeps``, which adds the ``layout``) and of
    ``solver._ResidentPop.step``: the events of one population's step as
    records through ``side`` (a :class:`DensePortSide`): the rebin
    decision (``decision``), the gate evaluations (``gates``), each
    substep's window with its slot positions in and out and its
    side-neutral input state (``subs``), and a copy of the layout the first
    substep starts from (``start``)."""

    def __init__(self, side):
        self.side = side
        self.decision: Optional[GateRecord] = None
        self.gates: List[GateRecord] = []
        self.subs: List[SubstepRecord] = []
        self.start = None
        self._in = None

    def __call__(self, event: str, s: int, layout=None, **v) -> None:
        if event in ("gate", "rebin"):
            rec = GateRecord(s, _np(v["rel2"]), _np(v["disp"]),
                             _np(v["mean"]), int(v["n_over"]),
                             bool(v["trip"]),
                             _np(v["extra"]) if "extra" in v else None)
            if event == "rebin":
                self.decision = rec
            else:
                self.gates.append(rec)
        elif event == "substep":
            if s == 0:
                self.start = (layout[0], [t.clone() for t in layout[1]])
            self._in = (self.side.positions(layout),
                        None if s == 0 else self.side.state(layout),
                        bool(v["wide"]))
        elif event == "ran":
            xy_in, state_in, wide = self._in
            self.subs.append(SubstepRecord(s, wide, xy_in,
                                           self.side.positions(layout),
                                           state_in))
        else:
            raise ValueError(f"unknown step event {event!r}")


class DensePortSide:
    """This package's dense-engine pieces on ``device`` (kernels A and B on
    a card, their plain versions on the CPU), numpy in and out: each piece
    is a method of ``ops.solver._Population``, which the step runs, and
    :meth:`substeps` is the step's own gated substeps. A layout is the
    population's binned layout (a list of tensors, the fused ``[xy, prev,
    stat, follow]`` or the planes ``[planes, aux]``) with its
    ``_Population``; ``cfg2`` as in :class:`PortSide`."""

    def __init__(self, cfg2, options: solver_ops.SolverOptions, device,
                 step_delta: float = 1 / 60, relaxation: float = 1.0):
        if options.engine != "dense" or options.dense_rebin != "step":
            raise ValueError("the dense replay steps the dense engine with "
                             "dense_rebin='step' only")
        self.device = torch.device(device)
        self.options = options
        self._cfg = [population_config(
            type(cfg2)(**{f.name: getattr(cfg2, f.name).to(self.device)
                          for f in dataclasses.fields(cfg2)}), i)
            for i in range(2)]
        f32 = dict(dtype=torch.float32, device=self.device)
        self.sub_dt = torch.clamp(torch.tensor(step_delta, **f32)
                                  / options.n_substeps, min=EPS)
        self.relaxation = torch.tensor(relaxation, **f32)

    def _t(self, a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    def population(self, pop: int, before: Dict[str, np.ndarray]):
        """``solver._Population`` of ``pop`` from the host view ``before``
        (its live count, masses, batches and follow targets)."""
        opts = self.options
        cap_all = before["pos"].shape[1]
        cap = min((opts.pop_caps or (cap_all, cap_all))[pop], cap_all)
        act = torch.arange(cap, device=self.device) < int(before["count"][pop])
        slot = self._t(before["batch_slot"][pop, :cap])
        table = torch.cat([self._t(before["batch_target"]), torch.sqrt(
            torch.clamp(self._t(before["batch_radius"][pop]), min=0.0))[:, None]],
            dim=1)
        rows = solver_ops.take_batch_rows(table, slot)
        return solver_ops._Population(
            self._t(before["mass_t"][pop, :cap]), slot, act, self._cfg[pop],
            rows, self.sub_dt, self.relaxation, opts,
            opts.dense_grid_dim[pop], opts.dense_slots[pop])

    def bin(self, pop: int, before):
        """``(layout, slot)`` of ``pop`` binned from ``before``."""
        P = self.population(pop, before)
        cap = P.act.shape[0]
        grid, slot = P.bin(self._t(before["pos"][pop, :cap]),
                           self._t(before["vel"][pop, :cap]))
        return (P, grid), _np(slot)

    def gate_thresh2(self, layout) -> np.float32:
        return _f32(_np(solver_ops.wide_thresh2(self.options,
                                                layout[0].cell_size)))

    def occupancy(self, layout) -> np.ndarray:
        P, grid = layout
        return _np(P.occupancy(grid))

    def positions(self, layout) -> np.ndarray:
        P, grid = layout
        return _np(P.positions(grid))

    def substeps(self, layout, fb, wide_in):
        """One step's gated substeps, ``solver._Population.substeps`` itself
        on a copy of ``layout``, from the fallback ``fb`` = (pos, prev,
        vel) and the episode state ``wide_in`` (host values): ``(recorder,
        layout, fb, wide_out)``."""
        P, grid = layout
        work = [t.clone() for t in grid]
        rec = Recorder(self)
        ws = (torch.tensor(bool(wide_in[0]), device=self.device),
              torch.tensor(int(wide_in[1]), dtype=torch.int32,
                           device=self.device),
              torch.tensor(int(wide_in[2]), dtype=torch.int32,
                           device=self.device))
        fb, ws = P.substeps(work, tuple(map(self._t, fb)), ws, record=rec)
        return rec, (P, work), tuple(map(_np, fb)), wide_host([ws])[0]

    def run(self, layout, wide: bool, first: bool):
        """The layout after one substep at the window ``wide`` decides (a
        device flag, as the gate hands it to the kernel)."""
        P, grid = layout
        work = [t.clone() for t in grid]
        P.substep(work, torch.full((), bool(wide), dtype=torch.bool,
                                   device=self.device), first)
        return P, work

    def state(self, layout):
        """``(xy, prev)`` of the layout after a substep: the positions and
        the positions the substep started from."""
        P, grid = layout
        if P.fused:
            return _np(grid[0]), _np(grid[1])
        rp = dense_ops.ROW_PAD
        return (_np(P.positions(grid)),
                _np(grid[1][solver_ops.AUX_PX:solver_ops.AUX_PY + 1,
                            rp:rp + P.g]))

    def with_state(self, layout, xy, prev):
        """``layout`` holding the substep state ``(xy, prev)`` of another
        side (the velocity a plane layout stores is derived from it as its
        substeps derive it)."""
        P, grid = layout
        xy, prev = self._t(xy), self._t(prev)
        if P.fused:
            return P, [xy, prev, grid[2], grid[3]]
        planes, aux = grid[0].clone(), grid[1].clone()
        rp = dense_ops.ROW_PAD
        planes[:2, rp:rp + P.g] = xy
        dense_ops.refresh_halo_xy(planes)
        aux[solver_ops.AUX_PX:solver_ops.AUX_PY + 1, rp:rp + P.g] = prev
        aux[solver_ops.AUX_VX:solver_ops.AUX_VY + 1, rp:rp + P.g] = \
            (xy - prev) / P.sub_dt
        return P, [planes, aux]

    def with_positions(self, layout, xy):
        """``layout`` with its slot positions replaced by ``xy``."""
        P, grid = layout
        xy = self._t(xy)
        if P.fused:
            return P, [xy] + list(grid[1:])
        planes = grid[0].clone()
        rp = dense_ops.ROW_PAD
        planes[:2, rp:rp + P.g] = xy
        dense_ops.refresh_halo_xy(planes)
        return P, [planes, grid[1]]

    def finish(self, pop: int, layout, slot, fb, before):
        """The step's particle arrays of population ``pop``: the layout's
        extraction merged with the fallback ``fb``, the inactive rows kept,
        and ``in_grid`` (binned and live)."""
        P, grid = layout
        cap = P.act.shape[0]
        ext = P.extract(grid, self._t(slot))
        pos, vel = (self._t(before[f][pop, :cap]) for f in ("pos", "vel"))
        merged = P.keep_inactive(P.merge(ext, tuple(map(self._t, fb))),
                                 (pos, pos, vel))
        out = {f: _np(t) for f, t in zip(("pos", "prev", "vel"), merged)}
        out["in_grid"] = _np(ext[3] & P.act)
        return out


def replay_dense(side, before: Dict[str, np.ndarray], wide_in
                 ) -> List[PopReplay]:
    """The dense step of both populations from the host view ``before``
    and the episode state ``wide_in`` (per population ``(trip, budget,
    calm)``) through ``side``: its binning, its gated substeps (this
    package's: the step's own, :meth:`DensePortSide.substeps`) and its
    merge."""
    opts = side.options
    cap_all = before["pos"].shape[1]
    out = []
    for pop in range(2):
        cap = min((opts.pop_caps or (cap_all, cap_all))[pop], cap_all)
        n_live = int(before["count"][pop])
        layout, slot = side.bin(pop, before)
        pos, vel = before["pos"][pop, :cap], before["vel"][pop, :cap]
        rec, layout, fb, wide_out = side.substeps(layout, (pos, pos, vel),
                                                  wide_in[pop])
        out.append(PopReplay(
            pop, slot, side.occupancy(layout), side.gate_thresh2(layout),
            gate_limit(opts.wide_tolerance, n_live), rec.gates, rec.subs,
            wide_out, side.finish(pop, layout, slot, fb, before), rec.start))
    return out


def step_tol(pos_tol: float, sub_dt: float) -> Dict[str, float]:
    """Per field the tolerance of :func:`reproduces` for a position
    tolerance ``pos_tol``: the velocity ``(pos - prev) / sub_dt`` parts by
    twice that over ``sub_dt``."""
    return dict(pos=pos_tol, prev=pos_tol, vel=2.0 * pos_tol / sub_dt)


def reproduces(replays: List[PopReplay], after: Dict[str, np.ndarray],
               wide, tol: Optional[Dict[str, float]] = None,
               where: str = "") -> float:
    """Hold a side's replay (:func:`replay_dense`) to the step that ran on
    that side: per population its merged ``pos``, ``prev`` and ``vel`` (the
    rows of its cap) against the host view ``after`` of the step's result,
    bit for bit, or within ``tol`` (:func:`step_tol`), and its episode
    state equal to ``wide`` (per population ``(trip, budget, calm)``).
    Returns the largest position difference; raises :class:`Departure`."""
    worst = 0.0
    wide = wide_host(wide)
    for r in replays:
        name = f"{where}{('white', 'yolk')[r.pop]}"
        for f in ("pos", "prev", "vel"):
            got = r.out[f]
            want = after[f][r.pop, :got.shape[0]]
            d = float(np.abs(got.astype(np.float64) - want).max(initial=0.0))
            if f != "vel":
                worst = max(worst, d)
            ok = np.array_equal(got, want) if tol is None else d <= tol[f]
            if not ok:
                raise Departure(f"{name}: the replay does not reproduce the "
                                f"step that ran: {f} parts by {d:.4g}")
        if tuple(r.wide_out) != tuple(wide[r.pop]):
            raise Departure(f"{name}: the replay's episode state "
                            f"{tuple(r.wide_out)} is not the step's "
                            f"{tuple(wide[r.pop])}")
    return worst


def float_steps(a, b) -> np.ndarray:
    """Float32 steps between ``a`` and ``b`` (elementwise, finite, same
    sign): how many representable values lie between them."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def threshold_flip(ga: GateRecord, gb: GateRecord, thresh2, limit,
                   where: str, occ=None) -> Tuple[List[int], int]:
    """Hold one threshold decision that differs between two sides to the
    flip rule: the slots counted on one side only must each lie within
    :data:`GATE_ULPS` float32 steps of ``thresh2`` on the first side,
    beyond what the sides' relative displacements at that slot differ by
    (a rel2 moves by ``2 |d| |dd| + |dd|^2`` for a displacement change
    ``dd``); the counts without them must be equal, so those slots alone
    carry the count across ``limit``. Returns the slots and the most
    steps; raises :class:`Departure`."""
    ta, tb = ga.rel2 > thresh2, gb.rel2 > thresh2
    differ = np.nonzero((ta != tb).reshape(-1))[0]
    if ga.extra is not None:
        ea, eb = ga.extra > thresh2, gb.extra > thresh2
        if not np.array_equal(ga.extra < 0, gb.extra < 0):
            raise Departure(f"{where}: the fallback particles the count "
                            f"takes differ")
        dropped = np.nonzero(ea != eb)[0]
    else:
        ea = eb = np.zeros(0, bool)
        dropped = np.zeros(0, np.int64)
    if ga.n_over != int(ta.sum()) + int(ea.sum()) or \
            gb.n_over != int(tb.sum()) + int(eb.sum()):
        raise Departure(f"{where}: a count is not its slots' count")
    if differ.size + dropped.size == 0:
        raise Departure(f"{where}: the decisions differ with every slot "
                        f"counted alike")
    rel_a = (ga.disp - ga.mean[:, None, None]).reshape(2, -1)
    rel_b = (gb.disp - gb.mean[:, None, None]).reshape(2, -1)
    if occ is not None:
        o = np.minimum(occ, 1.0).reshape(-1)
        rel_a, rel_b = rel_a * o, rel_b * o
    dd = np.abs(rel_a - rel_b).max(0)[differ]
    r = np.sqrt(np.maximum(ga.rel2.reshape(-1)[differ], 0.0))
    explained = 2.0 * r * dd + dd * dd
    ra = ga.rel2.reshape(-1)[differ]
    ulp = float(np.spacing(np.float32(thresh2)))
    steps = np.maximum(np.abs(ra.astype(np.float64) - float(thresh2))
                       - explained, 0.0) / ulp
    if dropped.size:
        # a fallback particle's drift: both sides integrate it alike, so
        # hold its displacement to the pass tolerance
        ea_d = ga.extra[dropped].astype(np.float64)
        slack = 2.0 * np.sqrt(np.maximum(ea_d, 0.0)) * PASS_TOL + PASS_TOL ** 2
        steps = np.concatenate([steps, np.maximum(
            np.abs(ea_d - float(thresh2)) - slack, 0.0) / ulp])
    worst = int(np.ceil(steps.max()))
    if worst > GATE_ULPS:
        raise Departure(f"{where}: slots {differ[:8].tolist()} counted on "
                        f"one side only lie {worst} float32 steps from the "
                        f"threshold {float(thresh2):.6g} (more than "
                        f"{GATE_ULPS})")
    if (_f32(ga.n_over) > limit) == (_f32(gb.n_over) > limit):
        raise Departure(f"{where}: the decisions differ but the counts "
                        f"{ga.n_over}, {gb.n_over} do not straddle {limit}")
    return differ.tolist() + [-1 - int(p) for p in dropped], worst


@dataclasses.dataclass
class Amplified:
    """A substep that parted with the same window on both sides, and whose
    second side, run on the first side's input, agrees with the first
    side's output within the pass tolerance plus :data:`ENVELOPE_FACTOR`
    times the slot's own 1-ulp envelope at every slot: the same function,
    its rounding amplified by a packed scene. The two outputs part by
    ``part_px`` (inputs by ``part_in_px``), the same-input outputs by
    ``err_px``; the envelope reaches ``envelope_px``; ``ratio`` is the
    most any slot's error past the pass tolerance is of its envelope."""
    pop: int
    substep: int
    part_px: float
    part_in_px: float
    err_px: float
    envelope_px: float
    ratio: float
    decision: str = "rounding within the 1-ulp envelope"

    def describe(self) -> str:
        return (f"{('white', 'yolk')[self.pop]} substep {self.substep}: "
                f"parts by {self.part_px:.4g} px (input "
                f"{self.part_in_px:.4g}); on one input the sides part by "
                f"{self.err_px:.4g} px, at most {self.ratio:.3g} of a "
                f"slot's own 1-ulp envelope (up to {self.envelope_px:.4g} "
                f"px) past the pass tolerance")


def nudge(xy: np.ndarray, occ: np.ndarray, seed: int) -> np.ndarray:
    """``xy`` with every coordinate of an occupied slot moved one float32
    step up or down (seeded)."""
    rng = np.random.default_rng(seed)
    up = rng.random(xy.shape) < 0.5
    toward = np.where(up, np.float32(np.inf), np.float32(-np.inf))
    return np.where(occ, np.nextafter(xy.astype(np.float32),
                                      toward.astype(np.float32)), xy
                    ).astype(np.float32)


def envelope(side, layout, wide: bool, first: bool, base: np.ndarray,
             occ: np.ndarray) -> np.ndarray:
    """(G, L) rounding envelope of one substep of ``side`` at ``layout``:
    per slot, the most its own output ``base`` moves when the input
    positions move by one float32 step, over :data:`ENVELOPE_NUDGES`
    seeded nudges. Rounding inside a substep perturbs it as much as such a
    nudge does; a packed scene amplifies both."""
    moved = np.zeros(occ.shape, np.float32)
    xy = side.positions(layout)
    for seed in range(ENVELOPE_NUDGES):
        out = side.positions(side.run(side.with_positions(
            layout, nudge(xy, occ, seed)), wide, first))
        moved = np.maximum(moved, np.abs(out - base).max(0))
    return moved


def explain_dense(ref, other, before: Dict[str, np.ndarray], wide_in, ran,
                  replays=None) -> list:
    """Show that a dense step which parted (or whose episode state
    differs) is rounding or a flip of the violence gate (the section's
    rule), or raise :class:`Departure`: the findings, :class:`Amplified`
    and :class:`DenseFlip`. ``ref`` is the side whose counts the ulps are
    measured on; ``replays``, if given, are the two sides' replays already
    made (:func:`replay_dense`; the second side's with its ``start``).
    ``ran`` holds, per side, ``(after, wide, tol)``: the host view of the
    step that ran, its episode state and the tolerance each replay must
    reproduce them to (:func:`reproduces`)."""
    ra, rb = replays or (replay_dense(ref, before, wide_in),
                         replay_dense(other, before, wide_in))
    for rs, (after, wide, tol), where in zip((ra, rb), ran,
                                             ("first side ", "second side ")):
        reproduces(rs, after, wide, tol, where)
    found: list = []
    for a, b in zip(ra, rb):
        found += explain_pop(other, a, b)
    if not found:
        raise Departure("no substep of the replayed dense step parts and "
                        "every gate decision agrees")
    return found


def explain_pop(other, a: PopReplay, b: PopReplay) -> list:
    """The rule on one population's replays ``a`` (the first side) and
    ``b``: equal slot vectors, occupied slots, gate threshold and fallback
    set, the particles outside the layout within :data:`POS_TOL`; at each
    substep whose outputs part by more than its inputs did
    plus :func:`pass_tol`, the second side's substep, run on the first
    side's input (from ``b.start``, the second side's layout at the step's
    first substep) with the first side's window, agreeing with the first
    side's output at every slot within :func:`pass_tol` plus
    :data:`ENVELOPE_FACTOR` times that slot's :func:`envelope`; a window
    the gate chose differently, and any gate decision or episode state
    that differs, from a count :func:`threshold_flip` explains. Returns the
    findings; raises :class:`Departure`."""
    name = ("white", "yolk")[a.pop]
    if not np.array_equal(a.slot, b.slot):
        raise Departure(f"{name}: the slot vectors differ "
                        f"({int((a.slot != b.slot).sum())} particles)")
    if not np.array_equal(a.occ > 0, b.occ > 0):
        raise Departure(f"{name}: the occupied slots differ")
    if a.thresh2 != b.thresh2 or a.limit != b.limit:
        raise Departure(f"{name}: the gate's threshold {a.thresh2} / "
                        f"{b.thresh2} or limit {a.limit} / {b.limit} "
                        f"differs")
    if not np.array_equal(a.out["in_grid"], b.out["in_grid"]):
        raise Departure(f"{name}: the fallback set (in_grid) differs")
    rest = ~a.out["in_grid"]
    fb_part = float(np.abs(a.out["pos"][rest] - b.out["pos"][rest]).max(
        initial=0.0))
    if fb_part > POS_TOL:
        raise Departure(f"{name}: the particles outside the layout (the "
                        f"fallback's, integrated without pairs) part by "
                        f"{fb_part:.4g} px")
    occ = a.occ > 0
    found: list = []
    parted = None      # the first substep that parts with the windows the
    #                    gate chose differently
    for sa, sb in zip(a.substeps, b.substeps):
        part_in = float(np.abs(sa.xy_in - sb.xy_in)[:, occ].max(initial=0))
        part = float(np.abs(sa.xy_out - sb.xy_out)[:, occ].max(initial=0))
        tol = pass_tol(sa.xy_in[:, occ])
        if part <= part_in + tol:
            continue
        where = f"{name} substep {sa.substep}"
        first = sa.state_in is None
        layout = b.start
        if not first:
            layout = other.with_state(layout, *sa.state_in)
        same = other.positions(other.run(layout, sa.wide, first))
        err = np.abs(same - sa.xy_out).max(0)
        env = np.zeros_like(err)
        if (err[occ] > tol).any():
            env = envelope(other, layout, sa.wide, first, same, occ)
        past = occ & (err > tol + ENVELOPE_FACTOR * env)
        if past.any():
            raise Departure(
                f"at {where} the second side's substep on the first side's "
                f"input parts by {float(err[past].max()):.4g} px, past the "
                f"pass tolerance and {ENVELOPE_FACTOR:g} times the slot's "
                f"1-ulp envelope at {int(past.sum())} slots: the substep "
                f"itself differs")
        if sa.wide != sb.wide:
            if parted is None:
                parted = (sa.substep, part)
            continue
        over = occ & (err > tol)
        ratio = float(((err - tol)[over] / env[over]).max(initial=0.0))
        found.append(Amplified(a.pop, sa.substep, part, part_in,
                               float(err[occ].max()),
                               float(env[occ].max()), ratio))
    gi = next((i for i, (ga, gb) in enumerate(zip(a.gates, b.gates))
               if ga.trip != gb.trip), None)
    if gi is None:
        if parted is not None:
            raise Departure(f"{name}: the windows differ with every gate "
                            f"decision equal")
        if a.wide_out != b.wide_out:
            raise Departure(f"{name}: the episode states {a.wide_out} / "
                            f"{b.wide_out} differ with every gate decision "
                            f"equal")
        return found
    ga, gb = a.gates[gi], b.gates[gi]
    if parted is not None and parted[0] < ga.substep:
        raise Departure(f"{name}: substep {parted[0]} parts before the "
                        f"first gate decision that differs")
    slots, worst = threshold_flip(
        ga, gb, a.thresh2, a.limit,
        f"{name} violence gate before substep {ga.substep}", a.occ)
    moved = np.nonzero(a.out["in_grid"] & (np.abs(
        a.out["pos"] - b.out["pos"]) > PASS_TOL).any(1))[0]
    found.append(DenseFlip(a.pop, ga.substep, "violence gate", slots, worst,
                           parted[1] if parted else 0.0, moved.tolist(),
                           (ga.n_over, gb.n_over), float(a.limit)))
    return found


def drift_flip(pop: int, step: int, da: GateRecord, db: GateRecord,
               thresh2, limit) -> DenseFlip:
    """A resident drift rebin taken on one side only (decisions ``da``,
    ``db`` against ``(cell / 4)^2`` and ``rebin_tolerance * n_live``) held
    to :func:`threshold_flip`; raises :class:`Departure`."""
    slots, worst = threshold_flip(
        da, db, thresh2, limit,
        f"{('white', 'yolk')[pop]} drift rebin of resident step {step}")
    return DenseFlip(pop, step, "drift rebin", slots, worst, 0.0, [],
                     (da.n_over, db.n_over), float(limit))


# -------------------------------------------- the resident loop, step-locked --

def resident_carry(rs) -> List[Dict[str, object]]:
    """What a step of ``solver.ResidentSteps`` ``rs`` reads, per population,
    on the host: the binned layout ``grid``, ``slot``, the fallback ``fb``,
    the episode state ``ws``, the drift references ``ref_p`` and
    ``ref_xy``, and the slot positions ``xy``."""
    out = []
    for r in rs.pops:
        host = lambda ts: [_np(t) for t in ts]    # noqa: E731
        out.append(dict(grid=host(r.grid), slot=_np(r.slot),
                        fb=host(r.fb), ws=host(r.ws),
                        ref_p=_np(r.ref_p),
                        ref_xy=_np(r.ref_xy),
                        xy=_np(r.pop.positions(r.grid))))
    return out


def load_resident_carry(rs, carry) -> None:
    """``rs``'s buffers take ``carry`` (:func:`resident_carry`)."""
    for r, c in zip(rs.pops, carry):
        dev = r.slot.device
        dsts = list(r.grid) + [r.slot] + list(r.fb) + list(r.ws) + \
            [r.ref_p, r.ref_xy]
        srcs = c["grid"] + [c["slot"]] + c["fb"] + c["ws"] + \
            [c["ref_p"], c["ref_xy"]]
        for d, s in zip(dsts, srcs):
            d.copy_(torch.as_tensor(np.array(s)).to(dev))


@dataclasses.dataclass
class ResidentStep:
    """One resident step of ``solver.ResidentSteps`` run from a carry with
    its recorders: per population the rebin decision and the step's
    :class:`PopReplay` (the substeps from the decision's layout), and the
    carry after."""
    decisions: List[GateRecord]
    replays: List[PopReplay]
    after: List[Dict[str, object]]


def resident_step(side, rs, carry, check: bool = True) -> ResidentStep:
    """One step of the resident loop ``rs`` (its own code,
    ``ResidentSteps.step``) from ``carry``, recorded through ``side``."""
    load_resident_carry(rs, carry)
    recs = [Recorder(side) for _ in rs.pops]
    rs.step(check=check, record=lambda i: recs[i])
    decisions, replays = [], []
    for r, rec in zip(rs.pops, recs):
        P = r.pop
        n_live = int(torch.sum(P.act))
        merged = r.merged()
        in_grid = P.extract(r.grid, r.slot)[3] & P.act
        replays.append(PopReplay(
            r.i, _np(r.slot), _np(P.occupancy(r.grid)),
            side.gate_thresh2((P, r.grid)),
            gate_limit(P.options.wide_tolerance, n_live), rec.gates,
            rec.subs, wide_host([r.ws])[0],
            dict(pos=_np(merged[0]), in_grid=_np(in_grid)), rec.start))
        decisions.append(rec.decision)
    return ResidentStep(decisions, replays, resident_carry(rs))


def carry_parts(a, b) -> Tuple[bool, Dict[str, float]]:
    """Two carries of one population (:func:`resident_carry`): whether the
    slot vectors and episode states are equal, and per field the largest
    difference: ``pos`` the slot and fallback positions, ``prev`` and
    ``vel`` the fallback's."""
    same = (np.array_equal(a["slot"], b["slot"])
            and wide_host([a["ws"]]) == wide_host([b["ws"]]))

    def part(x, y):
        return float(np.abs(x.astype(np.float64) - y).max(initial=0.0))

    return same, dict(pos=max(part(a["xy"], b["xy"]),
                              part(a["fb"][0], b["fb"][0])),
                      prev=part(a["fb"][1], b["fb"][1]),
                      vel=part(a["fb"][2], b["fb"][2]))


def hold_resident_step(ref, ref_rs, other, other_rs, carry, other_after,
                       other_taken, step: int = 0,
                       tol: Optional[Dict[str, float]] = None) -> tuple:
    """One resident step held across two sides: the other side's loop (a
    captured graph, say) stepped from ``carry`` to ``other_after`` with
    rebins ``other_taken`` (per population). Both sides' ``ResidentSteps``
    (``ref_rs``, ``other_rs``, and their :class:`DensePortSide` ``ref``,
    ``other``) run the step from ``carry`` with their recorders
    (:func:`resident_step`). The other side's run must reproduce
    ``other_after`` and its rebins, bit for bit or within ``tol``
    (:func:`step_tol`). Per population: the rebins equal, or a drift flip
    (:func:`drift_flip`); then the slot vector bit for bit, the slot
    positions and the fallback at :data:`POS_TOL` / :data:`VEL_TOL` and the
    episode state equal, or the substeps held by :func:`explain_pop`.
    Returns ``(findings, ref_taken, errors, reproduced)``, ``reproduced``
    the largest position difference of the other side's run from
    ``other_after``; raises :class:`Departure`."""
    ra = resident_step(ref, ref_rs, carry)
    rb = resident_step(other, other_rs, carry)
    taken = [bool(d.trip) for d in ra.decisions]
    found, errs, reproduced = [], [], 0.0
    for i in range(2):
        name = f"{('white', 'yolk')[i]}: resident step {step}"
        same, d = carry_parts(rb.after[i], other_after[i])
        reproduced = max(reproduced, d["pos"], d["prev"])
        ok = same and (all(v == 0.0 for v in d.values()) if tol is None
                       else all(d[f] <= tol[f] for f in d))
        if bool(rb.decisions[i].trip) != bool(other_taken[i]) or not ok:
            raise Departure(f"{name}: the replay does not reproduce the "
                            f"loop's step (rebin {rb.decisions[i].trip} / "
                            f"{bool(other_taken[i])}, slots and episode "
                            f"state equal: {same}, parts by {d})")
        da, db = ra.decisions[i], rb.decisions[i]
        if da.trip != db.trip:
            r = ref_rs.pops[i]
            found.append(drift_flip(
                i, step, da, db, _f32(_np(r.thresh2)),
                gate_limit(r.pop.options.rebin_tolerance,
                           int(torch.sum(r.pop.act)))))
            continue
        a, b = ra.after[i], rb.after[i]
        if not np.array_equal(a["slot"], b["slot"]):
            raise Departure(f"{name}: the slot vectors differ")
        live = _np(ref_rs.pops[i].pop.act)
        pos = max(float(np.abs(a["xy"] - b["xy"]).max(initial=0)),
                  float(np.abs(a["fb"][0] - b["fb"][0])[live].max(initial=0)))
        vel = float(np.abs(a["fb"][2] - b["fb"][2])[live].max(initial=0))
        errs.append(dict(pos=pos, vel=vel))
        if pos <= POS_TOL and vel <= VEL_TOL and \
                wide_host([a["ws"]]) == wide_host([b["ws"]]):
            continue
        held = explain_pop(other, ra.replays[i], rb.replays[i])
        found += held
        if not held:
            raise Departure(f"{name} parts by {pos:.4g} px with every "
                            f"decision equal and no substep parting")
    return found, taken, errs, reproduced
