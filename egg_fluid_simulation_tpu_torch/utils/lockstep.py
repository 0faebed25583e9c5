"""Step-locked comparison of two runs of the gather step, and the flip rule.

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
from ..ops import solver as solver_ops
from ..ops.kernels import gather_kernel
from .mathx import EPS

__all__ = ["POS_TOL", "VEL_TOL", "PASS_TOL", "FLIP_ULPS", "HOST_FIELDS",
           "Departure",
           "Flip", "PassRecord", "PortSide", "live_errors", "replay", "pass_tol",
           "cell_ulps", "explain"]

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
