"""What decides ``correct``: the program's outputs in the window against
the reference's, number by number, each against its limit.

The reference follows the program step by step (``reference/model.py``
says why): from the moving state the program held before a checked unit,
it does the unit's work and hands back what the unit should have produced.
A checked unit is a frame (``update`` then ``draw``) or a ``run_steps``
call, drawn from the seed among the window's units by reservoir sampling,
and in a frames cell one settling ``update`` besides. The spawn, where the
step-by-step following starts, is checked by itself, exactly.

The numbers, each the worst over the checked units:
- ``spawn_gap``: the program's state after ``add_many`` against the
  reference's spawn, every spawn field (exact);
- ``pos_gap_px`` / ``vel_gap_px_s``: the live particles' positions and
  velocities after the unit;
- ``stats_gap_px``: the step's centroid, last centroid and box;
- ``batch_gap_px``: each batch's centroid (the mean of its live particles
  of both populations);
- ``reach_gap_px``: how far each batch reaches, the largest distance of a
  live particle of each population from its batch's centroid;
- ``move_gap``: how far the particles moved in the unit, the root mean
  square of each live particle's move, per population, as a share of the
  reference's (a state left unchanged reads 1);
- ``frame_gap``: the frame ``draw`` returned, every channel, against the
  reference's render of the program's state after the update (frames);
- ``rebin_gap``: the resident loop's rebins in the call, per population,
  against the reference's (headless).

Every number is worked out in every run; the cell's limits file names
those that decide ``correct``, and only those are reported.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .reference import control as control_mod
from .reference.model import Reference
from .roofline import tally as tally_mod
from .system import DYNAMIC, STATS


class Reservoir:
    """A sample of ``m`` units drawn uniformly from however many come, by
    the seed (reservoir sampling): ``offer(i)`` says before unit ``i`` runs
    whether it is to be held and in which place."""

    def __init__(self, m: int, rng: np.random.Generator):
        self.m, self.rng, self.seen = m, rng, 0
        self.held = {}

    def offer(self):
        i, self.seen = self.seen, self.seen + 1
        if i < self.m:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.m else None

    def keep(self, place: int, item: dict) -> None:
        self.held[place] = item

    def items(self) -> list:
        return [self.held[k] for k in sorted(self.held)]


def _gap(a, b) -> float:
    """The largest absolute difference; a non-finite one reads as inf."""
    d = (a.to(torch.float64) - b.to(torch.float64).to(a.device)).abs()
    if d.numel() == 0:
        return 0.0
    m = float(torch.nan_to_num(d, nan=math.inf).max())
    return m


def _batch_means(pos, slot, count, batches: int):
    """(batches, 2) float64 centroid of each batch's live particles of both
    populations."""
    sums = torch.zeros((batches, 2), dtype=torch.float64, device=pos.device)
    cnt = torch.zeros((batches,), dtype=torch.float64, device=pos.device)
    for i in range(2):
        n = int(count[i])
        s = slot[i, :n].to(pos.device).long()
        sums.index_add_(0, s, pos[i, :n].to(torch.float64))
        cnt += torch.bincount(s, minlength=batches).to(torch.float64)
    return sums / cnt.clamp(min=1.0)[:, None]


def _batch_reach(pos, slot, count, means):
    """(2, batches) float64: the largest distance of a live particle of
    each population from its batch's centroid ``means``."""
    out = []
    for i in range(2):
        n = int(count[i])
        s = slot[i, :n].to(pos.device).long()
        d = torch.linalg.vector_norm(
            pos[i, :n].to(torch.float64) - means[s], dim=1)
        out.append(torch.zeros((means.shape[0],), dtype=torch.float64,
                               device=pos.device).scatter_reduce(
            0, s, d, "amax", include_self=True))
    return torch.stack(out)


def _rms_move(before, after, pop: int, count) -> float:
    """Root mean square of the live particles' moves of population
    ``pop``, in float64."""
    n = int(count[pop])
    d = (after[pop, :n].to(torch.float64)
         - before[pop, :n].to(torch.float64).to(after.device))
    return float(torch.sqrt(torch.mean(torch.sum(d * d, dim=1))))


def _live(t, count, caps):
    """The live rows of a (2, N, ...) field, both populations joined."""
    return torch.cat([t[i, :int(count[i])] for i in range(2)])


STAND_INS = ("control", "witness", "unchanged")


class Checker:
    """The reference of one run and the numbers it reads. With
    ``stand_in`` something else takes the program's place and the same
    numbers are read between its outputs and the reference's, from the same
    held inputs: ``control`` and ``witness`` (``reference/control.py``),
    or ``unchanged``, a step that hands back the state it was given."""

    def __init__(self, cell_cfg: dict, specs: list, device, limits: dict,
                 stand_in: str = None):
        if stand_in is not None and stand_in not in STAND_INS:
            raise ValueError(f"stand_in must be one of {STAND_INS}")
        self.ref = Reference(cell_cfg, specs, device)
        self.stand_in = stand_in
        self.limits = limits
        self.batches = len(specs)
        self.numbers = {}
        self.failed_units = 0
        self.bounds = {}        # unit -> {kernel: bound seconds}
        self.passes = {}        # window -> collision passes, checked units
        self.seconds = 0.0

    def _note(self, found: dict) -> None:
        bad = False
        for k, v in found.items():
            v = math.inf if math.isnan(v) else v     # NaN fails, as inf
            self.numbers[k] = max(self.numbers.get(k, 0.0), v)
            bad |= k in self.limits and not v <= self.limits[k]
        self.failed_units += int(bad)

    def spawn(self, program: dict) -> None:
        want = self.ref.spawned
        if self.stand_in == "control":
            program = {k: torch.from_numpy(v) for k, v in want.items()}
            program["pos"] = control_mod.bf16(program["pos"])
        gap = max(float(np.max(np.abs(
            program[k].cpu().numpy().astype(np.float64)
            - want[k].astype(np.float64)))) for k in want)
        self._note({"spawn_gap": gap})

    def _state_gaps(self, before: dict, after: dict, stats: dict, ref_state,
                    ref_stats):
        count = self.ref.counts
        caps = self.ref.options.pop_caps
        out = {}
        for name, f in (("pos_gap_px", "pos"), ("vel_gap_px_s", "vel")):
            out[name] = _gap(_live(after[f], count, caps),
                             _live(getattr(ref_state, f), count, caps))
        out["stats_gap_px"] = max(_gap(stats[f], getattr(ref_stats, f))
                                  for f in stats)
        slot = torch.from_numpy(self.ref.spawned["batch_slot"])
        got_m = _batch_means(after["pos"], slot, count, self.batches)
        want_m = _batch_means(ref_state.pos, slot, count, self.batches)
        out["batch_gap_px"] = _gap(got_m, want_m)
        out["reach_gap_px"] = _gap(
            _batch_reach(after["pos"], slot, count, got_m),
            _batch_reach(ref_state.pos, slot, count, want_m))
        out["move_gap"] = max(
            abs(_rms_move(before["pos"], after["pos"], i, count)
                / max(_rms_move(before["pos"], ref_state.pos, i, count),
                      1e-30) - 1.0)
            for i in range(2))
        return out

    def _stand_in(self, fn, *args):
        """``fn(*args)`` as the stand-in computes it."""
        ctx = (control_mod.lowered() if self.stand_in == "control"
               else control_mod.reordered())
        with ctx:
            return fn(*args)

    def _replaced(self, item: dict, run):
        """The unit's (after, stats) as the stand-in gives them, or the
        program's where no stand-in computes: ``run`` is the reference's
        call for the unit, returning (state, stats, ...)."""
        after, stats = item["after"], item["stats"]
        if self.stand_in == "unchanged":
            after = item["before"]
        elif self.stand_in is not None:
            out = run()
            after = {f: getattr(out[0], f) for f in DYNAMIC}
            stats = {f: getattr(out[1], f) for f in STATS}
            return after, stats, out
        return after, stats, None

    def frame(self, item: dict, viewport) -> None:
        """One checked ``update`` (and ``draw`` where the item holds its
        frame): ``item`` holds ``before``/``after`` (moving fields),
        ``wide``, ``stats``, ``targets``, ``steps``, ``alpha``,
        ``step_delta``, ``unit`` and, for a drawn frame, ``frame``."""
        t0 = time.perf_counter()
        sink, drawn = {}, {}
        args = (item["before"], item["wide"], item["targets"],
                item["step_delta"], item["steps"])
        after, stats, _ = self._replaced(
            item, lambda: self._stand_in(self.ref.step, *args))
        with tally_mod.tally(sink):
            st, stt, _ = self.ref.step(*args)
        found = self._state_gaps(item["before"], after, stats, st, stt)
        if "frame" in item:
            dargs = (item["before"], item["after"], viewport, item["alpha"])
            with tally_mod.tally(drawn):
                want = self.ref.draw(*dargs)
            got = item["frame"]
            if self.stand_in in ("control", "witness"):
                got = self._stand_in(self.ref.draw, *dargs)
            found["frame_gap"] = _gap(got, want)
            # the step's bounds (``update``) beside the render's (``draw``)
            self.bounds[item["unit"]] = {**sink, **drawn}
        self._note(found)
        self.seconds += time.perf_counter() - t0

    def call(self, item: dict) -> None:
        """One checked ``run_steps`` call: ``item`` as for :meth:`frame`,
        with ``n_steps`` and the program's ``rebins`` in the call."""
        t0 = time.perf_counter()
        sink = {}
        args = (item["before"], item["wide"], item["targets"],
                item["n_steps"], item["step_delta"])
        after, stats, out = self._replaced(
            item, lambda: self._stand_in(self.ref.run_steps, *args))
        got_rebins = item["rebins"]
        if out is not None:
            got_rebins = out[3]
        elif self.stand_in == "unchanged":
            got_rebins = [0, 0]
        with tally_mod.tally(sink):
            st, stt, _, rebins = self.ref.run_steps(*args)
        self.bounds[item["unit"]] = dict(sink)
        for w in (1, 3):
            n = sink.get(f"passes.w{w}", 0)
            self.passes[w] = self.passes.get(w, 0) + n
        found = self._state_gaps(item["before"], after, stats, st, stt)
        found["rebin_gap"] = float(max(abs(int(a) - int(b)) for a, b in
                                       zip(got_rebins, rebins)))
        self._note(found)
        self.seconds += time.perf_counter() - t0

    @property
    def correct(self) -> bool:
        return all(self.numbers.get(k, 0.0) <= v
                   for k, v in self.limits.items())

    def report(self) -> dict:
        """Each number that decides ``correct`` with its limit, in the
        limits' order."""
        return {k: {"value": _finite(self.numbers.get(k, 0.0)),
                    "limit": self.limits[k]} for k in self.limits}


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e30
