"""The dense rule of ``egg_fluid_simulation_tpu_torch.utils.lockstep`` with
both sides the port's, and the plain kernel B's occupied-slot sums.

- ``substep_pass_plain`` sums pairs at the occupied slots only; its
  output is bit for bit that of the whole-grid sums (``_grid_sums``, the
  plain pass before it skipped the empty slots), on the ragged grids of
  ``chip_smoke.sweep_shape_case`` (about 60% occupied) and on a sparse one;
- ``threshold_flip``: a slot within a few float32 steps of the threshold
  explains a decision counted on one side only; a slot far from it, counts
  that do not straddle the limit, or no slot that differs raise
  ``Departure``;
- ``explain_dense`` between the port's fused step and the same step
  rounded one float32 step apart at each substep: a packed spawn amplifies
  that past the pass tolerance, which twice each slot's own 1-ulp envelope
  explains; a side whose substep is off by 2e-3 px at every slot or by
  5e-4 px at three slots, or whose gate threshold is 0.49 cells instead of
  0.5, raises ``Departure``, and so do two sides that agree, and a replay
  that does not reproduce the step that ran;
- ``hold_resident_step``: two CPU resident loops from one carry agree;
  a rebin or a carry the other side's run does not reproduce raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from egg_fluid_simulation_tpu_torch.interop import state_from_numpy
from egg_fluid_simulation_tpu_torch.ops import solver as S
from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK
from egg_fluid_simulation_tpu_torch.utils import lockstep as L
from test_torch_step import _configs, lattice_state

PACKED = dict(engine="dense", budget_mode="off", dense_rebin="step",
              dense_grid_dim=64, dense_slots=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --------------------------------------------- kernel B's plain version --

def _grid_sums(fields, k: int, w: int, cohesion: bool, consts):
    """The plain pass's pair sums as the whole grid gives them: each
    partner field rolled over every slot, in the kernel's offset order."""
    g, lanes = fields[0].shape
    lane = torch.arange(lanes)
    tx = torch.zeros_like(fields[0])
    ty = torch.zeros_like(fields[1])
    rolled_d = None
    for d, dy in SK._offsets(k, w):
        if rolled_d != d:
            rolled_d = d
            rolled = [torch.roll(f, d, dims=1) if d else f for f in fields]
            lane_ok = SK._lane_ok(lane, k, d, w)[None, :]
        o = [torch.roll(f, -dy, dims=0) if dy else f for f in rolled]
        ax, ay = SK._pair_term(fields, o, lane_ok, d, dy, cohesion, consts)
        tx = tx - ax
        ty = ty - ay
    return tx, ty


def _sparse_case(g=48, k=4, seed=3):
    """A grid about 8% occupied in two clumps (rows 5-12 and 30-33)."""
    c = chip_smoke.sweep_shape_case(g, k, seed)
    keep = np.zeros((g, g * k), bool)
    keep[5:13, 20:90] = True
    keep[30:34, 100:160] = True
    for name in ("xy", "stat", "prev", "follow"):
        c[name] = np.where(keep, c[name], 0.0).astype(np.float32)
    return c


@pytest.mark.parametrize("integrate", [False, True], ids=["pass", "integrate"])
@pytest.mark.parametrize("window", [1, 3], ids=["w1", "w3_fresh"])
@pytest.mark.parametrize("case", [(20, 3, 0.0), (24, 1, 24.5), (40, 8, 0.0),
                                  "sparse"], ids=str)
def test_plain_substep_pass_occupied_sums_bit_for_bit(case, window,
                                                      integrate, monkeypatch):
    c = _sparse_case() if case == "sparse" else \
        chip_smoke.sweep_shape_case(case[0], case[1], 7, case[2])
    k = 4 if case == "sparse" else case[1]
    t = {n: torch.from_numpy(v) for n, v in c.items()}
    kw = dict(cohesion=True, window=window, fresh_mask=window == 3)
    if integrate:
        kw.update(prev=t["prev"], follow=t["follow"], integrate=True)
    got = SK.substep_pass_plain(t["xy"], t["stat"], t["params"], t["aux"], k,
                                **kw)
    monkeypatch.setattr(SK, "_occupied_sums", _grid_sums)
    want = SK.substep_pass_plain(t["xy"], t["stat"], t["params"], t["aux"],
                                 k, **kw)
    for a, b in zip(got if integrate else (got,),
                    want if integrate else (want,)):
        assert torch.equal(a, b)
    out = got[0] if integrate else got
    assert float((out - t["xy"]).abs().max()) > 0.1    # pairs were summed


# ------------------------------------------------------- threshold_flip --

def _record(rel2, n_over=None, thresh2=None):
    rel2 = np.asarray(rel2, np.float32).reshape(1, -1)
    if n_over is None:
        n_over = int((rel2 > thresh2).sum())
    z = np.zeros((2,) + rel2.shape, np.float32)
    return L.GateRecord(0, rel2, z, np.zeros(2, np.float32), n_over,
                        False)


def test_threshold_flip_names_a_slot_at_the_threshold():
    th = np.float32(16.0)
    up = np.nextafter(th, np.float32(np.inf))
    a = _record([1.0, up, 20.0, 30.0], thresh2=th)       # 3 over
    b = _record([1.0, th, 20.0, 30.0], thresh2=th)       # 2 over
    slots, ulps = L.threshold_flip(a, b, th, np.float32(2.5), "test")
    assert slots == [1] and ulps <= L.GATE_ULPS


def test_threshold_flip_refuses_what_rounding_does_not_explain():
    th, limit = np.float32(16.0), np.float32(2.5)
    with pytest.raises(L.Departure, match="float32 steps"):
        L.threshold_flip(_record([1.0, 17.0, 20.0, 30.0], thresh2=th),
                         _record([1.0, 15.0, 20.0, 30.0], thresh2=th),
                         th, limit, "far")
    up = np.nextafter(th, np.float32(np.inf))
    with pytest.raises(L.Departure, match="straddle"):
        L.threshold_flip(_record([1.0, up, 20.0, 30.0], thresh2=th),
                         _record([1.0, th, 20.0, 30.0], thresh2=th),
                         th, np.float32(0.5), "limit")
    with pytest.raises(L.Departure, match="counted alike"):
        L.threshold_flip(_record([1.0, 20.0], thresh2=th),
                         _record([1.0, 20.0], thresh2=th), th, limit, "same")
    with pytest.raises(L.Departure, match="not its slots"):
        L.threshold_flip(_record([1.0, up], n_over=2), _record([1.0, th],
                                                                n_over=0),
                         th, limit, "count")


# --------------------------------------------------------- explain_dense --

def packed_state(factor=0.5):
    """``tests/test_torch_step.py``'s lattice at ``factor`` of its spacing
    (a spawn), its follow pull on: at a half, a pass barely amplifies an
    ulp; at a quarter (16 times the density), a substep carries one float32
    step of its input to ~1e-3 px."""
    d = lattice_state()
    for pop in (0, 1):
        n = int(d["count"][pop])
        c = d["pos"][pop, :n].mean(0)
        p = (c + factor * (d["pos"][pop, :n] - c)).astype(np.float32)
        for f in ("pos", "prev", "last_pos"):
            d[f][pop, :n] = p
    return d


def _wrap_substep(side, P, after=None, before=None):
    """``P.substep`` (the step's and ``side.run``'s) with ``before(grid)``
    run on its layout first, and ``after(grid)`` on its result."""
    real = P.substep

    def substep(grid, wide, first):
        if before is not None:
            before(grid)
        real(grid, wide, first)
        if after is not None:
            after(grid)

    P.substep = substep
    return P


class NoisySide(L.DensePortSide):
    """A side whose substep starts from its input positions rounded one
    float32 step up or down (seeded by the substep's count): rounding at
    the start of each substep, which the substep then carries as far as
    the scene amplifies it."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = 0

    def population(self, pop, before):
        P = super().population(pop, before)

        def nudge(grid):
            self.calls += 1
            occ = self.occupancy((P, grid)) > 0
            xy = L.nudge(self.positions((P, grid)), occ, 100 + self.calls)
            grid[:] = self.with_positions((P, grid), xy)[1]

        return _wrap_substep(self, P, before=nudge)


class OffSide(L.DensePortSide):
    """A side whose substep moves the occupied slots ``slots`` (all, if
    None) by ``by`` px."""

    def __init__(self, *a, by=2e-3, slots=None, **kw):
        super().__init__(*a, **kw)
        self.by, self.slots = by, slots

    def population(self, pop, before):
        P = super().population(pop, before)

        def off(grid):
            occ = self.occupancy((P, grid)) > 0
            if self.slots is not None:
                pick = np.zeros(occ.size, bool)
                pick[np.flatnonzero(occ)[self.slots]] = True
                occ = pick.reshape(occ.shape)
            xy = self.positions((P, grid))
            grid[:] = self.with_positions(
                (P, grid), np.where(occ, xy + np.float32(self.by), xy))[1]

        return _wrap_substep(self, P, after=off)


def NarrowGateSide(cfg2, options, device):
    """A side whose gate counts at 0.49 cells."""
    return L.DensePortSide(cfg2, dataclasses.replace(
        options, wide_threshold_cells=0.49), device)


def _sides(cls, options, **kw):
    _, cfg2 = _configs()
    return L.DensePortSide(cfg2, options, "cpu"), cls(cfg2, options, "cpu",
                                                      **kw)


def _wide_in(options):
    return L.wide_host([S.wide_state_init(options)] * 2)


def _ran(replays, d):
    """What a synthetic side's step gave: its replay, as the host view of
    the state after (the rows past a population's cap kept) and its
    episode state."""
    after = {f: d[f].copy() for f in ("pos", "prev", "vel")}
    for r in replays:
        for f in after:
            after[f][r.pop, :r.out[f].shape[0]] = r.out[f]
    return after, [r.wide_out for r in replays], None


def _explain(first, second, d, options):
    """``explain_dense`` of two sides' replays, each side's own step what
    ran."""
    ra = L.replay_dense(first, d, _wide_in(options))
    rb = L.replay_dense(second, d, _wide_in(options))
    return ra, rb, L.explain_dense(first, second, d, _wide_in(options),
                                   (_ran(ra, d), _ran(rb, d)),
                                   replays=(ra, rb))


def test_explain_dense_names_rounding_amplified_by_a_spawn():
    """Rounding one float32 step apart at each substep: a packed spawn
    parts the two sides past the pass tolerance, and every parting substep
    of the second side, run on the first side's input, agrees with it
    within the pass tolerance plus twice each slot's own 1-ulp envelope
    (past the tolerance alone, at a quarter of the lattice spacing), the
    windows alike."""
    options = S.SolverOptions(**PACKED)
    exact, noisy = _sides(NoisySide, options)
    d = packed_state(0.25)
    ra, rb, found = _explain(noisy, exact, d, options)
    part = max(float(np.abs(a.out["pos"] - b.out["pos"]).max())
               for a, b in zip(ra, rb))
    assert part > L.PASS_TOL
    assert found and all(isinstance(f, L.Amplified) for f in found)
    assert max(f.err_px for f in found) > L.PASS_TOL
    assert max(f.ratio for f in found) <= L.ENVELOPE_FACTOR
    # the spawn trips the gate after the step's last substep, both sides
    assert ra[0].gates[-1].trip and rb[0].gates[-1].trip


@pytest.mark.parametrize("cls,kw,match", [
    (OffSide, {}, "substep itself differs"),
    (OffSide, dict(by=5e-4, slots=[3, 17, 41]), "substep itself differs"),
    (NarrowGateSide, {}, "threshold")], ids=["every_slot", "three_slots",
                                             "narrow_gate"])
def test_explain_dense_refuses_a_fault(cls, kw, match):
    """A substep off by 2e-3 px at every slot, one off by 5e-4 px at three
    slots only, and a gate at 0.49 cells, each against the step it
    differs from on the packed spawn."""
    options = S.SolverOptions(**PACKED)
    good, bad = _sides(cls, options, **kw)
    with pytest.raises(L.Departure, match=match):
        _explain(good, bad, packed_state(), options)


def test_explain_dense_refuses_equal_sides():
    options = S.SolverOptions(**PACKED)
    a, b = _sides(L.DensePortSide, options)
    with pytest.raises(L.Departure, match="no substep"):
        _explain(a, b, packed_state(), options)


def test_explain_dense_holds_each_replay_to_its_step():
    """A replay that does not reproduce the step that ran explains
    nothing: one float32 step of one position, or another episode state,
    of the step that ran raises."""
    options = S.SolverOptions(**PACKED)
    exact, noisy = _sides(NoisySide, options)
    d = packed_state(0.25)
    ra = L.replay_dense(noisy, d, _wide_in(options))
    rb = L.replay_dense(exact, d, _wide_in(options))
    after, wide, _ = _ran(rb, d)
    moved = {f: a.copy() for f, a in after.items()}
    moved["pos"][1, 0, 0] = np.nextafter(moved["pos"][1, 0, 0],
                                         np.float32(np.inf))
    other = [wide[0], (wide[1][0], wide[1][1] - 1, wide[1][2])]
    for ran_b, match in (((moved, wide, None), "pos parts"),
                         ((after, other, None), "episode state")):
        with pytest.raises(L.Departure, match=match):
            L.explain_dense(noisy, exact, d, _wide_in(options),
                            (_ran(ra, d), ran_b), replays=(ra, rb))
    # within a tolerance the graph's run is held to
    tol = L.step_tol(1e-4, 1 / 120)
    L.reproduces(rb, moved, wide, tol)


# ---------------------------------------------------- hold_resident_step --

def _resident(options, d):
    _, cfg2 = _configs()
    wide = [S.wide_state_init(options)] * 2
    return S.ResidentSteps(state_from_numpy(d), cfg2, torch.tensor(1 / 60),
                           torch.tensor(1.0), options, wide)


def test_hold_resident_step_cpu_against_cpu():
    """Two CPU resident loops from the carries of a third: every step
    agrees bit for bit (no finding), rebins included, and the other side's
    run reproduces the third's; a rebin the other side's loop reports that
    its run does not take, or a carry one float32 step off, raises."""
    options = S.SolverOptions(**PACKED, wide_budget_substeps=0)
    d = lattice_state()
    d["batch_radius"][:, :2] = 65536.0
    rng = np.random.RandomState(1)
    for pop in (0, 1):
        n = int(d["count"][pop])
        d["vel"][pop, :n] = rng.uniform(-120.0, 120.0, (n, 2))
    run = _resident(options, d)
    carries, taken = [L.resident_carry(run)], []
    for _ in range(4):
        before = list(S.rebins)
        run.step()
        taken.append([b - a for a, b in zip(before, S.rebins)])
        carries.append(L.resident_carry(run))
    assert sum(map(sum, taken)) > 0
    side = L.DensePortSide(_configs()[1], options, "cpu")
    ref, other = _resident(options, d), _resident(options, d)
    for i in range(4):
        found, mine, errs, reproduced = L.hold_resident_step(
            side, ref, side, other, carries[i], carries[i + 1], taken[i], i)
        assert not found and mine == [bool(t) for t in taken[i]]
        assert all(e["pos"] == 0.0 == e["vel"] for e in errs)
        assert reproduced == 0.0
    flipped = [not t for t in taken[0]]
    with pytest.raises(L.Departure, match="does not reproduce"):
        L.hold_resident_step(side, ref, side, other, carries[0], carries[1],
                             flipped, 0)
    off = [dict(c) for c in carries[1]]
    off[1]["xy"] = np.nextafter(off[1]["xy"], np.float32(np.inf))
    with pytest.raises(L.Departure, match="does not reproduce"):
        L.hold_resident_step(side, ref, side, other, carries[0], off,
                             taken[0], 0)


def test_resident_carry_round_trip():
    options = S.SolverOptions(**PACKED)
    run = _resident(options, lattice_state())
    c = L.resident_carry(run)
    other = _resident(options, packed_state())
    L.load_resident_carry(other, c)
    for a, b in zip(L.resident_carry(other), c):
        for key in ("slot", "ref_p", "ref_xy", "xy"):
            np.testing.assert_array_equal(a[key], b[key])
        for x, y in zip(a["grid"] + a["fb"] + a["ws"],
                        b["grid"] + b["fb"] + b["ws"]):
            np.testing.assert_array_equal(x, y)
