"""Whole runs of a shrunk cell on the CPU (the look for a card skipped),
sound and with the timed path broken underneath: the sound run is
correct, each fault the cells can have makes ``correct`` false, and so
does the control in the program's place. The cells run on one card, so
there is no exchange between cards to leave out. ``gather`` is the frames
cell of the gather engine (``default_4k.frames``)."""

import pytest
import torch

import bench_tiny

KINDS = ("frames", "headless", "gather")
FRAMES = ("frames", "gather")


def _solver():
    from egg_fluid_simulation_tpu_torch.ops import solver
    return solver


@pytest.mark.parametrize("kind", KINDS)
def test_sound_run_is_correct(kind):
    r = bench_tiny.run(kind)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    from egg_fluid_simulation_tpu_torch import handler
    monkeypatch.setattr(handler.SimulationHandler, "_advance",
                        lambda self, *a, **k: None)
    monkeypatch.setattr(handler.SimulationHandler, "run_steps",
                        lambda self, *a, **k: None)


def _half_left_out(monkeypatch):
    """Half of the particles left out of every step; the stats taken over
    the rest."""
    S = _solver()

    def halve(fn):
        def wrapped(state, *a, **k):
            out = fn(state, *a, **k)
            new = out[0]
            keep = {f: getattr(new, f).clone()
                    for f in ("pos", "prev", "vel")}
            for i, live in enumerate(new.count.tolist()):
                for f in keep:
                    keep[f][i, live // 2:live] = \
                        getattr(state, f)[i, live // 2:live]
            return (new.replace(**keep),) + tuple(out[1:])
        return wrapped
    monkeypatch.setattr(S, "step", halve(S.step))
    monkeypatch.setattr(S, "multi_step", halve(S.multi_step))


def _altered_by(shift: float):
    def fault(monkeypatch):
        S = _solver()

        def alter(fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                pos = out[0].pos.clone()
                pos[0, 7, 0] += shift
                return (out[0].replace(pos=pos),) + tuple(out[1:])
            return wrapped
        monkeypatch.setattr(S, "step", alter(S.step))
        monkeypatch.setattr(S, "multi_step", alter(S.multi_step))
    return fault


# One particle's position altered where the step produces it: by 16 px,
# inside its egg, and by 160 px, out of it. A headless call is compared in
# aggregate (its particles' paths part within the call's 100 steps on any
# change of rounding), so only a particle that leaves its egg shows there.
_position_altered = _altered_by(16.0)
_out_of_its_egg = _altered_by(160.0)


def _pixel_altered(monkeypatch):
    """One pixel of the frame altered where the draw produces it."""
    from egg_fluid_simulation_tpu_torch.ops import render
    draw = render.draw

    def wrapped(*a, **k):
        frame = draw(*a, **k).clone()
        frame[100, 100, 0] += 0.25
        return frame
    monkeypatch.setattr(render, "draw", wrapped)


FAULTS = {"state_unchanged": (_state_unchanged, KINDS),
          "half_left_out": (_half_left_out, KINDS),
          "position_altered": (_position_altered, FRAMES),
          "out_of_its_egg": (_out_of_its_egg, KINDS),
          "pixel_altered": (_pixel_altered, FRAMES)}


@pytest.mark.parametrize("kind,fault", [(k, f) for f, (_, ks) in
                                        FAULTS.items() for k in ks])
def test_fault_is_not_correct(monkeypatch, kind, fault):
    FAULTS[fault][0](monkeypatch)
    r = bench_tiny.run(kind)
    assert r["correct"] is False, (fault, r["checks"])
    assert r["failed"] >= 1


@pytest.mark.parametrize("kind", KINDS)
def test_control_is_not_correct(kind):
    """The control (bfloat16 storage) in the program's place, at the
    shrunk size: it fails the cell's limits."""
    from benchmark import calibrate
    from benchmark.harness import Cell
    torch.set_num_threads(2)
    man, w, f = bench_tiny.files(kind)
    cell = Cell(w, bench_tiny.SEED, torch.device("cpu"), False, **f)
    cell.setup()
    cell.window(0.2)
    got = calibrate.readings(cell, cell.spawned, cell.checks, "control")
    assert got["correct"] is False, got
    assert any(got["numbers"][k] > v for k, v in cell.limits.items())


@pytest.mark.parametrize("kind", KINDS)
def test_witness_is_correct(kind):
    """The witness (kernel B's pair sums in another order, ``1 / sqrt`` for
    ``rsqrt``) rounds otherwise than the reference and is sound: at the
    shrunk size it parts from the reference and stays within the limits."""
    from benchmark import calibrate
    from benchmark.harness import Cell
    torch.set_num_threads(2)
    man, w, f = bench_tiny.files(kind)
    cell = Cell(w, bench_tiny.SEED, torch.device("cpu"), False, **f)
    cell.setup()
    cell.window(0.2)
    got = calibrate.readings(cell, cell.spawned, cell.checks, "witness")
    assert got["correct"] is True, got
    assert got["numbers"]["pos_gap_px"] > 0.0
