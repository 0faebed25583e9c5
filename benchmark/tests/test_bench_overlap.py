"""The overlap cell (``overlap_8.headless``: 8 default eggs spawned on one
point, run headless on the default handler) through the harness on the
CPU, where the port runs kernel H's plain versions, at the cell's own size
with a short window: the configuration's options, ``correct`` under the
committed limits, the control past at least one of them, the budget's cuts
counted; and the readers of the cell's two kernel H metrics, which give
None where the program keeps no cut counter (an older commit) and on a
frames run."""

import pytest
import torch

from benchmark import calibrate, harness, manifest, program, scene, tracing
from benchmark.reference.model import Reference

CELL = "overlap_8.headless"
SEED = 2 ** 31 + 24


def test_the_cell_and_its_configuration():
    man = manifest.load()
    w = manifest.workload(man, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("overlap_8",
                                                        "headless", 1)
    conf = next(c for c in man["configs"] if c["name"] == "overlap_8")
    assert conf["reduced"] == [] and "BASELINE.json configs[2]" in \
        conf["source"]
    cfg = manifest.config("overlap_8")
    homes = scene.homes(cfg["scene"])
    assert (homes == homes[0]).all()                      # one point
    derived = cfg["derived"]
    opts = Reference(cfg, scene.batch_specs(cfg["scene"], SEED),
                     "cpu").options
    assert (opts.engine, opts.budget_mode, opts.table_size,
            opts.slots_per_cell, list(opts.pop_caps)) == (
        derived["engine"], derived["budget_mode"], derived["table_size"],
        derived["slots_per_cell"], derived["pop_caps"])
    assert sum(scene.particles(cfg["scene"])) == derived["particles"]
    for name in ("particle_steps_per_s", "step_device_ms",
                 "device_idle_pct.headless", "setup_capture_s",
                 "budget_cut_share", "gather_sweep_roofline.headless"):
        metric = next(m for m in man["end_to_end"] + man["per_layer"]
                      if m["name"] == name)
        assert manifest.applies(metric, CELL), name
    for name in ("rebins_per_step", "substep_pass_roofline"):
        metric = next(m for m in man["per_layer"] if m["name"] == name)
        assert not manifest.applies(metric, CELL), name


def test_a_short_run_is_correct_and_the_control_is_not():
    """The cell's set-up (120 settling steps), its warm call and a window
    of one ``run_steps(100)`` call, read as the check reads it: the
    program within every committed limit, the control past one; the
    yolk's budget cut passes meanwhile."""
    torch.set_num_threads(2)
    w = manifest.workload(manifest.load(), CELL)
    cell = harness.Cell(w, SEED, torch.device("cpu"), False)
    cell.setup()
    cell.window(0.01)
    spawned, checks = cell.spawned, cell.checks
    del cell.h
    assert len(checks) == 1
    got = calibrate.readings(cell, spawned, checks)
    assert got["correct"], got["numbers"]
    ctrl = calibrate.readings(cell, spawned, checks, "control")
    assert not ctrl["correct"], ctrl["numbers"]
    assert any(ctrl["numbers"][k] > v for k, v in cell.limits.items())
    share = manifest.reader("budget_cut_share")(cell.run)
    assert share is not None and 0.0 < share < 100.0


def _counters(cuts):
    return lambda h=None: {"capture_seconds": 1.0, "budget_cuts": cuts}


def test_budget_cut_share_reads_the_port_counter(monkeypatch):
    read = manifest.reader("budget_cut_share")
    run = harness.Run(CELL, "headless")
    monkeypatch.setattr(program, "program_counters", _counters(
        torch.tensor([[0, 600], [550, 600]], dtype=torch.int32)))
    assert read(run) == pytest.approx(100.0 * 550 / 1200)
    monkeypatch.setattr(program, "program_counters", _counters(
        torch.zeros((2, 2), dtype=torch.int32)))
    assert read(run) is None                        # no budgeted pass
    monkeypatch.setattr(program, "program_counters", _counters(None))
    assert read(run) is None                        # none on this device
    monkeypatch.setattr(program, "program_counters",
                        lambda h=None: {"capture_seconds": 1.0})
    assert read(run) is None                        # a program without it
    monkeypatch.setattr(program, "program_counters", lambda h=None: None)
    assert read(run) is None                        # no counters at all


def _run_with(ranges, bounds, kind="headless"):
    run = harness.Run(CELL, kind)
    run.trace = tracing.Summary(1.0, 0.5, ranges, [], [])
    run.bounds = bounds
    return run


def test_gather_sweep_roofline_headless_reads_checked_traced_calls():
    read = manifest.reader("gather_sweep_roofline.headless")
    ranges = [tracing.Range("run_steps", 2, 0, 1, device_s=0.2,
                            kernels={"gather_sweep": 1e-2}),
              tracing.Range("run_steps", 3, 2, 3, device_s=0.2,
                            kernels={"gather_sweep": 3e-2}),
              tracing.Range("sync", 3, 3, 4, device_s=0.0)]
    bounds = {3: {"gather_sweep": 3e-4}, 9: {"gather_sweep": 1.0}}
    assert read(_run_with(ranges, bounds)) == pytest.approx(1.0)
    assert read(_run_with(ranges, {3: {"substep_pass": 1e-4}})) is None
    assert read(_run_with([], bounds)) is None      # nothing traced
    assert read(_run_with(ranges, bounds, "frames")) is None
    # the frames cells' reader leaves a headless run alone, as before
    assert manifest.reader("gather_sweep_roofline")(
        _run_with(ranges, bounds)) is None
