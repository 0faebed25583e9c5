"""The reference on the gather engine (a handler below capacity 16384)
against the port's plain path on a small scene on the CPU, where the port
runs kernel H's plain versions: the spawn, the options, fixed steps, a
``run_steps`` call, the frame; the stand-ins reach the gather sweep; the
sweep's bound is tallied; and the readers of the frames cells' step and
kernel H metrics and of the default handler's frame tail."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import harness, manifest, scene, system, tracing
from benchmark.check import Checker
from benchmark.reference import control
from benchmark.reference.frozen.ops import hash_grid
from benchmark.reference.frozen.ops.kernels import gather_kernel as GK
from benchmark.reference.model import Reference
from benchmark.roofline import counts, tally

import bench_tiny

VIEW = (-40.0, -30.0, 512, 512)


def _pair(seed=5):
    torch.set_num_threads(2)
    _, _, f = bench_tiny.files("gather")
    cfg = f["cfg"]
    specs = scene.batch_specs(cfg["scene"], seed)
    h, _ = system.build(cfg, specs, "cpu")
    return cfg, specs, h, Reference(cfg, specs, "cpu")


def _same(a, b):
    return all(torch.equal(a[k], getattr(b, k)) for k in a)


def test_the_cell_runs_the_gather_engine():
    cfg, specs, h, ref = _pair()
    assert cfg["handler"]["capacity"] < 16384
    assert ref.options.engine == "gather"
    assert ref.options.budget_mode == "ordered"
    real = manifest.config("default_4k")
    derived = real["derived"]
    opts = Reference(real, scene.batch_specs(real["scene"], 1),
                     "cpu").options
    assert (opts.engine, opts.budget_mode, opts.table_size,
            opts.slots_per_cell, list(opts.pop_caps)) == (
        derived["engine"], derived["budget_mode"], derived["table_size"],
        derived["slots_per_cell"], derived["pop_caps"])
    assert sum(scene.particles(real["scene"])) == derived["particles"]


def test_spawn_options_and_steps_bit_for_bit():
    cfg, specs, h, ref = _pair()
    got = system.snapshot(h, system.SPAWN)
    for k, v in ref.spawned.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert dataclasses.asdict(ref.options) == dataclasses.asdict(h._options)
    wide = None
    for _ in range(3):
        before = system.snapshot(h)
        h.update(1 / 60)
        st, stats, wide = ref.step(before, wide, None, 1 / 60)
        assert _same(system.snapshot(h), st)
        assert _same(system.stats(h), stats)


def test_run_steps_bit_for_bit():
    cfg, specs, h, ref = _pair(7)
    h.update(1 / 60)
    before, wide = system.snapshot(h), system.wide_state(h)
    r0 = system.rebins(h)
    h.run_steps(4)
    st, stats, _, rebins = ref.run_steps(before, wide, None, 4, 1 / 60)
    assert _same(system.snapshot(h), st)
    assert _same(system.stats(h), stats)
    assert (system.rebins(h) - r0).tolist() == rebins == [0, 0]


def test_frame_against_the_port_draw():
    cfg, specs, h, ref = _pair(9)
    h.run_steps(4)
    before = system.snapshot(h)
    h.update(1 / 60)
    frame = h.draw(viewport=VIEW)
    want = ref.draw(before, system.snapshot(h), VIEW, h.interpolation_alpha)
    assert frame.shape == want.shape == (512, 512, 4)
    assert float(want[..., 3].max()) > 0.5
    assert float((frame - want).abs().max()) <= 1e-5


def test_stand_ins_change_gather_steps():
    """The control and the witness each move the positions of a few gather
    steps, the control by far more than the witness's rounding (at this
    size one step's rounding of the witness seldom reaches a position's
    last bit: four steps carry it there)."""
    cfg, specs, h, ref = _pair(11)
    h.run_steps(3)
    before = system.snapshot(h)
    want, _, _ = ref.step(before, None, None, 1 / 60, 4)
    gaps = {}
    for name, ctx in (("control", control.lowered),
                      ("witness", control.reordered)):
        with ctx():
            got, _, _ = ref.step(before, None, None, 1 / 60, 4)
        gaps[name] = float((got.pos - want.pos).abs().max())
    assert 0.0 < gaps["witness"] < 1e-2
    assert gaps["control"] > 100 * gaps["witness"]


def _pass_inputs(seed=13):
    """The record, slot table and budget prefix of one gather pass of the
    white population, as the reference's step makes them."""
    cfg, specs, h, ref = _pair(seed)
    h.run_steps(3)
    seen = []
    fn = GK.gather_sweep

    def keep(record, grid, cum, *args, **kw):
        seen.append((record, grid, cum, args, kw))
        return fn(record, grid, cum, *args, **kw)
    GK.gather_sweep = keep
    try:
        ref.step(system.snapshot(h), None, None, 1 / 60)
    finally:
        GK.gather_sweep = fn
    return seen[0]


def test_witness_reverses_the_gather_sums_alone():
    """The witness's sweep parts from the plain one by rounding (the
    positions centred on the origin, where a position's last bit is finer
    than a correction's), chunked or not; the budget's count and the
    sweep's bound, which do not depend on the candidates' order, read the
    same bit for bit."""
    record, grid, cum, args, kw = _pass_inputs()
    act = GK.record_active(record)
    record = record.clone()
    record[:, 0:2] -= record[act, 0:2].mean(0)
    plain = GK.gather_sweep(record, grid, cum, *args, **kw)
    count = GK.gather_count(record, grid)
    bound = {}
    with tally.tally(bound):
        GK.gather_sweep(record, grid, cum, *args, **kw)
    with control.reordered():
        other = GK.gather_sweep(record, grid, cum, *args, **kw)
        chunked = GK.gather_sweep(record, grid, cum, *args,
                                  **dict(kw, pair_chunk=97))
        assert torch.equal(GK.gather_count(record, grid), count)
        witness = {}
        with tally.tally(witness):
            GK.gather_sweep(record, grid, cum, *args, **kw)
    gap = float((other - plain).abs().max())
    assert 0.0 < gap < 1e-3
    assert torch.equal(chunked, other)
    assert witness == bound
    assert torch.equal(GK.gather_sweep(record, grid, cum, *args, **kw), plain)


def test_gather_sweep_bound_hand_counted():
    """Pairs in the true 3x3 cells; bytes: the records, the table rows the
    live particles' 3x3 cells hash to (counted one particle at a time),
    the prefix at the live particles, the positions written. Fewer bytes
    than the whole table and prefix."""
    record, grid, cum, args, kw = _pass_inputs()
    act = GK.record_active(record)
    cand, valid = GK.candidates(grid, act)
    near = GK.in_cells(grid.cell_xy, cand.clamp(min=0).long())
    pairs = float((valid & near).sum())
    assert pairs > 0
    rows = set()
    for i in torch.nonzero(act).flatten().tolist():
        x, y = (int(v) for v in grid.cell_xy[i])
        for dx, dy in hash_grid.NEIGHBOR_OFFSETS:
            rows.add(int(hash_grid._bucket_of(torch.tensor([x + dx]),
                                              torch.tensor([y + dy]),
                                              grid.table_size)))
    assert 0 < len(rows) < grid.table.shape[0]
    sink = {}
    with tally.tally(sink):
        GK.gather_sweep(record, grid, cum, *args, **kw)
    n, k, live = record.shape[0], grid.table.shape[1], int(act.sum())
    moved = record.numel() * 4 + len(rows) * k * 4 + live * 4 + n * 8
    assert moved < record.numel() * 4 + grid.table.numel() * 4 \
        + cum.numel() * 4 + n * 8
    assert sink["gather_sweep"] == pytest.approx(max(
        pairs * counts.PAIR_OPS / counts.FP32_OPS_PER_S,
        moved / counts.HBM_BYTES_PER_S), rel=1e-12)


def _port_gather_tally(monkeypatch, sink):
    """Count H's sweep bound from the inputs the port's route gets."""
    from egg_fluid_simulation_tpu_torch.ops.kernels import gather_kernel
    fn = gather_kernel.gather_sweep

    def gather_sweep(record, grid, cum, *args, **kw):
        active = gather_kernel.record_active(record)
        cand, valid = gather_kernel.candidates(grid, active)
        near = gather_kernel.in_cells(grid.cell_xy,
                                      cand.clamp(min=0).long())
        sink["gather_sweep"] = sink.get("gather_sweep", 0.0) + \
            counts.gather_sweep_seconds(
                float((valid & near).sum()), record,
                tally.table_rows(grid, active), grid.table.shape[1],
                int(active.sum()) if cum is not None else 0)
        return fn(record, grid, cum, *args, **kw)
    monkeypatch.setattr(gather_kernel, "gather_sweep", gather_sweep)


def test_frame_unit_keeps_the_step_and_render_bounds(monkeypatch):
    """A checked frame's bounds hold H's sweep over the update's passes,
    counted alike from the port's inputs, beside the splat's bound, which
    reads what the render alone tallies."""
    cfg, specs, h, ref = _pair(3)
    h.run_steps(3)
    before, wide = system.snapshot(h), system.wide_state(h)
    port = {}
    _port_gather_tally(monkeypatch, port)
    h.update(1 / 60)
    item = dict(before=before, wide=wide, unit=0, step_delta=1 / 60,
                after=system.snapshot(h), stats=system.stats(h),
                targets=None, steps=1, alpha=h.interpolation_alpha,
                frame=h.draw(viewport=VIEW))
    checker = Checker(cfg, specs, "cpu", {})
    checker.frame(item, VIEW)
    b = checker.bounds[0]
    assert b["gather_sweep"] == port["gather_sweep"] > 0
    drawn = {}
    with tally.tally(drawn):
        Reference(cfg, specs, "cpu").draw(before, item["after"], VIEW,
                                          item["alpha"])
    assert b["splat"] == drawn["splat"] > 0
    assert "substep_pass" not in b


def _run_with(ranges, bounds, kind="frames"):
    run = harness.Run("default_4k.frames", kind)
    run.trace = tracing.Summary(1.0, 0.5, ranges, [], [])
    run.bounds = bounds
    return run


def test_update_device_ms_reads_the_update_ranges():
    read = manifest.reader("update_device_ms")
    ranges = [tracing.Range("update", 0, 0, 1, device_s=2e-3),
              tracing.Range("update", 1, 2, 3, device_s=4e-3),
              tracing.Range("draw", 1, 3, 4, device_s=9e-3)]
    assert read(_run_with(ranges, {})) == pytest.approx(3.0)
    assert read(_run_with(ranges, {}, "headless")) is None
    assert read(_run_with([], {})) is None
    assert read(harness.Run("default_4k.frames", "frames")) is None


def test_gather_sweep_roofline_reads_checked_traced_updates():
    read = manifest.reader("gather_sweep_roofline")
    ranges = [tracing.Range("update", 0, 0, 1, device_s=2e-3,
                            kernels={"gather_sweep": 1e-3}),
              tracing.Range("update", 1, 2, 3, device_s=2e-3,
                            kernels={"gather_sweep": 3e-3}),
              tracing.Range("draw", 1, 3, 4, device_s=9e-3,
                            kernels={"gather_sweep": 5e-3})]
    bounds = {1: {"gather_sweep": 3e-4, "splat": 1e-4},
              7: {"gather_sweep": 1.0}}           # a unit not traced
    assert read(_run_with(ranges, bounds)) == pytest.approx(10.0)
    assert read(_run_with(ranges, {1: {"splat": 1e-4}})) is None
    assert read(_run_with(ranges, bounds, "headless")) is None


def test_frame_p95_reads_the_frames_after_the_profiled_ones():
    read = manifest.reader("frame_p95_ms.handler")
    ranges = [tracing.Range("frame", i, i, i + 1) for i in range(2)]
    run = _run_with(ranges, {})
    run.unit_s = [9.0, 8.0] + [1e-3 * (k + 1) for k in range(20)]
    assert read(run) == pytest.approx(19.0)      # nearest rank 19 of 20
    run.unit_s = [9.0, 8.0]
    assert read(run) is None
    assert read(_run_with(ranges, {}, "headless")) is None
