"""The program's spans and counters as the benchmark reads them: the span
reduction (``spans.py``) on a synthetic trace, the trace reduction
(``tracing.py``) unchanged by them, the port's counters (``program.py``)
and the ``setup_capture_s`` reader."""

import dataclasses

import pytest

from benchmark import harness, manifest, program, spans, tracing


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _bench_events():
    """Two traced frames (and one before ``first``) with the device's work:
    busy 110-180 and 250-270 of the window 100-300."""
    ua = "user_annotation"
    return [
        _ev(ua, "bench.frame#0", 0, 100),
        _ev(ua, "bench.frame#1", 100, 100),
        _ev(ua, "bench.update#1", 100, 10),
        _ev(ua, "bench.draw#1", 110, 60),
        _ev(ua, "bench.sync#1", 170, 30),
        _ev(ua, "bench.frame#2", 200, 100),
        _ev(ua, "bench.draw#2", 200, 50),
        _ev("cuda_runtime", "cudaGraphLaunch", 5, 1, corr=1),
        _ev("cuda_runtime", "cudaGraphLaunch", 105, 1, corr=2),
        _ev("cuda_runtime", "cudaGraphLaunch", 121, 1, corr=3),
        _ev("cuda_runtime", "cudaMemcpyAsync", 127, 1, corr=5),
        _ev("cuda_runtime", "cudaGraphLaunch", 205, 1, corr=4),
        _ev("kernel", "k_before", 10, 50, corr=1),
        _ev("kernel", "(anonymous namespace)::substep_pass_kernel(float)",
            110, 20, corr=2),
        _ev("kernel", "(anonymous namespace)::splat_kernel<1, false>(x)",
            130, 40, corr=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 170, 10, corr=5),
        _ev("kernel", "void splat_kernel_other()", 250, 20, corr=4),
    ]


def _program_events():
    ua = "user_annotation"
    return [
        _ev(ua, "egg.update", 101, 8),
        _ev(ua, "egg.update.step", 102, 6),
        _ev(ua, "egg.draw", 111, 58),
        _ev(ua, "egg.draw.read_stats", 112, 8),
        _ev(ua, "egg.draw.render", 120, 5),
        _ev(ua, "egg.draw.read_audit", 126, 42),
        _ev(ua, "egg.draw", 201, 48),
        _ev(ua, "egg.draw.render", 202, 6),
        _ev(ua, "egg.graph.capture.render", 203, 4),
        _ev(ua, "egg.update", 40, 20),              # before the window
    ]


SYMBOLS = {"splat": "splat_kernel", "substep_pass": "substep_pass_kernel"}


def test_the_trace_reduction_ignores_the_program_spans():
    plain = tracing.reduce(_bench_events(), SYMBOLS, first=1)
    both = tracing.reduce(_bench_events() + _program_events(), SYMBOLS,
                          first=1)
    assert dataclasses.asdict(both) == dataclasses.asdict(plain)
    assert all(r.name in ("frame", "update", "draw", "sync")
               for r in both.ranges)


def test_spans_count_self_time_and_device_time():
    r = spans.reduce(_bench_events() + _program_events(), first=1)
    assert r["units"] == 2
    s = r["spans"]
    assert set(s) == {"egg.update", "egg.update.step", "egg.draw",
                      "egg.draw.read_stats", "egg.draw.render",
                      "egg.draw.read_audit", "egg.graph.capture.render"}
    assert s["egg.draw"]["count"] == 2 and s["egg.update"]["count"] == 1
    # 58 - 8 - 5 - 42 and 48 - 6, in us
    assert s["egg.draw"]["host_self_s"] == pytest.approx(45e-6)
    assert s["egg.draw.render"]["host_self_s"] == pytest.approx(7e-6)
    assert s["egg.update"]["host_self_s"] == pytest.approx(2e-6)
    # each operation to the innermost span open at its launch
    assert s["egg.update.step"]["device_s"] == pytest.approx(20e-6)
    assert s["egg.draw.render"]["device_s"] == pytest.approx(40e-6)
    assert s["egg.draw.read_audit"]["device_s"] == pytest.approx(10e-6)
    assert s["egg.graph.capture.render"]["device_s"] == pytest.approx(20e-6)
    assert s["egg.draw"]["device_s"] == 0.0


def test_idle_gaps_are_named_by_the_innermost_span():
    r = spans.reduce(_bench_events() + _program_events(), first=1)
    # gaps: 100-110 (update, egg.update.step), 180-250 (draw #2, egg.draw:
    # mid 215), 270-300 (frame #2, no call, no span)
    assert r["idle_by_span"] == [
        ["host:draw/egg.draw", pytest.approx(70e-6)],
        ["host:frame", pytest.approx(30e-6)],
        ["host:update/egg.update.step", pytest.approx(10e-6)]]
    within = dict(r["idle_within"])
    assert within == {"egg.draw": pytest.approx(70e-6),
                      "egg.update": pytest.approx(10e-6),
                      "egg.update.step": pytest.approx(10e-6)}
    assert r["idle_gaps"][0] == ["host:draw/egg.draw", pytest.approx(70e-6)]
    per = spans.per_unit(r)
    assert per["spans"]["egg.draw"]["count"] == 1.0
    assert per["idle_within_ms"][0] == ["egg.draw", pytest.approx(0.035)]


def test_a_trace_without_program_spans_keeps_the_call_names():
    r = spans.reduce(_bench_events(), first=1)
    assert r["spans"] == {} and r["idle_within"] == []
    assert [n for n, _ in r["idle_by_span"]] == ["host:draw", "host:frame",
                                                 "host:update"]
    assert spans.reduce([], first=0)["units"] == 0


def test_window_metrics_of_the_spans_and_counters():
    r = spans.reduce(_bench_events() + _program_events(), first=1)
    got = spans.window_metrics("frames", 4, 0, r, {"capture_seconds": 2.5},
                               {"rerenders": 12})
    assert got == {"setup_capture_s": 2.5, "rerenders_per_frame": 3.0,
                   "draw_idle_ms": pytest.approx(0.035)}
    got = spans.window_metrics("headless", 3, 100, r, {}, {})
    assert got == {"run_steps_idle_ms": 0.0}


def test_program_counters_of_the_port():
    c = program.program_counters()
    for key in ("host_reads", "rerenders", "dropped", "host_syncs", "rebins",
                "capture_seconds", "load_seconds"):
        assert key in c
    n = program.numbers_of({**c, "captures": {"step": 2},
                            "resident_rebins": object()})
    assert n["captures.step"] == 2 and n["rebins.0"] == c["rebins"][0]
    assert "resident_rebins" not in n and "rebins" not in n


def test_setup_capture_s_reads_the_builds_of_a_card_run(monkeypatch):
    read = manifest.reader("setup_capture_s")
    run = harness.Run("eggs_1m.frames", "frames")
    assert read(run) is None                         # untraced
    run.trace = tracing.Summary(1.0, 0.0, [], [], [])
    monkeypatch.setattr(program, "program_counters",
                        lambda h=None: {"capture_seconds": 3.5})
    assert read(run) is None                         # no device work
    run.trace = tracing.Summary(1.0, 0.5, [], [], [])
    assert read(run) == 3.5
    monkeypatch.setattr(program, "program_counters", lambda h=None: None)
    assert read(run) is None                         # an older program
    monkeypatch.setattr(program, "program_counters",
                        lambda h=None: {"capture_seconds": 0.0})
    assert read(run) is None                         # no graph built


@pytest.mark.parametrize("kind", ("frames", "headless"))
def test_a_spans_run_of_a_shrunk_cell(kind):
    import torch

    import bench_tiny
    torch.set_num_threads(2)
    man, w, files = bench_tiny.files(kind)
    r = spans.run(w["name"], bench_tiny.SEED, 0.4, torch.device("cpu"),
                  **files)
    traced = r["traced"]
    assert traced["units"] >= 1 and r["units"] >= traced["units"]
    want = {"frames": {"egg.update", "egg.update.step", "egg.draw",
                       "egg.draw.read_stats", "egg.draw.render",
                       "egg.draw.read_audit"},
            "headless": {"egg.run_steps"}}[kind]
    assert want <= set(traced["spans"])
    assert r["counters_setup"]["host_reads"] >= 0
    got = r["program"]
    if kind == "frames":
        assert set(got) == {"rerenders_per_frame", "draw_idle_ms"}
        assert r["metrics"]["host_reads_per_frame"] == pytest.approx(
            2.0 + 2.0 * got["rerenders_per_frame"])
    else:
        assert set(got) == {"run_steps_idle_ms"}
    assert "setup_capture_s" not in got            # no graph on the CPU
