"""The trace reduction on a synthetic trace, and a traced run of a
shrunk cell on the CPU."""

import pytest

from benchmark import tracing

import bench_tiny


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_ranges_busy_gaps_and_kernels():
    ev = [
        _ev("user_annotation", "bench.frame#0", 0, 100),   # before `first`
        _ev("user_annotation", "bench.frame#1", 100, 100),
        _ev("user_annotation", "bench.update#1", 100, 10),
        _ev("user_annotation", "bench.draw#1", 110, 60),
        _ev("user_annotation", "bench.sync#1", 170, 30),
        _ev("user_annotation", "bench.frame#2", 200, 100),
        _ev("user_annotation", "bench.draw#2", 200, 50),
        _ev("cuda_runtime", "cudaGraphLaunch", 5, 1, corr=1),
        _ev("cuda_runtime", "cudaGraphLaunch", 105, 1, corr=2),
        _ev("cuda_runtime", "cudaGraphLaunch", 115, 1, corr=3),
        _ev("cuda_runtime", "cudaGraphLaunch", 205, 1, corr=4),
        _ev("kernel", "k_before", 10, 50, corr=1),          # outside window
        _ev("kernel", "(anonymous namespace)::substep_pass_kernel(float)",
            110, 20, corr=2),
        _ev("kernel", "(anonymous namespace)::splat_kernel<1, false>(x)",
            130, 40, corr=3),
        _ev("kernel", "void splat_kernel_other()", 170, 10, corr=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 250, 20, corr=4),
    ]
    s = tracing.reduce(ev, {"splat": "splat_kernel",
                            "substep_pass": "substep_pass_kernel"}, first=1)
    assert s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx(90e-6)
    draws = {r.unit: r for r in s.of("draw")}
    assert draws[1].device_s == pytest.approx(50e-6)
    assert draws[1].kernels == {"splat": pytest.approx(40e-6)}
    assert {r.unit: r.kernels for r in s.of("update")}[1] == \
        {"substep_pass": pytest.approx(20e-6)}
    assert draws[2].device_s == pytest.approx(20e-6)
    assert not s.of("frame") or min(r.unit for r in s.of("frame")) == 1
    assert [n for n, _ in s.device_ops][0].startswith("(anonymous")
    gaps = dict((n, v) for n, v in reversed(s.idle_gaps))
    assert s.idle_gaps[0][1] == pytest.approx(70e-6)     # 180 .. 250
    assert "host:sync" in gaps or "host:frame" in gaps


@pytest.mark.parametrize("kind", ("frames", "headless", "gather"))
def test_traced_run_reports_the_per_layer_metrics_it_can(kind):
    r = bench_tiny.run(kind, trace=True, seconds=0.4)
    assert r["correct"] is True
    names = set(r["metrics"])
    # the CPU has no device trace: only the counters' metrics are there
    want = {"frames": {"host_reads_per_frame"},
            "headless": {"rebins_per_step"},
            "gather": {"host_reads_per_frame"}}[kind]
    assert names == want
    assert "busy_s" in r["device"] and "breakdown" in r
