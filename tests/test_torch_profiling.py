"""``StepTimer`` and ``trace`` of the port's ``utils/profiling.py`` on the
CPU (the CUDA-event branch of ``StepTimer`` needs a card)."""

import json
import os
import time

import pytest
import torch

from egg_fluid_simulation_tpu_torch.utils.profiling import StepTimer, trace


def test_step_timer_rolls_its_window_and_summarises():
    timer = StepTimer(window=3, device="cpu")
    for _ in range(5):
        with timer.phase("step"):
            time.sleep(0.002)
    with timer.phase("draw"):
        pass
    out = timer.summary()
    assert set(out) == {"step", "draw"}
    assert out["step"]["n"] == 3                      # rolled to the window
    assert 1.5 <= out["step"]["p50_ms"] <= out["step"]["max_ms"]
    assert out["draw"]["n"] == 1
    pct = timer.frame_usage_pct("step")
    assert pct == pytest.approx(out["step"]["mean_ms"] / (1000 / 60) * 100)
    assert timer.frame_usage_pct("missing") == 0.0


def test_step_timer_records_a_phase_that_raises():
    timer = StepTimer(device="cpu")
    with pytest.raises(ValueError):
        with timer.phase("bad"):
            raise ValueError("boom")
    assert timer.summary()["bad"]["n"] == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    out = os.path.join(tmp_path, "prof")
    with trace(out):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(out, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
