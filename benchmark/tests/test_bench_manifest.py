"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import json
import re

import pytest

from benchmark import manifest, traffic

MAN = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert manifest.MANIFEST.stat().st_size <= 64 * 1024
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51


def test_names_units_and_texts():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and TEXT.match(w["why"])
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
    for kind in ("end_to_end", "per_layer"):
        for m in MAN[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
    metrics = [m["name"] for k in ("end_to_end", "per_layer")
               for m in MAN[k]]
    cells = [w["name"] for w in MAN["workloads"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))


def test_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in MAN["end_to_end"]} >= {"setup_s"}


def test_every_cell_reports_enough():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        own = [m["name"] for m in manifest.cell_metrics(MAN, w["name"],
                                                        "end_to_end")]
        assert "setup_s" in own and len(own) >= 2, w["name"]
        layers = manifest.cell_metrics(MAN, w["name"], "per_layer")
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in own, (w["name"], m["name"])
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cfg = manifest.config(w["config"])
    assert cfg["name"] == w["config"]
    entry = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"benchmark/configs/{w['config']}.json"
    assert json.loads((manifest.ROOT / entry["file"]).read_text()) == cfg
    mix = traffic.load(w["traffic"])
    assert mix.kind in traffic.KINDS
    lim = manifest.limits(w["name"])
    # every limit names a number the check works out for the mix's kind;
    # the spawn, the aggregate numbers and a frame's pixels always decide
    shared = {"spawn_gap", "pos_gap_px", "vel_gap_px_s", "stats_gap_px",
              "batch_gap_px", "reach_gap_px", "move_gap"}
    extra = {"frames": {"frame_gap"}, "headless": {"rebin_gap"}}[mix.kind]
    assert set(lim) <= shared | extra
    assert {"spawn_gap", "stats_gap_px", "batch_gap_px", "reach_gap_px",
            "move_gap"} <= set(lim)
    if mix.kind == "frames":
        assert "frame_gap" in lim
    assert lim["spawn_gap"] == 0.0


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_found_by_name(m):
    assert callable(manifest.reader(m["name"]))


def test_config_files_state_their_deployment():
    for c in MAN["configs"]:
        cfg = manifest.config(c["name"])
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]
        for key in ("scene", "handler", "settle_steps", "precision",
                    "guarantees", "assumed", "viewport_px"):
            assert key in cfg, (c["name"], key)


def test_bad_name_refused():
    with pytest.raises(ValueError):
        manifest.config("../BENCHMARK")
