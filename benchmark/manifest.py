"""``BENCHMARK.json`` and the files it names, found by name."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def config(name: str) -> dict:
    """``configs/<name>.json``: the deployment as it is run."""
    return _json("configs", name)


def traffic(name: str) -> dict:
    """``traffic/<name>.json``: the mix's parameters."""
    return _json("traffic", name)


def limits(cell: str) -> dict:
    """``limits/<cell>.json``: each compared number's limit."""
    return _json("limits", cell)


def applies(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell`` (no ``workloads`` key:
    in every cell)."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(manifest: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics of ``cell``."""
    return [m for m in manifest[kind] if applies(m, cell)]


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(ctx)``: the metric's value from a
    traced run, or None where the run holds nothing to read."""
    if not NAME.match(metric):
        raise ValueError(f"metric name {metric!r} is not a valid name")
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

