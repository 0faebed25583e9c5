"""The readings a cell's limits are set from, on the card:

    python benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--seconds 3] [--control 3] [--unchanged 1] [--samples 40]
    python benchmark/calibrate.py --workload <name> --seeds 1 --idle 10

For each seed, in one process: the cell's set-up and a short window at its
own load, then every number the check works out, read between the
reference and, in turn, the program, the witness (a float32 program that
rounds otherwise: with the program, the lower readings), the control (the
upper readings; the first ``--control`` seeds) and a step that hands back
its state unchanged (the first ``--unchanged`` seeds), all on the same held
units (``check.py``, ``reference/control.py``). ``--samples`` holds that
many of the window's units in place of the mix's ``check_samples``, so a
rare unit that reads far above the rest (a pair set that rounding changes)
is seen in a dozen seeds. One JSON line a seed.

``--idle S`` reads instead, after set-up, the units' mean seconds over an
untraced window of S seconds and over one of S seconds traced with the
device's activity alone (no host ranges, no host operations), and the share
of the second window in which nothing ran on the device. The benchmark's
own runs run none of this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import manifest, traffic  # noqa: E402
from benchmark.check import Checker  # noqa: E402
from benchmark.harness import Cell  # noqa: E402
from benchmark.tracing import DEVICE_CATS  # noqa: E402


def readings(cell: Cell, spawned, checks, stand_in=None) -> dict:
    checker = Checker(cell.cfg, cell.specs, cell.device, cell.limits,
                      stand_in=stand_in)
    checker.spawn(spawned)
    for kind, item in checks:
        if kind == "frame":
            checker.frame(item, getattr(cell, "viewport", None))
        else:
            checker.call(item)
    return {"numbers": dict(checker.numbers), "seconds": checker.seconds,
            "correct": checker.correct}


def _busy_share(events) -> tuple:
    """(busy seconds, span seconds) of the device operations in a trace,
    the span from the first one's start to the last one's end."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    if not spans:
        return 0.0, 0.0
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return busy * 1e-6, (max(b for _, b in spans) - spans[0][0]) * 1e-6


def idle(cell: Cell, seconds: float) -> dict:
    frames = cell.mix.kind == "frames"

    def loop():
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if frames:
                cell._frame(False)
            else:
                cell._call(False)
            n += 1
        return 1000.0 * (time.perf_counter() - t0) / n, n

    plain_ms, plain_n = loop()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    traced_ms, traced_n = loop()
    torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(tempfile.gettempdir(), "bench_idle_trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    busy, span = _busy_share(events)
    return {"untraced_unit_ms": plain_ms, "untraced_units": plain_n,
            "device_traced_unit_ms": traced_ms, "device_traced_units": traced_n,
            "busy_s": busy, "span_s": span,
            "idle_pct": 100.0 * (1.0 - busy / span) if span > 0 else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--unchanged", type=int, default=1)
    ap.add_argument("--idle", type=float, default=0.0)
    ap.add_argument("--samples", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    w = manifest.workload(manifest.load(), args.workload)
    mix = traffic.load(w["traffic"])
    if args.samples > 0:
        mix = traffic.Mix(mix.name, dict(mix.params,
                                         check_samples=args.samples))
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = Cell(w, seed, torch.device(args.device), False, mix=mix)
        cell.setup()
        if args.idle > 0:
            out = {"workload": args.workload, "seed": seed,
                   "idle": idle(cell, args.idle)}
            print(json.dumps(out), flush=True)
            del cell
            gc.collect()
            continue
        cell.window(args.seconds)
        spawned, checks = cell.spawned, cell.checks
        del cell.h
        gc.collect()
        out = {"workload": args.workload, "seed": seed,
               "units": cell.run.units, "checked": len(checks),
               "program": readings(cell, spawned, checks),
               "witness": readings(cell, spawned, checks, "witness")}
        if n < args.control:
            out["control"] = readings(cell, spawned, checks, "control")
        if n < args.unchanged:
            out["unchanged"] = readings(cell, spawned, checks, "unchanged")
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del cell, checks
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
