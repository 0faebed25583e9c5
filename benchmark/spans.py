"""The program's own spans in a traced run, and a run of one cell that
reports them:

    python3 -m benchmark.spans --workload <name> --seed <n> --seconds <s>

The port opens ``egg.<...>`` ranges of its host work while a profiler
records (``utils.profiling.span``): inside ``update``, ``draw`` and
``run_steps``, around each graph build and the kernel library's load. They
nest on the host thread inside the benchmark's own ranges (``tracing.py``:
the unit ``bench.frame#i`` / ``bench.call#i`` and its calls), so a unit's
range is what its spans share. :func:`reduce` gives, over the traced
sub-window, each span's count, host self seconds (its duration less its
child spans') and the device seconds of the operations launched while it
was the innermost span open; and the device's idle gaps named by the
benchmark call and the innermost program span open on the host at the gap's
middle (``host:draw/egg.draw.read_audit``; a gap in no program span keeps
the call's name, ``host:draw``), summed by name (``idle_by_span``) and by
every span that holds the middle (``idle_within``).

The run is ``run.py --trace 1``'s set-up and window without the check: it
prints one JSON object with the reduction per traced unit, the program's
counters at the window's start (the set-up's) and over the window
(:mod:`.program`), the per-layer metrics whose readers find something, and
the card. A program without spans (an older commit) reduces to none.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

TOP = 10
PROGRAM = re.compile(r"^egg\.[A-Za-z0-9_.]+$")


@dataclass
class Span:
    name: str
    start: float            # us, host clock of the trace
    end: float
    parent: int = -1        # index of the innermost span holding it
    child_us: float = 0.0   # of its duration, what its child spans cover
    device_s: float = 0.0   # operations launched while it was innermost


class _Spans:
    """The program's spans sorted by start, each with its parent (spans on
    one host thread nest), and the innermost span open at a time."""

    def __init__(self, spans: List[Span]):
        self.spans = sorted(spans, key=lambda s: (s.start, -s.end))
        self.starts = [s.start for s in self.spans]
        open_ = []
        for i, s in enumerate(self.spans):
            while open_ and self.spans[open_[-1]].end < s.end:
                open_.pop()
            if open_:
                s.parent = open_[-1]
                self.spans[s.parent].child_us += s.end - s.start
            open_.append(i)

    def at(self, ts: float) -> int:
        """Index of the innermost span open at ``ts``, or -1."""
        j = bisect.bisect_right(self.starts, ts) - 1
        while j >= 0 and self.spans[j].end < ts:
            j = self.spans[j].parent
        return j

    def chain(self, j: int):
        """The names of span ``j`` and of every span holding it."""
        names = []
        while j >= 0:
            names.append(self.spans[j].name)
            j = self.spans[j].parent
        return names


def reduce(events: list, first: int = 0) -> dict:
    """The program's spans over the traced sub-window (as
    :func:`.tracing.reduce` bounds it: the units from ``first`` on):
    ``units`` traced, ``spans`` (name -> ``count``, ``host_self_s``,
    ``device_s``), ``idle_by_span`` and ``idle_within`` (name -> idle
    seconds, longest first), ``idle_gaps`` (the ``TOP`` longest, named as
    in ``idle_by_span``)."""
    from .tracing import DEVICE_CATS, RANGE, UNITS, Range, _Index
    bench, spans, launch_ts, device = [], [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation":
            m = RANGE.match(name)
            if m and int(m.group(2)) >= first:
                bench.append(Range(m.group(1), int(m.group(2)), e["ts"],
                                   e["ts"] + e["dur"]))
            elif PROGRAM.match(name):
                spans.append(Span(name, e["ts"], e["ts"] + e["dur"]))
        elif cat.startswith("cuda_"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
        elif cat in DEVICE_CATS:
            device.append(e)
    units = [r for r in bench if r.name in UNITS]
    if not units:
        return {"units": 0, "spans": {}, "idle_by_span": [],
                "idle_within": [], "idle_gaps": []}
    w0, w1 = min(r.start for r in units), max(r.end for r in units)
    index = _Spans([s for s in spans if s.end > w0 and s.start < w1])
    calls = _Index(bench)
    busy = []
    for e in device:
        a, b = e["ts"], e["ts"] + e["dur"]
        if b <= w0 or a >= w1:
            continue
        busy.append((max(a, w0), min(b, w1)))
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        j = -1 if ts is None else index.at(ts)
        if j >= 0:
            index.spans[j].device_s += e["dur"] * 1e-6
    out: Dict[str, dict] = {}
    for s in index.spans:
        o = out.setdefault(s.name, {"count": 0, "host_self_s": 0.0,
                                    "device_s": 0.0})
        o["count"] += 1
        o["host_self_s"] += (s.end - s.start - s.child_us) * 1e-6
        o["device_s"] += s.device_s
    by_span: Dict[str, float] = {}
    within: Dict[str, float] = {}
    gaps = []
    busy.sort()
    t = w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            mid, idle = 0.5 * (a + t), (a - t) * 1e-6
            call: Optional[Range] = calls.at(mid)
            j = index.at(mid)
            name = "host:" + (call.name if call else "outside")
            if j >= 0:
                name += "/" + index.spans[j].name
            by_span[name] = by_span.get(name, 0.0) + idle
            for n in set(index.chain(j)):
                within[n] = within.get(n, 0.0) + idle
            gaps.append([name, idle])
        t = max(t, b)
    gaps.sort(key=lambda g: -g[1])

    def longest(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])]

    return {"units": len(units), "spans": out,
            "idle_by_span": longest(by_span), "idle_within": longest(within),
            "idle_gaps": gaps[:TOP]}


def per_unit(reduced: dict) -> dict:
    """:func:`reduce`'s seconds as milliseconds and its counts per traced
    unit."""
    n = max(reduced["units"], 1)
    ms = 1000.0 / n
    return {
        "units": reduced["units"],
        "spans": {k: {"count": v["count"] / n,
                      "host_self_ms": v["host_self_s"] * ms,
                      "device_ms": v["device_s"] * ms}
                  for k, v in reduced["spans"].items()},
        "idle_by_span_ms": [[k, v * ms] for k, v in
                            reduced["idle_by_span"][:TOP]],
        "idle_within_ms": [[k, v * ms] for k, v in reduced["idle_within"]],
        "idle_gaps_ms": [[k, v * 1000.0] for k, v in reduced["idle_gaps"]],
    }


def window_metrics(kind: str, units: int, steps_per_call: int,
                   reduced: dict, setup: dict, window: dict) -> dict:
    """The numbers the spans and counters give of one traced run:
    re-renders a frame over the window, device-idle ms a traced frame
    inside ``egg.draw`` (a step of the traced calls inside
    ``egg.run_steps``), graph-build seconds at the window's start (none
    where no graph was built)."""
    within = dict(reduced["idle_within"])
    n = reduced["units"]
    out = {"setup_capture_s": setup.get("capture_seconds") or None}
    if kind == "frames":
        if units > 0 and "rerenders" in window:
            out["rerenders_per_frame"] = window["rerenders"] / units
        if n > 0:
            out["draw_idle_ms"] = 1000.0 * within.get("egg.draw", 0.0) / n
    elif n > 0 and steps_per_call > 0:
        out["run_steps_idle_ms"] = (1000.0 * within.get("egg.run_steps", 0.0)
                                    / (n * steps_per_call))
    return {k: v for k, v in out.items() if v is not None}


def run(workload: str, seed: int, seconds: float, device, **files) -> dict:
    """One traced run of ``workload`` on ``device``, without the check: the
    object :func:`main` prints (its ``setup_s`` counts from this call, not
    from the process's start). ``files`` stand in for the cell's files, as
    in ``harness.run_cell``."""
    from . import harness, manifest, program, tracing
    t0 = time.perf_counter()
    man = manifest.load()
    w = manifest.workload(man, workload)
    cell = harness.Cell(w, seed, device, True, **files)
    cell.setup()
    setup_s = time.perf_counter() - t0
    c0 = program.numbers_of(program.program_counters(cell.h))
    cell.window(seconds)
    c1 = program.numbers_of(program.program_counters(cell.h))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        cell.tracer.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    run_ = cell.run
    run_.trace = tracing.reduce(events, harness.KERNEL_SYMBOLS,
                                cell.tracer.lead)
    reduced = reduce(events, cell.tracer.lead)
    window = {k: c1[k] - c0[k] for k in c0 if k in c1}
    return {
        "workload": workload, "seed": seed, "card": harness.card(),
        "setup_s": setup_s, "units": run_.units,
        "window_s": run_.window_s,
        "graphs_made_in_window": cell.census[0] != cell.census[1],
        "device": {"busy_s": run_.trace.busy_s,
                   "window_s": run_.trace.window_s},
        "metrics": {k: v["value"] for k, v in harness.result_metrics(
            man, workload, run_, True, setup_s).items()},
        "program": window_metrics(cell.mix.kind, run_.units,
                                  run_.steps_per_call, reduced, c0, window),
        "counters_setup": c0,
        "counters_window_per_unit": {k: v / max(run_.units, 1)
                                     for k, v in window.items()},
        "breakdown": {"idle_gaps": run_.trace.idle_gaps},
        "traced": per_unit(reduced),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("benchmark.spans: needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(run(args.workload, args.seed, args.seconds,
                         torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
