"""The traced sub-window: ``torch.profiler`` over a bounded run of units,
the benchmark's own ranges around each call into the handler, and the
reduction of the trace to device seconds by range, busy and idle time and
the top device operations.

A unit of work ``i`` is the range ``bench.<unit>#i`` (``frame`` or
``call``); inside it each call into the handler is a range
``bench.<call>#i`` (``targets``, ``update``, ``draw``, ``run_steps``,
``sync``). A device operation belongs to the innermost range open when the
host launched it (the runtime call with its correlation id: a replayed
CUDA graph's kernels carry its launch's), and the idle gaps between device
operations are named by the range open on the host at the gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
RANGE = re.compile(r"^bench\.([a-z_]+)#(\d+)$")
UNITS = ("frame", "call")


class Tracer:
    """With ``enabled``, profiles from the end of set-up (``start``: the
    profiler's own start-up, seconds on a card, falls there) through unit
    ``lead + count - 1``; the units from ``lead`` on are the traced
    sub-window (the earlier ones let the tracing settle). ``span(name, i)``
    is a range while the profiler runs and a no-op otherwise."""

    def __init__(self, enabled: bool, lead: int, count: int, cuda: bool):
        self.enabled, self.lead, self.count = enabled, lead, count
        self.cuda = cuda
        self.prof = None
        self.done = False

    def start(self) -> None:
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def counted(self, i: int) -> bool:
        """Whether unit ``i`` is in the traced sub-window."""
        return self.enabled and self.lead <= i < self.lead + self.count

    def end(self, i: int) -> None:
        if i >= self.lead + self.count - 1:
            self.stop()

    def stop(self) -> None:
        if self.prof is not None and not self.done:
            if self.cuda:
                torch.cuda.synchronize()
            self.prof.stop()
            self.done = True

    def span(self, name: str, i: int):
        if self.prof is None or self.done:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}#{i}")

    def summary(self, tmpdir: str, symbols: Dict[str, str]):
        """The reduced trace (:func:`reduce`), or None without one."""
        if self.prof is None:
            return None
        # a file of its own: processes that share a temporary directory
        # (a test run's workers) must not read each other's traces
        fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json",
                                    dir=tmpdir)
        os.close(fd)
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return reduce(events, symbols, self.lead)


@dataclass
class Range:
    name: str
    unit: int
    start: float            # us, host clock of the trace
    end: float
    device_s: float = 0.0
    kernels: Dict[str, float] = field(default_factory=dict)   # symbol -> s


@dataclass
class Summary:
    window_s: float
    busy_s: float
    ranges: List[Range]
    device_ops: list
    idle_gaps: list

    def of(self, name: str) -> List[Range]:
        return [r for r in self.ranges if r.name == name]


class _Index:
    """Finds the innermost range that holds a time: a call's range, else
    its unit's (calls do not overlap each other, nor do units)."""

    def __init__(self, ranges: List[Range]):
        self.levels = []
        for pick in (lambda r: r.name not in UNITS, lambda r: r.name in UNITS):
            rs = sorted((r for r in ranges if pick(r)), key=lambda r: r.start)
            self.levels.append((rs, [r.start for r in rs]))

    def at(self, ts: float) -> Optional[Range]:
        for rs, starts in self.levels:
            j = bisect.bisect_right(starts, ts) - 1
            if j >= 0 and rs[j].start <= ts <= rs[j].end:
                return rs[j]
        return None


def reduce(events: list, symbols: Dict[str, str], first: int = 0) -> Summary:
    """Device seconds by range, busy seconds over the traced sub-window
    (from the start of unit ``first``'s range to the end of the last
    unit's), the device operations that took most time in it and the
    longest idle gaps. ``symbols`` maps a kernel's name in the metrics to
    its symbol, matched as a word."""
    ranges, launch_ts, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "user_annotation":
            m = RANGE.match(e.get("name", ""))
            if m:
                ranges.append(Range(m.group(1), int(m.group(2)), e["ts"],
                                    e["ts"] + e["dur"]))
        elif cat.startswith("cuda_"):          # the CUDA API calls
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
        elif cat in DEVICE_CATS:
            device.append(e)
    ranges = sorted((r for r in ranges if r.unit >= first),
                    key=lambda r: r.start)
    index = _Index(ranges)
    units = [r for r in ranges if r.name in UNITS]
    if not units:
        return Summary(0.0, 0.0, ranges, [], [])
    w0, w1 = units[0].start, max(r.end for r in units)
    pats = {k: re.compile(r"(?<![\w])" + re.escape(v) + r"(?![\w])")
            for k, v in symbols.items()}
    by_name: Dict[str, float] = {}
    spans = []
    for e in device:
        if e["ts"] + e["dur"] <= w0 or e["ts"] >= w1:
            continue
        dur_s = e["dur"] * 1e-6
        name = e.get("name", "?")
        by_name[name] = by_name.get(name, 0.0) + dur_s
        spans.append((e["ts"], e["ts"] + e["dur"]))
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        r = None if ts is None else index.at(ts)
        if r is None:
            continue
        r.device_s += dur_s
        for k, p in pats.items():
            if p.search(name):
                r.kernels[k] = r.kernels.get(k, 0.0) + dur_s
    # busy: the union of device intervals inside the window
    spans.sort()
    merged = []
    for a, b in spans:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps, t = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > t:
            mid = 0.5 * (a + t)
            r = index.at(mid)
            gaps.append(("host:" + (r.name if r else "outside"),
                         (a - t) * 1e-6))
        t = max(t, b)
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                   ranges=ranges,
                   device_ops=[[n[:200], s] for n, s in ops],
                   idle_gaps=[[n, s] for n, s in gaps[:TOP]])
