"""One run of one cell: set-up, the measured window, the check, the result.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the handler, adds the scene's batches, settles it
(``settle_steps`` fixed steps: ``update`` in a frames cell, one
``run_steps`` call in a headless cell) and warms up every path the window
takes, so the window captures no graph and builds no kernel. The window
then runs the mix's units back to back, in a closed loop, for ``--seconds``
on the host clock; each unit ends with a wait for the device. Afterwards
the program's memory peak is read, the handler is let go and the check runs
(``check.py``). ``--trace 1`` profiles a bounded run of the window's units
and reports the per-layer metrics in place of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (units in the window), ``failed`` (checked units past a
limit), ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each compared number with its limit, also the last lines of
standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import manifest, scene, seeds, stats, system, traffic, tracing
from .check import Checker, Reservoir
from .reference.model import Clock

KERNEL_SYMBOLS = {"substep_pass": "substep_pass_kernel",
                  "splat": "splat_kernel",
                  "gather_sweep": "gather_sweep_kernel"}
FORBIDDEN = ("jax", "jaxlib", "flax", "egg_fluid_simulation_tpu")
STEP_DELTA = 1 / 60


@dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``)."""
    cell: str
    kind: str
    units: int = 0                  # frames or calls in the window
    steps: int = 0                  # fixed steps in the window
    window_s: float = 0.0
    unit_s: list = field(default_factory=list)    # each unit's seconds
    particles: int = 0
    counters: dict = field(default_factory=dict)  # deltas over the window
    rebins: Optional[list] = None   # (white, yolk) over the window
    trace: Optional[tracing.Summary] = None
    bounds: dict = field(default_factory=dict)    # unit -> kernel -> s
    steps_per_call: int = 0
    host_s: dict = field(default_factory=dict)    # call -> host seconds


def forbidden_modules() -> list:
    """Top-level names of ``sys.modules`` that the run must not hold."""
    tops = {name.split(".")[0] for name in sys.modules}
    return sorted(tops & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


class Cell:
    """The handler of one run and the mix's loop around it."""

    def __init__(self, workload: dict, seed: int, device, trace: bool,
                 cfg=None, mix=None, limits=None):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.cfg = cfg or manifest.config(workload["config"])
        self.mix = mix or traffic.load(workload["traffic"])
        self.limits = limits or manifest.limits(workload["name"])
        self.specs = scene.batch_specs(self.cfg["scene"], seed)
        self.centres = np.array([[s["x"], s["y"]] for s in self.specs])
        self.target_fn = traffic.targets(self.mix, self.centres, seed,
                                         float(self.cfg["viewport_px"]))
        self.sample_rng = seeds.rng(seed, seeds.SAMPLE)
        frames = self.mix.kind == "frames"
        lead = self.mix["trace_lead_frames" if frames else "trace_lead_calls"]
        count = self.mix["trace_frames" if frames else "trace_calls"]
        self.tracer = tracing.Tracer(trace, lead, count, self.cuda)
        self.run = Run(workload["name"], self.mix.kind,
                       particles=sum(scene.particles(self.cfg["scene"])))
        self.clock = Clock()
        self.frame_no = 0           # frames since the spawn (target time)
        self.checks = []            # held units: ("frame" | "call", item)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ set-up --

    def setup(self) -> None:
        self.h, self.ids = system.build(self.cfg, self.specs, self.device)
        self.spawned = system.snapshot(self.h, system.SPAWN)
        settle = int(self.cfg["settle_steps"])
        if self.mix.kind == "frames":
            pick = int(self.sample_rng.integers(0, settle))
            for s in range(settle):
                self._frame(hold=s == pick, draw=False)
            x, y = self.centres.mean(axis=0)
            v = int(self.cfg["viewport_px"])
            self.viewport = (float(x - v / 2), float(y - v / 2), v, v)
            # an app's set-up of a large scene: the render budget sized
            # from the scene before the first draw (public API)
            self.h.seed_render_budget()
            for _ in range(int(self.mix["warm_frames"])):
                self._frame(hold=False)
        else:
            self.h.run_steps(settle)
            for _ in range(int(self.mix["warm_calls"])):
                self._call(hold=False)
        self.sync()
        self.tracer.start()

    # ------------------------------------------------------------- units --

    @contextlib.contextmanager
    def _host(self, name: str, i: int):
        """Host seconds of each call of the window's units, summed."""
        if i < 0:
            yield
            return
        t0 = time.perf_counter()
        yield
        s = self.run.host_s
        s[name] = s.get(name, 0.0) + time.perf_counter() - t0

    def _targets(self):
        if self.target_fn is None:
            return None
        t = self.target_fn(self.frame_no)
        for bid, (x, y) in zip(self.ids, t):
            self.h.set_target_position(bid, float(x), float(y))
        return t

    def _frame(self, hold: bool, draw: bool = True, i: int = -1):
        """One frame (or one settling update): targets, ``update``,
        ``draw``, the wait. With ``hold`` the unit's inputs and outputs are
        kept for the check. Returns the held item or None."""
        h, tr = self.h, self.tracer
        dt = float(self.mix["frame_dt_s"])
        item = None
        if hold:
            item = dict(before=system.snapshot(h), wide=system.wide_state(h),
                        unit=i, step_delta=STEP_DELTA)
        clock = self._host
        with tr.span("targets", i), clock("targets", i):
            t = self._targets()
        with tr.span("update", i), clock("update", i):
            h.update(dt)
        steps, alpha = self.clock.advance(dt, STEP_DELTA)
        self.frame_no += 1
        self.run.steps += steps if i >= 0 else 0
        if hold:
            item.update(after=system.snapshot(h), stats=system.stats(h),
                        targets=t, steps=steps, alpha=alpha)
        if draw:
            with tr.span("draw", i), clock("draw", i):
                img = h.draw(viewport=self.viewport)
                if hold:
                    item["frame"] = img.clone()
        with tr.span("sync", i), clock("sync", i):
            self.sync()
        if hold and not draw:
            self.checks.append(("frame", item))
        return item

    def _call(self, hold: bool, i: int = -1):
        """One ``run_steps`` call and the wait."""
        h, tr = self.h, self.tracer
        n = int(self.mix["steps_per_call"])
        item = None
        if hold:
            item = dict(before=system.snapshot(h), wide=system.wide_state(h),
                        rebins0=system.rebins(h), unit=i, n_steps=n,
                        targets=None, step_delta=STEP_DELTA)
        with tr.span("run_steps", i), self._host("run_steps", i):
            h.run_steps(n)
        with tr.span("sync", i), self._host("sync", i):
            self.sync()
        if hold:
            r1 = system.rebins(h)
            item.update(after=system.snapshot(h), stats=system.stats(h),
                        rebins=(r1 - item.pop("rebins0").to(r1.device)))
        if i >= 0:
            self.run.steps += n
        return item

    # ------------------------------------------------------------ window --

    def window(self, seconds: float) -> None:
        frames = self.mix.kind == "frames"
        res = Reservoir(int(self.mix["check_samples"]), self.sample_rng)
        tr = self.tracer
        c0 = system.counters()
        r0 = system.rebins(self.h)
        self.census = [system.graph_census(self.h)]
        i = 0
        t_start = t_prev = time.perf_counter()
        while True:
            place = None
            if not tr.enabled or tr.counted(i):
                place = res.offer()
            with tr.span("frame" if frames else "call", i):
                item = (self._frame(place is not None, i=i) if frames
                        else self._call(place is not None, i=i))
            t = time.perf_counter()
            self.run.unit_s.append(t - t_prev)
            t_prev = t
            if place is not None:
                res.keep(place, item)
            tr.end(i)
            i += 1
            if t - t_start >= seconds:
                break
        tr.stop()
        self.run.window_s = t_prev - t_start
        self.run.units = i
        c1 = system.counters()
        self.run.counters = {k: c1[k] - c0[k] for k in c0}
        self.run.rebins = (system.rebins(self.h) - r0.to(self.device)).tolist()
        self.run.steps_per_call = 0 if frames else int(
            self.mix["steps_per_call"])
        self.census.append(system.graph_census(self.h))
        kind = "frame" if frames else "call"
        self.checks += [(kind, it) for it in res.items()]


def result_metrics(man: dict, cell: str, run: Run, trace: bool,
                   setup_s: float) -> dict:
    """The cell's end-to-end metrics (``trace`` off) or its per-layer
    metrics (``trace`` on); a reader that finds nothing leaves its metric
    out."""
    out = {}
    if trace:
        for m in manifest.cell_metrics(man, cell, "per_layer"):
            v = manifest.reader(m["name"])(run)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    values = {
        "setup_s": setup_s,
        "frame_ms": lambda: stats.rate_ms(run.window_s, run.units),
        "frame_p95_ms": lambda: 1000.0 * stats.percentile(run.unit_s, 95),
        "particle_steps_per_s": lambda: stats.per_second(
            run.particles * run.steps, run.window_s),
    }
    for m in manifest.cell_metrics(man, cell, "end_to_end"):
        v = values[m["name"]]
        out[m["name"]] = {"value": v if isinstance(v, float) else v(),
                          "unit": m["unit"]}
    return out


def run_cell(man: dict, workload: dict, seed: int, seconds: float,
             trace: bool, device, t0: float, **files) -> dict:
    """One run; returns the result object (``correct`` and the rest).
    ``files`` (``cfg``, ``mix``, ``limits``) stand in for the cell's files
    (a test's small scene)."""
    cell = Cell(workload, seed, device, trace, **files)
    cuda = cell.cuda
    cell.setup()
    setup_s = time.perf_counter() - t0
    cell.window(seconds)
    peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    run = cell.run
    if trace:
        run.trace = cell.tracer.summary(tempfile.gettempdir(),
                                        KERNEL_SYMBOLS)
    spawned, checks = cell.spawned, cell.checks
    del cell.h
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checker = Checker(cell.cfg, cell.specs, cell.device, cell.limits)
    checker.spawn(spawned)
    for kind, item in checks:
        if kind == "frame":
            checker.frame(item, getattr(cell, "viewport", None))
        else:
            checker.call(item)
    run.bounds = checker.bounds
    name = workload["name"]
    out = {
        "correct": checker.correct,
        "attempted": run.units,
        "failed": checker.failed_units,
        "metrics": result_metrics(man, name, run, trace, setup_s),
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(cell.device) if cuda
                            else device.type),
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace and run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["card"] = card() if cuda else device.type
    out["checked_units"] = len(checks)
    out["reference_s"] = checker.seconds
    out["diagnostics"] = {
        "graphs_before_after": cell.census,
        "graphs_made_in_window": cell.census[0] != cell.census[1],
        "unit_s": {q: stats.percentile(run.unit_s, q)
                   for q in (0, 5, 50, 95, 100)},
        "host_s_per_unit": {k: v / max(run.units, 1)
                            for k, v in run.host_s.items()},
        "window_s": run.window_s, "steps": run.steps,
        "checked_passes_by_window": checker.passes,
        "numbers": checker.numbers}
    out["checks"] = checker.report()
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    man = manifest.load()
    workload = manifest.workload(man, args.workload)
    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(man, workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("diagnostics " + json.dumps(result["diagnostics"]),
          file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
