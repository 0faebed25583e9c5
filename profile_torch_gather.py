#!/usr/bin/env python3
"""What the gather engine costs the small scenes, replayed from its CUDA
graph and run eagerly, against the dense fused path, on one card.

    python3 profile_torch_gather.py [--blocks 4] [--n 6]
        [--scenes gather_path demo] [--rules gather gather_eager dense]

Below capacity 16384 the automatic handler options pick the gather engine
(kernel H for each collision pass), as the JAX handler does. Before the
gather engine was ported they picked the dense engine with the budget off
at every capacity (the fused path, kernels A and B). This script builds
each scene once per rule and times them in one process. Rules: ``gather``
(the automatic options; the handler replays its captured step),
``gather_eager`` (the same stepping eagerly: one launch per op)
and ``dense`` (the dense rule, replayed). Scenes:

- ``gather_path``: ``chip_smoke.gather_handler`` (capacity 8192, 8 batches
  of 900 white + 90 yolk), after 3 settling updates;
- ``demo``: ``DemoState(seed=0, capacity=8192)`` after ``run(60)``.

Before the timing, kernel H is held against its plain version on each
scene's state (``chip_smoke.check_gather_pairs``: its ms per call from a
CUDA graph of 20 calls, its bound and the plain version's ms, both
populations). Modes, in alternating blocks of ``--n`` units (the rule
order reverses every block): ``update`` (``update(1/60)``) and ``frame``
(``update`` + the 800 x 600 ``draw``). Each block is timed with the host
clock around work that ends in ``torch.cuda.synchronize()``; one more
block of each runs under ``utils.profiling.trace`` for the device ms (sum
of the kernel events), kernels, busy share and the top kernels per unit.
Prints the gather / dense and eager / replay wall ratios. Run from the
root of another tree (an older commit unpacked with ``git archive``), it
times that tree's package (there ``gather_eager`` is ``gather``, and the
check of H is skipped where the tree has none). Prints one JSON object per
line and needs a CUDA card (exits 1 without one).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import sys
import time

VIEWPORT = (0.0, 0.0, 800, 600)


def dense_rule(base):
    """``base`` (the port's ``SimulationHandler``) with the automatic
    options of every capacity before the gather engine: the dense engine,
    budget off, K = 4, a grid of ``g^2 >= cap`` cells a population."""

    class DenseRule(base):
        def _auto_options(self, counts):
            o = super()._auto_options(counts)
            grids = []
            for cap in o.pop_caps:
                g = 32
                while g * g < cap and g < 2048:
                    g *= 2
                grids.append(g)
            return dataclasses.replace(o, engine="dense",
                                       dense_grid_dim=tuple(grids),
                                       dense_slots=4, budget_mode="off")

    return DenseRule


@contextlib.contextmanager
def handler_rule(rule: str):
    """Build handlers under ``rule`` ("gather" and "gather_eager": the
    automatic options as they are; "dense": ``dense_rule``) inside the
    block."""
    import egg_fluid_simulation_tpu_torch as P
    from egg_fluid_simulation_tpu_torch import demo as D
    base = P.SimulationHandler
    cls = dense_rule(base) if rule == "dense" else base
    P.SimulationHandler = D.SimulationHandler = cls
    try:
        yield
    finally:
        P.SimulationHandler = D.SimulationHandler = base


def step_eagerly(h) -> None:
    """``h`` runs its fixed steps eagerly on the card (a tree without the
    captured step always does)."""
    try:
        from egg_fluid_simulation_tpu_torch.ops.step_graph import EAGER
    except ImportError:
        return
    h._step_graphs = EAGER


def build(scene: str, rule: str, dev):
    """(handler, update, draw) of ``scene`` under ``rule``; with
    "gather_eager" the handler steps eagerly from its first step."""
    import chip_smoke as C
    from egg_fluid_simulation_tpu_torch.demo import DemoState
    eager = rule == "gather_eager"
    with handler_rule(rule):
        if scene == "gather_path":
            h = C.gather_handler(dev)
            if eager:
                step_eagerly(h)
            for _ in range(3):
                h.update(1 / 60)
            return (h, lambda: h.update(1 / 60),
                    lambda: h.draw(viewport=VIEWPORT))
        d = DemoState(seed=C.SEED, capacity=C.GATHER_CAPACITY, device=dev)
        if eager:
            step_eagerly(d.handler)
        d.run(C.DEMO_FRAMES)
        return d.handler, lambda: d.update(1 / 60), d.draw


def traced(fn, n: int) -> dict:
    """One block of ``fn`` (``n`` units) under ``utils.profiling.trace``:
    device ms, kernels, busy share and wall ms per unit, and the 8 kernels
    with the most device time (name, ms per unit, launches per unit)."""
    import tempfile
    import torch
    from egg_fluid_simulation_tpu_torch.utils.profiling import trace
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    return {"device_ms": dev_ms / n, "kernels": len(kernels) / n,
            "busy_share": dev_ms / wall if wall else None,
            "profiled_wall_ms": wall / n,
            "top": [(e.key[:80], e.device_time_total / 1e3 / n, e.count / n)
                    for e in top[:8]]}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--scenes", nargs="+", default=["gather_path", "demo"],
                    choices=["gather_path", "demo"])
    ap.add_argument("--rules", nargs="+",
                    default=["gather", "gather_eager", "dense"],
                    choices=["gather", "gather_eager", "dense"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C

    card = C.nvidia_smi()
    dev = torch.device("cuda", 0)
    n = args.n
    summary = {}
    for scene in args.scenes:
        runs = {}
        for rule in args.rules:
            h, update, draw = build(scene, rule, dev)
            o = h._options
            if rule == "gather" and hasattr(C, "check_gather_pairs"):
                results = {}
                C.check_gather_pairs(h, scene, results)
                print(json.dumps({"scene": scene, "kernel_h": results}),
                      flush=True)
            print(json.dumps({"scene": scene, "rule": rule, "engine": o.engine,
                              "budget_mode": o.budget_mode,
                              "pop_caps": list(o.pop_caps),
                              "table_size": o.table_size,
                              "dense_grid_dim": list(o.dense_grid_dim),
                              "particles": list(h.get_n_particles())}),
                  flush=True)

            def frame(update=update, draw=draw):
                update()
                draw()

            runs[rule] = {"update": update, "frame": frame}
        times = {(r, m): [] for r in runs for m in ("update", "frame")}
        for b in range(args.blocks):
            rules = list(runs) if b % 2 == 0 else list(runs)[::-1]
            for rule in rules:
                for mode, fn in runs[rule].items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(n):
                        fn()
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3 / n
                    times[(rule, mode)].append(ms)
                    print(json.dumps({"scene": scene, "block": b, "rule": rule,
                                      "mode": mode, "ms_per_unit": ms}),
                          flush=True)
        for (rule, mode), v in times.items():
            prof = traced(lambda: [runs[rule][mode]() for _ in range(n)], n)
            row = {"scene": scene, "rule": rule, "mode": mode,
                   "wall_p50_ms": statistics.median(v), "wall_ms": v, **prof}
            print(json.dumps(row), flush=True)
            summary[f"{scene}.{rule}.{mode}"] = row
        for mode in ("update", "frame"):
            wall = {r: summary[f"{scene}.{r}.{mode}"]["wall_p50_ms"]
                    for r in runs}
            ratios = {f"{a}_over_{b}_wall": wall[a] / wall[b]
                      for a, b in (("gather", "dense"),
                                   ("gather_eager", "gather"))
                      if a in wall and b in wall}
            print(json.dumps({"scene": scene, "mode": mode, **ratios}),
                  flush=True)
    print(json.dumps({"card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
