#!/usr/bin/env python3
"""Where the time of a resident step and a resident frame goes, on one card.

    python3 profile_torch_resident.py [--blocks 2] [--n 8]

On the 1M-white scene of ``chip_smoke.build_handler`` (fused path, wide
gate off), after 3 settling updates, in alternating blocks of ``--n``:

- ``update``: ``update(1/60)`` per step;
- ``run_steps``: ``run_steps(n)`` (``n - 1`` resident steps + one full step,
  replayed from the handler's resident graphs);
- ``update_draw``: ``update(1/60)`` + ``draw`` of a 2560 px viewport;
- ``frames``: ``solver.multi_step_frames`` over ``n`` frames through the
  handler's resident graphs, with the same render as ``frame_fn``.

``rebins`` is the handler's count over the block (the replayed loops'
device counter), ``host_syncs`` the eager loop's reads of the rebin flag.

Each block is timed with the host clock around work that ends in
``torch.cuda.synchronize()``; one more block of each runs under
``utils.profiling.trace`` for the device time (sum of kernel events), the
kernel count and the device's busy share, its Chrome trace written to
``--trace-dir/<mode>/trace.json`` (a temporary directory by default).
Prints one JSON object per line and needs a CUDA card (exits 1 without
one).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    from egg_fluid_simulation_tpu_torch.utils.profiling import trace

    card = C.nvidia_smi()
    dev = torch.device("cuda", 0)
    h = C.build_handler(C.N_WHITE, dev)
    h.seed_render_budget()
    viewport = (0, 0, 2560, 2560)
    for _ in range(3):
        h.update(1 / 60)
        h.draw(viewport=viewport)
    torch.cuda.synchronize()
    n = args.n

    def frames():
        dt, relax = h._step_scalars(1 / 60)
        h._state, _ = S.multi_step_frames(h.state, h._device_cfg2(), dt, relax,
                                          h._options, n,
                                          C.render_frame_fn(h, viewport),
                                          graphs=h._resident_graphs())

    def update_draw():
        for _ in range(n):
            h.update(1 / 60)
            h.draw(viewport=viewport)

    def update():
        for _ in range(n):
            h.update(1 / 60)

    modes = {"update": update, "run_steps": lambda: h.run_steps(n),
             "update_draw": update_draw, "frames": frames}
    times = {m: [] for m in modes}
    for b in range(args.blocks):
        order = list(modes) if b % 2 == 0 else list(modes)[::-1]
        for m in order:
            S.host_syncs = 0
            before = C.BENCH.rebin_count(h)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            modes[m]()
            torch.cuda.synchronize()
            times[m].append((time.perf_counter() - t0) * 1e3 / n)
            rebins = [a - b for a, b in zip(C.BENCH.rebin_count(h), before)]
            print(json.dumps({"block": b, "mode": m, "ms_per_unit": times[m][-1],
                              "rebins": rebins,
                              "host_syncs": S.host_syncs}), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        for m, fn in modes.items():
            profiled(m, fn, os.path.join(trace_dir, m), n, trace)
    print(json.dumps({"card": card, "summary": {
        m: {"p50_ms": statistics.median(v), "all": v}
        for m, v in times.items()}}), flush=True)
    return 0


def profiled(mode: str, fn, trace_dir: str, n: int, trace) -> None:
    """One block of ``fn`` under ``trace``: prints its device ms, kernels
    and busy share per unit, and the top kernels."""
    import torch
    torch.cuda.synchronize()
    with trace(trace_dir) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    print(json.dumps({
        "mode": mode, "profiled_ms_per_unit": wall / n,
        "device_ms_per_unit": dev_ms / n,
        "kernels_per_unit": len(kernels) / n,
        "busy_share": dev_ms / wall if wall else None,
        "top": [(e.key, e.device_time_total / 1e3 / n, e.count / n)
                for e in top[:8]]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
