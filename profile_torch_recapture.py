#!/usr/bin/env python3
"""How far a replayed graph's time moves from one capture to the next, on
one card.

    python3 profile_torch_recapture.py [--captures 8] [--n 30] [--tree DIR]

On the bench's 1M scene (``bench.build_handler``, settled 120 updates):
for each of ``--captures`` captures of the fixed step's graph (the
handler's step graphs dropped between, so the next ``update`` captures
anew), the replayed ``update`` per step (CUDA events around ``--n``
replays, the median of 3 blocks) and the device time of one traced block
(the sum of its CUDA kernel, copy and set events, per step); then the same
for the replayed 2560 px render (the handler's ``_render`` at alpha 0.5,
the render graphs dropped between captures). ``--tree`` imports the
package from another checkout (its own kernel library is built there), so
two commits run in turns in one call compare on one card. Prints one JSON
line; needs a CUDA card (exits 1 without one).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--captures", type=int, default=8)
    ap.add_argument("--n", type=int, default=30)
    ap.add_argument("--tree", default=None)
    args = ap.parse_args(argv)
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to measure", file=sys.stderr)
        return 1
    from egg_fluid_simulation_tpu_torch import bench as B
    from egg_fluid_simulation_tpu_torch.ops.kernels import library
    library.load()
    dev = torch.device("cuda", 0)

    def timed(fn):
        """(median ms of 3 blocks of ``--n`` calls, device ms a call)."""
        fn()
        torch.cuda.synchronize()
        blocks = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            for _ in range(args.n):
                fn()
            e1.record()
            torch.cuda.synchronize()
            blocks.append(e0.elapsed_time(e1) / args.n)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(6):
                fn()
            torch.cuda.synchronize()
        dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        return round(sorted(blocks)[1], 4), round(dev_us / 6e3, 4)

    h = B.build_handler(1_000_000, dev)
    for _ in range(120):
        h.update(1 / 60)
    update = []
    for _ in range(args.captures):
        update.append(timed(lambda: h.update(1 / 60)))
        h._step_graphs = None
    h.seed_render_budget()
    viewport = B._canvas_viewport(h)
    opts2 = h._frame_options()
    render = []
    for _ in range(args.captures):
        render.append(timed(lambda: h._render(opts2, viewport, alpha=0.5,
                                              clone=False)))
        h._render_graphs = None
    print(json.dumps({"tree": args.tree or ".", "card": card(),
                      "update_ms_device_ms": update,
                      "render_ms_device_ms": render}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
