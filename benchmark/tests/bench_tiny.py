"""A cell of the benchmark shrunk to a size a CPU test holds: four default
configs' batches of 60 white + 6 yolk on the cell's capacity (16384, the
dense engine, for ``frames`` and ``headless``; 4096, the gather engine, for
``gather``), a few settling steps, short units."""

from __future__ import annotations

import time

import torch

from benchmark import harness, manifest, traffic

CELLS = {"frames": "eggs_64.frames", "headless": "eggs_64.headless",
         "gather": "default_4k.frames"}
SEED = 2 ** 31 + 11


def files(kind: str):
    man = manifest.load()
    w = manifest.workload(man, CELLS[kind])
    cfg = manifest.config(w["config"])
    cfg["scene"].update(batches=4, lattice_side=2, white_n_particles=60,
                        yolk_n_particles=6, white_radius=31.0)
    cfg["settle_steps"] = 4
    cfg["viewport_px"] = 512
    p = dict(manifest.traffic(w["traffic"]))
    p.update(steps_per_call=3, warm_frames=1, warm_calls=1, check_samples=1,
             trace_lead_frames=0, trace_frames=2, trace_lead_calls=0,
             trace_calls=1)
    return man, w, dict(cfg=cfg, mix=traffic.Mix(w["traffic"], p))


def run(kind: str, trace: bool = False, seconds: float = 0.2,
        seed: int = SEED) -> dict:
    """One run of the shrunk cell on the CPU: the result object."""
    torch.set_num_threads(2)
    man, w, f = files(kind)
    return harness.run_cell(man, w, seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter(), **f)
