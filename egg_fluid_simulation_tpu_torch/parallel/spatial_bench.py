"""Spatial-mode benchmark: time a step, count its collective bytes.

    python -m egg_fluid_simulation_tpu_torch.parallel.spatial_bench --device cpu [--ranks 4] [--particles 20000]

The counterpart of ``egg_fluid_simulation_tpu/parallel/spatial_bench.py``.
It starts ``--ranks`` processes of one group (a file store in a temporary
directory; gloo ranks with ``--device cpu``, NCCL and one card a rank with
``--device cuda``), builds the product SpatialHandler on a ``db x dx`` mesh
of them with ~``--particles`` white particles, and prints one JSON line
(rank 0):

- per-step wall time of the resident steps (``run_steps`` of 10, median of
  3): with ``--device cuda`` the span between two CUDA events around the
  steps, replayed from CUDA graphs (``parallel/spatial_graph.py``), which
  holds the host's work between launches (the migration counters' read, on
  more than one rank the rebin flags' read a step, a redistribute when
  migration overflows), so a wall time and not the device's busy time; with
  ``--device cpu`` the eager steps on the host clock of gloo ranks, a CPU
  number; the route and the host reads of the rebin decision a step;
- the bytes each rank sent in one spatial step, per category
  (``accounting.measured_collective_bytes``: counted at the collective call
  sites on the CPU, from the replayed step's tallies on a card), next to the
  analytic model (``SpatialLayout.collective_bytes_per_step``), and the
  bytes a resident step sent in a ``run_steps`` of 10 (the branches' by the
  rebins the device counted).

``--device`` is required: on a machine with one card more than one rank
works only as gloo ranks on the CPU, and the script does not choose that for
the caller.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

MESHES = {1: (1, 1), 2: (2, 1), 4: (2, 2), 8: (4, 2)}


def bench(n_ranks: int, n_target: int, device: str) -> None:
    """The benchmark on every rank of a running group; rank 0 prints."""
    import torch.distributed as dist

    from egg_fluid_simulation_tpu_torch import (SolverOptions, SpatialHandler,
                                                default_white_config,
                                                default_yolk_config)
    from egg_fluid_simulation_tpu_torch.parallel import spatial as S
    from egg_fluid_simulation_tpu_torch.parallel.accounting import \
        measured_collective_bytes
    from egg_fluid_simulation_tpu_torch.parallel.spatial_graph import \
        rebin_route

    db, dx = MESHES[n_ranks]
    per_batch = max(200, n_target // 16)
    n_batches = max(1, n_target // per_batch)
    capacity = 1 << int(np.ceil(np.log2(n_target + n_batches + 1024)))
    g = 32
    while g * g * 4 < capacity and g < 512:
        g *= 2
    options = SolverOptions(engine="dense", budget_mode="off",
                            dense_rebin="step", dense_grid_dim=g,
                            dense_slots=4)
    h = SpatialHandler(default_white_config(), default_yolk_config(),
                       db=db, dx=dx, capacity=capacity,
                       max_batches=max(256, n_batches + 1), options=options,
                       device=device)
    side = int(np.ceil(np.sqrt(n_batches)))
    batch_radius = float(np.sqrt(per_batch) * 4.0)
    spacing = batch_radius * 2.2
    for b in range(n_batches):
        h.add((b % side) * spacing + spacing, (b // side) * spacing + spacing,
              batch_radius, batch_radius * 0.3, None, None,
              per_batch, max(2, per_batch // 10))
    total = sum(h.get_n_particles())
    dev = h.device
    cuda = dev.type == "cuda"

    # ---- bytes of one spatial step: the eager step's call sites on the
    # CPU, the replayed step's tallies on a card ----
    h._ensure_spatial()
    graphs = h._spatial_graphs()
    step = h._fns()[0] if graphs is None else graphs.step
    dt, relax = h._inner._step_scalars(1 / 60)
    (h._sp_state, h._sp_stats, _), counted = measured_collective_bytes(
        h.mesh, step, h._sp_state, h._inner._device_cfg2(), dt, relax)
    analytic = h.layout.collective_bytes_per_step(options)

    # ---- per-step time and bytes of the resident steps ----
    h.run_steps(2)
    chain, times = 10, []
    S.host_reads = 0
    _, resident = measured_collective_bytes(h.mesh, h.run_steps, chain)
    reads = S.host_reads / chain
    for _ in range(3):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            h.run_steps(chain)
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end) / chain)
        else:
            t0 = time.perf_counter()
            h.run_steps(chain)
            times.append((time.perf_counter() - t0) * 1e3 / chain)
    info = np.asarray(h.last_migration_info)
    if dist.get_rank() == 0:
        print(json.dumps({
            "metric": ("spatial per-step wall time (CUDA events, "
                       "host-bound)" if cuda
                       else "spatial per-step host wall time (CPU gloo "
                            "ranks)"),
            "value": float(sorted(times)[len(times) // 2]),
            "unit": "ms",
            "device": (torch.cuda.get_device_name(dev) if cuda
                       else "cpu (gloo ranks)"),
            "mesh": f"{db}x{dx}",
            "n_particles": total,
            "grid_dim": g,
            "collective_bytes_measured_per_step": counted["total"],
            "collective_bytes_measured": {k: v for k, v in counted.items()
                                          if k != "total"},
            "collective_bytes_analytic_per_step": analytic["total_per_step"],
            "collective_bytes_analytic": analytic,
            "collective_bytes_resident_per_step": {
                k: v / chain for k, v in resident.items()},
            "route": ("eager" if graphs is None
                      else f"graphs, rebin {rebin_route(h.mesh)}"),
            "rebin_host_reads_per_step": reads,
            "migration_dropped": int(info[:, 0].sum()),
        }), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", required=True, choices=("cpu", "cuda"),
                    help="cpu: gloo ranks; cuda: NCCL, one card a rank")
    ap.add_argument("--ranks", type=int, default=4, choices=sorted(MESHES))
    ap.add_argument("--particles", type=int, default=20_000)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device")
    from .mesh import spawn_ranks
    spawn_ranks(bench, (args.ranks, args.particles, args.device), args.ranks,
                args.device, timeout_s=1800.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
