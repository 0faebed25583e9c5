"""Multi-device dry run: the sharded layers on N ranks against one device.

    python -m egg_fluid_simulation_tpu_torch.parallel.dryrun --device cpu [--ranks 4]

The counterpart of ``egg_fluid_simulation_tpu/parallel/dryrun.py``. It
starts ``--ranks`` processes of one process group (a file store in a
temporary directory; gloo ranks with ``--device cpu``, NCCL and one card a
rank with ``--device cuda``) and checks on them: the 1D particle-sharded
step against the single-device step of the same state (positions rtol 1e-5
/ atol 1e-4 px), the 2D spatial step (halo exchange, migration) against the
single-device dense step (centroids rtol 1e-4 / atol 1e-3 px), three
resident spatial steps without a migration drop, the sharded render, and
the SpatialHandler product flow, which on a card replays its steps and
draws from CUDA graphs (``parallel/spatial_graph.py``), held bit for bit
against the same flow on the eager route (frame within 1e-6). ``--device`` is required: on a machine
with one card, more than one rank works only as gloo ranks on the CPU, and
the script does not choose that for the caller.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

MESHES = {1: (1, 1), 2: (2, 1), 4: (2, 2), 8: (4, 2)}


def _tiny_handler(capacity: int, device, engine: str = "gather"):
    from egg_fluid_simulation_tpu_torch import (SimulationHandler,
                                                SolverOptions,
                                                default_white_config,
                                                default_yolk_config)
    h = SimulationHandler(
        default_white_config(), default_yolk_config(), capacity=capacity,
        max_batches=8, device=device,
        options=SolverOptions(engine=engine, table_size=2048,
                              slots_per_cell=16, dense_grid_dim=64,
                              dense_slots=4,
                              budget_mode="off" if engine == "dense"
                              else "ordered"))
    a = h.add(0.0, 0.0, 20.0, 6.0, None, None, 40, 10)
    h.add(120.0, 40.0, 20.0, 6.0, None, None, 30, 8)
    h.set_target_position(a, 80.0, 30.0)
    h._flush_targets()
    return h


def check(n_ranks: int, device: str) -> None:
    """The dry run's checks, on every rank of a running group; rank 0
    prints."""
    import torch.distributed as dist

    from egg_fluid_simulation_tpu_torch import (SpatialHandler,
                                                default_white_config,
                                                default_yolk_config)
    from egg_fluid_simulation_tpu_torch.ops import render as R
    from egg_fluid_simulation_tpu_torch.ops import solver as solver_ops
    from egg_fluid_simulation_tpu_torch.ops.solver import SolverOptions
    from egg_fluid_simulation_tpu_torch.parallel import sharding
    from egg_fluid_simulation_tpu_torch.parallel import spatial as S

    lead = dist.get_rank() == 0
    mesh = sharding.make_mesh(device)
    dev = mesh.device
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (gloo ranks)")
    capacity = n_ranks * max(64, -(-512 // n_ranks))
    h = _tiny_handler(capacity, dev)
    opts = SolverOptions(engine="gather", table_size=2048, slots_per_cell=16,
                         budget_mode="off")
    cfg2 = h._device_cfg2()
    dt = torch.tensor(1 / 60, device=dev)
    relax = torch.tensor(1.0, device=dev)
    step = sharding.sharded_step(mesh, opts)
    new, stats = step(sharding.shard_state(h.state, mesh), cfg2, dt, relax)
    pos = sharding.unshard_state(new, mesh).pos.cpu().numpy()
    if not np.isfinite(pos[:, :70]).all():
        raise AssertionError("sharded step produced non-finite positions")
    ref, _ = solver_ops.step(h.state, cfg2, dt, relax, opts)
    np.testing.assert_allclose(pos[:, :70], ref.pos.cpu().numpy()[:, :70],
                               rtol=1e-5, atol=1e-4)
    if lead:
        print(f"dryrun: {n_ranks}-rank sharded step OK ({kind}), matches one "
              f"device, centroid={stats.centroid[0].cpu().numpy().round(2)}",
              flush=True)

    # ---- 2D spatial decomposition (dense engine, halo exchange) ----
    db, dx = MESHES[n_ranks]
    lay = S.SpatialLayout(grid_dim=32, slots_per_cell=4, db=db, dx=dx,
                          migrate_cap=32)
    sp_opts = SolverOptions(engine="dense", budget_mode="off",
                            dense_rebin="step", dense_grid_dim=32,
                            dense_slots=4)
    h2 = _tiny_handler(capacity, dev, engine="dense")
    cells = [max(1.0, cfg["max_radius"]
                 * max(cfg["collision_overlap_factor"],
                       cfg["cohesion_interaction_distance_factor"]))
             for cfg in (h2._white_config, h2._yolk_config)]
    sp_mesh = S.make_spatial_mesh(db, dx, device)
    sp_state = S.redistribute(h2.state, cells, lay, sp_mesh)
    sp_state, sp_stats, _ = S.spatial_step(sp_mesh, lay, sp_opts)(
        sp_state, h2._device_cfg2(), dt, relax)
    if not torch.isfinite(sp_state.pos).all():
        raise AssertionError("spatial step produced non-finite positions")
    _, ref2_stats = solver_ops.step(h2.state, h2._device_cfg2(), dt, relax,
                                    sp_opts)
    np.testing.assert_allclose(sp_stats.centroid.cpu().numpy(),
                               ref2_stats.centroid.cpu().numpy(), rtol=1e-4,
                               atol=1e-3)
    cb = lay.collective_bytes_per_step(sp_opts)
    if lead:
        print(f"dryrun: ({db}x{dx})-mesh 2D spatial dense step OK, halo "
              f"exchange + migration, centroid matches one device; bytes a "
              f"step a rank (model): {cb['total_per_step']:,}", flush=True)

    # ---- resident steps (drift-gated rebin, migration inside it) ----
    multi = S.spatial_multi_step(sp_mesh, lay, sp_opts)
    sp_state2, sp_stats2, info2, _ = multi(sp_state, h2._device_cfg2(), dt,
                                           relax, 3)
    if not (torch.isfinite(sp_state2.pos).all()
            and int(info2[:, 0].sum()) == 0):
        raise AssertionError("resident spatial steps: non-finite or dropped")
    if lead:
        print(f"dryrun: ({db}x{dx})-mesh resident steps OK (3 steps)",
              flush=True)

    # ---- sharded render ----
    opts2 = tuple(R.auto_render_options(cfg, 256)
                  for cfg in (h2._white_config, h2._yolk_config))
    draw = S.spatial_draw(sp_mesh, lay, opts2, (0.0, 0.0, 256, 256), 0.3,
                          0.01, True)
    frame = draw(sp_state2, sp_stats2, h2._device_cfg2(), 1.0).cpu().numpy()
    if not (frame.shape == (256, 256, 4) and np.isfinite(frame).all()
            and frame[..., 3].max() > 0.05):
        raise AssertionError("sharded render is empty or not finite")
    if lead:
        print(f"dryrun: ({db}x{dx})-mesh sharded render OK (frame alpha max "
              f"{frame[..., 3].max():.3f})", flush=True)

    # ---- the product surface ----
    hp = SpatialHandler(default_white_config(), default_yolk_config(),
                        db=db, dx=dx, capacity=capacity, max_batches=8,
                        options=sp_opts, device=device)
    bid = hp.add(60.0, 50.0, 25.0, 8.0, None, None, 50, 12)
    hp.set_target_position(bid, 100.0, 80.0)
    hp.update(2 / 60)
    hp.run_steps(2)
    frame2 = hp.draw(viewport=(0, 0, 256, 256)).cpu().numpy()
    px, py = hp.get_position(bid)
    if not (np.isfinite(frame2).all() and frame2[..., 3].max() > 0.05
            and np.isfinite([px, py]).all()):
        raise AssertionError("SpatialHandler product flow failed")
    if lead:
        print(f"dryrun: SpatialHandler product flow OK (add / update / "
              f"run_steps / draw / get_position on the {db}x{dx} mesh)",
              flush=True)

    # ---- the same flow on the eager route: on a card the handler above
    # replayed its steps and draws from CUDA graphs ----
    from egg_fluid_simulation_tpu_torch.ops.step_graph import EAGER
    from egg_fluid_simulation_tpu_torch.parallel.spatial_graph import (
        STATE_OUT, rebin_route)
    he = SpatialHandler(default_white_config(), default_yolk_config(),
                        db=db, dx=dx, capacity=capacity, max_batches=8,
                        options=sp_opts, device=device)
    he._spatial = EAGER
    bid = he.add(60.0, 50.0, 25.0, 8.0, None, None, 50, 12)
    he.set_target_position(bid, 100.0, 80.0)
    he.update(2 / 60)
    he.run_steps(2)
    frame_e = he.draw(viewport=(0, 0, 256, 256)).cpu().numpy()
    unequal = [f for f in STATE_OUT if not torch.equal(
        getattr(hp.state, f), getattr(he.state, f))]
    frame_err = float(np.abs(frame2 - frame_e).max())
    if unequal or frame_err > 1e-6:
        raise AssertionError(f"the replayed SpatialHandler differs from the "
                             f"eager one: {unequal}, frame {frame_err}")
    if lead:
        route = ("eager on the CPU" if hp._spatial is None
                 else f"graphs, rebin route {rebin_route(hp.mesh)}")
        print(f"dryrun: SpatialHandler ({route}) = the eager route, bit for "
              f"bit (frame {frame_err})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", required=True, choices=("cpu", "cuda"),
                    help="cpu: gloo ranks; cuda: NCCL, one card a rank")
    ap.add_argument("--ranks", type=int, default=4, choices=sorted(MESHES))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device")
    from .mesh import spawn_ranks
    spawn_ranks(check, (args.ranks, args.device), args.ranks, args.device,
                timeout_s=600.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
